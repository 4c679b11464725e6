"""TTE loss: CE over HuBERT codes + MSE on log-durations.

Port of `parrot_tts_tpu/models/tte/loss.py` (reference
`modules/loss.py:5-21`): cross entropy with ignore_index = n_codes (the pad
code) and MSE on log(dur + 1) masked to real tokens.
"""

from __future__ import annotations

from typing import Callable

import torch


def tte_loss(logits: torch.Tensor, log_dur_pred: torch.Tensor,
             codes: torch.Tensor, durations: torch.Tensor,
             src_mask: torch.Tensor, *, num_codes: int = 1000,
             sample_weight: torch.Tensor | None = None,
             reduce: Callable[[torch.Tensor], None] | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits: (B, T, num_codes); codes: (B, T) int with pad = num_codes;
    log_dur_pred: (B, S); durations: (B, S) int; src_mask: (B, S)
    True=valid; sample_weight: optional (B,) loss weights (0.0 drops a
    filler row; weights scale numerator and denominator, so all-ones is
    torch's masked mean). reduce: for a data-parallel shard, a function
    that sums a tensor over the shards in place; the two denominators
    (weighted valid codes and tokens) are summed by it, so the shard's
    losses are its share of the global batch's, and their sum over the
    shards is the global loss. Returns (total, code_loss, dur_loss)."""
    code_valid = (codes != num_codes).to(torch.float32)
    dur_valid = src_mask.to(torch.float32)
    if sample_weight is not None:
        code_valid = code_valid * sample_weight[:, None]
        dur_valid = dur_valid * sample_weight[:, None]
    denom = torch.stack([code_valid.sum(), dur_valid.sum()])
    if reduce is not None:
        reduce(denom)
    denom = denom.clamp(min=1.0)
    safe_codes = torch.where(codes != num_codes, codes, 0).to(torch.int64)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, safe_codes[..., None])[..., 0]
    code_loss = (nll * code_valid).sum() / denom[0]

    log_dur_tgt = torch.log(durations.to(torch.float32) + 1.0)
    sq = (log_dur_pred - log_dur_tgt).square()
    dur_loss = (sq * dur_valid).sum() / denom[1]
    return code_loss + dur_loss, code_loss, dur_loss
