"""Static-shape length regulator (FastSpeech2 expand-by-duration).

Port of `parrot_tts_tpu/ops/length_regulator.py`: the token index of output
frame t is `searchsorted(cumsum(dur), t, right=True)`, one gather into a
bucket-padded output length; frames beyond sum(dur) are zero.
"""

from __future__ import annotations

import torch


def length_regulator(x: torch.Tensor, durations: torch.Tensor,
                     out_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand encoder states x (B, S, D) by per-token durations (B, S)
    (padding tokens carry 0). Returns (expanded (B, out_len, D) with zeros
    beyond each sample's total, mask (B, out_len) True = valid frame)."""
    b = x.shape[0]
    cum = torch.cumsum(durations.to(torch.int64), dim=1)          # (B, S)
    t = torch.arange(out_len, device=x.device, dtype=torch.int64)
    idx = torch.searchsorted(cum, t.expand(b, out_len).contiguous(),
                             right=True)
    valid = t[None, :] < cum[:, -1:]
    idx = idx.clamp(max=x.shape[1] - 1)
    expanded = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    return torch.where(valid[:, :, None], expanded, 0.0), valid


def durations_from_log_pred(log_dur_pred: torch.Tensor) -> torch.Tensor:
    """Inference-time duration rounding `clamp(round(exp(p) - 1), min=0)`
    (reference modules/parrot.py:82-86); torch.round is round-half-to-even
    like the JAX package's jnp.round."""
    return torch.clamp(torch.round(torch.exp(log_dur_pred) - 1.0),
                       min=0.0).to(torch.int32)
