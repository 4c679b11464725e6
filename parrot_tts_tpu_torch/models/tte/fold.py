"""Serving-time parameter folding for the TTE.

Port of `parrot_tts_tpu/models/tte/fold.py`. The reference's attention
applies four projections per block — qkv Linear, MHA in_proj, MHA out_proj,
wo. Consecutive linear maps compose, so for inference (torch layouts,
y = x Wᵀ):

    in_proj_weight[q] <- in_proj_weight[q] @ qkv.weight[q]   (per q/k/v third)
    out_proj.weight   <- wo.weight @ out_proj.weight

halving the projection matmuls. A folded state dict loads into
`Parrot(cfg, folded=True)`.
"""

from __future__ import annotations

import torch

from parrot_tts_tpu_torch.core.device import exact_numerics

_QKV = ".attention.qkv.weight"


def fold_tte_params(state: dict) -> dict:
    """Fold every FFT block's attention in a `Parrot` state dict."""
    folded = dict(state)
    prefixes = [k[: -len(_QKV)] for k in state if k.endswith(_QKV)]
    with torch.no_grad(), exact_numerics(True):
        for p in prefixes:
            qkv = folded.pop(p + _QKV)
            wo = folded.pop(f"{p}.attention.wo.weight")
            in_w = f"{p}.attention.mha.in_proj_weight"
            out_w = f"{p}.attention.mha.out_proj.weight"
            folded[in_w] = torch.cat(
                [a @ b for a, b in zip(state[in_w].chunk(3), qkv.chunk(3))])
            folded[out_w] = wo @ state[out_w]
    return folded
