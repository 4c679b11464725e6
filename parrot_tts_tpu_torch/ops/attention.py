"""Multi-head attention with torch.nn.MultiheadAttention semantics.

Port of `parrot_tts_tpu/ops/attention.py::multi_head_attention`: bias-free
packed in-projection and out-projection around per-head attention. The
reference's double projection (qkv Linear before MHA, wo after) lives in
the FFT block (`models/tte/fft.py`). Weights are in torch layout:
in_proj_weight (3D, D), out_proj_weight (D, D).

Every call goes through `ops/flash_attention.py::flash_attention`: the
CUDA kernel on the card at any T (the TPU needed T >= 512 and a multiple
of 128 for its Pallas path), the plain version on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.ops.flash_attention import flash_attention


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         in_proj_weight: torch.Tensor,
                         out_proj_weight: torch.Tensor, n_head: int, *,
                         key_padding_mask: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """q, k, v: (B, T, D); key_padding_mask: (B, T) bool, True = IGNORE
    that key (torch convention). Returns (B, T, D)."""
    b, t, d = q.shape
    if d % n_head:
        raise ValueError(f"d_model {d} % n_head {n_head} != 0")
    d_head = d // n_head
    wq, wk, wv = in_proj_weight.chunk(3, dim=0)

    def heads(x, w):
        return (F.linear(x, w).reshape(b, -1, n_head, d_head)
                .transpose(1, 2).contiguous())          # (B, H, T, dh)

    out = flash_attention(heads(q, wq), heads(k, wk), heads(v, wv),
                          key_padding_mask, 1.0 / math.sqrt(d_head))
    out = out.transpose(1, 2).reshape(b, t, d)
    return F.linear(out, out_proj_weight)
