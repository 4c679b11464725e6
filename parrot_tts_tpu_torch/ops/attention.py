"""Multi-head attention with torch.nn.MultiheadAttention semantics.

Port of `parrot_tts_tpu/ops/attention.py::multi_head_attention`: bias-free
packed in-projection and out-projection around per-head attention. The
reference's double projection (qkv Linear before MHA, wo after) lives in
the FFT block (`models/tte/fft.py`). Weights are in torch layout:
in_proj_weight (3D, D), out_proj_weight (D, D).

Two paths, the JAX package's split at `attention.py:93-97`:

- `seed=None` (serving, `eval_step`): `ops/flash_attention.py::
  flash_attention`, row 1 of PERF.md's kernel table, forward only;
- a `seed` (training): `ops/flash_dropout.py::flash_attention_dropout`,
  rows 2-4, with attention-weight dropout `dropout_p` drawn from that seed.
  Training takes it even at `dropout_p == 0`, so the port has one backward.

Both run their CUDA kernels on the card at any T (the TPU needed T >= 512
and a multiple of 128 for its Pallas paths) and the plain versions on the
CPU.

`precision` (serving; `ops/precision.py`) sets the projections' products
and row 1's mode: "tf32" takes its 1-pass TF32 mode, "ieee" its 3xTF32
mode (the closest the kernel comes to IEEE float32), None its 3xTF32 mode
with the projections under the ambient torch flags.

`mesh` (tensor parallelism, `parallel/tensor.py`, forward only): the
weights are this model rank's shards, in_proj_weight its heads' rows and
out_proj_weight their columns; attention runs on those heads and the
out-projection's partial sums are summed over the model axis.
"""

from __future__ import annotations

import math

import torch

from parrot_tts_tpu_torch.core.mesh import Mesh, model_sum
from parrot_tts_tpu_torch.ops import precision as prec
from parrot_tts_tpu_torch.ops.flash_attention import flash_attention
from parrot_tts_tpu_torch.ops.flash_dropout import (flash_attention_dropout,
                                                    padding_bias)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         in_proj_weight: torch.Tensor,
                         out_proj_weight: torch.Tensor, n_head: int, *,
                         key_padding_mask: torch.Tensor | None = None,
                         dropout_p: float = 0.0, seed: int | None = None,
                         row0: int = 0,
                         precision: str | None = None,
                         mesh: Mesh | None = None) -> torch.Tensor:
    """q, k, v: (B, T, D); key_padding_mask: (B, T) bool, True = IGNORE
    that key (torch convention). seed: this call's 64-bit dropout stream;
    None for the deterministic forward. row0: the global batch row of q's
    first (a data-parallel shard's), where the dropout mask's rows start.
    precision: the deterministic forward's mode; mesh: a model axis the
    weights are sharded over (module docstring). Returns (B, T, D)."""
    b, t, d = q.shape
    if d % n_head:
        raise ValueError(f"d_model {d} % n_head {n_head} != 0")
    d_head = d // n_head
    wq, wk, wv = in_proj_weight.chunk(3, dim=0)
    h = wq.shape[0] // d_head                   # this model rank's heads
    if h != n_head and seed is not None:
        raise ValueError("tensor-parallel attention is forward only")

    def heads(x, w):
        return (prec.linear(x, w, mode=precision).reshape(b, -1, h, d_head)
                .transpose(1, 2).contiguous())          # (B, h, T, dh)

    qh, kh, vh = heads(q, wq), heads(k, wk), heads(v, wv)
    scale = 1.0 / math.sqrt(d_head)
    if seed is None and precision == "tf32":
        out = flash_attention(qh, kh, vh, key_padding_mask, scale, passes=1)
    elif seed is None:
        out = flash_attention(qh, kh, vh, key_padding_mask, scale)
    else:
        bias = padding_bias(key_padding_mask, b, t, q.device)
        out = flash_attention_dropout(qh, kh, vh, bias, seed, dropout_p,
                                      scale, row0 * n_head)
    out = out.transpose(1, 2).reshape(b, t, h * d_head)
    return model_sum(prec.linear(out, out_proj_weight, mode=precision), mesh)
