"""Float32 products at a chosen precision: the port's counterpart of the
JAX package's matmul-precision contexts (`jax.default_matmul_precision`,
used by `parrot_tts_tpu/models/tte/parrot.py::apply_parrot` to mix
precisions by section).

Modes, and the TPU tier each stands for:

- "ieee": IEEE float32 (TF32 off for cuBLAS and cuDNN) — JAX "highest",
  and JAX "high" (3-pass bf16) as well: a 3xTF32 split of each product
  through cuBLAS / cuDNN (three TF32 products of hi/lo operands) was
  slower than IEEE on an H100 and less exact (PERF.md §6), so the
  card runs "high" as IEEE;
- "tf32": one TF32 product (operands rounded to 11 significant bits,
  ~2^-10 relative per product) — the TPU's default 1-pass precision.
- None: whatever the ambient torch flags give (training's path).

On the card `linear` and `conv1d` call cuBLAS / cuDNN with TF32 allowed
or not, and deterministic cuDNN algorithms, through
`core/device.py::exact_numerics`, which restores the global flags on exit.
These are plain large products that the JAX package leaves to XLA. On the
CPU, which has no TF32, "tf32" emulates the card's arithmetic: every
operand is rounded to TF32 (`round_tf32`) and the products are IEEE.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.core.device import exact_numerics
from parrot_tts_tpu_torch.ops import conv as conv_ops

MODES = ("ieee", "tf32")
_LOW_BITS = 0x1FFF           # float32 mantissa bits below TF32's 10


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (11 significant bits), to nearest, ties away
    from zero (the card's cvt.rna), on the bit pattern: adding half a TF32
    ulp to a sign-magnitude pattern rounds the magnitude. The result is a
    float32 whose low 13 bits are 0."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~_LOW_BITS).view(torch.float32)


def _products(op, x, w, b, mode):
    """op(x, w, b) at `mode`: op contracts x's last axis with w's axis 1
    and adds the bias b."""
    if mode is not None and mode not in MODES:
        raise ValueError(f"precision mode {mode!r} not in {MODES} or None")
    if mode is None:
        return op(x, w, b)
    if x.device.type == "cpu":
        if mode == "tf32":
            x, w = round_tf32(x), round_tf32(w)
        return op(x, w, b)
    with exact_numerics(mode == "ieee", deterministic=True):
        return op(x, w, b)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           mode: str | None = None) -> torch.Tensor:
    """F.linear(x, w, b) with its products at `mode` (torch layout w
    (out, in))."""
    return _products(F.linear, x, w, b, mode)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           mode: str | None = None, *, padding: int = 0) -> torch.Tensor:
    """`ops/conv.py::conv1d` on x (B, T, Cin) with w (Cout, Cin, K) ->
    (B, T', Cout), products at `mode`."""
    return _products(
        lambda x, w, b: conv_ops.conv1d(x, w, b, padding=padding),
        x, w, b, mode)
