"""The leaky ReLU in the JAX package's rounding, in float32 and bfloat16.

`jax.nn.leaky_relu(x, slope)` computes `where(x >= 0, x, slope * x)` with
the slope a weak-typed Python float, so on a bfloat16 x it multiplies by
bf16(slope) (0.10009765625 for 0.1) and rounds the product once.
`F.leaky_relu` on a bfloat16 tensor multiplies by the float32 slope
instead and differs from it in over 5% of elements
(tests/test_torch_bf16.py). The bf16 form here
multiplies by bf16(slope), a float32 value, so the float32 product is exact
and the one rounding is to bfloat16; max(x, s * x) equals the select for 0
<= s <= 1. In float32 it is `F.leaky_relu`, whose bits the port's float32
paths have always had.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def bf16_slope(slope: float) -> float:
    """slope rounded to bfloat16 (to nearest, ties to even), as a float."""
    return float(torch.tensor(slope, dtype=torch.bfloat16))


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """leaky_relu(x, slope) with the JAX package's rounding for x's dtype."""
    if x.dtype != torch.bfloat16:
        return F.leaky_relu(x, slope)
    return torch.maximum(x, x * bf16_slope(slope))
