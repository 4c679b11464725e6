"""Seeded parameter initializers with the shapes and fan-in rules of
`parrot_tts_tpu/ops/init.py` (torch's own defaults), drawn from a
`torch.Generator` so a run with no JAX can make full-size weights from a
seed. The numbers differ from `jax.random`'s for the same seed; tests that
compare the two packages carry weights across with `convert.py` instead.

Tensors are made on the CPU (where the generator lives) and moved by the
caller.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32)
            * (2 * bound) - bound)


def kaiming_uniform(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """torch default for Conv*/Linear weights: kaiming_uniform(a=sqrt(5)),
    which reduces to U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return _uniform(gen, shape, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0)


def uniform_fan_in(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """torch default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return kaiming_uniform(gen, shape, fan_in)


def xavier_uniform(gen: torch.Generator, shape, fan_in: int,
                   fan_out: int) -> torch.Tensor:
    """torch nn.MultiheadAttention in_proj init."""
    return _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def embedding(gen: torch.Generator, shape,
              padding_idx: int | None = None) -> torch.Tensor:
    """torch nn.Embedding default N(0,1); the `padding_idx` row zeroed."""
    emb = torch.randn(shape, generator=gen, dtype=torch.float32)
    if padding_idx is not None:
        emb[padding_idx] = 0.0
    return emb
