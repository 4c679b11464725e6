"""Weight normalization as plain (weight_g, weight_v) parameters.

Port of `parrot_tts_tpu/ops/weight_norm.py::wn_resolve`. torch's weight
norm takes the norm per slice of dim 0 of the torch layout: Conv1d weights
are (Cout, Cin, K) and ConvTranspose1d weights (Cin, Cout, K), so both
normalise over dims (1, 2) — the JAX package's axes (0, 1) and (0, 2) of
its (K, Cin, Cout) layout.
"""

from __future__ import annotations

import torch


def wn_resolve(weight_g: torch.Tensor, weight_v: torch.Tensor) -> torch.Tensor:
    """w = g * v / ||v||, the norm over every dim but 0 (torch._weight_norm)."""
    dims = tuple(range(1, weight_v.dim()))
    norm = torch.sqrt(torch.sum(weight_v * weight_v, dim=dims, keepdim=True))
    return weight_g * weight_v / norm


def wn_init(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split an initialised kernel into (g, v) with wn_resolve(g, v) == w."""
    dims = tuple(range(1, w.dim()))
    return torch.sqrt(torch.sum(w * w, dim=dims, keepdim=True)), w
