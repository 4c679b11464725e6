"""Weight normalization as plain (weight_g, weight_v) parameters, and
spectral normalization with its power-iteration state as explicit tensors.

Port of `parrot_tts_tpu/ops/weight_norm.py::{wn_resolve, sn_init,
sn_resolve}`. torch's weight norm takes the norm per slice of dim 0 of the
torch layout: Conv1d weights are (Cout, Cin, K), Conv2d weights (Cout,
Cin, Kh, Kw) and ConvTranspose1d weights (Cin, Cout, K), so all normalise
over every dim but 0 — the JAX package's axes (0, 1), (0, 1, 2) and
(0, 2) of its channels-last layouts.

Spectral norm follows torch's `spectral_norm` on the weight as a
(dim 0, -1) matrix W (torch's (Cout, Cin, K) flattened, the same matrix
as the JAX package's `_to_mat`): v = normalize(W^T u), u = normalize(W v),
sigma = u^T W v, with u and v carrying no gradient. Unlike torch's hook
the caller decides when u and v advance (`train/vocoder.py` threads them
through a GAN step as the JAX trainer does).
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


def sn_init(w: torch.Tensor, gen: torch.Generator
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit-norm random (u, v) estimates for the kernel w: u (dim 0,),
    v (numel / dim 0,)."""
    u = torch.randn(w.shape[0], generator=gen, dtype=w.dtype)
    v = torch.randn(w[0].numel(), generator=gen, dtype=w.dtype)
    return u / (u.norm() + 1e-12), v / (v.norm() + 1e-12)


def sn_power_iteration(w: torch.Tensor, u: torch.Tensor, eps: float = 1e-12
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One power iteration from u: (u', v'), no gradient."""
    with torch.no_grad():
        mat = w.reshape(w.shape[0], -1)
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        return u / (torch.linalg.vector_norm(u) + eps), v


def sn_resolve(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
               update: bool = True) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """(w / sigma, u, v). update=True first runs one power iteration from
    u; update=False uses the given (u, v) as they are (torch's eval)."""
    if update:
        u, v = sn_power_iteration(w, u)
    sigma = torch.dot(u, w.reshape(w.shape[0], -1) @ v)
    return w / sigma, u, v
