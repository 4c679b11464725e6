"""Fused MRF stage: the CUDA kernel's wrapper, its plain version and the
weight packing.

Port of `parrot_tts_tpu/ops/fused_mrf.py::{MRFPlan, pack_mrf, mrf_fused}`.
One MRF stage (the mean of the stage's ResBlock1 branches, each a chain of
(dilated conv, conv) pairs with leaky ReLUs and residual adds) runs as one
kernel, `csrc/fused_mrf.cu`, which replaces the TPU's Pallas `_mrf_kernel`.
The TPU kernel works on the folded block-Toeplitz layout; here the
activations stay (B, T, C) and the weights are plain (K, Ci, Co) kernels,
so the halo is counted in samples.

A CPU tensor goes to `mrf_fused_reference` (the averaged `apply_resblock1`
composition); a CUDA tensor launches the kernel or raises. Nothing falls
back, and unlike the JAX `mrf_fused` the kernel takes any T.
`FUSED_MRF.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.core import kernels

LRELU_SLOPE = 0.1
MAX_BRANCHES = 4           # csrc/fused_mrf.cu MAXB
MAX_PAIRS = 4              # csrc/fused_mrf.cu MAXP
CHANNEL_QUANTUM = 8        # channels per thread in the kernel
_MAX_GRID_Y = 65535


@dataclass(frozen=True)
class MRFPlan:
    """Static description of one stage: each branch's kernel size and the
    dilation of each of its dilated convs; halo = the longest branch's
    one-sided receptive field in samples (the sum of its convs' pads)."""

    channels: int
    kernel_sizes: tuple[int, ...]
    dilations: tuple[tuple[int, ...], ...]
    halo: int

    def pads(self, branch: int) -> list[tuple[int, int]]:
        """(dilated pad, plain pad) of each pair of a branch."""
        k = self.kernel_sizes[branch]
        return [((k - 1) * d // 2, (k - 1) // 2)
                for d in self.dilations[branch]]


def pack_mrf(convs: list[list[tuple]], kernel_sizes, dilation_sizes
             ) -> tuple[torch.Tensor, torch.Tensor, MRFPlan]:
    """convs[branch][pair] = (w1, b1, w2, b2): the stage's weight-norm-folded
    ResBlock1 convs, w (K, Ci, Co) and b (Co,). Returns all kernels
    flattened in traversal order (branch, pair, dilated then plain), their
    biases likewise, and the plan."""
    ws, bs = [], []
    for branch in convs:
        for w1, b1, w2, b2 in branch:
            ws += [w1.reshape(-1), w2.reshape(-1)]
            bs += [b1, b2]
    halo = max(sum((k - 1) * d // 2 + (k - 1) // 2 for d in dils)
               for k, dils in zip(kernel_sizes, dilation_sizes))
    plan = MRFPlan(channels=convs[0][0][0].shape[2],
                   kernel_sizes=tuple(kernel_sizes),
                   dilations=tuple(tuple(d) for d in dilation_sizes),
                   halo=halo)
    return (torch.cat(ws).float().contiguous(),
            torch.cat(bs).float().contiguous(), plan)


def _unpack(w: torch.Tensor, b: torch.Tensor, plan: MRFPlan):
    """Yield (branch, pair, w1, b1, w2, b2, d, pads) with w in (K, Ci, Co)."""
    c, wo, bo = plan.channels, 0, 0
    for i, k in enumerate(plan.kernel_sizes):
        n = k * c * c
        for j, (d, pads) in enumerate(zip(plan.dilations[i], plan.pads(i))):
            w1 = w[wo:wo + n].reshape(k, c, c)
            w2 = w[wo + n:wo + 2 * n].reshape(k, c, c)
            yield i, j, w1, b[bo:bo + c], w2, b[bo + c:bo + 2 * c], d, pads
            wo, bo = wo + 2 * n, bo + 2 * c


def mrf_fused_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        plan: MRFPlan) -> torch.Tensor:
    """Plain PyTorch: the mean of the branches' apply_resblock1 chains,
    each conv a zero-padded F.conv1d on (B, C, T)."""
    xt = x.transpose(1, 2)
    acc, y = None, None
    for i, j, w1, b1, w2, b2, d, (p1, p2) in _unpack(w, b, plan):
        if j == 0:
            y = xt
        t = F.leaky_relu(y, LRELU_SLOPE)
        t = F.conv1d(t, w1.permute(2, 1, 0), b1, padding=p1, dilation=d)
        t = F.leaky_relu(t, LRELU_SLOPE)
        t = F.conv1d(t, w2.permute(2, 1, 0), b2, padding=p2)
        y = t + y
        if j == len(plan.dilations[i]) - 1:
            acc = y if acc is None else acc + y
    return (acc / len(plan.kernel_sizes)).transpose(1, 2)


class _FusedMRF:
    """The loaded kernel and its launch count (one per process)."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def lib(self):
        if self._lib is None:
            lib = kernels.load("fused_mrf")
            lib.fused_mrf_f32.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3 + [
                ctypes.c_int, ctypes.c_void_p]
            lib.fused_mrf_f32.restype = ctypes.c_int
            lib.fused_mrf_tile.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.fused_mrf_tile.restype = ctypes.c_int
            self._lib = lib
        return self._lib


FUSED_MRF = _FusedMRF()


def mrf_fused(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              plan: MRFPlan) -> torch.Tensor:
    """x (B, T, C) float32; w, b from `pack_mrf`. Returns (B, T, C)."""
    if x.device.type == "cpu":
        return mrf_fused_reference(x, w, b, plan)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_fused: unsupported device {x.device}")
    _check(x, w, b, plan)
    bsz, t, c = x.shape
    out = torch.empty_like(x)
    if bsz == 0 or t == 0:
        return out
    nb = len(plan.kernel_sizes)
    ks = (ctypes.c_int * nb)(*plan.kernel_sizes)
    npairs = (ctypes.c_int * nb)(*(len(d) for d in plan.dilations))
    dils = (ctypes.c_int * (nb * MAX_PAIRS))(
        *(d[j] if j < len(d) else 0 for d in plan.dilations
          for j in range(MAX_PAIRS)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = FUSED_MRF.lib().fused_mrf_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            bsz, t, c, nb, ks, npairs, dils, plan.halo, stream)
    if err != 0:
        raise RuntimeError(f"fused_mrf launch failed: CUDA error {err}")
    FUSED_MRF.launches += 1
    return out


def _check(x, w, b, plan: MRFPlan) -> None:
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"mrf_fused: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"mrf_fused: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"mrf_fused: {name} must be contiguous")
    if x.dim() != 3 or x.shape[2] != plan.channels:
        raise ValueError(f"mrf_fused: want x (B, T, {plan.channels}), got "
                         f"{tuple(x.shape)}")
    c = plan.channels
    if c % CHANNEL_QUANTUM or c > 256 * CHANNEL_QUANTUM:
        raise ValueError(f"mrf_fused: {c} channels; the kernel takes "
                         f"multiples of {CHANNEL_QUANTUM}")
    nb = len(plan.kernel_sizes)
    if not 1 <= nb <= MAX_BRANCHES or any(
            not 1 <= len(d) <= MAX_PAIRS for d in plan.dilations):
        raise ValueError(f"mrf_fused: at most {MAX_BRANCHES} branches of "
                         f"{MAX_PAIRS} pairs")
    n_pairs = sum(len(d) for d in plan.dilations)
    n_w = sum(2 * k * c * c * len(d)
              for k, d in zip(plan.kernel_sizes, plan.dilations))
    if w.shape != (n_w,) or b.shape != (2 * n_pairs * c,):
        raise ValueError("mrf_fused: packed weights do not fit the plan")
    if x.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"mrf_fused: B = {x.shape[0]} > {_MAX_GRID_Y}")
