"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

`flash_attention` computes softmax(Q Kᵀ·scale + mask) V for (B, H, T, D)
float32, non-causal, with a torch-style key padding mask (True = ignore
that key). It replaces the TPU's Pallas flash attention
(`parrot_tts_tpu/ops/attention.py::_flash_attention`). A query row whose
keys are all masked gives 0, never NaN.

A CPU tensor goes to `flash_attention_reference` (plain PyTorch); a CUDA
tensor launches `csrc/flash_attn_fwd.cu` or raises. Nothing falls back.
The kernel multiplies on the TF32 tensor cores in one of two modes:

- passes=3: a 3xTF32 split (each float32 operand as a sum of two TF32
  values, three products), which keeps float32 accuracy: it stays within
  1e-5 of the IEEE float32 plain version and keeps the exact decode's
  units (the source says how);
- passes=1: one TF32 product of operands rounded to TF32, the TPU's
  default 1-pass precision, for the "selective" decode and exact=False.
  Its plain version is `flash_attention_reference(..., passes=1)`, which
  rounds q, k, P and v to TF32 where the kernel does, P tile by tile
  against the running row max.

`FLASH_FWD.launches` counts kernel launches, and `FLASH_FWD.one_pass`
those of them in 1-pass mode, so a run can show that its attention went
through the kernel, and in which mode.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.core import kernels
from parrot_tts_tpu_torch.ops.precision import round_tf32

D_HEADS = (64, 128)        # head widths the kernel is instantiated for
BK = 32                    # the kernel's keys per tile
_MAX_GRID_Y = 65535


class _FlashForward:
    """The loaded kernel and its launch counts (one per process): all
    launches, and the 1-pass ones among them."""

    def __init__(self):
        self.launches = 0
        self.one_pass = 0
        self._fn = None

    def fn(self):
        if self._fn is None:
            fn = kernels.load("flash_attn_fwd").flash_attn_fwd_f32
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


FLASH_FWD = _FlashForward()


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              key_padding_mask: torch.Tensor | None,
                              scale: float, passes: int = 3) -> torch.Tensor:
    """Plain PyTorch: the XLA path of the JAX package
    (`attention.py:99-111`), except that rows with no valid key give 0.
    passes=3: IEEE float32 (under IEEE matmul flags). passes=1: the
    kernel's 1-pass mode, q, k, v and the unnormalised weights rounded to
    TF32 (`round_tf32`) before their products, which are exact in float32.
    As in the kernel's online softmax, the weights of each BK-key tile are
    P = exp(s - m) with m the row max over the keys up to that tile, and
    are rounded so, then scaled by exp(m - max); P V is divided by the sum
    of the unrounded weights."""
    if passes == 1:
        q, k, v = round_tf32(q), round_tf32(k), round_tf32(v)
    elif passes != 3:
        raise ValueError(f"flash_attention: passes {passes} not in (1, 3)")
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                    float("-inf"))
    if passes == 3:
        if key_padding_mask is None:
            return torch.matmul(torch.softmax(scores, dim=-1), v)
        attn = torch.softmax(scores, dim=-1)
        all_masked = key_padding_mask.all(dim=-1)[:, None, None, None]
        return torch.matmul(attn.masked_fill(all_masked, 0.0), v)
    t = scores.shape[-1]
    n = -(-t // BK)
    tiles = F.pad(scores, (0, n * BK - t), value=float("-inf"))
    m = tiles.unflatten(-1, (n, BK)).amax(-1).cummax(-1).values
    m = m.repeat_interleave(BK, dim=-1)[..., :t]    # running max, per key
    seen = m > float("-inf")        # a valid key at or before this tile
    p = torch.exp(scores - torch.where(seen, m, 0.0))
    rescale = torch.where(seen, torch.exp(m - m[..., -1:]), 0.0)
    l = (p * rescale).sum(dim=-1, keepdim=True)
    o = torch.matmul(round_tf32(p) * rescale, v)
    return torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: torch.Tensor | None,
                    scale: float, passes: int = 3) -> torch.Tensor:
    """q, k, v: (B, H, T, D) float32; key_padding_mask: (B, T) bool or
    None; passes: 3 (3xTF32) or 1 (one TF32 pass)."""
    if passes not in (1, 3):
        raise ValueError(f"flash_attention: passes {passes} not in (1, 3)")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_padding_mask, scale,
                                         passes)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, key_padding_mask)
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    if t == 0 or b * h == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = FLASH_FWD.fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_padding_mask.data_ptr() if key_padding_mask is not None
            else None,
            out.data_ptr(), b, h, t, d, float(scale), passes, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    FLASH_FWD.launches += 1
    FLASH_FWD.one_pass += passes == 1
    return out


def _check(q, k, v, key_padding_mask) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, "
                             f"q on {q.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"flash_attention: {name} must be float32, "
                            f"got {x.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"flash_attention: {name} shape {tuple(x.shape)}"
                             f" != q shape {tuple(q.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: want (B, H, T, D), got "
                         f"{tuple(q.shape)}")
    b, h, t, d = q.shape
    if d not in D_HEADS:
        raise ValueError(f"flash_attention: head width {d} not in {D_HEADS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: B*H = {b * h} > {_MAX_GRID_Y}")
    if key_padding_mask is not None:
        m = key_padding_mask
        if (m.dtype != torch.bool or m.shape != (b, t)
                or m.device != q.device or not m.is_contiguous()):
            raise ValueError(
                "flash_attention: key_padding_mask must be a contiguous "
                f"bool (B, T) = {(b, t)} tensor on {q.device}")
