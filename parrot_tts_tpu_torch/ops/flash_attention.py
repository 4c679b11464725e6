"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

`flash_attention` computes softmax(Q Kᵀ·scale + mask) V for (B, H, T, D)
float32, non-causal, with a torch-style key padding mask (True = ignore
that key). It replaces the TPU's Pallas flash attention
(`parrot_tts_tpu/ops/attention.py::_flash_attention`). A query row whose
keys are all masked gives 0, never NaN.

A CPU tensor goes to `flash_attention_reference` (plain PyTorch); a CUDA
tensor launches `csrc/flash_attn_fwd.cu` or raises. Nothing falls back.
The kernel multiplies on the TF32 tensor cores with a 3xTF32 split (each
float32 operand as a sum of two TF32 values, three products), which keeps
float32 accuracy: it stays within 1e-5 of the IEEE float32 plain version
and keeps the exact decode's units (the source says how).
`FLASH_FWD.launches` counts kernel launches, so a run can show that its
attention went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from parrot_tts_tpu_torch.core import kernels

D_HEADS = (64, 128)        # head widths the kernel is instantiated for
_MAX_GRID_Y = 65535


class _FlashForward:
    """The loaded kernel and its launch count (one per process)."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def fn(self):
        if self._fn is None:
            fn = kernels.load("flash_attn_fwd").flash_attn_fwd_f32
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


FLASH_FWD = _FlashForward()


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              key_padding_mask: torch.Tensor | None,
                              scale: float) -> torch.Tensor:
    """Plain PyTorch: the XLA path of the JAX package
    (`attention.py:99-111`), except that rows with no valid key give 0."""
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if key_padding_mask is None:
        return torch.matmul(torch.softmax(scores, dim=-1), v)
    scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                float("-inf"))
    attn = torch.softmax(scores, dim=-1)
    all_masked = key_padding_mask.all(dim=-1)[:, None, None, None]
    return torch.matmul(attn.masked_fill(all_masked, 0.0), v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: torch.Tensor | None,
                    scale: float) -> torch.Tensor:
    """q, k, v: (B, H, T, D) float32; key_padding_mask: (B, T) bool or None."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_padding_mask, scale)
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
            out.data_ptr(), b, h, t, d, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    FLASH_FWD.launches += 1
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
