"""int8 stride-1 NWC convolution: the CUDA kernel's wrapper and its plain
version.

`int8_conv` computes, for xq (B, T, Ci) int8 and a kernel w (K, Ci, Co)
int8, given as wt (K, Co, Ci), the layout the kernel reads,
    acc = conv(xq, w) in int32 (stride 1, dilation d, zero pads (pl, pr)),
    y = float32(acc) · scale[b, co] + bias[co],  then max(y, leaky·y),
as float32 (B, T + pl + pr - d·(K-1), Co). It replaces the TPU's Pallas
kernel `parrot_tts_tpu/ops/pallas_qconv.py::_conv_kernel`, which the JAX
package never wired in; here it is the int8 conv of every int8-static
serving site (`ops/quant.py`). PyTorch has no int8
convolution on CUDA.

A CPU tensor goes to `int8_conv_reference`; a CUDA tensor launches
`csrc/int8_conv.cu` or raises. Nothing falls back. `INT8_CONV.launches`
counts kernel launches. The kernel's output is bit-identical to the plain
version: the plain conv runs in float64, which is exact for these integer
sums (|acc| < 2^53), and the epilogue is the same two float32 roundings.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.core import kernels

_MAX_GRID_YZ = 65535
_TILE_N = 64               # output channels per block (csrc/int8_conv.cu BN)


class _Int8Conv:
    """The loaded kernel and its launch count (one per process)."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def fn(self):
        if self._fn is None:
            fn = kernels.load("int8_conv").int8_conv_s8
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [
                ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


INT8_CONV = _Int8Conv()


def out_len(t: int, k: int, pads: tuple[int, int], dilation: int) -> int:
    return t + pads[0] + pads[1] - dilation * (k - 1)


def int8_conv_reference(xq: torch.Tensor, wt: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor | None, *,
                        pads: tuple[int, int], dilation: int = 1,
                        leaky: float | None = None) -> torch.Tensor:
    """Plain PyTorch: the conv in float64, then the float32 epilogue. cuDNN
    is off for the conv, since its FFT and Winograd algorithms are not
    exact; PyTorch's own im2col + GEMM sums integers below 2^53 exactly."""
    x = F.pad(xq.double().transpose(1, 2), pads)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv1d(x, wt.double().permute(1, 2, 0), dilation=dilation)
    y = acc.transpose(1, 2).float() * scale[:, None, :]
    if bias is not None:
        y = y + bias
    if leaky is not None:
        y = torch.maximum(y, leaky * y)
    return y.contiguous()


def int8_conv(xq: torch.Tensor, wt: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor | None = None, *, pads: tuple[int, int],
              dilation: int = 1, leaky: float | None = None) -> torch.Tensor:
    """xq (B, T, Ci) int8, wt (K, Co, Ci) int8, scale (B, Co) float32 with
    unit channel stride (a (Co,) vector `expand`ed over the batch is passed
    as it is), bias (Co,) float32 or None; xq, wt and bias contiguous; all
    on one device."""
    if xq.device.type == "cpu":
        return int8_conv_reference(xq, wt, scale, bias, pads=pads,
                                   dilation=dilation, leaky=leaky)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {xq.device}")
    _check(xq, wt, scale, bias, pads, dilation)
    b, t, ci = xq.shape
    k, co, _ = wt.shape
    t_out = out_len(t, k, pads, dilation)
    out = torch.empty((b, t_out, co), dtype=torch.float32, device=xq.device)
    if b == 0 or co == 0:
        return out
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = INT8_CONV.fn()(
            xq.data_ptr(), wt.data_ptr(), scale.data_ptr(), scale.stride(0),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            b, t, ci, k, co, t_out, pads[0], dilation,
            int(leaky is not None), float(leaky or 0.0), stream)
    if err != 0:
        raise RuntimeError(f"int8_conv launch failed: CUDA error {err}")
    INT8_CONV.launches += 1
    return out


def _check(xq, wt, scale, bias, pads, dilation) -> None:
    if xq.dim() != 3 or wt.dim() != 3:
        raise ValueError(f"int8_conv: want xq (B, T, Ci) and wt (K, Co, Ci), "
                         f"got {tuple(xq.shape)} and {tuple(wt.shape)}")
    b, t, ci = xq.shape
    k, co, wci = wt.shape
    for name, x, dtype in (("xq", xq, torch.int8), ("wt", wt, torch.int8),
                           ("scale", scale, torch.float32),
                           ("bias", bias, torch.float32)):
        if x is None:
            continue
        if x.dtype != dtype:
            raise TypeError(f"int8_conv: {name} must be {dtype}, got {x.dtype}")
        if x.device != xq.device:
            raise ValueError(f"int8_conv: {name} on {x.device}, xq on "
                             f"{xq.device}")
        if name != "scale" and not x.is_contiguous():
            raise ValueError(f"int8_conv: {name} must be contiguous")
    if wci != ci or k < 1:
        raise ValueError(f"int8_conv: wt {tuple(wt.shape)} does not fit xq "
                         f"{tuple(xq.shape)}")
    if scale.shape != (b, co):
        raise ValueError(f"int8_conv: scale must be (B, Co) = {(b, co)}, "
                         f"got {tuple(scale.shape)}")
    if co > 1 and scale.stride(1) != 1 or scale.stride(0) < 0:
        raise ValueError(f"int8_conv: scale strides {scale.stride()}; the "
                         "kernel wants unit channel stride")
    if bias is not None and bias.shape != (co,):
        raise ValueError(f"int8_conv: bias must be ({co},), got "
                         f"{tuple(bias.shape)}")
    if min(pads) < 0 or dilation < 1:
        raise ValueError(f"int8_conv: pads {pads} and dilation {dilation}")
    if out_len(t, k, pads, dilation) < 1:
        raise ValueError("int8_conv: the output would be empty")
    if b > _MAX_GRID_YZ or -(-co // _TILE_N) > _MAX_GRID_YZ:
        raise ValueError(f"int8_conv: B = {b} or Co = {co} exceeds the grid")
