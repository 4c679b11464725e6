"""int8 stride-1 NWC convolution and the dense GEMM: the CUDA kernels'
wrappers and their plain versions.

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

`matmul(a, b)` computes (M, K) @ (K, N): int8 operands give int32, bf16
and float32 operands float32 (bf16 products are exact in float32, so only
the order of the float32 sums differs from the plain version). It replaces
`parrot_tts_tpu/ops/pallas_qconv.py::matmul_pallas` (`_mm_kernel`), the
rate microkernel of the int8 experiment
(`parrot_tts_tpu_torch/scripts/exp_int8_rate.py`). The TPU tile arguments
`bm / bn / bk` are not carried over: the Hopper kernel `csrc/int8_gemm.cu`
picks its own tiles and takes any M, N, K >= 1. A CPU tensor goes to
`matmul_reference`, a CUDA tensor launches the kernel or raises;
`MATMUL.launches` counts its launches. Other dtypes, mixed dtypes and an
int8 K above 133,144 (where 127^2 * K overflows int32) raise on either
device.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.core import kernels
from parrot_tts_tpu_torch.core.device import exact_numerics

_MAX_GRID_YZ = 65535
_TILE_N = 64               # output channels per block (csrc/int8_conv.cu BN)
_GEMM_TILE = 128           # output rows and columns per block (int8_gemm.cu)
INT8_MAX_K = 133_144       # the largest K with 127^2 * K < 2^31
_MM_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


class _Kernel:
    """A loaded kernel entry point and its launch count (one per process)."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.launches = 0
        self._source, self._symbol, self._argtypes = source, symbol, argtypes
        self._fn = None

    def fn(self):
        if self._fn is None:
            fn = getattr(kernels.load(self._source), self._symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


_P, _I = ctypes.c_void_p, ctypes.c_int
INT8_CONV = _Kernel("int8_conv", "int8_conv_s8",
                    [_P] * 3 + [_I] + [_P] * 2 + [_I] * 9 + [ctypes.c_float,
                                                             _P])
MATMUL = _Kernel("int8_gemm", "int8_gemm",
                 [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P])


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


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: int8 as a float64 matmul cast to int32 (exact: |acc|
    < 2^53), bf16 and float32 as a float32 matmul with TF32 off."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    with exact_numerics(True):
        return a.float() @ b.float()


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N), both int8 (-> int32) or both bf16 or float32
    (-> float32); on the card both contiguous, on one device."""
    _check_mm(a, b)
    if a.device.type == "cpu":
        return matmul_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul: a and b must be contiguous")
    (m, k), n = a.shape, b.shape[1]
    code, esize = _MM_CODES[a.dtype], a.element_size()
    out = torch.empty((m, n), dtype=torch.int32 if code == 0 else
                      torch.float32, device=a.device)
    # the tensor-core kernels read B^T, rows padded to 16 bytes
    ldb = -(-k * esize // 16) * 16 // esize if code < 2 else 0
    bt = torch.empty((n, ldb), dtype=a.dtype, device=a.device) if ldb else None
    vec_a = (k * esize) % 16 == 0 and a.data_ptr() % 16 == 0
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = MATMUL.fn()(code, a.data_ptr(), b.data_ptr(),
                          bt.data_ptr() if bt is not None else None, ldb,
                          out.data_ptr(), m, n, k, int(vec_a), stream)
    if err != 0:
        raise RuntimeError(f"matmul launch failed: CUDA error {err}")
    MATMUL.launches += 1
    return out


def _check_mm(a, b) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: want (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: mixed dtypes {a.dtype} and {b.dtype}")
    if a.dtype not in _MM_CODES:
        raise TypeError(f"matmul: takes int8, bfloat16 or float32, got "
                        f"{a.dtype}")
    if a.device != b.device:
        raise ValueError(f"matmul: a on {a.device}, b on {b.device}")
    (m, k), n = a.shape, b.shape[1]
    if min(m, k, n) < 1:
        raise ValueError(f"matmul: empty operand ({m}, {k}) @ ({k}, {n})")
    if a.dtype == torch.int8 and k > INT8_MAX_K:
        raise ValueError(f"matmul: int8 K = {k} > {INT8_MAX_K} would overflow "
                         "the int32 sums")
    if (-(-n // _GEMM_TILE) > _MAX_GRID_YZ or -(-k // 32) > _MAX_GRID_YZ
            or max(m, n, 2 * k) >= 2**31):
        raise ValueError(f"matmul: ({m}, {k}) @ ({k}, {n}) exceeds the grid")
