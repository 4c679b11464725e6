"""int8 quantization for the vocoder's int8 serving paths.

Port of `parrot_tts_tpu/ops/quant.py::{QMAX, _absmax, quantize_per_tensor,
quantize_per_row, quantize_per_out_channel, quantize_static, int8_conv_qin,
int8_conv_nwc}` with the same arithmetic, so the int8 values equal the JAX
package's bit for bit: symmetric int8 in [-127, 127], scales = absmax /
127 (an all-zero operand gets scale 1/127), `x / scale` rounded half to
even and clipped.

Every int8 conv runs with int32 accumulation and a float32 epilogue
`acc · scale[b, co] + bias[co]` (then an optional leaky ReLU): on a CUDA
tensor the hand-written kernel `csrc/int8_conv.cu` (`ops/qconv.py`), on a
CPU tensor its plain version. Weights are fixed, so a server quantizes
each one once, in the kernel's (K, Co, Ci) layout (`quantize_weight`,
`quantize_weight_qin`); the JAX package re-quantizes them in the graph on
every call for XLA's sake (its `int8_conv_qin` docstring), which gives the
same values.

- Static scales ("int8-static"): `int8_conv_qin` = `quantize_weight_qin`
  (the per-channel activation scales folded into the weight before its
  per-out-channel quantization: conv(xq·sx, w) == conv(xq, w·sx[ci])) +
  `int8_conv_qweight` (the conv on an activation already int8).
- Dynamic scales ("int8", "int8-tail"): `int8_conv_nwc` = `quantize_weight`
  + `int8_conv_nwc_qweight`, which quantizes the float activation per batch
  row (absmax over (T, C)) on every call and runs the conv with the
  materialised (B, Co) scale s_x[b]·s_w[co]. Per-row scales keep a batch
  row's output independent of its batchmates. The output has x's dtype:
  for a bfloat16 x the float32 epilogue is rounded to bf16 once and a fused
  leaky ReLU is then taken in bf16, as the JAX package's `int8_conv_nwc`
  (out_dtype x.dtype) followed by its bf16 `leaky_relu` computes it.

The quantizers take float32 or bfloat16 input: the absmax of bf16 values
is exact, and the division runs in float32 (`x.float() / scale`), as in
the JAX package.
"""

from __future__ import annotations

import torch

from parrot_tts_tpu_torch.ops import qconv

# int8 symmetric range: 127 (not 128) keeps quantize(-x) == -quantize(x)
QMAX = 127.0


def _absmax(x: torch.Tensor, dims) -> torch.Tensor:
    m = x.abs().amax() if dims is None else x.abs().amax(dim=dims)
    # guard all-zero operands: scale 1 maps 0 -> 0
    return torch.where(m > 0, m, torch.ones_like(m)).float()


def _scale(x: torch.Tensor, dims) -> torch.Tensor:
    """absmax / 127, one float32 division: with a Python scalar divisor
    PyTorch's CUDA kernel multiplies by a rounded 1/127 instead, which
    differs from the JAX package's division in the last bit."""
    m = _absmax(x, dims)
    return m / torch.full((), QMAX, dtype=m.dtype, device=m.device)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -QMAX,
                       QMAX).to(torch.int8)


def quantize_per_tensor(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 values, scalar float32 scale)."""
    scale = _scale(x, None)
    return _quantize(x, scale), scale


def quantize_per_row(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, C) -> (int8 values, (B, 1, 1) float32 scales): one scale per
    batch row, so a quiet row is not degraded by a loud batchmate."""
    scale = _scale(x, (1, 2))[:, None, None]
    return _quantize(x, scale), scale


def quantize_per_out_channel(w: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """w (K, Ci, Co) float -> (int8 values, (Co,) float32 scales)."""
    scale = _scale(w, (0, 1))
    return _quantize(w, scale[None, None, :]), scale


def quantize_static(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, T, C) float -> int8 with static per-channel scales (C,) (or a
    scalar); values beyond scale·127 clip."""
    return _quantize(x, scale)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w (K, Ci, Co) float quantized per out channel, in the kernel's
    layout: (int8 (K, Co, Ci), contiguous; (Co,) float32 scales)."""
    q, sw = quantize_per_out_channel(w)
    return q.transpose(1, 2).contiguous(), sw


def quantize_weight_qin(w: torch.Tensor, sx: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The weight side of `int8_conv_qin`: w (K, Ci, Co) float with the
    activation scales sx (Ci,) (or a scalar) folded in, then
    `quantize_weight`."""
    sx = torch.as_tensor(sx, dtype=torch.float32, device=w.device)
    return quantize_weight(w.float() * (sx[None, :, None] if sx.dim() == 1
                                        else sx))


def int8_conv_qweight(xq: torch.Tensor,
                      qweight: tuple[torch.Tensor, torch.Tensor],
                      b: torch.Tensor | None = None, *, pads: tuple[int, int],
                      rhs_dilation: int = 1, leaky: float | None = None
                      ) -> torch.Tensor:
    """The int8 conv of `int8_conv_qin` with its weight already quantized:
    qweight = `quantize_weight_qin(w, sx)`; b (Co,) float32 or None."""
    wt, sw = qweight
    return qconv.int8_conv(xq.contiguous(), wt, sw.expand(xq.shape[0], -1),
                           b, pads=pads, dilation=rhs_dilation, leaky=leaky)


def int8_conv_qin(xq: torch.Tensor, sx: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None, *, pads: tuple[int, int],
                  rhs_dilation: int = 1, leaky: float | None = None
                  ) -> torch.Tensor:
    """Stride-1 NWC conv on an already-int8 activation with static scales.

    xq: (B, T, Ci) int8; sx: (Ci,) per-channel scales or a scalar; w:
    (K, Ci, Co) float packed kernel; b: (Co,) or None. Returns (B, T', Co)
    float32 = acc · sw' + b, then max(y, leaky·y) when `leaky` is given
    (the leaky ReLU that follows a ResBlock's dilated conv)."""
    return int8_conv_qweight(
        xq, quantize_weight_qin(w, sx),
        None if b is None else b.float().contiguous(), pads=pads,
        rhs_dilation=rhs_dilation, leaky=leaky)


def int8_conv_nwc_qweight(x: torch.Tensor,
                          qweight: tuple[torch.Tensor, torch.Tensor],
                          b: torch.Tensor | None = None, *,
                          pads: tuple[int, int], rhs_dilation: int = 1,
                          leaky: float | None = None) -> torch.Tensor:
    """The dynamic int8 conv with its weight already quantized: qweight =
    `quantize_weight(w)`. x (B, T, Ci) float32 or bfloat16 is quantized
    per row here; returns (B, T', Co) in x's dtype = acc · (s_x[b]·s_w[co])
    + float32(b), then max(y, leaky·y) when `leaky` is given (in bf16 on the
    rounded output)."""
    wt, sw = qweight
    xq, sx = quantize_per_row(x)
    return qconv.int8_conv(xq.contiguous(), wt, sx[:, :, 0] * sw,
                           None if b is None else b.float().contiguous(),
                           pads=pads, dilation=rhs_dilation, leaky=leaky,
                           out_dtype=x.dtype)


def int8_conv_nwc(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None, *, pads: tuple[int, int],
                  rhs_dilation: int = 1, leaky: float | None = None
                  ) -> torch.Tensor:
    """Stride-1 NWC conv with both operands dynamically quantized to int8.

    x: (B, T, Ci) float; w: (K, Ci, Co) float (already packed by the
    caller's lowering); b: (Co,) or None. Returns (B, T', Co) in x's dtype,
    equal to the float conv up to the quantization error the per-row and
    per-channel scales bound."""
    return int8_conv_nwc_qweight(x, quantize_weight(w), b, pads=pads,
                                 rhs_dilation=rhs_dilation, leaky=leaky)
