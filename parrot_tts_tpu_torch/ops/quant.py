"""Static-scale int8 quantization for the vocoder's int8-static serving path.

Port of `parrot_tts_tpu/ops/quant.py::{QMAX, _absmax,
quantize_per_out_channel, quantize_static, int8_conv_qin}` with the same
arithmetic, so the int8 values equal the JAX package's bit for bit:
symmetric int8 in [-127, 127], scales = absmax / 127 (an all-zero operand
gets scale 1/127), `x / scale` rounded half to even and clipped.

`int8_conv_qin` is the composition of two steps. `quantize_weight_qin`
folds the per-channel activation scales into the float weight before the
weight's per-out-channel quantization (conv(xq·sx, w) == conv(xq, w·sx[ci])
exactly); a server does it once per set of scales. `int8_conv_qweight` then
runs the int8 conv with int32 accumulation and the `acc · sw[co] + bias[co]`
epilogue: on a CUDA tensor the hand-written kernel `csrc/int8_conv.cu`
(`ops/qconv.py`), on a CPU tensor its plain version. The dynamic per-row
modes ("int8", "int8-tail") are not ported yet.
"""

from __future__ import annotations

import torch

from parrot_tts_tpu_torch.ops import qconv

# int8 symmetric range: 127 (not 128) keeps quantize(-x) == -quantize(x)
QMAX = 127.0


def _absmax(x: torch.Tensor, dims) -> torch.Tensor:
    m = x.abs().amax(dim=dims)
    # guard all-zero operands: scale 1 maps 0 -> 0
    return torch.where(m > 0, m, torch.ones_like(m)).float()


def quantize_per_out_channel(w: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """w (K, Ci, Co) float -> (int8 values, (Co,) float32 scales)."""
    scale = _absmax(w, (0, 1)) / QMAX
    q = torch.clamp(torch.round(w.float() / scale[None, None, :]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def quantize_static(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, T, C) float -> int8 with static per-channel scales (C,) (or a
    scalar); values beyond scale·127 clip."""
    q = torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX)
    return q.to(torch.int8)


def quantize_weight_qin(w: torch.Tensor, sx: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The weight side of `int8_conv_qin`: w (K, Ci, Co) float with the
    activation scales sx (Ci,) (or a scalar) folded in, quantized per out
    channel. Returns (int8 (K, Co, Ci), contiguous: the layout the kernel
    reads; (Co,) float32 scales)."""
    sx = torch.as_tensor(sx, dtype=torch.float32, device=w.device)
    w_eff = w.float() * (sx[None, :, None] if sx.dim() == 1 else sx)
    q, sw = quantize_per_out_channel(w_eff)
    return q.transpose(1, 2).contiguous(), sw


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
