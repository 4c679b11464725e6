"""1-D convolutions with the JAX package's (B, T, C) activations at the
boundary and torch weight layouts: Conv1d (Cout, Cin, K), ConvTranspose1d
(Cin, Cout, K).

Port of `parrot_tts_tpu/ops/conv.py::{conv1d, conv_transpose1d,
get_padding, _polyphase_plan, polyphase_weights}`. The JAX package leaves
the float convs to XLA; here they go to `F.conv1d` / `F.conv_transpose1d`
(cuDNN on the card), and the folded tail of the TPU build has no
counterpart. `quant=True` runs a conv as the dynamic int8 conv of
`ops/quant.py` (the hand-written kernel `csrc/int8_conv.cu` on the card).
That kernel is stride-1, so the int8 upsample runs the transposed conv as
a stride-1 conv on its polyphase packing, the (q_len, Cin, u·Cout) kernel
that `polyphase_weights` makes (the int8-static vocoder,
`models/vocoder/generator_staticq.py`, packs it the same way).

In bfloat16 (x, w and b all bf16) each conv sums in float32 (cuDNN on the
card) and rounds its output to bf16 once; the bias is then added in bf16,
which rounds a second time, as the JAX package's bf16 conv (no
preferred_element_type) followed by `out + b` does. The leaky ReLU that
follows takes bf16(slope) (`ops/activation.py`). The int8 convs return
x's dtype.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.ops import quant as quant_ops
from parrot_tts_tpu_torch.ops.activation import leaky_relu

_WARNED_QUANT_FALLBACK: set = set()


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           *, padding: int = 0, dilation: int = 1, quant: bool = False,
           qweight: tuple | None = None, leaky: float | None = None
           ) -> torch.Tensor:
    """torch.nn.functional.conv1d on x (B, T, Cin) -> (B, T', Cout), then
    leaky_relu(·, leaky) when `leaky` is given; w and b in x's dtype (in
    bf16 the bias is added after the conv's rounding). quant=True runs the
    dynamic int8 conv (`quant.int8_conv_nwc_qweight`, the leaky fused into
    its epilogue) on qweight, the int8 form of w that
    `quant.quantize_weight` makes of w (K, Cin, Cout); without one, w is
    quantized here."""
    if quant:
        if qweight is None:
            qweight = quant_ops.quantize_weight(w.permute(2, 1, 0))
        return quant_ops.int8_conv_nwc_qweight(
            x, qweight, b, pads=(padding, padding), rhs_dilation=dilation,
            leaky=leaky)
    late = x.dtype == torch.bfloat16 and b is not None
    y = F.conv1d(x.transpose(1, 2), w, None if late else b, padding=padding,
                 dilation=dilation).transpose(1, 2)
    if late:
        y = y + b
    return y if leaky is None else leaky_relu(y, leaky)


def _warn_quant_fallback(k: int, stride: int, padding: int) -> None:
    """One warning per topology whose quant=True upsample has no polyphase
    form and runs the float lowering, as the JAX package does."""
    key = (k, stride, padding)
    if key not in _WARNED_QUANT_FALLBACK:
        _WARNED_QUANT_FALLBACK.add(key)
        warnings.warn(
            f"conv_transpose1d(K={k}, stride={stride}, padding={padding}): "
            "quant=True requires K - 2*padding == stride (polyphase "
            "packing); this layer runs the float lowering instead")


def polyphase_applies(k: int, stride: int, padding: int) -> bool:
    """Whether a transposed conv has the polyphase form the int8 path runs
    (the vocoder's upsamples: K - 2*padding == stride > 1)."""
    return stride > 1 and k - 2 * padding == stride


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, *, stride: int = 1,
                     padding: int = 0, quant: bool = False,
                     qweight: tuple | None = None) -> torch.Tensor:
    """torch.nn.ConvTranspose1d on x (B, T, Cin): out_len =
    (T-1)*stride - 2*padding + K. quant=True, where the polyphase form
    applies, runs the dynamic int8 conv on the packed kernel (qweight:
    `quant.quantize_weight` of `polyphase_weights(w)`, else made here) with
    the bias tiled over the phases into the epilogue (the same two float32
    roundings as the JAX package's add after the reshape; in bf16 the bias
    is added to the bf16 output after the reshape, as there); elsewhere it
    warns once and runs the float conv. w and b in x's dtype."""
    k = w.shape[2]
    late = x.dtype == torch.bfloat16 and b is not None
    if quant and polyphase_applies(k, stride, padding):
        *_, pad_left, q_len = _polyphase_plan(k, stride, padding)
        if qweight is None:
            qweight = quant_ops.quantize_weight(
                polyphase_weights(w.permute(2, 0, 1), stride, padding)[0])
        y = quant_ops.int8_conv_nwc_qweight(
            x, qweight, None if b is None or late else b.repeat(stride),
            pads=(pad_left, q_len - 1 - pad_left))
        bsz, t, _ = y.shape
        y = y.reshape(bsz, t * stride, w.shape[1])      # phase-major
        return y + b if late else y
    if quant:
        _warn_quant_fallback(k, stride, padding)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        # PyTorch's CPU bf16 transposed conv returns a wrong input gradient
        # (relative error ~1 against float64 at the vocoder's upsamples);
        # the same bf16 conv, operands widened to float32 and the output
        # rounded once, has the same rounding points forward and backward
        y = F.conv_transpose1d(x.float().transpose(1, 2), w.float(),
                               stride=stride, padding=padding).to(x.dtype)
    else:
        y = F.conv_transpose1d(x.transpose(1, 2), w, None if late else b,
                               stride=stride, padding=padding)
    y = y.transpose(1, 2)
    return y + b if late else y


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the last axis (numpy / torch mode "reflect"). Built from
    slices and flips, so its backward is a sum of slices: the CUDA
    reflection-pad backward accumulates with atomics, and a training step
    through it would not repeat bit for bit."""
    n = x.shape[-1]
    if max(left, right) >= n:
        raise ValueError(f"reflect pad ({left}, {right}) needs more than "
                         f"{n} samples")
    parts = [x[..., 1:left + 1].flip(-1)] if left else []
    parts.append(x)
    if right:
        parts.append(x[..., n - right - 1:n - 1].flip(-1))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else x


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    """'same'-style padding helper (reference utils/vocoder/utils.py:44-45)."""
    return (kernel_size * dilation - dilation) // 2


def _polyphase_plan(k: int, u: int, pad: int):
    """Static packing plan. Phase p of the output (o = t*u + p) reads input
    taps j = j0_p + m*u with j0_p = (p+pad) % u, shifted by
    s_p = (p+pad-j0_p)//u:  out[t*u+p] = sum_m x[t+s_p-m] * w[j0_p+m*u]."""
    j0 = [(p + pad) % u for p in range(u)]
    m_taps = [-(-(k - j) // u) for j in j0]            # ceil((k-j0)/u)
    s = [(p + pad - j0[p]) // u for p in range(u)]
    pad_left = max(m_taps[p] - 1 - s[p] for p in range(u))
    q_len = pad_left + max(s) + 1
    return j0, m_taps, s, pad_left, q_len


def polyphase_weights(w: torch.Tensor, stride: int, padding: int
                      ) -> tuple[torch.Tensor, int, int]:
    """Pack a transposed-conv kernel (K, Cin, Cout) into the equivalent
    stride-1 conv kernel (q_len, Cin, stride*Cout) emitting phase-major
    channels, plus its left pad and q_len. The stride-1 conv with pads
    (pad_left, q_len-1-pad_left), reshaped (B, T, u*Cout) -> (B, u*T, Cout),
    is the transposed conv with `padding` when K - 2*padding == stride."""
    k, cin, cout = w.shape
    u = stride
    j0, m_taps, s, pad_left, q_len = _polyphase_plan(k, u, padding)
    # W2[q, ci, p, co] = w[j0_p + (pad_left + s_p - q)*u, ci, co] (or 0)
    q_idx = np.arange(q_len)[:, None]                  # (Q, 1)
    m = np.asarray([pad_left + s[p] for p in range(u)])[None, :] - q_idx
    j = np.asarray(j0)[None, :] + m * u                # (Q, u)
    valid = (m >= 0) & (m < np.asarray(m_taps)[None, :])
    j_safe = torch.as_tensor(np.where(valid, j, 0).reshape(-1),
                             device=w.device)
    w2 = w.index_select(0, j_safe).reshape(q_len, u, cin, cout)
    keep = torch.as_tensor(valid, device=w.device)[:, :, None, None]
    w2 = torch.where(keep, w2, torch.zeros((), dtype=w.dtype, device=w.device))
    w2 = w2.permute(0, 2, 1, 3).reshape(q_len, cin, u * cout)
    return w2, pad_left, q_len
