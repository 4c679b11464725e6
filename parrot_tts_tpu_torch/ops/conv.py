"""1-D convolutions with the JAX package's (B, T, C) activations at the
boundary and torch weight layouts: Conv1d (Cout, Cin, K), ConvTranspose1d
(Cin, Cout, K).

Port of `parrot_tts_tpu/ops/conv.py::{conv1d, conv_transpose1d,
get_padding, _polyphase_plan, polyphase_weights}`. The JAX package leaves
the float convs to XLA; here they go to `F.conv1d` / `F.conv_transpose1d`
(cuDNN on the card), and the folded tail of the TPU build has no
counterpart. The polyphase packing is kept for the int8-static vocoder:
its int8 conv kernel is stride-1, so the upsample runs the transposed conv
as a stride-1 conv on the packed (q_len, Cin, u·Cout) kernel
(`models/vocoder/generator_staticq.py`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           *, padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """torch.nn.functional.conv1d on x (B, T, Cin) -> (B, T', Cout)."""
    y = F.conv1d(x.transpose(1, 2), w, b, padding=padding, dilation=dilation)
    return y.transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, *, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """torch.nn.ConvTranspose1d on x (B, T, Cin): out_len =
    (T-1)*stride - 2*padding + K."""
    y = F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride,
                           padding=padding)
    return y.transpose(1, 2)


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
