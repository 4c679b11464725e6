"""1-D convolutions with the JAX package's (B, T, C) activations at the
boundary and torch weight layouts: Conv1d (Cout, Cin, K), ConvTranspose1d
(Cin, Cout, K).

Port of `parrot_tts_tpu/ops/conv.py::{conv1d, conv_transpose1d,
get_padding}`. The JAX package leaves these to XLA; here they go to
`F.conv1d` / `F.conv_transpose1d` (cuDNN on the card), so the polyphase
lowering and the folded tail of the TPU build have no counterpart.
"""

from __future__ import annotations

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
