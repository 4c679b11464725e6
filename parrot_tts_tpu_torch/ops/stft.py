"""Differentiable STFT magnitude and loss mel-spectrogram on tensors.

Port of `parrot_tts_tpu/ops/stft.py::{stft_magnitude, log_compress,
mel_spectrogram}` as the vocoder's loss mel calls them (reference
`utils/vocoder/dataset.py:43-69`): the manual (n_fft - hop)/2 reflect pad
with no centring, the periodic Hann window zero-padded to n_fft and
centred (torch.stft's convention), sqrt(re^2 + im^2 + 1e-9), the Slaney
filterbank of `ops/mel.py` and log-compression at 1e-5. Frames are cut
with `unfold` and transformed by `torch.fft.rfft`, which runs in IEEE
precision on the card whatever the TF32 flags (the JAX package's framed
DFT matmul asks for HIGHEST precision). Waveforms are (B, T); spectra
(B, frames, bins), frame-major as in the JAX package. Float64 inputs stay
float64, anything else runs in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from parrot_tts_tpu_torch.ops import mel as mellib
from parrot_tts_tpu_torch.ops.conv import reflect_pad


def _window(n_fft: int, win_size: int) -> np.ndarray:
    """Periodic Hann window of win_size, zero-padded centred to n_fft."""
    win = mellib.hann_window(win_size)
    pad_l = (n_fft - win_size) // 2
    return np.pad(win, (pad_l, n_fft - win_size - pad_l))


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_size: int,
                   win_size: int) -> torch.Tensor:
    """|STFT(y)| of (B, T) waveforms, reflect-padded by (n_fft - hop)/2 on
    each side first -> (B, n_frames, n_fft//2 + 1)."""
    if y.dim() != 2:
        raise ValueError(
            f"expected (B, T) waveform, got shape {tuple(y.shape)}")
    if y.dtype != torch.float64:
        y = y.float()
    pad = (n_fft - hop_size) // 2
    y = reflect_pad(y, pad, pad)
    win = torch.as_tensor(_window(n_fft, win_size), dtype=y.dtype,
                          device=y.device)
    spec = torch.fft.rfft(y.unfold(-1, n_fft, hop_size) * win, dim=-1)
    return torch.sqrt(spec.real.square() + spec.imag.square() + 1e-9)


def log_compress(x: torch.Tensor) -> torch.Tensor:
    """log(clamp(x, min=1e-5)) (reference utils/vocoder/dataset.py:88-89)."""
    return torch.log(torch.clamp(x, min=1e-5))


def mel_spectrogram(y: torch.Tensor, *, n_fft: int = 1024,
                    num_mels: int = 80, sampling_rate: int = 16_000,
                    hop_size: int = 256, win_size: int = 1024,
                    fmin: float = 0.0, fmax: float | None = None
                    ) -> torch.Tensor:
    """The reference's loss mel (utils/vocoder/dataset.py:43-69) of (B, T)
    waveforms -> (B, n_frames, num_mels)."""
    mag = stft_magnitude(y, n_fft, hop_size, win_size)
    fb = torch.as_tensor(
        mellib.mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax),
        dtype=mag.dtype, device=mag.device)
    return log_compress(mag @ fb.T)
