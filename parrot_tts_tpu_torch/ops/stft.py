"""Differentiable STFT magnitude, the loss mel-spectrogram and the
aligner's feature mel on tensors.

Port of `parrot_tts_tpu/ops/stft.py::{stft_magnitude, log_compress,
mel_spectrogram, librosa_mel_spectrogram}`. The vocoder's loss mel
(reference `utils/vocoder/dataset.py:43-69`): the manual (n_fft - hop)/2
reflect pad with no centring, sqrt(re^2 + im^2 + 1e-9). The aligner's
feature mel (reference `utils/aligner/audio.py:30-47`, librosa's
melspectrogram): centred (reflect pad by n_fft // 2), sqrt(re^2 + im^2),
any hop (320 at 16 kHz, not a divisor of n_fft). Both use the periodic
Hann window zero-padded to n_fft and centred (torch.stft's convention),
the Slaney filterbank of `ops/mel.py` and log-compression at 1e-5. Frames
are cut with `unfold` and transformed by `torch.fft.rfft`, which runs in
IEEE precision on the card whatever the TF32 flags (the JAX package's
framed DFT matmul asks for HIGHEST precision). Waveforms are (B, T);
spectra (B, frames, bins), frame-major as in the JAX package. Float64
inputs stay float64, anything else runs in float32.
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
                   win_size: int, *, center: bool = False) -> torch.Tensor:
    """|STFT(y)| of (B, T) waveforms -> (B, n_frames, n_fft//2 + 1).

    center=False, the loss mel: reflect-padded by (n_fft - hop)/2 on each
    side first, sqrt(re^2 + im^2 + 1e-9). center=True, librosa's: by
    n_fft // 2, sqrt(re^2 + im^2). (The JAX function's two knobs, centring
    and the epsilon, are always set together, so the port has one.)"""
    if y.dim() != 2:
        raise ValueError(
            f"expected (B, T) waveform, got shape {tuple(y.shape)}")
    if y.dtype != torch.float64:
        y = y.float()
    pad = n_fft // 2 if center else (n_fft - hop_size) // 2
    y = reflect_pad(y, pad, pad)
    win = torch.as_tensor(_window(n_fft, win_size), dtype=y.dtype,
                          device=y.device)
    spec = torch.fft.rfft(y.unfold(-1, n_fft, hop_size) * win, dim=-1)
    power = spec.real.square() + spec.imag.square()
    return torch.sqrt(power if center else power + 1e-9)


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


def librosa_mel_spectrogram(y: torch.Tensor, *, sample_rate: int = 16_000,
                            n_fft: int = 1024, n_mels: int = 80,
                            hop_length: int = 320, win_length: int = 1024,
                            fmin: float = 0.0, fmax: float = 8000.0,
                            power: float = 1.0) -> torch.Tensor:
    """The aligner's feature mel (reference utils/aligner/audio.py:30-47)
    of (B, T) waveforms -> (B, 1 + T // hop_length, n_mels): centred STFT,
    |.|^power, Slaney mel, log(clip(., 1e-5)). In a zero-padded batch a
    short wav's last frames see the zeros, not its own reflection."""
    mag = stft_magnitude(y, n_fft, hop_length, win_length, center=True)
    if power != 1.0:
        mag = mag ** power
    fb = torch.as_tensor(
        mellib.mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax),
        dtype=mag.dtype, device=mag.device)
    return log_compress(mag @ fb.T)
