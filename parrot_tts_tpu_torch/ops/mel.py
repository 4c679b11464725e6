"""Mel filterbank construction (host-side numpy, librosa-compatible); a
copy of `parrot_tts_tpu/ops/mel.py`.

The reference builds its filterbanks with `librosa.filters.mel`
(`utils/vocoder/dataset.py:51`,
`utils/aligner/audio.py:31-41` via librosa.feature).
librosa's defaults are the Slaney-style mel scale with Slaney area
normalization; this module reimplements that algorithm exactly (it is the
classic Auditory-Toolbox formulation) so the precomputed matrix matches the
reference's to float precision. The matrix is a compile-time constant folded
into the mel matmul.
"""

from __future__ import annotations

import functools

import numpy as np

# Slaney mel scale constants (Auditory Toolbox / librosa htk=False)
_F_SP = 200.0 / 3.0           # linear region: mels per Hz below 1 kHz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # step size above 1 kHz


def hz_to_mel(freq: np.ndarray | float) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray | float) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(mels, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


@functools.lru_cache(maxsize=16)
def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft//2), float32.

    Matches `librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)` with the
    librosa defaults `htk=False, norm='slaney'`.
    """
    if fmax is None:
        fmax = sr / 2.0
    fmax = float(fmax)
    fmin = float(fmin)

    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)

    fdiff = np.diff(mel_f)
    ramps = mel_f.reshape(-1, 1) - fft_freqs.reshape(1, -1)

    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalization
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm.reshape(-1, 1)

    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window matching `torch.hann_window` (periodic=True) and librosa's
    `get_window('hann', n, fftbins=True)`."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1))
    return w[:win_length].astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis (cos, -sin) of shape (n_fft, n_bins) for computing the
    one-sided STFT as a single matmul (n_bins = n_fft//2+1).

    spec_re = frames @ cos ; spec_im = frames @ (-sin) matches the sign
    convention of numpy/torch rfft (X[k] = sum x[n] e^{-2πikn/N})."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft).reshape(-1, 1)
    k = np.arange(n_bins).reshape(1, -1)
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)
