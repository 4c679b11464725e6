"""WAV IO + normalization (host-side, dependency-free); a copy of
`parrot_tts_tpu/data/audio_io.py`.

The reference loads int16 wavs with soundfile and peak-normalizes with
librosa (`utils/vocoder/dataset.py:72-74,212-213`); neither is a
dependency of the port, so 16-bit PCM WAV read/write is implemented on the
stdlib `wave` module + numpy, and `librosa.util.normalize` is
reimplemented (peak normalize to |x|max = 1).
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

MAX_WAV_VALUE = 32768.0  # reference utils/vocoder/dataset.py:22


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Returns (int16 samples (T,) or (T, C), sample_rate)."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width != 2:
        raise ValueError(f"{path}: only 16-bit PCM supported, got width {width}")
    data = np.frombuffer(raw, dtype="<i2")
    if ch > 1:
        data = data.reshape(-1, ch)
    return data, sr


def write_wav(path: str | Path, audio: np.ndarray, sample_rate: int) -> None:
    """Write float [-1, 1] or int16 audio as 16-bit PCM WAV."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = np.clip(audio, -1.0, 1.0)
        audio = (audio * (MAX_WAV_VALUE - 1)).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1 if audio.ndim == 1 else audio.shape[1])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(audio.astype("<i2").tobytes())


def peak_normalize(x: np.ndarray) -> np.ndarray:
    """librosa.util.normalize default (norm=inf over the whole signal)."""
    peak = np.max(np.abs(x))
    return x / peak if peak > 0 else x


def load_normalized(path: str | Path, scale: float = 0.95) -> tuple[np.ndarray, int]:
    """The reference's loading recipe (utils/vocoder/dataset.py:204-213):
    int16 -> /32768 -> peak-normalize -> x0.95."""
    data, sr = read_wav(path)
    audio = data.astype(np.float64) / MAX_WAV_VALUE
    return (peak_normalize(audio) * scale).astype(np.float32), sr


def duration_seconds(path: str | Path) -> float:
    with wave.open(str(path), "rb") as f:
        return f.getnframes() / f.getframerate()
