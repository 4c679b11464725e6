"""Training logs; port of `parrot_tts_tpu/core/metrics.py`.
`JsonlLogger` (one {step, tag, value, time} per line), `CsvLogger` (a
Lightning-CSVLogger-style metrics.csv, reference train.py:155),
`MetricsWriter` (scalars to JSONL; text artifacts as .txt files, audio
clips as WAV files, spectrograms as PNG figures when matplotlib is
importable; the JAX package's TensorBoard event files are not written)
and `Throughput`.
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path

import numpy as np

from parrot_tts_tpu_torch.data.audio_io import write_wav


class JsonlLogger:
    """Structured log: one {step, tag, value, time} per line."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps(
            {"step": step, "tag": tag, "value": float(value),
             "time": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class CsvLogger:
    """metrics.csv with a header that widens as new metrics appear."""

    def __init__(self, directory: str | Path):
        self.path = Path(directory) / "metrics.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fields: list[str] = []
        self._rows: list[dict] = []

    def log(self, step: int, **metrics: float) -> None:
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self._rows.append(row)
        new_fields = [k for k in row if k not in self._fields]
        if new_fields:
            # the field set changed: rewrite once with the wider header
            self._fields.extend(new_fields)
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fields)
                w.writeheader()
                w.writerows(self._rows)
        else:
            with open(self.path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fields).writerow(row)


class MetricsWriter:
    """Scalars to `<dir>/metrics.jsonl`; text, audio and figures under
    `<dir>/{text,audio,figures}/<tag>_<step>.*`."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.jsonl = JsonlLogger(self.dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.jsonl.scalar(tag, value, step)

    def scalars(self, step: int, **metrics: float) -> None:
        for k, v in metrics.items():
            self.scalar(k, v, step)

    def _path(self, kind: str, tag: str, step: int, suffix: str) -> Path:
        out = self.dir / kind / f"{tag.replace('/', '_')}_{step}{suffix}"
        out.parent.mkdir(parents=True, exist_ok=True)
        return out

    def text(self, tag: str, value: str, step: int) -> None:
        """Text artifact (the aligner's decoded-vs-target strings,
        reference utils/aligner/trainer.py:112-115)."""
        self._path("text", tag, step, ".txt").write_text(value)

    def audio(self, tag: str, wav: np.ndarray, step: int,
              sample_rate: int = 16_000) -> None:
        """Audio clip logging (reference utils/vocoder/train.py:205-219)."""
        write_wav(self._path("audio", tag, step, ".wav"), np.asarray(wav),
                  sample_rate)

    def figure_spectrogram(self, tag: str, spec: np.ndarray,
                           step: int) -> None:
        """Spectrogram figure (reference utils/vocoder/utils.py:20-29) of a
        (frames, bins) array; skipped where matplotlib is not installed."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots(figsize=(10, 2))
        im = ax.imshow(np.asarray(spec).T, aspect="auto", origin="lower",
                       interpolation="none")
        fig.colorbar(im, ax=ax)
        fig.savefig(self._path("figures", tag, step, ".png"))
        plt.close(fig)

    def close(self):
        self.jsonl.close()


class Throughput:
    """Seconds per batch and audio seconds per second since the last reset
    (host clock)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._batches = 0
        self._audio_seconds = 0.0

    def tick(self, audio_seconds: float = 0.0):
        self._batches += 1
        self._audio_seconds += audio_seconds

    def report(self) -> dict:
        dt = time.perf_counter() - self._t0
        return {"seconds_per_batch": dt / max(1, self._batches),
                "audio_seconds_per_second": (self._audio_seconds / dt
                                             if dt > 0 else 0.0)}
