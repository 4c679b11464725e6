"""Training logs: the part of `parrot_tts_tpu/core/metrics.py` that TTE
training uses. `JsonlLogger` (one {step, tag, value, time} per line),
`CsvLogger` (a Lightning-CSVLogger-style metrics.csv, reference
train.py:155), `MetricsWriter` (scalars to JSONL; the JAX package's
TensorBoard, audio and figure outputs are not copied) and `Throughput`.
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path


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
    """Scalars to `<dir>/metrics.jsonl`."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.jsonl = JsonlLogger(self.dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.jsonl.scalar(tag, value, step)

    def scalars(self, step: int, **metrics: float) -> None:
        for k, v in metrics.items():
            self.scalar(k, v, step)

    def close(self):
        self.jsonl.close()


class Throughput:
    """Seconds per batch since the last reset (host clock)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._batches = 0

    def tick(self):
        self._batches += 1

    def report(self) -> dict:
        dt = time.perf_counter() - self._t0
        return {"seconds_per_batch": dt / max(1, self._batches)}
