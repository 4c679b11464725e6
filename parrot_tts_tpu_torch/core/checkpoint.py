"""Step-numbered checkpoints with `torch.save`, in place of the JAX
package's Orbax `CheckpointManager` (`parrot_tts_tpu/core/checkpoint.py`),
with the same API: `save(step, state, metadata, wait)`, `latest_step()`,
`restore(step, with_metadata)` and `save_config_json`.

Each step gets its own directory `<dir>/<step>/` holding `state.pt` (any
picklable tree of tensors and numbers; the TTE trainer saves its params,
Adam moments, accumulated gradients and counters) and, when given,
`metadata.json`. Every checkpoint is kept (the reference's save_top_k=-1).
A step's directory is written under a temporary name and renamed into
place, so `latest_step` never sees a half-written checkpoint. Saves are
synchronous; `wait` is accepted for the API's sake and changes nothing.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any

import torch


class CheckpointManager:
    def __init__(self, directory: str | Path):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)

    def save(self, step: int, state: Any, metadata: dict | None = None,
             wait: bool = False) -> None:
        final = self.directory / str(step)
        tmp = Path(tempfile.mkdtemp(prefix=f".{step}-", dir=self.directory))
        try:
            torch.save(state, tmp / "state.pt")
            if metadata:
                (tmp / "metadata.json").write_text(json.dumps(metadata))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            if tmp.exists():
                shutil.rmtree(tmp)

    def latest_step(self) -> int | None:
        steps = [int(p.name) for p in self.directory.iterdir()
                 if p.name.isdigit() and (p / "state.pt").exists()]
        return max(steps) if steps else None

    def restore(self, step: int | None = None,
                with_metadata: bool = False) -> Any:
        """The state saved at `step` (latest by default), tensors on the
        CPU; with_metadata=True returns (state, metadata dict or None)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        d = self.directory / str(step)
        state = torch.load(d / "state.pt", map_location="cpu",
                           weights_only=True)
        if not with_metadata:
            return state
        meta = d / "metadata.json"
        return state, (json.loads(meta.read_text()) if meta.exists()
                       else None)


def save_config_json(directory: str | Path, cfg_json: str) -> None:
    """Keep the config beside the checkpoints."""
    Path(directory).mkdir(parents=True, exist_ok=True)
    (Path(directory) / "config.json").write_text(cfg_json)
