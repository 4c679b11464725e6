"""Manifest parsing and writing; a copy of `parrot_tts_tpu/data/manifest.py`.

Lines look like `{'audio': '...', 'hubert': '504 84 ...', 'duration': '...',
'speaker': 'en_f', 'characters': 'h e l l o'}` (the python-repr lines the
reference writes, `utils/TTE/preprocessor.py:144-156`), parsed with
`ast.literal_eval`.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Any


def parse_manifest_line(line: str) -> dict[str, Any]:
    line = line.strip()
    if not line:
        raise ValueError("empty manifest line")
    if line[0] == "{":
        return ast.literal_eval(line)
    return {"audio": line}


def read_manifest(path: str | Path) -> list[dict[str, Any]]:
    entries = []
    with open(path) as f:
        for line in f:
            if line.strip():
                entries.append(parse_manifest_line(line))
    return entries


def write_manifest(path: str | Path, entries: list[dict]) -> None:
    """Write dict-per-line exactly like the reference (str(dict) repr,
    utils/TTE/preprocessor.py:149-156) so files interchange both ways."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for e in entries:
            f.write(str(e) + "\n")


def parse_speaker(path: str | Path, method: str = "_") -> str:
    """Speaker from filename (reference utils/vocoder/dataset.py:133-142,
    utils/TTE/preprocessor.py:11-21): first two '_'-joined name fields."""
    name = Path(path).name
    if method == "_":
        return "_".join(name.split("_")[:2])
    if method == "single":
        return "A"
    raise NotImplementedError(f"speaker method {method!r}")


def read_speaker_map(path: str | Path) -> dict[str, int]:
    with open(path) as f:
        return json.load(f)
