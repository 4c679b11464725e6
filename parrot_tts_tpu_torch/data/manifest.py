"""Manifest parsing; a copy of `read_manifest` and `read_speaker_map` from
`parrot_tts_tpu/data/manifest.py`.

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


def read_speaker_map(path: str | Path) -> dict[str, int]:
    with open(path) as f:
        return json.load(f)
