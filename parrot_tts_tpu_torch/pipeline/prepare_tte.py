"""TTE preprocessor: join HuBERT units + aligner tokens/durations into
train/val manifests; a copy of `parrot_tts_tpu/pipeline/prepare_tte.py`
(for the same inputs and seed it writes the same files).

Reference: `utils/TTE/preprocessor.py` — per-line speaker
parse, character reconstruction from aligner tokens (' ' -> 'sil'), the
±2-frame `adjust_duration` reconciliation between Σdurations and #units,
shuffled split with val_size head, and speakers.json emission.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np

from parrot_tts_tpu_torch.data.manifest import (
    parse_speaker,
    read_manifest,
    write_manifest,
)
from parrot_tts_tpu_torch.text.tokenizer import load_symbols


def adjust_duration(total_codes: int, durations: list[int]) -> list[int] | None:
    """Reconcile Σdurations with the unit count, tolerating |diff| <= 2 by
    editing the first/last elements (reference utils/TTE/preprocessor.py:
    24-69). Returns None when not adjustable."""
    durations = list(durations)
    diff = sum(durations) - total_codes
    if diff == 0:
        return durations
    if abs(diff) > 2:
        return None
    if diff < 0:
        durations[-1] += -diff
        return durations
    # diff in (1, 2): shrink last, else first, else split across both
    if durations[-1] > diff:
        durations[-1] -= diff
        return durations
    if durations[0] > diff:
        durations[0] -= diff
        return durations
    if len(durations) >= 2 and diff == 2 and durations[0] > 1 and durations[-1] > 1:
        durations[0] -= 1
        durations[-1] -= 1
        return durations
    return None


def build_tte_manifests(
    hubert_path: str | Path,
    alignment_path: str | Path,
    out_dir: str | Path,
    *,
    speaker_method: str = "_",
    val_size: int = 100,
    seed: int | None = None,
) -> dict:
    """Returns {'train': n, 'val': n, 'skipped': n, 'speakers': {...}}."""
    alignment_path = Path(alignment_path)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    symbols = load_symbols(
        alignment_path / ("symbols.pkl" if (alignment_path / "symbols.pkl").exists()
                          else "symbols.json"))

    lines = read_manifest(hubert_path)
    rng = random.Random(seed)
    rng.shuffle(lines)

    processed, skipped = [], 0
    speakers: set[str] = set()
    for d in lines:
        basename = Path(d["audio"]).stem
        speaker = parse_speaker(d["audio"], speaker_method)
        speakers.add(speaker)
        d = dict(d)
        d["speaker"] = speaker

        tok_file = alignment_path / speaker / "tokens" / f"{basename}.npy"
        dur_file = (alignment_path / speaker / "outputs" / "durations"
                    / f"{basename}.npy")
        if not tok_file.exists() or not dur_file.exists():
            continue
        tokens = np.load(tok_file)
        durations = np.load(dur_file)

        # aligner ids are 1-based; ' ' becomes 'sil' (preprocessor.py:117-119)
        characters = ["sil" if symbols[i - 1] == " " else symbols[i - 1]
                      for i in tokens]

        n_units = len(d["hubert"].split())
        adj = adjust_duration(n_units, [int(x) for x in durations])
        if adj is None:
            skipped += 1
            continue
        assert sum(adj) == n_units
        d["characters"] = " ".join(characters)
        d["duration"] = " ".join(str(i) for i in adj)
        processed.append(d)

    speaker_dict = {s: i for i, s in enumerate(sorted(speakers))}
    with open(out_dir / "speakers.json", "w") as f:
        json.dump(speaker_dict, f)

    write_manifest(out_dir / "train.txt", processed[val_size:])
    write_manifest(out_dir / "val.txt", processed[:val_size])
    return {"train": len(processed) - min(val_size, len(processed)),
            "val": min(val_size, len(processed)),
            "skipped": skipped, "speakers": speaker_dict}


def prepare_vocoder_split(hubert_path: str | Path, out_dir: str | Path,
                          val_fraction: float = 0.02,
                          seed: int | None = None) -> dict:
    """Shuffled 98/2 vocoder train/val split
    (reference utils/vocoder/preprocessor.py:14-36)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = read_manifest(hubert_path)
    rng = random.Random(seed)
    rng.shuffle(lines)
    n_val = max(1, int(len(lines) * val_fraction))
    write_manifest(out_dir / "val.txt", lines[:n_val])
    write_manifest(out_dir / "train.txt", lines[n_val:])
    return {"train": len(lines) - n_val, "val": n_val}
