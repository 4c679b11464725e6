"""Step 4 of the pipeline: HuBERT unit extraction -> hubert.txt; a port of
`parrot_tts_tpu/pipeline/extract_units.py`.

Reference: `utils/hubert_extraction/extractor.py:25-81`: walks
`dataset_dir/<speaker>/wavs/*.wav`, codes each wav with mHuBERT layer 11 +
k-means 1000, and writes dict-per-line `{'audio': path, 'hubert': '1 2 3',
'duration': seconds}` to `hubert.txt`. Here extraction runs batched on the
card (`infer/unit_extractor.py`); the manifest is written in the same
format as the JAX package's.
"""

from __future__ import annotations

from glob import glob
from pathlib import Path

import numpy as np

from parrot_tts_tpu_torch.data.audio_io import read_wav
from parrot_tts_tpu_torch.data.manifest import write_manifest


def extract_units_corpus(extractor, dataset_dir: str | Path,
                         out_dir: str | Path, *, wav_glob: str = "wavs/*.wav",
                         batch_size: int | None = None) -> list[dict]:
    """Code every `<speaker>/wavs/*.wav` under dataset_dir (or, with none
    there, every `*.wav` directly in it) with `extractor`, a
    `UnitExtractor`; write <out_dir>/hubert.txt and return its entries.
    The wavs go to the extractor as read, int16 sample values in float32,
    as in the JAX package."""
    dataset_dir, out_dir = Path(dataset_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if batch_size is not None:
        extractor.batch_size = batch_size

    wav_files: list[str] = []
    for speaker in sorted(dataset_dir.glob("*")):
        wav_files.extend(sorted(glob(str(speaker / wav_glob))))
    if not wav_files:  # flat layout fallback
        wav_files = sorted(glob(str(dataset_dir / "*.wav")))

    sr = extractor.cfg.sample_rate
    wavs, durations = [], []
    for path in wav_files:
        wav, file_sr = read_wav(path)
        if file_sr != sr:
            raise ValueError(f"{path}: sample rate {file_sr} != {sr}")
        wavs.append(np.asarray(wav, np.float32))
        durations.append(len(wav) / file_sr)
    entries = [{"audio": path, "hubert": " ".join(str(int(x)) for x in c),
                "duration": dur}
               for path, c, dur in zip(wav_files,
                                       extractor.codes_for_wavs(wavs),
                                       durations)]
    write_manifest(out_dir / "hubert.txt", entries)
    return entries
