"""Aligner data: npy mel/token loading with length-binned bucketing; a copy
of `parrot_tts_tpu/data/aligner_data.py` (the same batches for a seed).

Reference: `utils/aligner/dataset.py` — AlignerDataset over
mels/*.npy + tokens/*.npy with a BinnedLengthSampler (sort by length, shuffle
within bins) and a pad-collate. Here bins are realized as static bucket
shapes.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Iterator

import numpy as np

from parrot_tts_tpu_torch.data.tte_data import pick_bucket


class AlignerDataset:
    def __init__(self, data_dir: str | Path):
        data_dir = Path(data_dir)
        self.mel_dir = data_dir / "mels"
        self.tok_dir = data_dir / "tokens"
        with open(data_dir / "dataset.pkl", "rb") as f:
            self.index = pickle.load(f)   # [(stem, n_frames, n_tokens)]

    def __len__(self):
        return len(self.index)

    def load(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        stem = self.index[i][0]
        mel = np.load(self.mel_dir / f"{stem}.npy")
        tok = np.load(self.tok_dir / f"{stem}.npy")
        return mel, tok


class AlignerLoader:
    """Length-binned batches (BinnedLengthSampler analog) padded to bucket
    shapes, each item cropped to its bucket. Nothing checks that a row has
    enough frames for its labels (a repeated label needs a blank between):
    `ops/ctc.py` gives such a row a large finite loss, as optax does."""

    def __init__(self, dataset: AlignerDataset, batch_size: int,
                 mel_buckets: tuple[int, ...], token_buckets: tuple[int, ...],
                 seed: int = 42):
        self.ds = dataset
        self.batch_size = batch_size
        self.mel_buckets = mel_buckets
        self.token_buckets = token_buckets
        self.seed = seed

    def batches(self, epoch: int = 0) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + epoch)
        by_bucket: dict[tuple[int, int], list[int]] = {}
        for i, (_, n_frames, n_tokens) in enumerate(self.ds.index):
            key = (pick_bucket(self.mel_buckets, n_frames),
                   pick_bucket(self.token_buckets, n_tokens))
            by_bucket.setdefault(key, []).append(i)

        batches = []
        for (mt, lt), idxs in sorted(by_bucket.items()):
            idxs = np.asarray(idxs)
            rng.shuffle(idxs)
            for off in range(0, len(idxs), self.batch_size):
                batches.append((mt, lt, idxs[off : off + self.batch_size]))
        rng.shuffle(batches)

        n_mels = None
        for mt, lt, idxs in batches:
            items = [self.ds.load(i) for i in idxs]
            if n_mels is None:
                n_mels = items[0][0].shape[1]
            b = len(items)
            mel = np.zeros((b, mt, n_mels), np.float32)
            tokens = np.zeros((b, lt), np.int32)
            mel_lengths = np.zeros((b,), np.int32)
            token_lengths = np.zeros((b,), np.int32)
            for i, (m, t) in enumerate(items):
                nm, nt = min(len(m), mt), min(len(t), lt)
                mel[i, :nm] = m[:nm]
                tokens[i, :nt] = t[:nt]
                mel_lengths[i] = nm
                token_lengths[i] = nt
            yield {"mel": mel, "tokens": tokens,
                   "mel_lengths": mel_lengths,
                   "token_lengths": token_lengths}
