"""TTE data: manifests -> length-bucketed, fixed-shape numpy batches.

Copies of `TTESample`, `TTEDataset`, `pick_bucket`, `collate`,
`BucketedLoader` and `shard_for_host` from
`parrot_tts_tpu/data/tte_data.py`: for the same seed they yield the same
batches, bit for bit, and each process of a data-parallel run
(`process_index` / `process_count`) takes its contiguous slice of every
global batch. Samples are padded to (src, tgt) bucket pairs with the
reference collate's values (phones with pad_idx, codes with the pad code =
CE ignore_index, durations with 0; masks True = valid). The loader always
pads a short last batch (the JAX loader's `drop_last=False`, the only
setting training uses).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

from parrot_tts_tpu_torch.data.manifest import read_manifest, read_speaker_map
from parrot_tts_tpu_torch.text.tokenizer import DFATokenizer


@dataclass
class TTESample:
    id: str
    speaker: int
    phones: np.ndarray       # (S,) int32
    codes: np.ndarray        # (T,) int32
    duration: np.ndarray     # (S,) int32
    audio: str = ""          # manifest audio path


class TTEDataset:
    """Parses {split}.txt + speakers.json + the aligner's symbols
    (reference modules/data.py:63-100)."""

    def __init__(self, root_path: str | Path, alignment_path: str | Path,
                 split: str = "train", hubert_codes: int = 1000):
        root = Path(root_path)
        self.tokenizer = DFATokenizer.from_alignment_path(alignment_path)
        self.speaker_map = read_speaker_map(root / "speakers.json")
        self.code_pad_idx = hubert_codes
        self.samples: list[TTESample] = []
        for d in read_manifest(root / f"{split}.txt"):
            self.samples.append(TTESample(
                id=Path(d["audio"]).stem,
                speaker=self.speaker_map[d["speaker"]],
                phones=np.asarray(self.tokenizer.tokenize_text(
                    d["characters"]), np.int32),
                codes=np.asarray([int(c) for c in d["hubert"].split(" ")],
                                 np.int32),
                duration=np.asarray([int(c) for c in
                                     d["duration"].split(" ")], np.int32),
                audio=d["audio"],
            ))

    def __len__(self):
        return len(self.samples)

    @property
    def src_pad_idx(self) -> int:
        return self.tokenizer.pad_idx

    @property
    def vocab_size(self) -> int:
        return len(self.tokenizer)


def pick_bucket(buckets: tuple[int, ...], length: int) -> int:
    """Smallest bucket >= length (the largest bucket caps/crops)."""
    i = bisect.bisect_left(buckets, length)
    return buckets[min(i, len(buckets) - 1)]


def collate(samples: list[TTESample], src_len: int, tgt_len: int,
            src_pad_idx: int, code_pad_idx: int,
            sample_weight: list[float] | None = None) -> dict:
    """Fixed-shape batch (reference collate_fn semantics, data.py:102-119).
    sample_weight: per-row loss weights (default 1.0); the loader gives 0.0
    to rows that only repeat an earlier sample to keep the shape static."""
    b = len(samples)
    phones = np.full((b, src_len), src_pad_idx, np.int32)
    codes = np.full((b, tgt_len), code_pad_idx, np.int32)
    duration = np.zeros((b, src_len), np.int32)
    src_mask = np.zeros((b, src_len), bool)
    tgt_mask = np.zeros((b, tgt_len), bool)
    speaker = np.zeros((b,), np.int32)
    ids = []
    for i, s in enumerate(samples):
        ns, nt = min(len(s.phones), src_len), min(len(s.codes), tgt_len)
        phones[i, :ns] = s.phones[:ns]
        codes[i, :nt] = s.codes[:nt]
        # beam-search durations may be shorter than the tokens: zero tail
        nd = min(len(s.duration), ns)
        duration[i, :nd] = s.duration[:nd]
        src_mask[i, :ns] = True
        tgt_mask[i, :nt] = True
        speaker[i] = s.speaker
        ids.append(s.id)
    weight = (np.ones((b,), np.float32) if sample_weight is None
              else np.asarray(sample_weight, np.float32))
    return {
        "ids": ids, "phones": phones, "codes": codes, "duration": duration,
        "src_mask": src_mask, "tgt_mask": tgt_mask, "speaker": speaker,
        "sample_weight": weight,
    }


class BucketedLoader:
    """Length-bucketed batching with per-epoch deterministic shuffling
    (numpy `default_rng(seed + epoch)`, the JAX package's schedule).

    `batch_size` is the GLOBAL batch: every process derives the same
    schedule from the shared seed and takes its contiguous
    `batch_size / process_count` slice of each global batch, filler rows
    (weight 0) included."""

    def __init__(self, dataset: TTEDataset, batch_size: int,
                 src_buckets: tuple[int, ...], tgt_buckets: tuple[int, ...],
                 seed: int = 42, shuffle: bool = True,
                 process_index: int = 0, process_count: int = 1):
        if batch_size % process_count != 0:
            raise ValueError(
                f"global batch_size={batch_size} must be divisible by "
                f"process_count={process_count} (each process takes an "
                f"equal slice of every global batch)")
        self.process_index = process_index
        self.process_count = process_count
        self.ds = dataset
        self.batch_size = batch_size
        self.src_buckets = src_buckets
        self.tgt_buckets = tgt_buckets
        self.seed = seed
        self.shuffle = shuffle

    def batches(self, epoch: int = 0) -> Iterator[dict]:
        by_bucket: dict[tuple[int, int], list[int]] = {}
        for i, s in enumerate(self.ds.samples):
            key = (pick_bucket(self.src_buckets, len(s.phones)),
                   pick_bucket(self.tgt_buckets, len(s.codes)))
            by_bucket.setdefault(key, []).append(i)

        rng = np.random.default_rng(self.seed + epoch)
        all_batches = []
        for (src_len, tgt_len), idxs in sorted(by_bucket.items()):
            idxs = np.asarray(idxs)
            if self.shuffle:
                rng.shuffle(idxs)
            for off in range(0, len(idxs), self.batch_size):
                all_batches.append((src_len, tgt_len,
                                    idxs[off: off + self.batch_size]))
        if self.shuffle:
            rng.shuffle(all_batches)

        local = self.batch_size // self.process_count
        mine = slice(self.process_index * local,
                     (self.process_index + 1) * local)
        for src_len, tgt_len, chunk in all_batches:
            idxs = list(chunk)
            # static shapes: pad short batches by repeating sample 0 with
            # loss weight 0 (the reference's last batch is just smaller)
            weights = [1.0] * len(idxs)
            while len(idxs) < self.batch_size:
                idxs.append(idxs[0])
                weights.append(0.0)
            idxs, weights = idxs[mine], weights[mine]
            yield collate([self.ds.samples[i] for i in idxs], src_len,
                          tgt_len, self.ds.src_pad_idx, self.ds.code_pad_idx,
                          sample_weight=weights)


def shard_for_host(indices: np.ndarray, process_index: int,
                   process_count: int) -> np.ndarray:
    """Per-process manifest shard, strided (the analog of
    DistributedSampler, reference utils/vocoder/train.py:97-100)."""
    return indices[process_index::process_count]
