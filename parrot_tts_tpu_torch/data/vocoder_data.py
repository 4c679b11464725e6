"""Vocoder GAN data: audio + code manifests -> fixed-size segment batches.

Copies of `VocoderDataset` and `VocoderLoader` from
`parrot_tts_tpu/data/vocoder_data.py` (the reference's `CodeDataset`,
`utils/vocoder/dataset.py:145-254`): load, peak-normalize x0.95, trim
the audio to the codes, repeat-pad short clips, and an aligned random
crop of `segment_size` samples, from the same `np.random.default_rng(seed +
epoch)` in the same order, so both packages yield the same batches. The
ground-truth loss mel is computed on the device in the train step. With
`with_f0=True` each batch also carries its code-rate pitch track
(`code_rate_f0`), extracted on the loader's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

from parrot_tts_tpu_torch.core.device import resolve_device
from parrot_tts_tpu_torch.data.audio_io import load_normalized
from parrot_tts_tpu_torch.data.manifest import parse_speaker, read_manifest
from parrot_tts_tpu_torch.ops.f0 import estimate_f0, f0_hop, f0_to_code_rate


@dataclass
class VocoderItem:
    audio_path: Path
    code: np.ndarray         # (Tc,) int32
    speaker_id: int


class VocoderDataset:
    def __init__(self, manifest_path: str | Path, *, segment_size: int = 8960,
                 code_hop_size: int = 320, multispkr: str | None = "_",
                 speaker_ids: dict[str, int] | None = None):
        self.segment_size = segment_size
        self.code_hop_size = code_hop_size
        self.multispkr = multispkr

        entries = read_manifest(manifest_path)
        speakers = sorted({parse_speaker(e["audio"], multispkr)
                           for e in entries}) if multispkr else []
        # the reference sorts the observed speaker set (dataset.py:168-175)
        self.spkr_to_id = (speaker_ids if speaker_ids is not None
                           else {s: i for i, s in enumerate(speakers)})
        self.items = [
            VocoderItem(
                audio_path=Path(e["audio"]),
                code=np.asarray([int(c) for c in e["hubert"].split(" ")],
                                np.int32),
                speaker_id=(self.spkr_to_id[parse_speaker(
                    e["audio"], multispkr)] if multispkr else 0),
            )
            for e in entries
        ]

    def __len__(self):
        return len(self.items)

    def load_item(self, idx: int, rng: np.random.Generator) -> dict:
        """One (code segment, audio segment) pair, reference __getitem__
        semantics (dataset.py:204-246) with split=True, the one value the
        trainer and validation use."""
        it = self.items[idx]
        audio, _ = load_normalized(it.audio_path)

        # trim to code alignment (dataset.py:220-224)
        code_len = min(len(audio) // self.code_hop_size, len(it.code))
        code = it.code[:code_len]
        audio = audio[: code_len * self.code_hop_size]

        # repeat-pad short clips (dataset.py:226-228)
        while len(audio) < self.segment_size:
            audio = np.concatenate([audio, audio])
            code = np.concatenate([code, code])

        audio, code = self._sample_interval(audio, code, rng)
        return {"audio": audio.astype(np.float32), "code": code,
                "spkr": it.speaker_id, "filename": str(it.audio_path)}

    def _sample_interval(self, audio: np.ndarray, code: np.ndarray,
                         rng: np.random.Generator):
        """Aligned random crop (reference _sample_interval,
        dataset.py:182-202): the audio window covers a whole number of code
        frames."""
        seq_len = self.segment_size
        hop = self.code_hop_size        # lcm(1, hop) == hop
        max_start = len(audio) // hop - seq_len // hop
        start = int(rng.integers(0, max_start + 1))
        return (audio[start * hop : start * hop + seq_len],
                code[start : start + seq_len // hop])


def code_rate_f0(audio: np.ndarray, code_len: int, code_hop_size: int,
                 f0_kwargs: dict, device) -> np.ndarray:
    """(B, 1, code_len) float32 pitch of (B, N) audio at the code rate:
    `estimate_f0` on `device`, pooled over code_hop_size // f0 hop frames
    per code (4 at 16 kHz)."""
    track = estimate_f0(audio, device=device, **f0_kwargs)
    per = max(1, code_hop_size // f0_hop(**f0_kwargs))
    return f0_to_code_rate(track, code_len, per).cpu().numpy()


class VocoderLoader:
    """Deterministic epoch iterator with per-process slicing; fixed shapes.

    `batch_size` is the GLOBAL batch; it must divide by `process_count`,
    every process derives the same global schedule from the shared seed and
    takes its contiguous `batch_size / process_count` slice of each global
    batch (the reference divides its global batch across DDP workers,
    `utils/vocoder/train.py:279`).

    with_f0=True adds batch["f0"] (`code_rate_f0`; `f0_kwargs` go to
    `estimate_f0`, for corpora off the 16 kHz / speech-band defaults),
    extracted on `device`: default the CUDA card (raises without one);
    a host-side loader passes device="cpu"."""

    def __init__(self, dataset: VocoderDataset, batch_size: int,
                 seed: int = 1234, process_index: int = 0,
                 process_count: int = 1, with_f0: bool = False,
                 f0_kwargs: dict | None = None, device=None):
        if batch_size % process_count != 0:
            raise ValueError(
                f"global batch_size={batch_size} must be divisible by "
                f"process_count={process_count} (each process takes an "
                f"equal slice of every global batch)")
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.with_f0 = with_f0
        self.f0_kwargs = dict(f0_kwargs or {})
        self.device = resolve_device(device) if with_f0 else None

    def batches(self, epoch: int = 0) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + epoch)
        order = np.arange(len(self.ds))
        rng.shuffle(order)
        if 0 < len(order) < self.batch_size:
            # tiny datasets: cycle the indices so one full batch exists;
            # each occurrence draws its own random crop below (load_item
            # advances rng), i.e. sampling with replacement
            order = np.resize(order, self.batch_size)
        local = self.batch_size // self.process_count
        for b in range(len(order) // self.batch_size):
            idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
            idxs = idxs[self.process_index * local
                        : (self.process_index + 1) * local]
            items = [self.ds.load_item(i, rng) for i in idxs]
            batch = {
                "audio": np.stack([it["audio"] for it in items]),
                "code": np.stack([it["code"] for it in items]),
                "spkr": np.asarray([it["spkr"] for it in items], np.int32),
                "filenames": [it["filename"] for it in items],
            }
            if self.with_f0:
                batch["f0"] = code_rate_f0(
                    batch["audio"], batch["code"].shape[1],
                    self.ds.code_hop_size, self.f0_kwargs, self.device)
            yield batch
