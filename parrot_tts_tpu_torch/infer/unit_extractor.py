"""Batched HuBERT unit extraction: a port of
`parrot_tts_tpu/infer/unit_extractor.py`.

The reference codes one wav at a time (`utils/hubert_extraction/
extractor.py:56-81`, `hubert_api.py:49-68`). Here wavs are grouped by
length bucket and batched on the device: the encoder (`models/hubert/
model.py`, masked so padding never reaches a valid frame) and the k-means
argmin run in IEEE float32, under `exact_numerics(True)`, since a TF32
feature flips the nearest centroid on near-ties. Wavs longer than
`max_chunk` samples take the reference's chunking rule: slices of
max_chunk coded independently and concatenated (hubert_api.py:60-69).

Host batches are padded into pinned memory and copied without blocking
(by an upload thread unless upload_thread=False); up to four batches are
queued on the device ahead of the in-order readback of their codes, so
the host pads and reads back while the card computes.
"""

from __future__ import annotations

import concurrent.futures as cf
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch

from parrot_tts_tpu_torch.core.config import HubertConfig
from parrot_tts_tpu_torch.core.device import (batch_to_device, exact_numerics,
                                              resolve_device)
from parrot_tts_tpu_torch.data.audio_io import read_wav
from parrot_tts_tpu_torch.models.hubert import model as hubert_model

WINDOW = 4          # batches queued on the device ahead of the readback
_BATCH_DTYPES = {"wav": torch.float32, "n_samples": torch.int64}


def _default_buckets(cfg: HubertConfig) -> tuple[int, ...]:
    """2.56 s (128-frame) steps up to 38.4 s, then max_chunk: at most
    2.56 s of padding per wav below 38.4 s."""
    step = 128 * cfg.frame_hop
    return tuple(step * i for i in range(1, 16)) + (cfg.max_chunk,)


class UnitExtractor:
    """wav -> HuBERT codes, batched per length bucket; the API of the
    reference `HubertInference` (extractor.py:10-23: `get_codes_from_path`,
    `get_codes`).

    state: a `HubertModel` state dict (HF keys; `models/hubert/convert.py`
    reads checkpoints into one); km_centers: (K, D) k-means centers.
    device: default the CUDA card (raises without one); "cpu" runs on the
    host."""

    def __init__(self, state: dict, cfg: HubertConfig,
                 km_centers: np.ndarray, *, output_layer: int | None = None,
                 buckets: Sequence[int] | None = None, batch_size: int = 8,
                 device=None):
        self.cfg = cfg
        self.output_layer = (cfg.output_layer if output_layer is None
                             else output_layer)
        if not 1 <= self.output_layer <= cfg.n_layer:
            raise ValueError(f"output_layer {self.output_layer} not in "
                             f"[1, {cfg.n_layer}]")
        self.device = resolve_device(device)
        self.model = hubert_model.HubertModel(cfg)
        self.model.load_state_dict(state, strict=True)
        self.model.to(self.device).eval()
        self.centers = torch.as_tensor(np.asarray(km_centers, np.float32),
                                       device=self.device)
        self.buckets = tuple(sorted(buckets or _default_buckets(cfg)))
        self.batch_size = batch_size

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def batches(self, wavs: Sequence[np.ndarray]) -> list[list[int]]:
        """The batches `codes_for_wavs` runs: indices of the wavs up to
        max_chunk samples, grouped by bucket (first-seen order) into
        groups of at most batch_size."""
        groups: dict[int, list[int]] = {}
        for i, w in enumerate(wavs):
            if len(w) <= self.cfg.max_chunk:
                groups.setdefault(self._bucket(len(w)), []).append(i)
        return [idxs[s: s + self.batch_size] for idxs in groups.values()
                for s in range(0, len(idxs), self.batch_size)]

    def _prepare_batch(self, wavs: Sequence[np.ndarray]) -> dict:
        """Host side of a batch: pad to the bucket and start the copy to
        the device (pinned memory, non-blocking on a card)."""
        lens = np.array([len(w) for w in wavs], np.int64)
        batch = np.zeros((len(wavs), self._bucket(int(lens.max()))),
                         np.float32)
        for i, w in enumerate(wavs):
            batch[i, : len(w)] = w
        return batch_to_device({"wav": batch, "n_samples": lens},
                               _BATCH_DTYPES, self.device)

    def _run(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Queue the encoder and the k-means argmin of one batch; returns
        (codes, n_frames) on the device, not read back."""
        with torch.no_grad(), exact_numerics(True):
            feats, n_frames = self.model(batch["wav"], batch["n_samples"],
                                         self.output_layer)
            return hubert_model.kmeans_predict(feats, self.centers), n_frames

    @staticmethod
    def _fetch(launched) -> list[np.ndarray]:
        codes, n_frames = (t.cpu().numpy() for t in launched)
        return [codes[i, : n_frames[i]].astype(np.int32)
                for i in range(codes.shape[0])]

    def get_codes(self, wav: np.ndarray) -> np.ndarray:
        """Codes of one wav, chunked at max_chunk like the reference."""
        wav = np.asarray(wav, np.float32)
        step = self.cfg.max_chunk
        outs = [self._fetch(self._run(self._prepare_batch(
            [wav[s: s + step]])))[0] for s in range(0, max(len(wav), 1), step)]
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def get_codes_from_path(self, wav_path: str | Path) -> np.ndarray:
        wav, sr = read_wav(wav_path)
        if sr != self.cfg.sample_rate:
            raise ValueError(
                f"{wav_path}: sample rate {sr} != {self.cfg.sample_rate} "
                "(the reference resamples via librosa; resample offline)")
        return self.get_codes(wav)

    def codes_for_wavs(self, wavs: Iterable[np.ndarray],
                       upload_thread: bool = True,
                       defer_readback: bool = False) -> list[np.ndarray]:
        """Codes of every wav, in order: the wavs of each of `batches`
        coded together, those longer than max_chunk alone (`get_codes`).

        upload_thread=True pads and copies up to WINDOW batches ahead in a
        thread while the main thread queues the encoder. Up to WINDOW
        batches are queued on the device ahead of the oldest's readback.
        defer_readback=True keeps every batch's codes on the device until
        all batches are queued, then reads them back in one pass."""
        wavs = [np.asarray(w, np.float32) for w in wavs]
        out: list[np.ndarray | None] = [
            self.get_codes(w) if len(w) > self.cfg.max_chunk else None
            for w in wavs]
        jobs = self.batches(wavs)

        inflight: list = []

        def drain(keep: int) -> None:
            while len(inflight) > keep:
                grp, launched = inflight.pop(0)
                for i, c in zip(grp, self._fetch(launched)):
                    out[i] = c

        keep = len(jobs) if defer_readback else WINDOW - 1
        if not upload_thread:
            for grp in jobs:
                inflight.append((grp, self._run(self._prepare_batch(
                    [wavs[i] for i in grp]))))
                drain(keep)
        else:
            with cf.ThreadPoolExecutor(max_workers=1) as uploader:
                def upload(j):
                    return uploader.submit(self._prepare_batch,
                                           [wavs[i] for i in jobs[j]])

                preps = [upload(j) for j in range(min(WINDOW, len(jobs)))]
                for j, grp in enumerate(jobs):
                    batch = preps[j].result()
                    preps[j] = None     # the wavs' device copy dies with _run
                    if j + WINDOW < len(jobs):
                        preps.append(upload(j + WINDOW))
                    inflight.append((grp, self._run(batch)))
                    drain(keep)
        drain(0)
        return out  # type: ignore[return-value]
