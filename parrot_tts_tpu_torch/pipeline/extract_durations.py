"""Duration extraction: batched posteriors on the device, the
monotonic DP on a host thread pool; port of
`parrot_tts_tpu/pipeline/extract_durations.py`.

Reference: `utils/aligner/extract_durations.py`: phase A dumps per-item
softmax posteriors from batched model inference; phase B maps dijkstra
over the items with a process pool. Here phase A runs the aligner in
batches of the JAX package's order (`np.argsort` of the frame counts) and
padding (to a multiple of 64 frames), so each item's posteriors are the
JAX package's; phase B runs the built DP (`ops/monotonic_align.py`, which
releases the interpreter lock inside ctypes) on a thread pool while the
next batch runs on the device.
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from pathlib import Path

import numpy as np
import torch

from parrot_tts_tpu_torch.data.aligner_data import AlignerDataset
from parrot_tts_tpu_torch.models.aligner.model import Aligner
from parrot_tts_tpu_torch.ops.monotonic_align import (extract_durations,
                                                      extract_durations_beam)
from parrot_tts_tpu_torch.train.aligner import posteriors


def extract_all_durations(data_dir: str | Path, model: Aligner, *,
                          batch_size: int = 8, max_workers: int = 8,
                          method: str = "dijkstra", beam_width: int = 10,
                          timings: dict | None = None) -> dict:
    """Writes outputs/durations/<stem>.npy per item (reference layout,
    utils/aligner/paths.py) with `model` on its own device. Returns
    {'items': n}.

    method: 'dijkstra' (the monotonic DP, the reference default) or 'beam'
    (k-best beam search, the reference Extractor's alternative,
    utils/aligner/extract_durations.py:35-36). timings, when a dict is
    given, gets the wall seconds of the posterior batches (upload, model,
    readback: `device_s`), the summed seconds of the path jobs (`dp_s`,
    across threads) and of the whole call (`wall_s`)."""
    if method not in ("dijkstra", "beam"):
        raise ValueError(f"unknown duration extraction method: {method!r}")
    t0 = time.perf_counter()
    device = next(model.parameters()).device
    data_dir = Path(data_dir)
    out_dir = data_dir / "outputs" / "durations"
    out_dir.mkdir(parents=True, exist_ok=True)

    ds = AlignerDataset(data_dir)
    order = np.argsort([n for (_, n, _) in ds.index])  # length-sorted batches

    jobs = []
    device_s = 0.0
    with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
        for off in range(0, len(order), batch_size):
            idxs = order[off : off + batch_size]
            items = [ds.load(i) for i in idxs]
            max_t = max(len(m) for m, _ in items)
            max_t = ((max_t + 63) // 64) * 64    # the JAX package's padding
            mel = np.zeros((len(items), max_t, items[0][0].shape[1]),
                           np.float32)
            for i, (m, _) in enumerate(items):
                mel[i, : len(m)] = m
            t1 = time.perf_counter()
            post = posteriors(model, torch.from_numpy(mel).to(device)
                              ).cpu().numpy()
            device_s += time.perf_counter() - t1
            for i, gi in enumerate(idxs):
                stem, n_frames, _ = ds.index[gi]
                jobs.append(pool.submit(_extract_one, out_dir, stem,
                                        items[i][1], post[i, :n_frames],
                                        method, beam_width))
        results = [j.result() for j in jobs]
    if timings is not None:
        timings.update(device_s=device_s, dp_s=sum(s for _, s in results),
                       wall_s=time.perf_counter() - t0)
    return {"items": len(results)}


def _extract_one(out_dir: Path, stem: str, tokens: np.ndarray,
                 post: np.ndarray, method: str, beam_width: int
                 ) -> tuple[str, float]:
    t0 = time.perf_counter()
    tokens = np.asarray(tokens, np.int64)
    if method == "beam":
        durs = extract_durations_beam(tokens, post, beam_width)[0][0]
    else:
        durs = extract_durations(tokens, post)
    np.save(out_dir / f"{stem}.npy", durs)
    return stem, time.perf_counter() - t0
