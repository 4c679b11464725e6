"""Bucketed TTE decode: token sequences -> predicted HuBERT units, and
their manifest entry point, which writes them as predictions.txt.

Port of `parrot_tts_tpu/infer/tte_infer.py::{max_decode_len,
decode_buckets, predict_units, write_predictions}` (reference
`inference.py`). Samples are decoded batched in static (s_len, out_len)
buckets; a sample whose predicted total duration overflows its bucket is
re-decoded in a larger one (the reference's dynamic shapes never
truncate). `decode_buckets(mesh=)` shards each batch over a mesh's data
axis.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch

from parrot_tts_tpu_torch.core import mesh as meshlib
from parrot_tts_tpu_torch.core.config import TTEModelConfig
from parrot_tts_tpu_torch.data.audio_io import duration_seconds
from parrot_tts_tpu_torch.data.tte_data import TTEDataset, pick_bucket
from parrot_tts_tpu_torch.models.tte import parrot


def max_decode_len(model_cfg: TTEModelConfig) -> int:
    """Largest usable decoder bucket = the PE table's padded row count
    (models/tte/parrot.py::pos_table)."""
    return -(-model_cfg.max_len // 128) * 128


def make_batch(samples: list[tuple[np.ndarray, int]], chunk: list[int],
               s_len: int) -> dict:
    """Pad the chunk's (phone_ids, speaker) samples to s_len (numpy)."""
    b = len(chunk)
    phones = np.zeros((b, s_len), np.int64)
    src_mask = np.zeros((b, s_len), bool)
    speaker = np.zeros((b,), np.int64)
    for j, gi in enumerate(chunk):
        seq, spk = samples[gi]
        n = min(len(seq), s_len)
        phones[j, :n] = seq[:n]
        src_mask[j, :n] = True
        speaker[j] = spk
    return {"phones": phones, "src_mask": src_mask, "speaker": speaker}


def _infer_sharded(replicas: list, mesh: meshlib.Mesh, batch: dict, *,
                   out_len: int, exact, with_margin: bool) -> list:
    """infer_codes over a mesh: rows padded to a multiple of the data
    axis with repeats of row 0, this process's rows (`local_rows`) split
    over its devices, each shard decoded on its device's replica, and the
    outputs fetched globally (numpy, padding rows dropped)."""
    b = len(batch["phones"])
    b_pad = meshlib.pad_rows_to_multiple(b, mesh.n_data)
    mine = meshlib.local_rows(b_pad)
    rows = {k: np.concatenate([v, np.repeat(v[:1], b_pad - b, axis=0)])[mine]
            for k, v in batch.items()}
    devs = mesh.local_data
    loc = len(rows["phones"]) // len(devs)
    outs = [parrot.infer_codes(
        rep, {k: v[i * loc: (i + 1) * loc] for k, v in rows.items()},
        out_len=out_len, exact=exact, with_margin=with_margin, device=dev)
        for i, (rep, dev) in enumerate(zip(replicas, devs))]
    return [meshlib.fetch([o[j] for o in outs])[:b]
            for j in range(len(outs[0]))]


def decode_buckets(model, samples: list[tuple[np.ndarray, int]],
                   plan: list[tuple[int, int, list[int]]], *,
                   batch_size: int, exact: bool | str = True,
                   margin_threshold: float = 0.5,
                   device: torch.device | str | None = None,
                   stats: dict | None = None,
                   mesh: meshlib.Mesh | None = None) -> list[np.ndarray]:
    """Greedy decode over a (s_len, out_len, indices) bucket plan; returns
    one int32 unit array per sample. exact: a mode of `parrot.infer_codes`,
    or "hybrid": decode in "selective" (IEEE lengths, a 1-pass TF32
    decoder) reading back each sample's min top-2 logit margin, then decode
    the samples whose margin is below `margin_threshold` (where an argmax
    could flip) again in "selective-high", through the same bucket and
    overflow plan, and keep those units. When a dict is given,
    `stats["decode_batches"]` counts the infer_codes calls made, and
    `stats["hybrid_flagged"]` the samples a hybrid decode re-decoded.

    mesh: shard every batch over the mesh's data axis (`_infer_sharded`);
    model is then a `Parrot` (replicated here) or the list of replicas
    `core/mesh.py::replicated` made for the mesh. Every process gets the
    global outputs, so the overflow retries and the hybrid's re-decode
    are planned alike on every rank."""
    parrot.check_exact(exact, hybrid=True)
    if mesh is not None and not isinstance(model, list):
        model = meshlib.replicated(mesh, model)
    cfg = (model[0] if mesh is not None else model).cfg
    hybrid = exact == "hybrid"
    fast_exact = "selective" if hybrid else exact
    flagged: dict[tuple[int, int], list[int]] = {}
    cap = max_decode_len(cfg)
    results: list[np.ndarray | None] = [None] * len(samples)
    pending = list(plan)
    while pending:
        s_len, out_len, idxs = pending.pop(0)
        retry: dict[tuple[int, int], list[int]] = {}
        for off in range(0, len(idxs), batch_size):
            chunk = idxs[off : off + batch_size]
            batch = make_batch(samples, chunk, s_len)
            if mesh is None:
                out = [x.cpu().numpy() for x in parrot.infer_codes(
                    model, batch, out_len=out_len, exact=fast_exact,
                    with_margin=hybrid, device=device)]
            else:
                out = _infer_sharded(model, mesh, batch, out_len=out_len,
                                     exact=fast_exact, with_margin=hybrid)
            if stats is not None:
                stats["decode_batches"] = stats.get("decode_batches", 0) + 1
            codes, mask, total = out[:3]
            margin = out[3] if hybrid else None
            for j, gi in enumerate(chunk):
                if total[j] > out_len and out_len < cap:
                    need = min(-(-int(total[j]) // 128) * 128, cap)
                    retry.setdefault((s_len, need), []).append(gi)
                    continue
                if total[j] > out_len:
                    warnings.warn(
                        f"sample {gi}: predicted duration {int(total[j])}"
                        f" frames exceeds the model's positional-table "
                        f"cap {cap}; output truncated")
                results[gi] = codes[j][mask[j]].astype(np.int32)
                if hybrid and margin[j] < margin_threshold:
                    flagged.setdefault((s_len, out_len), []).append(gi)
        for (rs, rt), ridx in sorted(retry.items()):
            pending.append((rs, rt, ridx))

    if hybrid:
        if stats is not None:
            stats["hybrid_flagged"] = sum(map(len, flagged.values()))
        if flagged:
            # the near-tie samples again in "selective-high", in the
            # buckets where their fast decode ended
            again = decode_buckets(
                model, samples, [(s, t, i) for (s, t), i in
                                 sorted(flagged.items())],
                batch_size=batch_size, exact="selective-high", device=device,
                stats=stats, mesh=mesh)
            for idxs in flagged.values():
                for gi in idxs:
                    results[gi] = again[gi]
    return results  # type: ignore[return-value]


def predict_units(model: parrot.Parrot, dataset: TTEDataset, *,
                  batch_size: int = 16,
                  src_buckets: tuple[int, ...] = (64, 128, 192, 256),
                  out_len_per_token: int = 16,
                  device=None) -> list[dict]:
    """Greedy-decode every sample of the dataset (the exact decode),
    bucketed by token count (`pick_bucket`) with the decoder bucket
    min(s_len * out_len_per_token, cap); returns one {"hubert": "u u ..."}
    per sample."""
    by_bucket: dict[int, list[int]] = {}
    for i, s in enumerate(dataset.samples):
        by_bucket.setdefault(pick_bucket(src_buckets, len(s.phones)),
                             []).append(i)
    cap = max_decode_len(model.cfg)
    plan = [(s_len, min(s_len * out_len_per_token, cap), idxs)
            for s_len, idxs in sorted(by_bucket.items())]
    samples = [(s.phones, s.speaker) for s in dataset.samples]
    units = decode_buckets(model, samples, plan, batch_size=batch_size,
                           exact=True, device=device)
    return [{"hubert": " ".join(map(str, u.tolist()))} for u in units]


def write_predictions(model: parrot.Parrot, dataset: TTEDataset,
                      out_path: str | Path, **kwargs) -> Path:
    """predictions.txt in the reference format (inference.py:70-72): one
    {'audio', 'hubert', 'duration'} line per sample, duration the audio's
    true length in seconds, or the ground-truth code count at 320 samples
    per code and 16 kHz where the file cannot be read (with a warning).
    kwargs go to `predict_units`."""
    out_path = Path(out_path)
    preds = predict_units(model, dataset, **kwargs)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    missing = 0
    with open(out_path, "w") as f:
        for s, p in zip(dataset.samples, preds):
            audio = s.audio or f"{s.id}.wav"
            try:
                dur = duration_seconds(audio)
            except Exception:
                missing += 1
                dur = len(s.codes) * 320 / 16000.0
            f.write(str({"audio": audio, "hubert": p["hubert"],
                         "duration": dur}) + "\n")
    if missing:
        warnings.warn(
            f"{missing}/{len(dataset.samples)} audio files were unreadable; "
            "their 'duration' fields fall back to GT-code-count seconds")
    return out_path
