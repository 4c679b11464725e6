"""Bucketed TTE decode: token sequences -> predicted HuBERT units.

Port of `parrot_tts_tpu/infer/tte_infer.py::{max_decode_len,
decode_buckets}`, single device: no mesh and no hybrid mode. Samples are
decoded batched in static (s_len, out_len) buckets; a sample whose
predicted total duration overflows its bucket is re-decoded in a larger
one (the reference's dynamic shapes never truncate).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from parrot_tts_tpu_torch.core.config import TTEModelConfig
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


def decode_buckets(model: parrot.Parrot, samples: list[tuple[np.ndarray, int]],
                   plan: list[tuple[int, int, list[int]]], *,
                   batch_size: int, exact: bool = True,
                   device: torch.device | str | None = None,
                   stats: dict | None = None) -> list[np.ndarray]:
    """Greedy decode over a (s_len, out_len, indices) bucket plan; returns
    one int32 unit array per sample. `stats["decode_batches"]`, when a dict
    is given, counts the infer_codes calls made."""
    cap = max_decode_len(model.cfg)
    results: list[np.ndarray | None] = [None] * len(samples)
    pending = list(plan)
    while pending:
        s_len, out_len, idxs = pending.pop(0)
        retry: dict[tuple[int, int], list[int]] = {}
        for off in range(0, len(idxs), batch_size):
            chunk = idxs[off : off + batch_size]
            codes, mask, total = parrot.infer_codes(
                model, make_batch(samples, chunk, s_len), out_len=out_len,
                exact=exact, device=device)
            if stats is not None:
                stats["decode_batches"] = stats.get("decode_batches", 0) + 1
            codes, mask, total = (codes.cpu().numpy(), mask.cpu().numpy(),
                                  total.cpu().numpy())
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
        for (rs, rt), ridx in sorted(retry.items()):
            pending.append((rs, rt, ridx))
    return results  # type: ignore[return-value]
