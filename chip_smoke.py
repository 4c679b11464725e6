#!/usr/bin/env python3
"""Drive the PyTorch port (parrot_tts_tpu_torch) on one CUDA card and
check it. Run from the root of the checkout:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: name and power limit (nvidia-smi), torch / CUDA versions, TF32 flags;
2. build: every kernel of the serving path from csrc/ with nvcc (sm_90a);
3. kernel against plain: the flash-attention forward against its plain
   PyTorch version, H=2, d_head=128, at B=8 and T up to 3584 (with key
   padding, one all-masked row and a ragged T), at every (B, T) the
   serving phase gives it, and a d_head=64 case; max |diff| <= 1e-5 on
   rows with a valid key, all-masked rows exactly 0; kernel, plain, bound
   and scaled_dot_product_attention ms per shape;
4. serving at full width: the default TTEModelConfig (d_model 256, 4+4 FFT
   blocks, 2 heads of 128) and V1 VocoderModelConfig with seeded weights,
   through ParrotTTS.tts twice (deterministic, lengths len(units)*320,
   finite, the kernel launched once per FFT block per decode batch), then
   the same decode batches once more with plain attention on the card:
   durations and totals equal, max |dlogit| <= 1e-4, codes equal wherever
   the top-2 logit margin exceeds 1e-3;
5. profile: one more serve under torch.profiler (device time by kernel,
   the device's busy and idle share).

The second-to-last stdout line is a JSON object describing each kernel;
the last is {"ok": true, "device": {...}}. Without a CUDA device the
script exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SEED = 20261016
FP32_PEAK = 67e12            # H100 SXM float32 non-tensor FLOP/s (data sheet)
HBM_RATE = 3.35e12           # H100 SXM HBM3 bytes/s (data sheet)
ATOL = 1e-5
DLOGIT_TOL = 1e-4            # kernel decode against plain-attention decode
# (B, T, d_head) checked against the plain version: B=8 across T (a ragged
# T among them), then the (B, T) of every attention call of the serving
# phase (its decode plan: encoder buckets 64/128/256, decoder 1024/2048/
# 3584, with 3, 5 and 1 requests), then a narrower head
KERNEL_SHAPES = ([(8, t, 128) for t in (64, 128, 500, 768, 2048, 3584)]
                 + [(b, t, 128) for b, ts in ((3, (64, 1024)),
                                              (5, (128, 2048)),
                                              (1, (256, 3584))) for t in ts]
                 + [(8, 768, 64)])
REPORT_SHAPE = (5, 2048, 128)  # whose times go in the kernels line: the
                               # serving phase's largest decode batch
TEXTS = [
    "Hello there, how are you today?",
    "",
    "The quick brown fox jumps over the lazy dog near the quiet river bank.",
    "Speech synthesis turns written text into spoken audio, one sound at a "
    "time, and a vocoder then renders the waveform.",
    "We measured it twice.",
    "A long request makes the decoder work at its largest bucket: it has to "
    "carry many characters, so this sentence keeps going for a while, past "
    "two hundred characters, until the encoder needs its third source bucket.",
    "Numbers like 42 and 1999 are spelled out by the cleaner first.",
    "Short and sweet, this one fits the smallest bucket of all the buckets.",
    "The last request of the batch asks for a medium length answer, with a "
    "few commas, some pauses, and a period at the end.",
]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(b: int, h: int, t: int, d: int) -> tuple[float, str]:
    flops = 4.0 * b * h * t * t * d
    nbytes = 4.0 * (4 * b * h * t * d) + b * t     # Q, K, V, O; mask bytes
    ops_s, bytes_s = flops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"tf32 flags at start: matmul={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn={torch.backends.cudnn.allow_tf32} (the port turns both off"
          " around every exact=True forward)")
    return smi


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    log = kernels.build("flash_attn_fwd")
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  flash_attn_fwd: {line.strip()}")


def phase_kernel(fa, exact_numerics) -> dict:
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    rows = []
    for b, t, d in KERNEL_SHAPES:
        h = 2
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                    .astype(np.float32)).to(dev)
                   for _ in range(3))
        lengths = rng.integers(1, t + 1, size=b)
        lengths[0] = t
        mask_np = np.arange(t)[None, :] >= lengths[:, None]
        masked_row = b - 1 if b > 1 else None    # row 0 keeps every key
        if masked_row is not None:
            mask_np[masked_row] = True                    # all-masked row
        mask = torch.from_numpy(mask_np).to(dev)
        scale = 1.0 / math.sqrt(d)
        with exact_numerics(True):
            got = fa.flash_attention(q, k, v, mask, scale)
            want = fa.flash_attention_reference(q, k, v, mask, scale)
            torch.cuda.synchronize()
            keep = torch.ones(b, dtype=torch.bool, device=dev)
            if masked_row is not None:
                keep[masked_row] = False
                if not torch.equal(got[masked_row],
                                   torch.zeros_like(got[masked_row])):
                    raise AssertionError(f"B={b} T={t}: all-masked row is "
                                         "not exactly 0")
            err = float((got[keep] - want[keep]).abs().max())
            if not err <= ATOL:
                raise AssertionError(f"B={b} T={t} d={d}: max |diff| {err} "
                                     f"> {ATOL}")
            reps = max(3, min(50, int(2e5 / t)))
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask, scale), reps)
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_reference(q, k, v, mask, scale),
                max(3, reps // 4))
            attend = ~mask[:, None, None, :]
            library_ms = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=attend, scale=scale), reps)
        bound_ms, bound_by = attention_bound_ms(b, h, t, d)
        rows.append({"B": b, "H": h, "T": t, "d": d, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
        print(f"kernel B={b} T={t:5d} d={d:3d}: max|diff| {err:.3e}  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
              f"({bound_by})  sdpa {library_ms:.4f} ms")
        del q, k, v, got, want
    return {"rows": rows,
            "report": next(r for r in rows if (r["B"], r["T"], r["d"])
                           == REPORT_SHAPE),
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def phase_serving(fa, tcfg, vcfg, device=None):
    from parrot_tts_tpu_torch.core.device import exact_numerics
    from parrot_tts_tpu_torch.infer.serving import ParrotTTS
    from parrot_tts_tpu_torch.infer.tte_infer import make_batch
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.models.vocoder import generator
    from parrot_tts_tpu_torch.ops import attention
    from parrot_tts_tpu_torch.ops import length_regulator as lr
    from parrot_tts_tpu_torch.text.cleaners import english_cleaners
    from parrot_tts_tpu_torch.text.tokenizer import DFATokenizer

    gen = torch.Generator().manual_seed(SEED)
    tte_state = parrot.init_parrot(tcfg, gen)
    voc_state = generator.init_code_generator(vcfg, gen)
    # ~5 frames per token: exp(log 6) - 1, with a little spread
    tte_state["duration_predictor.proj.weight"] *= 0.2
    tte_state["duration_predictor.proj.bias"].fill_(math.log(6.0))
    tok = DFATokenizer([" "] + list("abcdefghijklmnopqrstuvwxyz,.?"))
    tts = ParrotTTS(tte_state, tcfg, voc_state, vcfg, tok, english_cleaners,
                    device=device)
    speakers = [i % tcfg.n_speaker for i in range(len(TEXTS))]
    tokens = [tts.tokenize(t) for t in TEXTS]
    plan = tts.plan(tokens)
    print("requests (tokens):", [len(s) for s in tokens])
    print("decode plan (s_len, out_len, n):",
          [(s, o, len(i)) for s, o, i in plan])
    if not {1024, 2048, 3584} <= {o for _, o, _ in plan}:
        raise AssertionError("the requests do not reach every decoder bucket")
    checked = {(b, t) for b, t, d in KERNEL_SHAPES
               if d == tcfg.d_model // tcfg.encoder.n_head}
    served = {(len(i), t) for s, o, i in plan for t in (s, o)}
    if device is None and not served <= checked:
        raise AssertionError(f"attention shapes {sorted(served - checked)} "
                             "of the plan were not checked against plain")
    n_blocks = tcfg.encoder.n_layer + tcfg.decoder.n_layer

    runs = []
    for run in range(2):
        fa.FLASH_FWD.launches = 0
        wavs = tts.tts(TEXTS, speakers=speakers)
        launches = fa.FLASH_FWD.launches
        st = tts.last_stats
        runs.append((wavs, launches, st))
        print(f"serve {run}: {st['audio_seconds']:.3f} audio-s in "
              f"{st['wall_s']:.3f} s = {st['audio_seconds_per_second']:.3f} "
              f"audio-s/s (TTE {st['tte_s']:.3f} s, vocoder "
              f"{st['vocoder_s']:.3f} s); decode batches "
              f"{st['decode_batches']}, flash launches {launches}")
        if launches != n_blocks * st["decode_batches"]:
            raise AssertionError(f"{launches} flash launches for "
                                 f"{st['decode_batches']} decode batches")
    (wavs, launches, _), (wavs2, _, _) = runs
    for i, (a, b) in enumerate(zip(wavs, wavs2)):
        if not np.array_equal(a, b):
            raise AssertionError(f"request {i}: serving is not deterministic")
    units = tts.predict_units(tokens, speakers)
    for i, (w, u) in enumerate(zip(wavs, units)):
        if len(w) != len(u) * vcfg.total_upsample:
            raise AssertionError(f"request {i}: {len(w)} samples for "
                                 f"{len(u)} units")
        if not np.isfinite(w).all():
            raise AssertionError(f"request {i}: non-finite samples")
    if len(wavs[1]) != 0:
        raise AssertionError("the empty request gave a non-empty waveform")
    if min(len(u) for i, u in enumerate(units) if TEXTS[i]) == 0:
        raise AssertionError("a non-empty request decoded to no units")

    # the same decode batches with plain attention on the card
    samples = [(s, speakers[i]) for i, s in enumerate(tokens)]
    near_ties = frames = 0
    for s_len, out_len, idxs in plan:
        batch = parrot.to_batch(make_batch(samples, idxs, s_len), tts.device)
        with torch.no_grad(), exact_numerics(True):
            logits_k, mask_k, logdur_k = parrot.apply_parrot(
                tts.tte, batch, out_len=out_len)
            with mock.patch.object(attention, "flash_attention",
                                   fa.flash_attention_reference):
                logits_p, mask_p, logdur_p = parrot.apply_parrot(
                    tts.tte, batch, out_len=out_len)
        dur_k = torch.where(batch["src_mask"],
                            lr.durations_from_log_pred(logdur_k), 0)
        dur_p = torch.where(batch["src_mask"],
                            lr.durations_from_log_pred(logdur_p), 0)
        if not (torch.equal(dur_k, dur_p) and torch.equal(mask_k, mask_p)):
            raise AssertionError(f"bucket {out_len}: durations differ")
        top2 = torch.topk(logits_p, 2, dim=-1).values
        clear = mask_p & (top2[..., 0] - top2[..., 1] > 1e-3)
        codes_k, codes_p = logits_k.argmax(-1), logits_p.argmax(-1)
        if not torch.equal(codes_k[clear], codes_p[clear]):
            raise AssertionError(f"bucket {out_len}: codes differ off ties")
        frames += int(mask_p.sum())
        near_ties += int((mask_p & ~clear).sum())
        dlogit = float((logits_k - logits_p)[mask_p].abs().max())
        if not dlogit <= DLOGIT_TOL:
            raise AssertionError(f"bucket {out_len}: max |dlogit| {dlogit} "
                                 f"> {DLOGIT_TOL}")
        print(f"plain-attention decode, bucket ({s_len}, {out_len}) x "
              f"{len(idxs)}: durations equal, codes equal off ties; "
              f"max |dlogit| {dlogit:.3e}")
    print(f"frames {frames}, near-tie frames (margin <= 1e-3) {near_ties}")
    return launches, lambda: tts.tts(TEXTS, speakers=speakers)


def phase_profile(serve) -> None:
    """One more serve under torch.profiler: device time by kernel and the
    device's busy share of the wall time. Busy time is the union of the
    kernels' intervals; the profiler's device-side annotations of aten ops
    span those same kernels and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print("profile: the profiler recorded no device time (not measured)")
        return
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in kernels):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    busy_ms = busy_us / 1e3
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    print(f"profile: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%; {len(kernels)} kernels, "
          f"{sum(ms for ms, _ in by_name.values()):.3f} ms summed")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from parrot_tts_tpu_torch.core import kernels
    from parrot_tts_tpu_torch.core.config import (TTEModelConfig,
                                                  VocoderModelConfig)
    from parrot_tts_tpu_torch.core.device import exact_numerics
    from parrot_tts_tpu_torch.ops import flash_attention as fa

    phase_card()
    phase_build(kernels)
    kern = phase_kernel(fa, exact_numerics)
    # full width: d_model 256, 4+4 FFT blocks of 2 heads, V1 vocoder
    launches, serve = phase_serving(fa, TTEModelConfig(n_speaker=4),
                                    VocoderModelConfig())
    phase_profile(serve)
    rep = kern["report"]
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "parrot_tts_tpu/ops/attention.py:153",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": rep["ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
