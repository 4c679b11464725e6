#!/usr/bin/env python3
"""Drive the PyTorch port (parrot_tts_tpu_torch) on one CUDA card and
check it. Run from the root of the checkout:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: name and power limit (nvidia-smi), torch / CUDA versions, TF32 flags;
2. build: the three kernels from csrc/ with nvcc (sm_90a), one nvcc per
   source in parallel, with each one's ptxas register and spill report;
3. flash attention against plain: the flash-attention forward against its
   plain PyTorch version, H=2, d_head=128, at B=8 and T up to 3584 (with
   key padding, one all-masked row and a ragged T), at every (B, T) the
   serving phase gives it, and a d_head=64 case; max |diff| <= 1e-5 on rows
   with a valid key, all-masked rows exactly 0; kernel, plain, bound and
   scaled_dot_product_attention ms per shape;
4. serving at full width: the default TTEModelConfig (d_model 256, 4+4 FFT
   blocks, 2 heads of 128) and V1 VocoderModelConfig with seeded weights,
   through ParrotTTS.tts twice (deterministic, lengths len(units)*320,
   finite, the kernel launched once per FFT block per decode batch), then
   the same decode batches once more with plain attention on the card:
   durations and totals equal, max |dlogit| <= 1e-4, codes equal wherever
   the top-2 logit margin exceeds 1e-3;
5. fused MRF against plain: the fused-MRF kernel at every (B, T, C) the
   fused serve gives it (the 64-, 32- and 16-channel stages of each vocoder
   batch), a ragged T and a batch whose rows end at different lengths;
   max |diff| <= 1e-5 * max |plain|; kernel, plain and bound ms;
6. int8 conv against plain: the int8 conv kernel at every distinct site
   shape of every int8-static vocoder batch, with that batch's rows (5
   polyphase upsamples, the MRF convs at k 3/7/11 and dilation 1/3/5 with
   the leaky epilogue and without it; the per-channel scale broadcast over
   the batch, as the serve passes it), bit-identical; kernel, plain and
   bound ms;
7. fused serve: ParrotTTS with VocoderModelConfig(fused_mrf=True) on the
   same requests and weights: waveforms within 1e-5 of phase 4's, 3 fused
   launches per vocoder batch, each at a shape phase 5 checked;
8. int8-static serve: ParrotTTS with VocoderModelConfig(quant="int8-static"),
   calibrated explicitly on a batch built from the serve's own units, served
   twice: deterministic, lengths len(units)*320, finite, 95 int8 conv
   launches per vocoder batch, each at a shape phase 6 checked, SNR >= 15
   dB against phase 4's waveforms over all requests and for each one;
9. profile: one more float serve and one more int8-static serve under
   torch.profiler (device time by kernel, the device's busy and idle share).

The second-to-last stdout line is a JSON object describing each kernel;
the last is {"ok": true, "device": {...}}. Without a CUDA device the
script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
INT8_PEAK = 1979e12          # H100 SXM int8 dense tensor-core OP/s (data sheet)
HBM_RATE = 3.35e12           # H100 SXM HBM3 bytes/s (data sheet)
ATOL = 1e-5
DLOGIT_TOL = 1e-4            # kernel decode against plain-attention decode
MRF_RTOL = 1e-5              # fused MRF: max |diff| <= MRF_RTOL * max |plain|
FUSED_SERVE_ATOL = 1e-5      # fused serve against the float serve
SNR_MIN_DB = 15.0            # int8-static serve against the float serve: the
                             # JAX package's envelope for random weights
INT8_SITES = 95              # int8 convs per V1 vocoder batch
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


@contextlib.contextmanager
def recording(module, name: str, key):
    """Patch module.name with a wrapper that adds key(*args, **kwargs) of
    every call to the yielded set, then calls the real function."""
    seen: set = set()
    real = getattr(module, name)

    def spy(*args, **kwargs):
        seen.add(key(*args, **kwargs))
        return real(*args, **kwargs)

    with mock.patch.object(module, name, spy):
        yield seen


def mrf_key(x, w, b, plan) -> tuple:
    return tuple(x.shape)


def int8_key(xq, wt, scale, bias=None, *, pads, dilation=1, leaky=None
             ) -> tuple:
    """(B, T, Ci, Co, K, dilation, pads, leaky) of an int8 conv call."""
    b, t, ci = xq.shape
    k, co, _ = wt.shape
    return (b, t, ci, co, k, dilation, tuple(pads), leaky)


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
    logs = kernels.build("flash_attn_fwd", "fused_mrf", "int8_conv")
    print(f"build (3 nvcc in parallel): {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


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


def make_tts(tcfg, vcfg, device=None):
    """ParrotTTS on weights made from SEED: every call gives the same."""
    from parrot_tts_tpu_torch.infer.serving import ParrotTTS
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.models.vocoder import generator
    from parrot_tts_tpu_torch.text.cleaners import english_cleaners
    from parrot_tts_tpu_torch.text.tokenizer import DFATokenizer

    gen = torch.Generator().manual_seed(SEED)
    tte_state = parrot.init_parrot(tcfg, gen)
    voc_state = generator.init_code_generator(vcfg, gen)
    # ~5 frames per token: exp(log 6) - 1, with a little spread
    tte_state["duration_predictor.proj.weight"] *= 0.2
    tte_state["duration_predictor.proj.bias"].fill_(math.log(6.0))
    tok = DFATokenizer([" "] + list("abcdefghijklmnopqrstuvwxyz,.?"))
    return ParrotTTS(tte_state, tcfg, voc_state, vcfg, tok, english_cleaners,
                     device=device)


def vocoder_batches(units) -> list[tuple[int, int]]:
    """(rows, code length) of each vocoder batch: units by length bucket."""
    from parrot_tts_tpu_torch.data.tte_data import pick_bucket
    from parrot_tts_tpu_torch.infer.synthesize import CODE_BUCKETS

    rows: dict[int, int] = {}
    for u in units:
        t = pick_bucket(CODE_BUCKETS, len(u))
        rows[t] = rows.get(t, 0) + 1
    return [(n, t) for t, n in sorted(rows.items())]


def phase_serving(fa, tcfg, vcfg, device=None) -> dict:
    from parrot_tts_tpu_torch.core.device import exact_numerics
    from parrot_tts_tpu_torch.infer.tte_infer import make_batch
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.ops import attention
    from parrot_tts_tpu_torch.ops import length_regulator as lr

    tts = make_tts(tcfg, vcfg, device)
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
    return {"launches": launches, "wavs": wavs, "units": units,
            "speakers": speakers, "tts": tts,
            "serve": lambda: tts.tts(TEXTS, speakers=speakers)}


def mrf_stages(vcfg) -> list[tuple[int, int, int]]:
    """(stage, channels, samples per code) of each stage the fused route
    takes."""
    from parrot_tts_tpu_torch.models.vocoder.generator import (
        FUSED_BELOW_CHANNELS)

    out, hop = [], 1
    for i, u in enumerate(vcfg.upsample_rates):
        hop *= u
        c = vcfg.upsample_initial_channel // 2 ** (i + 1)
        if c < FUSED_BELOW_CHANNELS:
            out.append((i, c, hop))
    return out


def mrf_serve_shapes(vcfg, batches) -> list[tuple[tuple, int]]:
    """((B, T, C), stage) of every fused-MRF launch of one fused serve."""
    return [((n, t * hop, c), i) for n, t in batches
            for i, c, hop in mrf_stages(vcfg)]


def bound(ops: float, peak: float, nbytes: float) -> tuple[float, str]:
    ops_s, bytes_s = ops / peak, nbytes / HBM_RATE
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def total(rows: list[dict]) -> dict:
    """Times of a set of launches (each row times its count)."""
    out = {key: sum(r[key] * r["count"] for r in rows)
           for key in ("ms", "plain_ms", "bound_ms")}
    out["bound_by"] = max(rows, key=lambda r: r["bound_ms"] * r["count"]
                          )["bound_by"]
    return out


def phase_mrf_kernel(fm, exact_numerics, model, vcfg, batches) -> dict:
    """The fused-MRF kernel against its plain version at every (B, T, C)
    the fused serve gives it, a ragged T, and rows of different lengths."""
    from parrot_tts_tpu_torch.models.vocoder.generator import pack_stage

    rng = np.random.default_rng(SEED + 1)
    stages = mrf_stages(vcfg)
    shapes = [(*shape, i, "serve") for shape, i in mrf_serve_shapes(vcfg,
                                                                    batches)]
    shapes += [(2, 1013, stages[0][1], stages[0][0], "ragged"),
               (3, 4000, stages[1][1], stages[1][0], "lengths")]
    rows = []
    with torch.no_grad(), exact_numerics(True):
        for b, t, c, i, kind in shapes:
            w, bias, plan = pack_stage(model, i)
            if all(r["C"] != c for r in rows):
                tb = fm.FUSED_MRF.lib().fused_mrf_tile(plan.halo, c)
                print(f"fused MRF C={c}: tile {tb} rows, halo {plan.halo} "
                      f"per side, tile/halo {tb / plan.halo:.2f}")
            x = torch.from_numpy(rng.standard_normal((b, t, c))
                                 .astype(np.float32)).cuda()
            if kind == "lengths":
                for r, n in enumerate((t, 2 * t // 3, t // 3)):
                    x[r, n:] = 0.0
            got = fm.mrf_fused(x, w, bias, plan)
            want = fm.mrf_fused_reference(x, w, bias, plan)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            lim = MRF_RTOL * float(want.abs().max())
            if not err <= lim:
                raise AssertionError(f"fused MRF B={b} T={t} C={c}: max "
                                     f"|diff| {err} > {lim}")
            reps = max(3, min(30, int(3e6 / (b * t))))
            ms = cuda_ms(lambda: fm.mrf_fused(x, w, bias, plan), reps)
            plain_ms = cuda_ms(
                lambda: fm.mrf_fused_reference(x, w, bias, plan), reps)
            flops = 2.0 * b * t * c * c * sum(
                2 * k * len(d) for k, d in zip(plan.kernel_sizes,
                                               plan.dilations))
            bound_ms, bound_by = bound(flops, FP32_PEAK,
                                       8.0 * b * t * c + 4.0 * (w.numel()
                                                                + bias.numel()))
            rows.append({"B": b, "T": t, "C": c, "kind": kind, "count": 1,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by})
            print(f"fused MRF B={b} T={t:7d} C={c:2d} ({kind}): max|diff| "
                  f"{err:.3e} (limit {lim:.3e})  kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
            del x, got, want
    serve = [r for r in rows if r["kind"] == "serve"]
    rep = total(serve)
    print(f"fused MRF per serve ({len(serve)} launches): kernel "
          f"{rep['ms']:.4f} ms  plain {rep['plain_ms']:.4f} ms  bound "
          f"{rep['bound_ms']:.4f} ms")
    return {"report": rep, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "checked": {(r["B"], r["T"], r["C"]) for r in serve}}


def int8_sites(vcfg, n: int, t: int) -> dict:
    """(B, T, Ci, Co, K, dilation, pads, leaky) -> count, for every int8
    conv of one int8-static vocoder batch of n rows of t codes."""
    from parrot_tts_tpu_torch.models.vocoder.generator import LRELU_SLOPE
    from parrot_tts_tpu_torch.ops import conv as conv_ops

    sites: dict = {}

    def add(key):
        sites[key] = sites.get(key, 0) + 1

    hop = 1
    for i, (u, k) in enumerate(zip(vcfg.upsample_rates,
                                   vcfg.upsample_kernel_sizes)):
        cin = vcfg.upsample_initial_channel // 2 ** i
        ch = cin // 2
        *_, pad_left, q_len = conv_ops._polyphase_plan(k, u, (k - u) // 2)
        add((n, t * hop, cin, u * ch, q_len, 1,
             (pad_left, q_len - 1 - pad_left), None))
        hop *= u
        for rk, ds in zip(vcfg.resblock_kernel_sizes,
                          vcfg.resblock_dilation_sizes):
            for d in ds:
                p1, p2 = conv_ops.get_padding(rk, d), conv_ops.get_padding(rk)
                add((n, t * hop, ch, ch, rk, d, (p1, p1), LRELU_SLOPE))
                add((n, t * hop, ch, ch, rk, 1, (p2, p2), None))
    return sites


def int8_serve_sites(vcfg, batches) -> dict:
    """int8_sites summed over the vocoder batches of one serve."""
    sites: dict = {}
    for n, t_codes in batches:
        batch = int8_sites(vcfg, n, t_codes)
        if sum(batch.values()) != INT8_SITES:
            raise AssertionError(f"{sum(batch.values())} int8 sites, want "
                                 f"{INT8_SITES}")
        for key, count in batch.items():
            sites[key] = sites.get(key, 0) + count
    return sites


def phase_int8_kernel(qc, vcfg, batches) -> dict:
    """The int8 conv kernel against its plain version, bit for bit, at
    every distinct site shape of every int8-static vocoder batch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    sites = int8_serve_sites(vcfg, batches)
    rows = []
    for key, count in sites.items():
        n, t, ci, co, k, d, pads, leaky = key
        xq, wt = ints(n, t, ci), ints(k, co, ci)
        # the serve's scale: one (Co,) vector broadcast over the batch
        scale = (torch.rand(co, generator=gen, device="cuda") * 1e-4
                 + 1e-6).expand(n, -1)
        bias = torch.randn(co, generator=gen, device="cuda") * 0.1

        def kern():
            return qc.int8_conv(xq, wt, scale, bias, pads=pads, dilation=d,
                                leaky=leaky)

        def plain():
            return qc.int8_conv_reference(xq, wt, scale, bias, pads=pads,
                                          dilation=d, leaky=leaky)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"int8 conv B={n} T={t} Ci={ci} Co={co} K={k} d={d}: not "
                f"bit-identical (max |diff| {float((got - want).abs().max())})")
        err = float((got - want).abs().max())
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        t_out = got.shape[1]
        bound_ms, bound_by = bound(
            2.0 * n * t_out * k * ci * co, INT8_PEAK,
            n * t * ci + k * ci * co + 4.0 * (co + co + n * t_out * co))
        rows.append({"key": key, "count": count,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"int8 conv B={n} T={t:7d} Ci={ci:3d} Co={co:4d} K={k:2d} "
              f"d={d} leaky={int(leaky is not None)} x{count}: bit-identical"
              f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        del xq, wt, got, want
    by_key = {r["key"]: r for r in rows}
    for n, t_codes in batches:
        rep = total([{**by_key[key], "count": count} for key, count
                     in int8_sites(vcfg, n, t_codes).items()])
        print(f"int8 conv per vocoder batch of {n} x {t_codes} codes "
              f"({INT8_SITES} launches): kernel {rep['ms']:.4f} ms  plain "
              f"{rep['plain_ms']:.4f} ms  bound {rep['bound_ms']:.4f} ms")
    rep = total(rows)
    print(f"int8 conv per serve ({len(rows)} distinct shapes, "
          f"{INT8_SITES * len(batches)} launches): kernel {rep['ms']:.4f} ms"
          f"  plain {rep['plain_ms']:.4f} ms  bound {rep['bound_ms']:.4f} ms")
    return {"report": rep, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "checked": set(sites)}


def serve_line(label: str, st: dict, launches: int) -> None:
    print(f"{label}: {st['audio_seconds']:.3f} audio-s in {st['wall_s']:.3f} s"
          f" = {st['audio_seconds_per_second']:.3f} audio-s/s (TTE "
          f"{st['tte_s']:.3f} s, vocoder {st['vocoder_s']:.3f} s); kernel "
          f"launches {launches}")


def phase_fused_serve(fm, tcfg, vcfg, base: dict, checked: set,
                      device=None) -> int:
    """The same requests through ParrotTTS with fused_mrf=True."""
    tts = make_tts(tcfg, vcfg, device)
    want = len(mrf_stages(vcfg)) * len(vocoder_batches(base["units"]))
    runs = []
    for run in range(2):
        with recording(fm, "mrf_fused", mrf_key) as shapes:
            fm.FUSED_MRF.launches = 0
            wavs = tts.tts(TEXTS, speakers=base["speakers"])
            launches = fm.FUSED_MRF.launches
        if not shapes <= checked:
            raise AssertionError(f"fused MRF shapes {sorted(shapes - checked)}"
                                 " of the serve were not checked against "
                                 "plain")
        serve_line(f"fused serve {run}", tts.last_stats, launches)
        if launches != want:
            raise AssertionError(f"{launches} fused MRF launches, want {want}")
        runs.append((wavs, launches))
    dev = 0.0
    for i, (a, b, c) in enumerate(zip(runs[0][0], runs[1][0], base["wavs"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"request {i}: fused serve not deterministic")
        if a.shape != c.shape:
            raise AssertionError(f"request {i}: {a.shape} != {c.shape}")
        if a.size:
            dev = max(dev, float(np.abs(a - c).max()))
    print(f"fused serve against the float serve: max |diff| {dev:.3e}")
    if not dev <= FUSED_SERVE_ATOL:
        raise AssertionError(f"fused serve deviates by {dev}")
    return runs[0][1]


def phase_int8_serve(qc, tcfg, vcfg, base: dict, checked: set,
                     device=None) -> dict:
    """The same requests through ParrotTTS with quant="int8-static"."""
    tts = make_tts(tcfg, vcfg, device)
    units, speakers = base["units"], base["speakers"]
    batches = vocoder_batches(units)
    length = max(t for _, t in batches)
    rows = [np.tile(u, -(-length // len(u)))[:length] for u in units if len(u)]
    spk = [s for u, s in zip(units, speakers) if len(u)]
    t0 = time.perf_counter()
    tts.vocoder.calibrate(rows, spk)
    torch.cuda.synchronize()
    print(f"int8-static calibration on {len(rows)} x {length} codes: "
          f"{time.perf_counter() - t0:.3f} s, "
          f"{len(tts.vocoder.staticq.scales)} sites")
    want = INT8_SITES * len(batches)
    runs = []
    for run in range(2):
        with recording(qc, "int8_conv", int8_key) as shapes:
            qc.INT8_CONV.launches = 0
            wavs = tts.tts(TEXTS, speakers=speakers)
            launches = qc.INT8_CONV.launches
        if not shapes <= checked:
            raise AssertionError(f"int8 conv shapes {sorted(shapes - checked)}"
                                 " of the serve were not checked against "
                                 "plain")
        serve_line(f"int8-static serve {run}", tts.last_stats, launches)
        if launches != want:
            raise AssertionError(f"{launches} int8 conv launches, want {want}")
        runs.append((wavs, launches))
    sig = err = 0.0
    dev, worst = 0.0, math.inf
    for i, (a, b, u, f) in enumerate(zip(runs[0][0], runs[1][0], units,
                                         base["wavs"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"request {i}: int8 serve not deterministic")
        if len(a) != len(u) * vcfg.total_upsample:
            raise AssertionError(f"request {i}: {len(a)} samples for "
                                 f"{len(u)} units")
        if not np.isfinite(a).all():
            raise AssertionError(f"request {i}: non-finite samples")
        if a.size:
            e = float(((a.astype(np.float64) - f) ** 2).sum())
            s = float((f.astype(np.float64) ** 2).sum())
            sig, err = sig + s, err + e
            dev = max(dev, float(np.abs(a - f).max()))
            worst = min(worst, 10 * math.log10(s / max(e, 1e-30)))
    snr = 10 * math.log10(sig / max(err, 1e-30))
    print(f"int8-static serve against the float serve: SNR {snr:.2f} dB "
          f"(worst request {worst:.2f} dB), max |dev| {dev:.4e}")
    if not (snr >= SNR_MIN_DB and worst >= SNR_MIN_DB):
        raise AssertionError(f"int8-static SNR {snr:.2f} dB (worst request "
                             f"{worst:.2f} dB) < {SNR_MIN_DB}")
    return {"launches": runs[0][1], "snr_db": snr,
            "serve": lambda: tts.tts(TEXTS, speakers=speakers)}


def phase_profile(serve, label: str) -> None:
    """One more serve under torch.profiler: device time by kernel and the
    device's busy share of the wall time. Busy time is the union of the
    kernels' intervals; the profiler's device-side annotations of aten ops
    span those same kernels and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"profile of one {label}:")
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
    from parrot_tts_tpu_torch.ops import fused_mrf as fm
    from parrot_tts_tpu_torch.ops import qconv as qc

    phase_card()
    phase_build(kernels)
    kern = phase_kernel(fa, exact_numerics)
    # full width: d_model 256, 4+4 FFT blocks of 2 heads, V1 vocoder
    tcfg, vcfg = TTEModelConfig(n_speaker=4), VocoderModelConfig()
    base = phase_serving(fa, tcfg, vcfg)
    batches = vocoder_batches(base["units"])
    print("vocoder batches (rows, codes):", batches)
    mrf = phase_mrf_kernel(fm, exact_numerics, base["tts"].vocoder.model,
                           vcfg, batches)
    q8 = phase_int8_kernel(qc, vcfg, batches)
    fused_launches = phase_fused_serve(
        fm, tcfg, dataclasses.replace(vcfg, fused_mrf=True), base,
        mrf["checked"])
    int8 = phase_int8_serve(
        qc, tcfg, dataclasses.replace(vcfg, quant="int8-static"), base,
        q8["checked"])
    phase_profile(base["serve"], "float serve")
    phase_profile(int8["serve"], "int8-static serve")
    rep = kern["report"]
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "parrot_tts_tpu/ops/attention.py:153",
        "launches": base["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": rep["ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
    }, {
        "name": "fused_mrf",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/fused_mrf.cu",
        "replaces": "parrot_tts_tpu/ops/fused_mrf.py:115",
        "launches": fused_launches,
        "max_abs_err": mrf["max_abs_err"],
        **{k: mrf["report"][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by")},
        "library_ms": None,
    }, {
        "name": "int8_conv",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/int8_conv.cu",
        "replaces": "parrot_tts_tpu/ops/pallas_qconv.py:42",
        "launches": int8["launches"],
        "max_abs_err": q8["max_abs_err"],
        **{k: q8["report"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
