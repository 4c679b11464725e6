#!/usr/bin/env python3
"""Drive the PyTorch port (parrot_tts_tpu_torch) on one CUDA card and
check it. Run from the root of the checkout:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: name and power limit (nvidia-smi), torch / CUDA versions, TF32 flags;
2. build: the five kernel sources in csrc/ with nvcc (sm_90a), one nvcc
   per source in parallel, with each one's ptxas register and spill report
   (phases 3, 5 and 10 repeat those of the two attention forwards and of
   every fused-MRF instantiation; phase 5 fails on a fused-MRF spill);
3. flash attention against plain: the flash-attention forward (row 1:
   3xTF32 products on the TF32 tensor cores, mma.sync m16n8k8, cp.async
   ring of 32-key tiles, IEEE float32 softmax) against its IEEE float32
   plain PyTorch version, H=2, d_head=128, at B=8 and T up to 3584 (with
   key padding, one all-masked row and a ragged T), at every (B, T) the
   serving phase gives it, and a d_head=64 case; max |diff| <= 1e-5 on rows
   with a valid key, all-masked rows exactly 0; kernel, plain, bound (the
   3xTF32 tensor-core bound beside the float32 CUDA-core one) and
   scaled_dot_product_attention ms (and its max |diff|) per shape;
4. serving at full width: the default TTEModelConfig (d_model 256, 4+4 FFT
   blocks, 2 heads of 128) and V1 VocoderModelConfig with seeded weights,
   through ParrotTTS.tts twice (deterministic, lengths len(units)*320,
   finite, the kernel launched once per FFT block per decode batch), then
   the same decode batches once more with plain attention on the card:
   durations and totals equal, max |dlogit| <= 1e-4, codes equal wherever
   the top-2 logit margin exceeds 1e-3;
5. fused MRF against plain: the fused-MRF kernel (row 6: 3xTF32 products
   on the TF32 tensor cores, wgmma m64nNk8 with A from registers, TF32
   hi / lo weight slabs through a cp.async ring) at every (B, T, C) the
   fused serve gives it (the 64-, 32- and 16-channel stages of each vocoder
   batch), a ragged T and a batch whose rows end at different lengths; max
   |diff| <= 1e-5 * max |plain|; each stage's tile (rows, wgmma n, blocks
   per SM, recompute factor); kernel, plain (cuDNN IEEE float32) and both
   bounds (3xTF32 tensor cores, the kernels line's; float32 CUDA cores) ms
   per launch, summed per stage C and per serve;
6. int8 conv against plain: the int8 conv kernel at every distinct site
   shape of every int8-static and "int8" vocoder batch, with that batch's
   rows (5 polyphase upsamples, the MRF convs at k 3/7/11 and dilation
   1/3/5 with the leaky epilogue and without it), each with the scale the
   serve passes: the int8-static serve's per-channel scale broadcast over
   the batch, the dynamic serves' per-row (B, Co) scales ("int8-tail"'s
   sites are a subset of "int8"'s), bit-identical; kernel, plain and bound
   ms (the kernel's device time per launch of launches queued ahead of
   the device, and the launch-to-launch time, both from CUDA events), the
   kernel's share of its bound and the plan's branch ("tma", or
   "padded" where an operand goes through a workspace), tile and ring per
   site; per serve of each mode the kernel's total beside the mma.sync
   kernel's it replaced (INT8_SERVE_MS_BEFORE);
7. fused serve: ParrotTTS with VocoderModelConfig(fused_mrf=True) on the
   same requests and weights: waveforms within 1e-5 of phase 4's, 3 fused
   launches per vocoder batch, each at a shape phase 5 checked;
8. int8-static serve: ParrotTTS with VocoderModelConfig(quant="int8-static"),
   calibrated explicitly on a batch built from the serve's own units, served
   twice: deterministic, lengths len(units)*320, finite, 95 int8 conv
   launches per vocoder batch, each at a shape phase 6 checked, SNR >= 15
   dB against phase 4's waveforms over all requests and for each one;
8b. dynamic int8 serves: ParrotTTS with quant="int8" and with
   quant="int8-tail" on the same requests and weights, each served twice:
   deterministic, lengths len(units)*320, finite, 95 and 56 int8 conv
   launches per vocoder batch, each at a shape phase 6 checked with
   per-row scales, SNR >= 15 dB against phase 4's waveforms over all
   requests and for each one; then the dynamic int8 conv on the card is
   batch-invariant: a quiet row alone and beside a loud row gives the same
   bits;
9. profile: one more float serve, fused serve, int8-static serve and
   "int8" serve under torch.profiler (device time by kernel, the device's
   busy and idle share, the row-6 and row-7 kernels' device time per
   serve);
10. flash attention with dropout against plain: the forward (wgmma and
   TMA on bf16 operands cast once, two passes over K), dQ (with the
   D = rowsum(dO . O) and the keep bits it writes) and dK/dV kernels (rows
   2-4) at B=6, H=2, d_head 128 and every T the training phase gives them
   (128, 256, 512, 1024, 2048, 3584), a ragged T and a d_head 64 case, each
   with a row whose keys are all padded, at p = 0 and 0.1 on the same mask
   (max |diff| <= 2^-8 of max |plain|, rms <= 1e-4 of rms); dQ's keep bits
   equal to the plain mask's; a second dQ and dK/dV launch on the same
   inputs gives the same bits (determinism); the keep-mask kernel (row 5)
   bit-identical to its plain Philox and its keep rate within 5 sigma of
   0.9; kernel, plain, bound and scaled_dot_product_attention ms, the
   forward, dQ and dK/dV at p = 0 beside p = 0.1, the forward and the
   backward as training runs them (the autograd function: the forward's
   q, k, v casts and kernel; the backward's dO cast, dQ, dK/dV) at both p,
   per launch and per (256, 3584) micro-step beside SDPA's, and the
   registers and spills of every kernel of csrc/flash_dropout.cu from
   phase 2;
11. training at full width: TTEModelConfig(n_speaker=4) and TTETrainConfig
   defaults (warmup 0, so the first update moves the weights) through
   pipeline/train_tte.run for 2 optimizer steps (8 micro-batches, bucket
   pairs (128, 1024) and (256, 3584)) on a seeded synthetic corpus: finite
   losses, weights changed at micro-steps 4 and 8 only, 8 launches of each
   of rows 2-4 per micro-step at shapes phase 10 checked, evaluation
   attention (row 1) at shapes phase 3 checked, the checkpoint equal to the
   live state bit for bit and a resumed run carrying on from micro-step 8;
   then one (256, 3584) micro-batch at dropout 0 with the kernels against
   plain attention at the seeded initial weights that training starts from
   (a state that is the same in every run; deterministic algorithms; the
   kernel pass taken twice must give the same bits): loss within 1e-5,
   |dg|/|g| <= 1e-3, each tensor's max |dg| <= 1e-2 of its max |g|;
12. profile: one training micro-step at (256, 3584) under torch.profiler,
   and micro-steps per second over one optimizer step (a reading);
13. GEMM against plain: the row-8 kernel at the int8 experiment's (8192,
   4096, 4096) in int8 and bf16, at a ragged (1000, 1000, 1000) and a
   small (17, 33, 9) in int8, bf16 and float32: int8 equal, bf16 and
   float32 within MM_RTOL * sqrt(K) of max |plain|, each with the plan's
   route and branch (the ragged shapes take the padded branch); kernel
   (its rate and share of the bound), plain, bound and torch._int_mm /
   torch.matmul ms at the rate shape, and the int8 B^T pass alone; then
   the ported int8 experiment (`python -m parrot_tts_tpu_torch.scripts.exp_int8_rate`)
   parts 1 and 2 with few repetitions, its GEMM launches counted;
14. vocoder GAN training at full width (no TPU kernel lies on its path):
   the V1 VocoderModelConfig and VocoderTrainConfig() defaults (batch 16,
   segments of 8960 samples) through pipeline/train_vocoder.run for 4
   steps on a seeded corpus (32 + 4 wavs of 1-1.6 s over two speakers,
   random units at 50 per second): finite losses, every tensor of the
   generator, the MPD and the MSD changed at every step, the MSD scale-0
   power-iteration vector advanced, the validation mel error logged, the
   checkpoint equal to the live state bit for bit, a resumed run carrying
   on from step 4; then one step from the seeded initial state under
   exact_numerics(True) and deterministic algorithms, taken twice in
   float32 (the same bits required) and once in float64: losses within
   1e-4, |dg|/|g| <= 1e-3 per network, each tensor's max |dg| <= 1e-2 of
   its max |g|; GAN steps per second over 5 warm steps (CUDA events) and
   one profiled step (readings, TF32 as training runs). Then the manifest
   entry points on phase 4's TTE: write_predictions on every non-empty
   request gives the serve's units, and synthesize_text a finite waveform
   of len(units) * 320 samples.

The second-to-last stdout line is a JSON object describing each kernel;
the last is {"ok": true, "device": {...}}. Without a CUDA device the
script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import warnings
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
# int8 convs per V1 vocoder batch: every conv between conv_pre and
# conv_post; "int8-tail" only the 64-, 32- and 16-channel stages' MRF convs
# (3 x 18) and the two upsamples after the first of them
INT8_SITES = {"int8-static": 95, "int8": 95, "int8-tail": 56}
# row 7's ms per serve of each mode with the mma.sync kernel it replaced
# (PERF.md section 6, the same phase on the same card)
INT8_SERVE_MS_BEFORE = {"int8-static": 29.7722, "int8": 29.9788,
                        "int8-tail": 16.1821}
INT8_CONV_KERNEL = "::conv_kernel<"   # csrc/int8_conv.cu's kernels, by name
MRF_KERNEL = "::mrf_kernel<"          # csrc/fused_mrf.cu's kernels, by name
INT8_WARMUP, INT8_TIMED = 2, 10       # phase 6's launches per site
# the GEMM's bf16 and float32 results against plain: the same float32
# products summed in another order (tests/test_torch_kernels.py states why)
MM_RTOL = 1e-5
RATE_SHAPE = (8192, 4096, 4096)   # (M, K, N) of the int8 experiment
BF16_PEAK = 989e12           # H100 SXM bf16 dense tensor-core FLOP/s (data sheet)
TF32_PEAK = 494.7e12         # H100 SXM TF32 dense tensor-core FLOP/s (data sheet)
# flash attention with dropout (rows 2-4) against plain on the same mask:
# both round every product operand to bf16 at the same points and sum in
# float32 in another order, so a few operands land on the other bf16
# neighbour: max |diff| <= FD_MAX * max|plain|, rms diff <= FD_RMS *
# rms(plain), each floored at 1 (tests/test_torch_kernels.py states why)
FD_MAX, FD_RMS = 2.0**-8, 1e-4
FD_P = 0.1                   # the TTE's attention dropout
# (B, T, d_head) of phase 10, H=2: every (B, T) the training phase gives
# rows 2-4 (batch 6; encoder buckets 128/256, decoder 512-3584), a ragged
# T, a narrower head; every shape has a row whose keys are all padded
FD_SHAPES = ([(6, t, 128) for t in (128, 256, 512, 1024, 2048, 3584)]
             + [(6, 777, 128), (6, 512, 64)])
TRAIN_PAIRS = ((128, 1024), (256, 3584))   # phase 11's bucket pairs
# phase 11's training: the loss and gradients of one (256, 3584) micro-batch
# at dropout 0 with the kernels against plain attention, both IEEE float32
# elsewhere: the attention outputs differ by sparse bf16 re-roundings (rms
# 1e-4 of rms, phase 10) that the network carries through linearly
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3       # |dg| / |g| over all parameters
TRAIN_GRAD_MAX = 1e-2        # max |dg| <= this * max |g|, per tensor
# (B, T, d_head) checked against the plain version: B=8 across T (a ragged
# T among them), then the (B, T) of every attention call of the serving
# phase (its decode plan: encoder buckets 64/128/256, decoder 1024/2048/
# 3584, with 3, 5 and 1 requests), then those of the training phase's
# evaluation (batch 6 at its bucket pairs), then a narrower head
KERNEL_SHAPES = ([(8, t, 128) for t in (64, 128, 500, 768, 2048, 3584)]
                 + [(b, t, 128) for b, ts in ((3, (64, 1024)),
                                              (5, (128, 2048)),
                                              (1, (256, 3584))) for t in ts]
                 + [(6, t, 128) for pair in TRAIN_PAIRS for t in pair]
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


def queued_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of reps back-to-back launches of fn (CUDA events),
    with the host's enqueue cost hidden: a spin kernel holds the device
    while the launches are queued behind it. If the device reached the
    first event before the host had queued them all, the spin is made
    longer and the measurement taken again."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 4_000_000
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("the launches could not be queued ahead of the "
                         "device")


def attention_bound_ms(b: int, h: int, t: int, d: int) -> dict:
    """Row 1's bounds: its 3xTF32 products (3 * 4*B*H*T^2*d on the TF32
    tensor cores; the kernels line's bound) and the same work as float32
    FMAs on the CUDA cores; Q, K, V read and O written once, mask bytes."""
    flops = 4.0 * b * h * t * t * d
    nbytes = 4.0 * (4 * b * h * t * d) + b * t
    return {"3xtf32": bound(3 * flops, TF32_PEAK, nbytes),
            "f32": bound(flops, FP32_PEAK, nbytes)}


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


def mrf_key(x, w, b, plan, wk=None) -> tuple:
    return tuple(x.shape)


def int8_key(xq, wt, scale, bias=None, *, pads, dilation=1, leaky=None
             ) -> tuple:
    """(B, T, Ci, Co, K, dilation, pads, leaky, per_row) of an int8 conv
    call; per_row: the (B, Co) scale is materialised per row, not one (Co,)
    vector broadcast over the batch."""
    b, t, ci = xq.shape
    k, co, _ = wt.shape
    return (b, t, ci, co, k, dilation, tuple(pads), leaky,
            scale.stride(0) != 0)


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


def phase_build(kernels) -> dict:
    """Build every source; print and return each one's ptxas report."""
    t0 = time.perf_counter()
    logs = kernels.build("flash_attn_fwd", "fused_mrf", "int8_conv",
                         "flash_dropout", "int8_gemm")
    print(f"build (5 nvcc in parallel): {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "warning")):
                print(f"  {name}: {line.strip()}")
    return logs


def ptxas_registers(log: str) -> dict:
    """{kernel<D>: (registers, spill store bytes, spill load bytes)} of
    each templated kernel in one source's ptxas report (the fused MRF's as
    mrf_kernel<C, wgmma n>)."""
    out, name = {}, None
    for line in log.splitlines():
        if "entry function" in line:
            m = re.search(r"(flash_fwd|fwd|dq|dkv)_kernelILi(\d+)E", line)
            name = m and f"{m.group(1)}_kernel<{m.group(2)}>"
            m = re.search(r"mrf_kernelILi(\d+)ELi(\d+)E", line)
            if m:       # <C, wgmma n>; C = 0: a runtime-C instantiation
                name = f"mrf_kernel<{m.group(1)}, {m.group(2)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = (out.get(name, (0,))[0], int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m[1]),) + out.get(name, (0, 0, 0))[1:]
    return out


def print_registers(registers: dict) -> None:
    for name, (regs, st, ld) in sorted(registers.items()):
        print(f"ptxas {name}: {regs} registers, spill stores {st} bytes, "
              f"spill loads {ld} bytes")


def phase_kernel(fa, exact_numerics, registers: dict) -> dict:
    """Row 1 against its plain version at every KERNEL_SHAPES shape, with
    its times, bounds and SDPA's. `registers`: ptxas_registers of the
    source."""
    print_registers(registers)
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

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=attend, scale=scale)

            library_ms = cuda_ms(sdpa, reps)
            lib_err = float((sdpa()[keep] - want[keep]).abs().max())
        bounds = attention_bound_ms(b, h, t, d)
        (bound_ms, bound_by), (f32_ms, f32_by) = bounds["3xtf32"], bounds["f32"]
        rows.append({"B": b, "H": h, "T": t, "d": d, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
        print(f"kernel B={b} T={t:5d} d={d:3d}: max|diff| {err:.3e}  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound 3xTF32 "
              f"{bound_ms:.4f} ms ({bound_by}), float32 {f32_ms:.4f} ms "
              f"({f32_by})  sdpa {library_ms:.4f} ms (max|diff| "
              f"{lib_err:.3e})")
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


def mrf_bounds(b: int, t: int, c: int, w, bias, plan) -> dict:
    """Row 6's bounds at one launch: its 3xTF32 products (3 * 2 * B*T *
    sum over convs of K * C^2 on the TF32 tensor cores; the kernels line's
    bound) and the same work as float32 FMAs on the CUDA cores; x read and
    out written once, the weights and biases read once."""
    flops = 2.0 * b * t * c * c * sum(
        2 * k * len(d) for k, d in zip(plan.kernel_sizes, plan.dilations))
    nbytes = 8.0 * b * t * c + 4.0 * (w.numel() + bias.numel())
    return {"3xtf32": bound(3 * flops, TF32_PEAK, nbytes),
            "f32": bound(flops, FP32_PEAK, nbytes)}


def phase_mrf_kernel(fm, exact_numerics, model, vcfg, batches,
                     registers: dict) -> dict:
    """The fused-MRF kernel against its plain version at every (B, T, C)
    the fused serve gives it, a ragged T, and rows of different lengths,
    with its times and both bounds. `registers`: ptxas_registers of the
    source (empty when it was built before this run)."""
    from parrot_tts_tpu_torch.models.vocoder.generator import pack_stage

    mrf_regs = {k: v for k, v in registers.items() if k.startswith("mrf")}
    print_registers(mrf_regs)
    spilled = {k: v for k, v in mrf_regs.items() if v[1] or v[2]}
    if spilled:
        raise AssertionError(f"fused MRF kernels spill: {spilled}")
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
            wk = fm.kernel_weights(w, plan)
            if all(r["C"] != c for r in rows):
                tile = fm.tile_plan(plan)
                print(f"fused MRF C={c}: tile {tile.tb} rows (least work "
                      f"per row), halo "
                      f"{plan.halo} per side, {tile.warpgroups} warpgroups, "
                      f"1 block per SM, units of "
                      f"{fm.UNIT_ROWS} rows x {c} channels (up to "
                      f"{tile.rounds} per warpgroup), wgmma n "
                      f"{tile.wgmma_n}, slabs of {tile.k_chunk} input "
                      f"channels, recompute {tile.recompute:.3f}, shared "
                      f"memory {tile.smem_bytes} bytes")
            tb = fm.tile_plan(plan, (b, t)).tb
            x = torch.from_numpy(rng.standard_normal((b, t, c))
                                 .astype(np.float32)).cuda()
            if kind == "lengths":
                for r, n in enumerate((t, 2 * t // 3, t // 3)):
                    x[r, n:] = 0.0
            got = fm.mrf_fused(x, w, bias, plan, wk=wk)
            want = fm.mrf_fused_reference(x, w, bias, plan)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            lim = MRF_RTOL * float(want.abs().max())
            if not err <= lim:
                raise AssertionError(f"fused MRF B={b} T={t} C={c}: max "
                                     f"|diff| {err} > {lim}")
            reps = max(3, min(30, int(3e6 / (b * t))))
            ms = cuda_ms(lambda: fm.mrf_fused(x, w, bias, plan, wk=wk), reps)
            plain_ms = cuda_ms(
                lambda: fm.mrf_fused_reference(x, w, bias, plan), reps)
            bounds = mrf_bounds(b, t, c, w, bias, plan)
            (bound_ms, bound_by), (f32_ms, _) = bounds["3xtf32"], bounds["f32"]
            rows.append({"B": b, "T": t, "C": c, "kind": kind, "count": 1,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "f32_bound_ms": f32_ms})
            print(f"fused MRF B={b} T={t:7d} C={c:2d} ({kind}, tile {tb}): "
                  f"max|diff| {err:.3e} (limit {lim:.3e})  kernel {ms:.4f} ms"
                  f"  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
                  f"3xTF32 ({bound_by}), {f32_ms:.4f} ms float32")
            del x, got, want
    serve = [r for r in rows if r["kind"] == "serve"]
    for c in sorted({r["C"] for r in serve}, reverse=True):
        st = [r for r in serve if r["C"] == c]
        print(f"fused MRF per serve C={c} ({len(st)} launches): kernel "
              f"{sum(r['ms'] for r in st):.4f} ms  plain "
              f"{sum(r['plain_ms'] for r in st):.4f} ms  bound "
              f"{sum(r['bound_ms'] for r in st):.4f} ms 3xTF32, "
              f"{sum(r['f32_bound_ms'] for r in st):.4f} ms float32")
    rep = total(serve)
    print(f"fused MRF per serve ({len(serve)} launches): kernel "
          f"{rep['ms']:.4f} ms  plain {rep['plain_ms']:.4f} ms  bound "
          f"{rep['bound_ms']:.4f} ms 3xTF32, "
          f"{sum(r['f32_bound_ms'] for r in serve):.4f} ms float32")
    return {"report": rep, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "checked": {(r["B"], r["T"], r["C"]) for r in serve}}


def int8_sites(vcfg, n: int, t: int, mode: str) -> dict:
    """(B, T, Ci, Co, K, dilation, pads, leaky, per_row) -> count, for
    every int8 conv of one vocoder batch of n rows of t codes in quant
    mode `mode`: every conv under "int8-static" (its scale broadcast over
    the batch), the sites of `generator.quant_plan` under "int8" and
    "int8-tail" (per-row scales)."""
    from parrot_tts_tpu_torch.models.vocoder.generator import (LRELU_SLOPE,
                                                               quant_plan)
    from parrot_tts_tpu_torch.ops import conv as conv_ops

    per_row = mode != "int8-static"
    plan = (quant_plan(dataclasses.replace(vcfg, quant=mode), t) if per_row
            else [(True, True)] * len(vcfg.upsample_rates))
    sites: dict = {}

    def add(key):
        sites[key] = sites.get(key, 0) + 1

    hop = 1
    for i, (u, k) in enumerate(zip(vcfg.upsample_rates,
                                   vcfg.upsample_kernel_sizes)):
        cin = vcfg.upsample_initial_channel // 2 ** i
        ch = cin // 2
        ups_q, mrf_q = plan[i]
        *_, pad_left, q_len = conv_ops._polyphase_plan(k, u, (k - u) // 2)
        if ups_q:
            add((n, t * hop, cin, u * ch, q_len, 1,
                 (pad_left, q_len - 1 - pad_left), None, per_row))
        hop *= u
        for rk, ds in zip(vcfg.resblock_kernel_sizes,
                          vcfg.resblock_dilation_sizes):
            for d in ds if mrf_q else ():
                p1, p2 = conv_ops.get_padding(rk, d), conv_ops.get_padding(rk)
                add((n, t * hop, ch, ch, rk, d, (p1, p1), LRELU_SLOPE,
                     per_row))
                add((n, t * hop, ch, ch, rk, 1, (p2, p2), None, per_row))
    return sites


def int8_serve_sites(vcfg, batches, mode: str) -> dict:
    """int8_sites summed over the vocoder batches of one serve."""
    sites: dict = {}
    for n, t_codes in batches:
        batch = int8_sites(vcfg, n, t_codes, mode)
        if sum(batch.values()) != INT8_SITES[mode]:
            raise AssertionError(f"{mode}: {sum(batch.values())} int8 sites,"
                                 f" want {INT8_SITES[mode]}")
        for key, count in batch.items():
            sites[key] = sites.get(key, 0) + count
    return sites


def phase_int8_kernel(qc, vcfg, batches) -> dict:
    """The int8 conv kernel against its plain version, bit for bit, at
    every distinct site shape of every int8-static and "int8" vocoder
    batch, with the scale each serve passes ("int8-tail"'s sites are a
    subset of "int8"'s). A site's "ms" is the device time per launch of
    launches queued ahead of the device (queued_ms): back to back, the
    launches of the small sites are paced by the host, whose
    launch-to-launch time (cuda_ms) is printed beside it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    serves = {mode: int8_serve_sites(vcfg, batches, mode)
              for mode in INT8_SITES}
    if not set(serves["int8-tail"]) <= set(serves["int8"]):
        raise AssertionError("int8-tail sites outside the int8 sites")
    sites = {**serves["int8-static"], **serves["int8"]}
    rows = []
    for key in sites:
        n, t, ci, co, k, d, pads, leaky, per_row = key
        xq, wt = ints(n, t, ci), ints(k, co, ci)
        # the serve's scale: per row (B, Co), or one (Co,) vector broadcast
        # over the batch
        scale = torch.rand(*((n,) if per_row else ()), co, generator=gen,
                           device="cuda") * 1e-4 + 1e-6
        scale = scale.expand(n, -1)
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
        ms = queued_ms(kern, INT8_TIMED, warmup=INT8_WARMUP)
        launch_ms = cuda_ms(kern, INT8_TIMED, warmup=0)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        t_out = got.shape[1]
        bound_ms, bound_by = bound(
            2.0 * n * t_out * k * ci * co, INT8_PEAK,
            n * t * ci + k * ci * co + 4.0 * (co + co + n * t_out * co))
        rows.append({"key": key, "max_abs_err": err, "ms": ms,
                     "launch_ms": launch_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        plan = qc.conv_plan(n, t, ci, k, co, pads, d)
        print(f"int8 conv B={n} T={t:7d} Ci={ci:3d} Co={co:4d} K={k:2d} "
              f"d={d} leaky={int(leaky is not None)} per_row={int(per_row)}"
              f": bit-identical  kernel {ms:.4f} ms device (launch to launch"
              f" {launch_ms:.4f} ms)  plain {plain_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}% of "
              f"it)  branch {plan['branch']} (tile {plan['bm']} x "
              f"{plan['bn']}, {'resident' if plan['resident'] else 'streamed'}"
              f" weights, {plan['stages']} stages)")
        del xq, wt, got, want
    by_key = {r["key"]: r for r in rows}

    def report(site_counts: dict) -> dict:
        rows_ = [{**by_key[key], "count": count}
                 for key, count in site_counts.items()]
        return {**total(rows_), "launch_ms": sum(
            r["launch_ms"] * r["count"] for r in rows_)}

    for mode in INT8_SITES:
        for n, t_codes in batches:
            r = report(int8_sites(vcfg, n, t_codes, mode))
            print(f"int8 conv per {mode} vocoder batch of {n} x {t_codes} "
                  f"codes ({INT8_SITES[mode]} launches): kernel "
                  f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
                  f"{r['bound_ms']:.4f} ms")
        r = report(serves[mode])
        print(f"int8 conv per {mode} serve ({len(serves[mode])} distinct "
              f"shapes, {INT8_SITES[mode] * len(batches)} launches): kernel "
              f"{r['ms']:.4f} ms device ({100 * r['bound_ms'] / r['ms']:.1f}% "
              f"of the bound; launch to launch {r['launch_ms']:.4f} ms; the "
              f"mma.sync kernel before it: {INT8_SERVE_MS_BEFORE[mode]} ms)  "
              f"plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms")
    # the three serves together, whose launches the kernels line counts
    all_serves: dict = {}
    for site_counts in serves.values():
        for key, count in site_counts.items():
            all_serves[key] = all_serves.get(key, 0) + count
    return {"report": report(all_serves),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "checked": set(sites)}


def serve_line(label: str, st: dict, launches: int) -> None:
    print(f"{label}: {st['audio_seconds']:.3f} audio-s in {st['wall_s']:.3f} s"
          f" = {st['audio_seconds_per_second']:.3f} audio-s/s (TTE "
          f"{st['tte_s']:.3f} s, vocoder {st['vocoder_s']:.3f} s); kernel "
          f"launches {launches}")


def phase_fused_serve(fm, tcfg, vcfg, base: dict, checked: set,
                      device=None) -> dict:
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
    return {"launches": runs[0][1],
            "serve": lambda: tts.tts(TEXTS, speakers=base["speakers"])}


def phase_int8_serve(qc, tcfg, vcfg, base: dict, checked: set,
                     device=None) -> dict:
    """The same requests through ParrotTTS with vcfg.quant an int8 mode,
    served twice; "int8-static" calibrates first on a batch built from the
    serve's own units."""
    mode = vcfg.quant
    tts = make_tts(tcfg, vcfg, device)
    units, speakers = base["units"], base["speakers"]
    batches = vocoder_batches(units)
    if mode == "int8-static":
        length = max(t for _, t in batches)
        rows = [np.tile(u, -(-length // len(u)))[:length] for u in units
                if len(u)]
        spk = [s for u, s in zip(units, speakers) if len(u)]
        t0 = time.perf_counter()
        tts.vocoder.calibrate(rows, spk)
        torch.cuda.synchronize()
        print(f"int8-static calibration on {len(rows)} x {length} codes: "
              f"{time.perf_counter() - t0:.3f} s, "
              f"{len(tts.vocoder.staticq.scales)} sites")
    want = INT8_SITES[mode] * len(batches)
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
        serve_line(f"{mode} serve {run}", tts.last_stats, launches)
        if launches != want:
            raise AssertionError(f"{launches} int8 conv launches, want {want}")
        runs.append((wavs, launches))
    sig = err = 0.0
    dev, worst = 0.0, math.inf
    for i, (a, b, u, f) in enumerate(zip(runs[0][0], runs[1][0], units,
                                         base["wavs"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"request {i}: {mode} serve not "
                                 "deterministic")
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
    print(f"{mode} serve against the float serve: SNR {snr:.2f} dB "
          f"(worst request {worst:.2f} dB), max |dev| {dev:.4e}")
    if not (snr >= SNR_MIN_DB and worst >= SNR_MIN_DB):
        raise AssertionError(f"{mode} SNR {snr:.2f} dB (worst request "
                             f"{worst:.2f} dB) < {SNR_MIN_DB}")
    return {"launches": runs[0][1], "snr_db": snr,
            "serve": lambda: tts.tts(TEXTS, speakers=speakers)}


def phase_batch_invariance(quant, device="cuda") -> None:
    """The dynamic int8 conv at a V1 stage-1 MRF site: a quiet row gives the
    same bits alone and beside a loud row (per-row scales)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    quiet, loud = randn(1, 1250, 256, scale=0.01), randn(1, 1250, 256,
                                                         scale=10.0)
    w = randn(3, 256, 256, scale=0.05)
    solo = quant.int8_conv_nwc(quiet, w, None, pads=(1, 1))
    pair = quant.int8_conv_nwc(torch.cat([quiet, loud]), w, None, pads=(1, 1))
    if not torch.equal(solo[0], pair[0]):
        raise AssertionError("dynamic int8 conv: a quiet row changes beside "
                             "a loud one")
    print("dynamic int8 conv batch-invariant: a quiet row (std 0.01) gives "
          "the same bits alone and beside a loud row (std 10)")


def phase_profile(serve, label: str, split=()) -> None:
    """One more serve under torch.profiler: device time by kernel and the
    device's busy share of the wall time. Busy time is the union of the
    kernels' intervals; the profiler's device-side annotations of aten ops
    span those same kernels and are left out. split: (label, name
    substrings) pairs; each kernel's time goes to the first whose
    substring its name holds, the rest to "other"."""
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
    if split:
        groups: dict[str, list] = {}
        for name, (ms, n) in by_name.items():
            group = next((g for g, keys in split
                          if any(k in name for k in keys)), "other")
            acc = groups.setdefault(group, [0.0, 0])
            acc[0] += ms
            acc[1] += n
        print("profile by kind: " + "; ".join(
            f"{g} {ms:.3f} ms / {n} kernels"
            for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    for row, source, key in ((6, "fused_mrf", MRF_KERNEL),
                             (7, "int8_conv", INT8_CONV_KERNEL)):
        runs = [v for name, v in by_name.items() if key in name]
        if runs:
            print(f"profile: row {row} (csrc/{source}.cu) "
                  f"{sum(ms for ms, _ in runs):.3f} ms device time over "
                  f"{sum(n for _, n in runs)} launches")


def fd_compare(got, want, what: str) -> tuple[float, float]:
    """Hold a flash-dropout kernel's output to its plain version (FD_MAX,
    FD_RMS); returns the max |diff| and the rms diff over its floored
    rms(plain)."""
    diff = (got - want).abs()
    err = float(diff.max())
    lim = FD_MAX * max(1.0, float(want.abs().max()))
    rms = float(diff.pow(2).mean().sqrt())
    rms_ref = max(1.0, float(want.pow(2).mean().sqrt()))
    if not (err <= lim and rms <= FD_RMS * rms_ref):
        raise AssertionError(f"{what}: max |diff| {err:.3e} (limit {lim:.3e})"
                             f", rms {rms:.3e} (limit {FD_RMS * rms_ref:.3e})")
    return err, rms / rms_ref


def fd_bounds(b: int, h: int, t: int, d: int) -> dict:
    """(bound ms, bound_by) of each row at one launch: the products' bf16
    operations (4, 6, 8 * B*H*T^2*d; D's 2*B*H*T*d float32 ones in dQ are
    below 1e-3 of them and not counted) and each input read once, each
    output written once (float32: fwd q, k, v -> o; dQ q, k, v, dO, O -> dQ;
    dK/dV q, k, v, dO -> dK, dV; besides, bias (B, T), lse (B, H, T) and
    D (B, H, T), which dQ writes and dK/dV reads); the keep mask writes
    B*H*T^2 int32 (its Philox work is integer, not tensor-core)."""
    x, side, row = 4.0 * b * h * t * d, 4.0 * (b * t + b * h * t), 4.0 * b * h * t
    base = 2.0 * b * h * t * t * d
    return {"fwd": bound(2 * base, BF16_PEAK, 4 * x + side),
            "dq": bound(3 * base, BF16_PEAK, 6 * x + side + row),
            "dkv": bound(4 * base, BF16_PEAK, 6 * x + side + row),
            "keep_mask": bound(0.0, BF16_PEAK, 4.0 * b * h * t * t)}


def phase_flash_dropout(fd, registers: dict) -> dict:
    """Rows 2-5 against their plain versions at every FD_SHAPES shape, at
    p = 0 and p = FD_P, on the same mask, dQ's keep bits against the plain
    mask's and two backward launches against each other; then each one's
    time, its plain version's, its bound and scaled_dot_product_attention's,
    and dQ and dK/dV at p = 0. `registers`: ptxas_registers of the source."""
    import torch.nn.functional as F

    print_registers(registers)
    rng = np.random.default_rng(SEED + 3)
    dev = torch.device("cuda")
    rows = []
    for b, t, d in FD_SHAPES:
        h = 2
        q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                        .astype(np.float32)).to(dev)
                       for _ in range(4))
        lengths = rng.integers(1, t + 1, size=b)
        lengths[0] = t
        pad_np = np.arange(t)[None, :] >= lengths[:, None]
        pad_np[b - 1] = True                   # a row with no valid key
        pad = torch.from_numpy(pad_np).to(dev)
        bias = fd.padding_bias(pad, b, t, dev)
        scale = 1.0 / math.sqrt(d)
        err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        rms = dict(err)
        for p in (0.0, FD_P):
            seed = SEED + 7 * t + int(100 * p)
            ops = fd.to_bf16(q, k, v, do)
            o, lse = fd.flash_dropout_fwd(q, k, v, bias, seed, p, scale,
                                          operands=ops[:3])
            want_o, want_lse = fd.flash_attention_dropout_reference(
                q, k, v, bias, seed, p, scale)
            # both backward versions on the plain forward's O and lse, and
            # both dK/dV on the plain D; the kernel's dK/dV on dQ's bits,
            # the plain one on the mask drawn from the seed
            qkv, rest = (q, k, v, bias, seed), (want_lse, do, p, scale)
            dq, delta, bits = fd.flash_dropout_dq(*qkv, want_o, *rest,
                                                  operands=ops)
            want_dq, want_delta = fd.flash_dropout_dq_reference(
                *qkv, want_o, *rest)
            dk, dv = fd.flash_dropout_dkv(*qkv, want_delta, *rest, bits=bits,
                                          operands=ops)
            again = (*fd.flash_dropout_dq(*qkv, want_o, *rest, operands=ops),
                     *fd.flash_dropout_dkv(*qkv, want_delta, *rest,
                                           bits=bits, operands=ops))
            torch.cuda.synchronize()
            tag = f"B={b} T={t} d={d} p={p}"
            if not all(x is y or torch.equal(x, y) for x, y in
                       zip((dq, delta, bits, dk, dv), again)):
                raise AssertionError(f"backward {tag}: two launches differ")
            if p and not torch.equal(bits, fd.pack_keep_bits(
                    fd.keep_mask_reference(b, h, t, seed, p, dev))):
                raise AssertionError(f"dQ keep bits {tag}: not the mask's")
            torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-5)
            want_dk, want_dv = fd.flash_dropout_dkv_reference(
                *qkv, want_delta, *rest)
            for name, pairs in (
                    ("fwd", ((o, want_o, "O"),)),
                    ("dq", ((dq, want_dq, "dQ"), (delta, want_delta, "D"))),
                    ("dkv", ((dk, want_dk, "dK"), (dv, want_dv, "dV")))):
                for got, want, what in pairs:
                    e, r = fd_compare(got, want, f"{what} {tag}")
                    err[name], rms[name] = max(err[name], e), max(rms[name], r)
            del (o, lse, want_o, want_lse, dq, delta, want_dq, want_delta, dk,
                 dv, want_dk, want_dv, bits, again, ops)
        seed = SEED + 7 * t + int(100 * FD_P)
        mask = fd.keep_mask(b, h, t, seed, FD_P, dev)
        torch.cuda.synchronize()
        if not torch.equal(mask, fd.keep_mask_reference(b, h, t, seed, FD_P,
                                                        dev)):
            raise AssertionError(f"keep mask B={b} T={t}: not bit-identical")
        rate = float(mask.double().mean())
        sigma = math.sqrt(FD_P * (1 - FD_P) / mask.numel())
        if not abs(rate - (1 - FD_P)) <= 5 * sigma:
            raise AssertionError(f"keep rate {rate} not within 5 sigma of "
                                 f"{1 - FD_P}")
        del mask

        # times at the training setting, p = FD_P: the three kernels as
        # training launches them, on operands cast to bf16 once; each at
        # p = 0, without the mask; and the forward and the backward as
        # training runs them (the autograd function's: the casts and the
        # kernels) at both p
        ops = fd.to_bf16(q, k, v, do)
        o, lse = fd.flash_dropout_fwd(q, k, v, bias, seed, FD_P, scale,
                                      operands=ops[:3])
        qkv, rest = (q, k, v, bias, seed), (lse, do, FD_P, scale)
        _, delta, bits = fd.flash_dropout_dq(*qkv, o, *rest, operands=ops)
        reps = max(3, min(50, int(3e5 / t)))
        plain_reps = max(2, reps // 10)

        def backward_ms(p):
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            out = fd.flash_attention_dropout(qg, kg, vg, bias, seed, p, scale)
            return cuda_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True), reps)

        def forward_ms(p):
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            return cuda_ms(lambda: fd.flash_attention_dropout(
                qg, kg, vg, bias, seed, p, scale), reps)

        kern = {"fwd": lambda: fd.flash_dropout_fwd(q, k, v, bias, seed,
                                                    FD_P, scale,
                                                    operands=ops[:3]),
                "dq": lambda: fd.flash_dropout_dq(*qkv, o, *rest,
                                                  operands=ops),
                "dkv": lambda: fd.flash_dropout_dkv(*qkv, delta, *rest,
                                                    bits=bits, operands=ops),
                "keep_mask": lambda: fd.keep_mask(b, h, t, seed, FD_P, dev)}
        rest0 = (lse, do, 0.0, scale)
        p0_ms = {"fwd": cuda_ms(lambda: fd.flash_dropout_fwd(
                     q, k, v, bias, seed, 0.0, scale, operands=ops[:3]),
                     reps),
                 "dq": cuda_ms(lambda: fd.flash_dropout_dq(
                     *qkv, o, *rest0, operands=ops), reps),
                 "dkv": cuda_ms(lambda: fd.flash_dropout_dkv(
                     *qkv, delta, *rest0, bits=None, operands=ops), reps)}
        autograd_ms = {FD_P: backward_ms(FD_P), 0.0: backward_ms(0.0)}
        autograd_fwd_ms = {FD_P: forward_ms(FD_P), 0.0: forward_ms(0.0)}
        plain = {"fwd": lambda: fd.flash_attention_dropout_reference(
                     q, k, v, bias, seed, FD_P, scale),
                 "dq": lambda: fd.flash_dropout_dq_reference(*qkv, o, *rest),
                 "dkv": lambda: fd.flash_dropout_dkv_reference(
                     *qkv, delta, *rest),
                 "keep_mask": lambda: fd.keep_mask_reference(
                     b, h, t, seed, FD_P, dev)}
        row = {"B": b, "H": h, "T": t, "d": d, "err": err, "p0_ms": p0_ms,
               "autograd_ms": autograd_ms, "autograd_fwd_ms": autograd_fwd_ms}
        for name in kern:
            row[name] = {"ms": cuda_ms(kern[name], reps),
                         "plain_ms": cuda_ms(plain[name], plain_reps,
                                             warmup=1)}
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        attend = ~pad[:, None, None, :]
        row["fwd"]["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=attend, dropout_p=FD_P, scale=scale),
            reps)
        qg, kg, vg = (x.detach().requires_grad_() for x in (qb, kb, vb))
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attend,
                                             dropout_p=FD_P, scale=scale)
        dob = do.to(torch.bfloat16)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), dob, retain_graph=True), reps)
        row["dq"]["library_ms"] = row["dkv"]["library_ms"] = bwd_ms
        row["keep_mask"]["library_ms"] = None
        for name, (bms, by) in fd_bounds(b, h, t, d).items():
            row[name].update(bound_ms=bms, bound_by=by)
        rows.append(row)
        print(f"flash dropout B={b} T={t:5d} d={d:3d}: max|diff| O "
              f"{err['fwd']:.3e} dQ/D {err['dq']:.3e} dK/dV {err['dkv']:.3e}"
              f"; rms diff / rms O {rms['fwd']:.2e} dQ/D {rms['dq']:.2e} "
              f"dK/dV {rms['dkv']:.2e}; mask bit-identical, keep rate "
              f"{rate:.5f}")
        for name in kern:
            r = row[name]
            lib = ("" if r["library_ms"] is None else
                   f"  sdpa {'fwd' if name == 'fwd' else 'bwd'} "
                   f"{r['library_ms']:.4f} ms")
            p0 = (f"  (p=0: {p0_ms[name]:.4f} ms, mask share "
                  f"{1 - p0_ms[name] / r['ms']:.1%})" if name in p0_ms
                  else "")
            print(f"  {name:9s} kernel {r['ms']:.4f} ms{p0}  plain "
                  f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}){lib}")
        print(f"  forward as training runs it (autograd: q, k, v casts, "
              f"kernel) {autograd_fwd_ms[FD_P]:.4f} ms (p=0: "
              f"{autograd_fwd_ms[0.0]:.4f} ms); sdpa fwd "
              f"{row['fwd']['library_ms']:.4f} ms")
        print(f"  backward as training runs it (autograd: dO cast, dQ, "
              f"dK/dV) {autograd_ms[FD_P]:.4f} ms (p=0: "
              f"{autograd_ms[0.0]:.4f} ms); dQ + dK/dV alone "
              f"{row['dq']['ms'] + row['dkv']['ms']:.4f} ms; sdpa bwd "
              f"{bwd_ms:.4f} ms")
        del (q, k, v, do, o, lse, delta, qb, kb, vb, qg, kg, vg, out, dob,
             ops, bits)
    # per micro-step at the largest bucket pair: 4 encoder launches at
    # T=256 and 4 decoder launches at T=3584
    step = [r for r in rows if (r["T"], r["d"]) in ((256, 128), (3584, 128))]
    report = {}
    for name in ("fwd", "dq", "dkv", "keep_mask"):
        report[name] = {key: (None if step[0][name][key] is None
                              else 4 * sum(r[name][key] for r in step))
                        for key in ("ms", "plain_ms", "bound_ms",
                                    "library_ms")}
        report[name]["bound_by"] = max(step, key=lambda r: r[name][
            "bound_ms"])[name]["bound_by"]
        p0 = (f" (p=0: {4 * sum(r['p0_ms'][name] for r in step):.4f} ms)"
              if name in step[0]["p0_ms"] else "")
        lib = ("" if report[name]["library_ms"] is None else
               f"  sdpa {'fwd' if name == 'fwd' else 'bwd'} "
               f"{report[name]['library_ms']:.4f} ms")
        print(f"{name} per (256, 3584) micro-step (8 launches): kernel "
              f"{report[name]['ms']:.4f} ms{p0}  plain "
              f"{report[name]['plain_ms']:.4f} ms  bound "
              f"{report[name]['bound_ms']:.4f} ms{lib}")
    print("forward as training runs it, per (256, 3584) micro-step: "
          + ", ".join(f"p={p}: "
                      f"{4 * sum(r['autograd_fwd_ms'][p] for r in step):.4f}"
                      " ms" for p in (FD_P, 0.0))
          + f"; sdpa fwd {report['fwd']['library_ms']:.4f} ms")
    print("backward as training runs it, per (256, 3584) micro-step: "
          + ", ".join(f"p={p}: {4 * sum(r['autograd_ms'][p] for r in step):.4f}"
                      " ms" for p in (FD_P, 0.0))
          + f"; sdpa bwd {report['dq']['library_ms']:.4f} ms")
    print(f"keep-mask kernel: {fd.KEEP_MASK.launches} launches in this "
          "phase, its oracle role (training never launches it)")
    return {"report": report,
            "max_abs_err": {n: max(r["err"][n] for r in rows)
                            for n in ("fwd", "dq", "dkv")},
            "checked": {(r["B"], r["T"], r["d"]) for r in rows}}


def write_train_corpus(root, n_speaker: int, ranges: dict, per_pair: dict,
                       seed: int):
    """A seeded TTE corpus in the format `data/tte_data.py::TTEDataset`
    reads: <root>/tte/{train,val}.txt manifests, speakers.json, and the
    aligner's symbols under <root>/aligner. ranges: bucket pair ->
    ((min, max) tokens, (min, max) codes); each pair gets per_pair[split]
    utterances (durations >= 1 summing to the code count)."""
    from pathlib import Path

    root = Path(root)
    rng = np.random.default_rng(seed)
    symbols = list("abcdefghijklmnopqrstuvwxyz")
    (root / "aligner").mkdir(parents=True)
    (root / "aligner" / "symbols.json").write_text(json.dumps(symbols))
    (root / "tte").mkdir()
    speakers = {f"spk{i}": i for i in range(n_speaker)}
    (root / "tte" / "speakers.json").write_text(json.dumps(speakers))
    for split, count in per_pair.items():
        lines = []
        for (s_lo, s_hi), (t_lo, t_hi) in ranges.values():
            for i in range(count):
                n_tok = int(rng.integers(s_lo, s_hi + 1))
                n_code = int(rng.integers(max(t_lo, n_tok), t_hi + 1))
                durs = rng.multinomial(n_code - n_tok,
                                       np.full(n_tok, 1.0 / n_tok)) + 1
                spk = f"spk{i % n_speaker}"
                lines.append(str({
                    "audio": f"/corpus/{spk}_{split}_{len(lines):04d}.wav",
                    "hubert": " ".join(map(str, rng.integers(0, 1000,
                                                             n_code))),
                    "duration": " ".join(map(str, durs)),
                    "speaker": spk,
                    "characters": " ".join(rng.choice(symbols, n_tok)),
                }))
        (root / "tte" / f"{split}.txt").write_text("\n".join(lines) + "\n")
    return root / "tte", root / "aligner"


def bucket_ranges(pairs, train_cfg, max_len: int) -> dict:
    """(src, tgt) pair -> ((min, max) tokens, (min, max) codes) of the
    utterances the loader puts in that pair (codes capped at max_len)."""
    def lower(buckets, x):
        return max((b for b in buckets if b < x), default=x // 2) + 1

    return {(s, t): ((lower(train_cfg.src_buckets, s), s),
                     (lower(train_cfg.tgt_buckets, t), min(t, max_len)))
            for s, t in pairs}


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic implementations (the length regulator's gather
    backward, a scatter-add, has atomics otherwise), without filling new
    tensors with NaN; the previous settings restored on exit."""
    import torch.utils.deterministic as det

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


def phase_train(fd, fa, tcfg, train_cfg, pairs, checked: set,
                checked_eval: set, device=None) -> dict:
    """TTE training through pipeline/train_tte.run: 2 optimizer steps (8
    micro-batches, 4 per bucket pair) from a seeded corpus, then the
    checks; a resumed run; and the kernels' loss and gradients against
    plain attention at one (256, 3584) micro-batch at dropout 0, on the
    seeded initial weights the training starts from."""
    import tempfile

    from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
    from parrot_tts_tpu_torch.core.config import PipelineConfig
    from parrot_tts_tpu_torch.core.device import exact_numerics
    from parrot_tts_tpu_torch.data.tte_data import BucketedLoader, TTEDataset
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.ops import attention
    from parrot_tts_tpu_torch.pipeline import train_tte
    from parrot_tts_tpu_torch.train import tte as tte_train

    acc = train_cfg.grad_acc_steps
    n_blocks = tcfg.encoder.n_layer + tcfg.decoder.n_layer
    records: list = []
    real_step = tte_train._micro_step

    def micro_step(state, batch, *args):
        before = [p.detach().clone() for p in state.model.parameters()]
        counts = (fd.FWD.launches, fd.DQ.launches, fd.DKV.launches)
        start = state.step
        metrics = real_step(state, batch, *args)
        changed = any(not torch.equal(a, p) for a, p in
                      zip(before, state.model.parameters()))
        records.append({
            "start": start, "loss": float(metrics["total_loss"]),
            "changed": changed, "shape": tuple(batch["codes"].shape),
            "launches": (fd.FWD.launches - counts[0],
                         fd.DQ.launches - counts[1],
                         fd.DKV.launches - counts[2]),
            "state": state})
        return metrics

    def attention_key(q, *args, **kwargs):
        return tuple(q.shape[i] for i in (0, 2, 3))

    with tempfile.TemporaryDirectory(prefix="parrot_train_") as tmp:
        per_pair = {"train": acc * train_cfg.batch_size,
                    "val": train_cfg.batch_size}
        root, align = write_train_corpus(
            tmp, tcfg.n_speaker, bucket_ranges(pairs, train_cfg,
                                               tcfg.max_len),
            per_pair, SEED + 4)
        cfg = PipelineConfig(root_path=str(root), alignment_path=str(align),
                             tte_model=tcfg, tte_train=train_cfg)
        run_dir = f"{tmp}/run"
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(tte_train, "_micro_step",
                                                  micro_step))
            seen = {name: stack.enter_context(recording(fd, name,
                                                        attention_key))
                    for name in ("flash_dropout_fwd", "flash_dropout_dq",
                                 "flash_dropout_dkv")}
            seen_eval = stack.enter_context(recording(
                attention, "flash_attention", attention_key))
            for kern in (fd.FWD, fd.DQ, fd.DKV, fd.KEEP_MASK, fa.FLASH_FWD):
                kern.launches = 0
            t0 = time.perf_counter()
            out = train_tte.run(cfg, run_dir=run_dir, max_steps=2,
                                device=device)
            wall = time.perf_counter() - t0
            launches = {"fwd": fd.FWD.launches, "dq": fd.DQ.launches,
                        "dkv": fd.DKV.launches,
                        "keep_mask": fd.KEEP_MASK.launches,
                        "flash_attn_fwd": fa.FLASH_FWD.launches}
        print(f"train: {out}, {len(records)} micro-steps in {wall:.3f} s "
              f"(first use included); launches {launches}")
        for r in records:
            print(f"  micro-step {r['start']}: codes {r['shape']}, loss "
                  f"{r['loss']:.5f}, params changed {r['changed']}, rows 2-4 "
                  f"launches {r['launches']}")
        if out["steps"] != 2 or len(records) != 2 * acc:
            raise AssertionError(f"{out}, {len(records)} micro-steps")
        if not all(math.isfinite(r["loss"]) for r in records):
            raise AssertionError("a non-finite loss")
        if [r["changed"] for r in records] != [(i + 1) % acc == 0
                                               for i in range(2 * acc)]:
            raise AssertionError("params did not change at exactly every "
                                 f"{acc}-th micro-step")
        if any(r["launches"] != (n_blocks,) * 3 for r in records):
            raise AssertionError(f"rows 2-4 not launched {n_blocks} times "
                                 "each per micro-step")
        tgts = {r["shape"][1] for r in records}
        if tgts != {t for _, t in pairs}:
            raise AssertionError(f"micro-batches at codes {tgts}")
        for name, shapes in seen.items():
            if device is None and not shapes <= checked:
                raise AssertionError(f"{name} at {sorted(shapes - checked)},"
                                     " which phase 10 did not check")
        if device is None and not seen_eval <= checked_eval:
            raise AssertionError(f"evaluation attention at "
                                 f"{sorted(seen_eval - checked_eval)}, "
                                 "which phase 3 did not check")

        # the checkpoint holds the live state, bit for bit
        state = records[-1]["state"]
        mgr = CheckpointManager(f"{run_dir}/ckpt")
        saved = mgr.restore()
        live = state.state_dict()
        for part in ("params", "mu", "nu", "acc"):
            for key, x in live[part].items():
                if not torch.equal(saved[part][key], x.cpu()):
                    raise AssertionError(f"checkpoint {part}.{key} differs")
        if (saved["step"], saved["count"], mgr.latest_step()) != (
                2 * acc, 2, 2):
            raise AssertionError(f"checkpoint step {saved['step']}, count "
                                 f"{saved['count']}")
        # a resumed run carries on from micro-step 2 * acc
        records.clear()
        with mock.patch.object(tte_train, "_micro_step", micro_step):
            out2 = train_tte.run(cfg, run_dir=run_dir, max_steps=3,
                                 device=device)
        if out2["steps"] != 3 or records[0]["start"] != 2 * acc:
            raise AssertionError(f"resume: {out2}, first micro-step "
                                 f"{records[0]['start']}")
        print(f"resumed: {out2}, first micro-step {records[0]['start']}; "
              "checkpoint restored params, moments and step bit for bit")

        # kernels against plain attention at one (256, 3584) micro-batch,
        # dropout 0, IEEE float32 elsewhere
        ds = TTEDataset(root, align, "train", tcfg.hubert_codes)
        loader = BucketedLoader(ds, train_cfg.batch_size,
                                train_cfg.src_buckets, train_cfg.tgt_buckets,
                                seed=train_cfg.seed)
        batch_np = next(b for b in loader.batches(0)
                        if b["codes"].shape[1] == pairs[-1][1])
    # compared on a state that is the same in every run: the seeded
    # initial weights (`train/tte.py::init_state`), not the trained state,
    # which TF32 training and cuDNN's algorithm choice make differ from run
    # to run
    cfg0 = dataclasses.replace(
        state.model.cfg, dur_dropout_p=0.0,
        encoder=dataclasses.replace(tcfg.encoder, dropout_p=0.0),
        decoder=dataclasses.replace(tcfg.decoder, dropout_p=0.0))
    model0 = parrot.Parrot(cfg0)
    model0.load_state_dict(parrot.init_parrot(
        cfg0, torch.Generator().manual_seed(train_cfg.seed)), strict=True)
    model0 = model0.to(state.model.pe.device)
    batch = tte_train.to_batch(batch_np, model0.pe.device)
    out_len = batch_np["codes"].shape[1]
    params = list(model0.parameters())

    def loss_and_grads():
        with exact_numerics(True), deterministic_algorithms():
            total, _ = tte_train.loss_fn(model0, batch, cfg0, out_len,
                                         (SEED, 0))
            return float(total.detach()), torch.autograd.grad(total,
                                                              params)

    def plain_fwd(*args, operands):
        return fd.flash_attention_dropout_reference(*args)

    def plain_dq(*args, operands):
        return (*fd.flash_dropout_dq_reference(*args), None)

    def plain_dkv(*args, bits, operands):
        return fd.flash_dropout_dkv_reference(*args)

    before = fd.FWD.launches
    loss_k, grads_k = loss_and_grads()
    kernel_launches = fd.FWD.launches - before
    loss_r, grads_r = loss_and_grads()
    repeat = loss_r == loss_k and all(torch.equal(a, b) for a, b in
                                      zip(grads_k, grads_r))
    print(f"kernel loss and gradients taken twice: bit-equal {repeat}")
    if not repeat:
        raise AssertionError("the parity comparison is not reproducible")
    del grads_r
    with mock.patch.object(fd, "flash_dropout_fwd", plain_fwd), \
            mock.patch.object(fd, "flash_dropout_dq", plain_dq), \
            mock.patch.object(fd, "flash_dropout_dkv", plain_dkv):
        loss_p, grads_p = loss_and_grads()
    if device is None and kernel_launches != n_blocks:
        raise AssertionError(f"{kernel_launches} forward launches")
    dl = abs(loss_k - loss_p) / abs(loss_p)
    num = sum(float((a - b).pow(2).sum()) for a, b in zip(grads_k, grads_p))
    den = sum(float(b.pow(2).sum()) for b in grads_p)
    rel = math.sqrt(num / den)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(grads_k, grads_p))
    print(f"kernels against plain attention at codes {tuple(batch_np['codes'].shape)},"
          f" dropout 0, initial weights: loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(rel {dl:.2e}), |dg|/|g| {rel:.2e}, worst tensor max|dg|/max|g| "
          f"{worst:.2e}")
    if not (dl <= TRAIN_LOSS_RTOL and rel <= TRAIN_GRAD_RTOL
            and worst <= TRAIN_GRAD_MAX):
        raise AssertionError("training with the kernels departs from plain "
                             "attention")
    return {"launches": launches, "state": state, "cfg": state.model.cfg,
            "batch": batch, "out_len": out_len}


def phase_train_profile(state, model_cfg, train_cfg, batch, out_len) -> None:
    """One more micro-step at (256, 3584) under torch.profiler, and
    micro-steps per second over one optimizer step (a reading, not a
    benchmark)."""
    from parrot_tts_tpu_torch.train import tte as tte_train

    def step():
        tte_train.train_step(state, batch, SEED, model_cfg, train_cfg,
                             out_len)
        torch.cuda.synchronize()

    step()
    phase_profile(step, f"training micro-step at codes "
                        f"{tuple(batch['codes'].shape)}")
    n = train_cfg.grad_acc_steps
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    dt = time.perf_counter() - t0
    print(f"training reading: {n} micro-steps (one optimizer step) in "
          f"{dt:.3f} s = {n / dt:.3f} micro-steps/s at codes "
          f"{tuple(batch['codes'].shape)}")


def phase_gemm(qc) -> dict:
    """The row-8 GEMM against its plain version (int8 equal, bf16 and
    float32 within MM_RTOL * sqrt(K) of max |plain|) at the rate shape, a
    ragged and a small shape, each with the plan's branch; kernel, plain,
    bound and library ms at the rate shape, and the int8 B^T pass alone."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cases = [(RATE_SHAPE, (torch.int8, torch.bfloat16))] + [
        (shape, (torch.int8, torch.bfloat16, torch.float32))
        for shape in ((1000, 1000, 1000), (17, 33, 9))]
    report, err_max = {}, 0.0
    for (m, k, n), dtypes in cases:
        for dtype in dtypes:
            if dtype == torch.int8:
                a, b = (torch.randint(-127, 128, s, generator=gen,
                                      device="cuda", dtype=torch.int8)
                        for s in ((m, k), (k, n)))
            else:
                a, b = (torch.randn(s, generator=gen, device="cuda"
                                    ).to(dtype) for s in ((m, k), (k, n)))
            got = qc.matmul(a, b)
            want = qc.matmul_reference(a, b)
            torch.cuda.synchronize()
            if dtype == torch.int8:
                if not torch.equal(got, want):
                    raise AssertionError(f"GEMM int8 {(m, k, n)}: not equal")
                err, lim = 0.0, 0.0
            else:
                err = float((got - want).abs().max())
                lim = MM_RTOL * math.sqrt(k) * float(want.abs().max())
                if not err <= lim:
                    raise AssertionError(f"GEMM {dtype} {(m, k, n)}: max "
                                         f"|diff| {err} > {lim}")
            err_max = max(err_max, err)
            plan = qc.gemm_plan(m, k, n, dtype)
            line = (f"GEMM (M, K, N) = {(m, k, n)} {str(dtype)[6:]}: "
                    f"max|diff| {err:.3e} (limit {lim:.3e})  {plan['route']}"
                    f", branch {plan['branch']}")
            if (m, k, n) == RATE_SHAPE:
                ops = 2.0 * m * k * n
                esize = a.element_size()
                bound_ms, bound_by = bound(
                    ops, INT8_PEAK if dtype == torch.int8 else BF16_PEAK,
                    esize * (m * k + k * n) + 4.0 * m * n)
                row = {"ms": cuda_ms(lambda: qc.matmul(a, b), 20),
                       "plain_ms": cuda_ms(lambda: qc.matmul_reference(a, b),
                                           3, warmup=1),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": cuda_ms(
                           (lambda: torch._int_mm(a, b)) if dtype == torch.int8
                           else (lambda: torch.matmul(a, b)), 20)}
                report[dtype] = row
                unit = "TOP/s" if dtype == torch.int8 else "TFLOP/s"
                peak = (INT8_PEAK if dtype == torch.int8 else BF16_PEAK) / 1e12
                line += (f"  kernel {row['ms']:.4f} ms "
                         f"({ops / row['ms'] / 1e9:.1f} {unit} of {peak:.0f}, "
                         f"{100 * bound_ms / row['ms']:.1f}% of the bound)  "
                         f"plain {row['plain_ms']:.4f} ms  bound "
                         f"{bound_ms:.4f} ms ({bound_by})  "
                         f"{'torch._int_mm' if dtype == torch.int8 else 'torch.matmul'}"
                         f" {row['library_ms']:.4f} ms")
                if dtype == torch.int8:
                    bt_ms = cuda_ms(lambda: qc.transpose_int8_b(
                        b, plan["ldb"]), 20)
                    line += (f"\nGEMM int8 B^T pass alone (part of the kernel"
                             f" time above): {bt_ms:.4f} ms, {2 * k * n} bytes"
                             f" ({2 * k * n / bt_ms / 1e6:.1f} GB/s; the bytes"
                             f" bound {2e3 * k * n / HBM_RATE:.4f} ms)")
            print(line)
            del a, b, got, want
    return {"report": report[torch.int8], "max_abs_err": err_max}


def phase_int8_experiment(qc) -> int:
    """The ported int8 experiment, parts 1 and 2, with few repetitions;
    returns the GEMM launches it made."""
    from parrot_tts_tpu_torch.scripts import exp_int8_rate

    qc.MATMUL.launches = 0
    t0 = time.perf_counter()
    exp_int8_rate.run(reps=3, out=lambda line: print(f"  {line}"))
    launches = qc.MATMUL.launches
    print(f"int8 experiment: {time.perf_counter() - t0:.2f} s, GEMM "
          f"launches {launches}")
    if launches == 0:
        raise AssertionError("the int8 experiment never launched the GEMM")
    return launches


GAN_STEPS = 4                # phase 14's training steps
GAN_TIMED = 5                # warm steps of its steps-per-second reading
# phase 14's parity: one full-width GAN step in IEEE float32 against the
# same step in float64 on the card, from the seeded initial state
GAN_LOSS_RTOL = 1e-4
GAN_GRAD_RTOL = 1e-3         # |dg| / |g| per network
GAN_GRAD_MAX = 1e-2          # max |dg| <= this * max |g|, per tensor
# kinds of kernel in phase 14's profiled step, by name
GAN_PROFILE_SPLIT = (
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions", ("conv", "cudnn", "cutlass", "xmma", "implicit_gemm",
                      "dgrad", "wgrad")),
    ("AdamW (fused)", ("fused_adam", "FusedAdam", "multi_tensor")),
    ("FFT", ("fft", "FFT")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def write_vocoder_corpus(root, n_train: int, n_val: int, seconds,
                         seed: int):
    """A seeded vocoder corpus in the format `data/vocoder_data.py` reads:
    16 kHz wavs of `seconds` = (min, max) length over two speakers (file
    names spk0_x_* / spk1_x_*), and train.txt / val.txt manifests of random
    HuBERT units at 50 per second."""
    from pathlib import Path

    from parrot_tts_tpu_torch.data.audio_io import write_wav
    from parrot_tts_tpu_torch.data.manifest import write_manifest

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        entries = []
        for i in range(n):
            n_samp = int(16000 * rng.uniform(*seconds))
            path = root / "wavs" / f"spk{i % 2}_x_{split}_{i:03d}.wav"
            # a few harmonics under noise, so the mel is not flat
            t = np.arange(n_samp) / 16000.0
            f0 = rng.uniform(90, 250)
            wav = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in (1, 2, 3))
            write_wav(path, 0.3 * wav + 0.05 * rng.standard_normal(n_samp),
                      16000)
            entries.append({"audio": str(path), "hubert": " ".join(map(
                str, rng.integers(0, 1000, n_samp * 50 // 16000)))})
        write_manifest(root / f"{split}.txt", entries)
    return root


def to_float64(state):
    """The GAN state in float64 (networks, buffers and moments; the
    parameters stay the optimizers' own)."""
    for m in (state.gen, state.mpd, state.msd):
        m.double()
    for opt in (state.opt_g, state.opt_d):
        for st in opt.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                st[key] = st[key].double()
    return state


def gan_grads(state) -> dict:
    """Each network's gradients of the state's one update from zero
    moments: the first moment is (1 - b1) g."""
    mu = state.moments()
    nets = {"G": mu["mu_g"],
            "MPD": {k: v for k, v in mu["mu_d"].items()
                    if k.startswith("mpd.")},
            "MSD": {k: v for k, v in mu["mu_d"].items()
                    if k.startswith("msd.")}}
    return {n: {k: v.double() for k, v in d.items()} for n, d in nets.items()}


def phase_gan(mcfg, tcfg, mel_cfg, corpus: dict, device=None) -> dict:
    """Vocoder GAN training at full width through pipeline/train_vocoder.run
    for GAN_STEPS steps on a seeded corpus, with the checks; a resumed run;
    one step in IEEE float32 against float64 from the seeded initial
    state; steps per second and a profiled step (readings)."""
    import tempfile

    from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
    from parrot_tts_tpu_torch.core.config import PipelineConfig
    from parrot_tts_tpu_torch.core.device import resolve_device
    from parrot_tts_tpu_torch.data.vocoder_data import (VocoderDataset,
                                                        VocoderLoader)
    from parrot_tts_tpu_torch.pipeline import train_vocoder
    from parrot_tts_tpu_torch.train import vocoder as voc_train

    dev = resolve_device(device)
    records: list = []
    real_step = voc_train.train_step

    def step_spy(state, *args, **kwargs):
        nets = (state.gen, state.mpd, state.msd)
        before = [[p.detach().clone() for p in m.parameters()] for m in nets]
        u0 = state.msd.discriminators[0].convs[0].weight_u.clone()
        start = state.step
        t0 = time.perf_counter()
        metrics = real_step(state, *args, **kwargs)
        values = {k: float(v) for k, v in metrics.items()}
        records.append({
            "start": start, "s": time.perf_counter() - t0, **values,
            "changed": [all(not torch.equal(a, p) for a, p in
                            zip(b, m.parameters()))
                        for b, m in zip(before, nets)],
            "u_moved": not torch.equal(
                u0, state.msd.discriminators[0].convs[0].weight_u),
            "state": state})
        return metrics

    with tempfile.TemporaryDirectory(prefix="parrot_gan_") as tmp:
        data = write_vocoder_corpus(tmp, seed=SEED + 7, **corpus)
        cfg = PipelineConfig(vocoder_model=mcfg, vocoder_train=tcfg,
                             mel=mel_cfg)
        run_dir = f"{tmp}/run"
        with mock.patch.object(voc_train, "train_step", step_spy):
            t0 = time.perf_counter()
            out = train_vocoder.run(cfg, data_dir=data, run_dir=run_dir,
                                    max_steps=GAN_STEPS, device=device)
            wall = time.perf_counter() - t0
        print(f"GAN train: {out}, {len(records)} steps in {wall:.3f} s "
              f"(first use, corpus load and checkpoints included)")
        for r in records:
            print(f"  step {r['start']}: {r['s']:.3f} s, D loss "
                  f"{r['loss_disc_all']:.5f}, G loss {r['loss_gen_all']:.5f},"
                  f" mel error {r['mel_error']:.5f}; G / MPD / MSD every "
                  f"tensor changed {r['changed']}, MSD scale-0 u advanced "
                  f"{r['u_moved']}")
        if out["steps"] != GAN_STEPS or len(records) != GAN_STEPS:
            raise AssertionError(f"GAN run: {out}, {len(records)} steps")
        if not all(math.isfinite(r[k]) for r in records
                   for k in ("loss_disc_all", "loss_gen_all", "mel_error")):
            raise AssertionError("a non-finite GAN loss")
        if not all(all(r["changed"]) and r["u_moved"] for r in records):
            raise AssertionError("a GAN step left a network or the MSD's "
                                 "power-iteration vector unchanged")
        logs = [json.loads(line) for line in
                open(f"{run_dir}/logs/metrics.jsonl")]
        val = [x["value"] for x in logs
               if x["tag"] == "validation/mel_spec_error"]
        if len(val) != GAN_STEPS // tcfg.validation_interval or not all(
                math.isfinite(v) for v in val):
            raise AssertionError(f"validation mel errors {val}")
        rates = [round(x["value"], 3) for x in logs
                 if x["tag"] == "train_audio_seconds_per_second"]
        print(f"validation mel error {val}; train audio-s/s logged {rates}")
        # the checkpoint holds the live state, bit for bit
        live = records[-1]["state"].state_dict()
        mgr = CheckpointManager(f"{run_dir}/ckpt")
        saved = mgr.restore()
        for part in ("gen", "mpd", "msd", "mu_g", "nu_g", "mu_d", "nu_d"):
            if saved[part].keys() != live[part].keys() or not all(
                    torch.equal(saved[part][k], v.cpu())
                    for k, v in live[part].items()):
                raise AssertionError(f"checkpoint {part} differs")
        if (saved["step"], mgr.latest_step()) != (GAN_STEPS, GAN_STEPS):
            raise AssertionError(f"checkpoint step {saved['step']}")
        del live, saved
        records.clear()
        with mock.patch.object(voc_train, "train_step", step_spy):
            out2 = train_vocoder.run(cfg, data_dir=data, run_dir=run_dir,
                                     max_steps=GAN_STEPS + 1, device=device)
        if out2["steps"] != GAN_STEPS + 1 or [r["start"] for r in records] \
                != [GAN_STEPS]:
            raise AssertionError(f"resume: {out2}, steps "
                                 f"{[r['start'] for r in records]}")
        print(f"resumed: {out2}, first step {records[0]['start']}; the "
              "checkpoint held the networks, buffers, moments and step "
              "bit for bit")
        records.clear()
        ds = VocoderDataset(data / "train.txt",
                            segment_size=tcfg.segment_size,
                            code_hop_size=tcfg.code_hop_size)
        batch_np = next(VocoderLoader(ds, tcfg.batch_size,
                                      seed=tcfg.seed).batches(0))
        steps_per_epoch = max(1, len(ds) // tcfg.batch_size)

    # one step from the seeded initial state: IEEE float32 (twice) against
    # float64, deterministic algorithms
    def one_step(float64: bool):
        state = voc_train.init_state(tcfg.seed, mcfg, dev)
        batch = voc_train.to_batch(batch_np, dev)
        if float64:
            state = to_float64(state)
            batch["audio"] = batch["audio"].double()
        with deterministic_algorithms():
            m = voc_train.train_step(state, batch, mcfg, tcfg, mel_cfg,
                                     steps_per_epoch, exact=True)
        return {k: float(v) for k, v in m.items()}, state

    m32, s32 = one_step(False)
    m32b, s32b = one_step(False)
    a, b = s32.state_dict(), s32b.state_dict()
    repeat = m32 == m32b and all(
        torch.equal(a[p][k], b[p][k]) for p in a if isinstance(a[p], dict)
        for k in a[p])
    print(f"GAN step in float32 taken twice: bit-equal {repeat}")
    if not repeat:
        raise AssertionError("the float32 GAN step is not reproducible")
    del s32b, a, b
    m64, s64 = one_step(True)
    g32, g64 = gan_grads(s32), gan_grads(s64)
    del s32, s64
    fails = []
    for k in m32:
        rel = abs(m32[k] - m64[k]) / abs(m64[k])
        print(f"  {k}: float32 {m32[k]:.8f} float64 {m64[k]:.8f} rel "
              f"{rel:.2e}")
        if not rel <= GAN_LOSS_RTOL:
            fails.append(k)
    for net in g32:
        num = sum(float((g32[net][k] - v).pow(2).sum())
                  for k, v in g64[net].items())
        den = sum(float(v.pow(2).sum()) for v in g64[net].values())
        worst = max(float((g32[net][k] - v).abs().max())
                    / max(float(v.abs().max()), 1e-30)
                    for k, v in g64[net].items())
        rel = math.sqrt(num / den)
        print(f"  {net} gradients: |dg|/|g| {rel:.2e}, worst tensor "
              f"max|dg|/max|g| {worst:.2e} ({len(g64[net])} tensors)")
        if not (rel <= GAN_GRAD_RTOL and worst <= GAN_GRAD_MAX):
            fails.append(net)
    if fails:
        raise AssertionError(f"GAN step float32 against float64: {fails}")
    del g32, g64

    # readings: steps per second and one profiled step, as training runs
    # (TF32 convolutions)
    state = voc_train.init_state(tcfg.seed, mcfg, dev)
    batch = voc_train.to_batch(batch_np, dev)

    def step():
        voc_train.train_step(state, batch, mcfg, tcfg, mel_cfg,
                             steps_per_epoch)

    if dev.type == "cuda":
        ms = cuda_ms(step, GAN_TIMED)
        audio_s = tcfg.batch_size * tcfg.segment_size / mel_cfg.sampling_rate
        print(f"GAN reading: {1e3 / ms:.3f} steps/s ({ms:.3f} ms per step "
              f"over {GAN_TIMED} warm steps, CUDA events; "
              f"{audio_s * 1e3 / ms:.3f} audio-s/s of {audio_s:.2f} s "
              f"segments per step)")
        phase_profile(lambda: (step(), torch.cuda.synchronize()),
                      f"GAN step at batch {tcfg.batch_size} x "
                      f"{tcfg.segment_size} samples", GAN_PROFILE_SPLIT)
    return {"records": records}


def phase_manifest_io(fa, tts, speakers, device=None) -> None:
    """write_predictions on the phase-4 TTE, for every non-empty request
    and with the serve's encoder buckets (so the same decode batches),
    gives the units that ParrotTTS decodes; synthesize_text gives a finite
    waveform of len(units) * 320 samples for each."""
    import tempfile
    from pathlib import Path

    from parrot_tts_tpu_torch.data.manifest import parse_manifest_line
    from parrot_tts_tpu_torch.data.tte_data import TTEDataset
    from parrot_tts_tpu_torch.infer import synthesize, tte_infer
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.text.cleaners import english_cleaners

    picked = [i for i, t in enumerate(TEXTS) if len(tts.tokenize(t))]
    tokens = [tts.tokenize(TEXTS[i]) for i in picked]
    spk = [speakers[i] for i in picked]
    want = tts.predict_units(tokens, spk)
    with tempfile.TemporaryDirectory(prefix="parrot_pred_") as tmp:
        root = Path(tmp)
        (root / "aligner").mkdir()
        (root / "aligner" / "symbols.json").write_text(json.dumps(
            [" "] + list("abcdefghijklmnopqrstuvwxyz,.?")))
        n_spk = tts.tte_cfg.n_speaker
        (root / "speakers.json").write_text(json.dumps(
            {f"spk{i}": i for i in range(n_spk)}))
        (root / "val.txt").write_text("".join(str({
            "audio": f"{tmp}/req_{i}.wav", "hubert": "0", "duration": "1",
            "speaker": f"spk{s}",
            "characters": " ".join(tts.tokenizer.itos[int(x)] for x in tok),
        }) + "\n" for i, (tok, s) in enumerate(zip(tokens, spk))))
        ds = TTEDataset(root, root / "aligner", "val",
                        tts.tte_cfg.hubert_codes)
        fa.FLASH_FWD.launches = 0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # no wavs: durations fall back
            path = tte_infer.write_predictions(
                tts.tte, ds, root / "predictions.txt",
                src_buckets=tts.src_buckets, device=device)
        launches = fa.FLASH_FWD.launches
        got = [parse_manifest_line(line)["hubert"]
               for line in path.read_text().splitlines()]
    same = [g == " ".join(map(str, u.tolist())) for g, u in zip(got, want)]
    print(f"write_predictions: {len(got)} requests of "
          f"{[len(t) for t in tokens]} tokens, units equal to the serve's "
          f"decode {same}; row-1 launches {launches}")
    if len(got) != len(want) or not all(same):
        raise AssertionError("write_predictions differs from the serve's "
                             "decode")
    if device is None and launches == 0:
        raise AssertionError("write_predictions never launched row 1")
    decoded = []
    real = parrot.infer_codes

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        decoded.append(int(out[1].sum()))
        return out

    lengths = []
    with mock.patch.object(parrot, "infer_codes", spy):
        for i, s in zip(picked, spk):
            decoded.clear()
            wav = synthesize.synthesize_text(
                TEXTS[i], tte_model=tts.tte, tokenizer=tts.tokenizer,
                synthesizer=tts.vocoder, cleaner=english_cleaners,
                speaker_id=s, device=device)
            lengths.append((len(wav), decoded[-1], len(decoded)))
            if len(wav) != decoded[-1] * 320 or not np.isfinite(wav).all():
                raise AssertionError(f"synthesize_text({TEXTS[i]!r}): "
                                     f"{len(wav)} samples for {decoded[-1]}"
                                     " units")
    print(f"synthesize_text: (samples, units, decodes) {lengths}, finite")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from parrot_tts_tpu_torch.core import kernels
    from parrot_tts_tpu_torch.core.config import (MelConfig, TTEModelConfig,
                                                  TTETrainConfig,
                                                  VocoderModelConfig,
                                                  VocoderTrainConfig)
    from parrot_tts_tpu_torch.core.device import exact_numerics
    from parrot_tts_tpu_torch.ops import flash_attention as fa
    from parrot_tts_tpu_torch.ops import flash_dropout as fd
    from parrot_tts_tpu_torch.ops import fused_mrf as fm
    from parrot_tts_tpu_torch.ops import qconv as qc
    from parrot_tts_tpu_torch.ops import quant

    phase_card()
    build = phase_build(kernels)
    kern = phase_kernel(fa, exact_numerics,
                        ptxas_registers(build["flash_attn_fwd"]))
    # full width: d_model 256, 4+4 FFT blocks of 2 heads, V1 vocoder
    tcfg, vcfg = TTEModelConfig(n_speaker=4), VocoderModelConfig()
    base = phase_serving(fa, tcfg, vcfg)
    batches = vocoder_batches(base["units"])
    print("vocoder batches (rows, codes):", batches)
    mrf = phase_mrf_kernel(fm, exact_numerics, base["tts"].vocoder.model,
                           vcfg, batches, ptxas_registers(build["fused_mrf"]))
    q8 = phase_int8_kernel(qc, vcfg, batches)
    fused = phase_fused_serve(
        fm, tcfg, dataclasses.replace(vcfg, fused_mrf=True), base,
        mrf["checked"])
    int8 = {mode: phase_int8_serve(
        qc, tcfg, dataclasses.replace(vcfg, quant=mode), base, q8["checked"])
        for mode in INT8_SITES}
    print("int8 conv launches per serve: " + ", ".join(
        f"{mode} {r['launches']}" for mode, r in int8.items())
        + f" (total {sum(r['launches'] for r in int8.values())})")
    phase_batch_invariance(quant)
    phase_profile(base["serve"], "float serve")
    phase_profile(fused["serve"], "fused serve")
    phase_profile(int8["int8-static"]["serve"], "int8-static serve")
    phase_profile(int8["int8"]["serve"], "int8 serve")
    fdk = phase_flash_dropout(fd, ptxas_registers(build["flash_dropout"]))
    # TTETrainConfig() defaults (batch 6, 4 micro-batches per step, the
    # reference's buckets) with an lr that is not 0 at the first update
    train_cfg = TTETrainConfig(warmup_steps=0, log_every=1, val_every=2,
                               save_every=1)
    tr = phase_train(fd, fa, tcfg, train_cfg, TRAIN_PAIRS, fdk["checked"],
                     set(KERNEL_SHAPES))
    phase_train_profile(tr["state"], tr["cfg"], train_cfg, tr["batch"],
                        tr["out_len"])
    gemm = phase_gemm(qc)
    gemm_launches = phase_int8_experiment(qc)
    # the V1 vocoder and VocoderTrainConfig() defaults (batch 16, segments
    # of 8960 samples), logging every step, validation at the last
    phase_gan(vcfg, VocoderTrainConfig(summary_interval=1,
                                       validation_interval=GAN_STEPS,
                                       checkpoint_interval=GAN_STEPS),
              MelConfig(), dict(n_train=32, n_val=4, seconds=(1.0, 1.6)))
    phase_manifest_io(fa, base["tts"], base["speakers"])
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
        "launches": fused["launches"],
        "max_abs_err": mrf["max_abs_err"],
        **{k: mrf["report"][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by")},
        "library_ms": None,
    }, {
        "name": "int8_conv",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/int8_conv.cu",
        "replaces": "parrot_tts_tpu/ops/pallas_qconv.py:42",
        "launches": sum(r["launches"] for r in int8.values()),
        "max_abs_err": q8["max_abs_err"],
        **{k: q8["report"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
        "library_ms": None,
    }, {
        "name": "int8_gemm",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/int8_gemm.cu",
        "replaces": "parrot_tts_tpu/ops/pallas_qconv.py:162",
        "launches": gemm_launches,
        "max_abs_err": gemm["max_abs_err"],
        **gemm["report"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/flash_dropout.cu",
        "replaces": f"parrot_tts_tpu/ops/flash_dropout.py:{line}",
        "launches": tr["launches"][key],
        "max_abs_err": fdk["max_abs_err"].get(key, 0.0),
        **fdk["report"][key],
    } for name, key, line in (("flash_dropout_fwd", "fwd", 87),
                              ("flash_dropout_dq", "dq", 173),
                              ("flash_dropout_dkv", "dkv", 207),
                              ("keep_mask", "keep_mask", 362))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
