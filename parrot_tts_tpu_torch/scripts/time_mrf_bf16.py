"""Time row 6 (`csrc/fused_mrf.cu`) alone, in its bf16 mode
(`mrf_kernel_bf16`) or its float32 mode (`mrf_kernel`, 3xTF32), at the
launches of one fused serve and of bench.py's vocoder batch, with
`--widths` at every width the kernel takes, and with `--vocoder` the
fused vocoder around it.

    python -m parrot_tts_tpu_torch.scripts.time_mrf_bf16 \
        [--dtype bfloat16|float32] [--widths] [--vocoder] [--reps N]

Run from the root of a checkout, on a machine with a CUDA card; it builds
the checkout's kernel. The shapes are V1's three fused stages (C = 64, 32
and 16 at 80, 160 and 320 samples per code, halo 60) over chip_smoke.py
phase 19's vocoder batches, (2, 128), (1, 256), (3, 512) and (3, 1024)
rows x codes, and over bench.py's batch of 64 x 256 codes (250 codes in
the 256-code bucket); `--widths` adds every multiple of 8 from 8 to 120
at (B, T) = (2, 16387), the second row zero past 2T / 3. Weights and
inputs are random from a seed. Each launch is held to its plain version
(`mrf_fused_reference`: in bf16 the JAX kernel's rounding points, in
float32 IEEE convs) within 2^-6 max |plain| in bf16 and 1e-5 max |plain|
in float32, as chip_smoke.py holds it, and two launches on the same input
must be bit-equal; every shape is printed, and a launch that fails either
check fails the run at its end. Times are CUDA events over back-to-back
launches (mean), each printed beside its bound: the operations on the
bf16 tensor cores (989 TFLOP/s), or in float32 three times them on the
TF32 tensor cores (494.7 TFLOP/s, 3xTF32), or the bytes at 3.35 TB/s
where those take longer. The card's name and power limit come first.
`--vocoder` serves random codes of the same batches (rows x codes)
through `VocoderSynthesizer` with `fused_mrf=True` in the dtype (V1,
weights seeded): ms per set of batches (CUDA events around each
synthesize, the waveforms read back; median of 5 after a warm one), the
device's busy time in one more (torch.profiler: the union of its
kernels' intervals) and the row-6 launches. It only calls public
functions, so the same file times another checkout's kernel when copied
there.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from parrot_tts_tpu_torch.core.device import exact_numerics
from parrot_tts_tpu_torch.ops import fused_mrf as fm

SEED = 20261018
STAGES = ((64, 80), (32, 160), (16, 320))   # (C, samples per code) at V1
KERNEL_SIZES, DILATIONS = (3, 7, 11), ((1, 3, 5),) * 3
SERVE = ((2, 128), (1, 256), (3, 512), (3, 1024))
BENCH = ((64, 256),)
WIDTHS = tuple(range(8, 121, 8))
WIDTH_SHAPE = (2, 16387)
# dtype: (gate, peak FLOP/s, operation factor, bytes per element)
MODES = {"bfloat16": (2.0 ** -6, 989e12, 1, 2),
         "float32": (1e-5, 494.7e12, 3, 4)}
HBM_RATE = 3.35e12


def stage(rng, c: int, dtype: torch.dtype):
    """A stage's packed weights and plan, random (fan-in scaled)."""
    def tens(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    convs = [[(tens(k, c, c, scale=(c * k) ** -0.5), tens(c, scale=0.1),
               tens(k, c, c, scale=(c * k) ** -0.5), tens(c, scale=0.1))
              for _ in ds] for k, ds in zip(KERNEL_SIZES, DILATIONS)]
    w, b, plan = fm.pack_mrf(convs, KERNEL_SIZES, DILATIONS)
    w, b = w.to(dtype).cuda(), b.to(dtype).cuda()
    return w, b, fm.kernel_weights(w, plan), plan


def cuda_ms(fn, reps: int) -> float:
    for _ in range(2):
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


def bound_ms(b: int, t: int, c: int, w, bias, plan, mode: str) -> float:
    _, peak, factor, size = MODES[mode]
    flops = 2.0 * b * t * c * c * sum(
        2 * k * len(d) for k, d in zip(plan.kernel_sizes, plan.dilations))
    nbytes = 2.0 * size * b * t * c + size * (w.numel() + bias.numel())
    return 1e3 * max(factor * flops / peak, nbytes / HBM_RATE)


def run_shape(x, w, bias, wk, plan, mode: str, reps: int, failed: list):
    """Gate, repeat and time one launch; returns (ms, bound ms, max |diff|,
    limit)."""
    n, t, c = x.shape
    got = fm.mrf_fused(x, w, bias, plan, wk=wk)
    again = fm.mrf_fused(x, w, bias, plan, wk=wk)
    want = fm.mrf_fused_reference(x, w, bias, plan)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    lim = MODES[mode][0] * float(want.float().abs().max())
    same = torch.equal(got, again)
    if not (err <= lim and same):
        failed.append(f"B={n} T={t} C={c}: max |diff| {err} (limit {lim}),"
                      f" two launches bit-equal: {same}")
    ms = cuda_ms(lambda: fm.mrf_fused(x, w, bias, plan, wk=wk), reps)
    return ms, bound_ms(n, t, c, w, bias, plan, mode), err, lim, same


def vocoder_readings(dtype: str) -> None:
    """The fused vocoder on the serve's and bench.py's batches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parrot_tts_tpu_torch.core.config import VocoderModelConfig
    from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer
    from parrot_tts_tpu_torch.models.vocoder import generator

    cfg = VocoderModelConfig(fused_mrf=True, dtype=dtype)
    state = generator.init_code_generator(
        cfg, torch.Generator().manual_seed(SEED))
    synth = VocoderSynthesizer(state, cfg)
    rng = np.random.default_rng(SEED)
    for kind, batches in (("serve", SERVE), ("bench", ((64, 250),))):
        work = [(list(rng.integers(0, cfg.num_embeddings, size=(n, codes))),
                 list(rng.integers(0, cfg.num_speakers, size=(n,))))
                for n, codes in batches]

        def serve():
            for code, spk in work:
                synth.synthesize(code, spk)

        before = fm.FUSED_MRF.launches
        serve()
        launches = fm.FUSED_MRF.launches - before
        times = sorted(cuda_ms(serve, 1) for _ in range(5))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False))
        busy, end = 0.0, -float("inf")
        for start, stop in spans:
            if stop > end:
                busy += stop - max(start, end)
                end = stop
        print(f"vocoder {dtype} fused {kind} batches {batches}: "
              f"{times[2]:.3f} ms (median of 5, {times[0]:.3f}-"
              f"{times[-1]:.3f}), device busy "
              f"{f'{busy / 1e3:.3f} ms' if spans else 'not measured'}, "
              f"{launches} row-6 launches")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=tuple(MODES), default="bfloat16")
    ap.add_argument("--widths", action="store_true",
                    help="also every width 8-120 at (B, T) = (2, 16387)")
    ap.add_argument("--vocoder", action="store_true",
                    help="also the fused vocoder on the same batches")
    ap.add_argument("--reps", type=int, default=0,
                    help="launches timed per shape (default: ~3e6 / (B*T), "
                         "3 to 30, as chip_smoke.py phases 5 and 19)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_mrf_bf16: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    mode, dtype = args.dtype, getattr(torch, args.dtype)
    rng = np.random.default_rng(SEED)
    sums: dict = {}
    failed: list = []
    with torch.no_grad(), exact_numerics(True):
        for c, hop in STAGES:
            w, bias, wk, plan = stage(rng, c, dtype)
            tile = fm.tile_plan(plan, dtype=dtype)
            print(f"{mode} C={c}: " + ", ".join(
                f"{k} {v}" for k, v in vars(tile).items()
                if k not in ("channels", "dtype")))
            for kind, batches in (("serve", SERVE), ("bench", BENCH)):
                for n, codes in batches:
                    t = codes * hop
                    x = torch.from_numpy(rng.standard_normal(
                        (n, t, c)).astype(np.float32)).cuda().to(dtype)
                    reps = args.reps or max(3, min(30, int(3e6 / (n * t))))
                    ms, bnd, err, lim, _ = run_shape(x, w, bias, wk, plan,
                                                     mode, reps, failed)
                    tb = fm.tile_plan(plan, (n, t), dtype=dtype).tb
                    print(f"{kind} B={n} T={t:7d} C={c:2d} tile {tb}: kernel "
                          f"{ms:.4f} ms  bound {bnd:.4f} ms "
                          f"({100 * bnd / ms:.1f}%)  max|diff| {err:.3e} "
                          f"(limit {lim:.3e})")
                    m, bd = sums.get((kind, c), (0.0, 0.0))
                    sums[(kind, c)] = (m + ms, bd + bnd)
                    del x
        if args.widths:
            b, t = WIDTH_SHAPE
            for c in WIDTHS:
                w, bias, wk, plan = stage(rng, c, dtype)
                x = torch.from_numpy(rng.standard_normal(
                    (b, t, c)).astype(np.float32))
                x[1, 2 * t // 3:] = 0.0
                x = x.cuda().to(dtype)
                ms, bnd, err, lim, same = run_shape(
                    x, w, bias, wk, plan, mode, args.reps or 10, failed)
                tb = fm.tile_plan(plan, (b, t), dtype=dtype).tb
                print(f"width B={b} T={t} C={c:3d} tile {tb}: kernel "
                      f"{ms:.4f} ms  bound {bnd:.4f} ms "
                      f"({100 * bnd / ms:.1f}%)  max|diff| {err:.3e} "
                      f"(limit {lim:.3e}, {err / lim:.3f} of it), "
                      f"bit-equal {same}")
                del x
    if args.vocoder:
        with torch.no_grad():
            vocoder_readings(args.dtype)
    for kind in ("serve", "bench"):
        total = [0.0, 0.0]
        for c, _ in STAGES:
            ms, bnd = sums[(kind, c)]
            total[0] += ms
            total[1] += bnd
            print(f"{kind} C={c}: kernel {ms:.4f} ms  bound {bnd:.4f} ms "
                  f"({100 * bnd / ms:.1f}%)")
        print(f"{kind} total: kernel {total[0]:.4f} ms  bound "
              f"{total[1]:.4f} ms ({100 * total[1] / total[0]:.1f}%)")
    if failed:
        raise AssertionError("\n".join(failed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
