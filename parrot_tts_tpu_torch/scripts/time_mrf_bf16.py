"""Time row 6's bf16 mode (`csrc/fused_mrf.cu::mrf_kernel_bf16`) alone, at
the launches of one bf16 fused serve and of bench.py's vocoder batch.

    python -m parrot_tts_tpu_torch.scripts.time_mrf_bf16 [--reps N]

Run from the root of a checkout, on a machine with a CUDA card; it builds
the checkout's kernel. The shapes are V1's three fused stages (C = 64, 32
and 16 at 80, 160 and 320 samples per code, halo 60) over chip_smoke.py
phase 19's vocoder batches, (2, 128), (1, 256), (3, 512) and (3, 1024)
rows x codes, and over bench.py's batch of 64 x 256 codes (250 codes in
the 256-code bucket). Weights and inputs are random from a seed. Each
launch is held to its plain version (`mrf_fused_reference`, the JAX
kernel's bf16 rounding points) within 2^-6 max |plain|, as phase 19
holds it, and two launches on the same input must be bit-equal. Times are
CUDA events over back-to-back launches (mean), each printed beside its
bound (operations on the bf16 tensor cores, 989 TFLOP/s); the card's name
and power limit come first. It only calls the module's public functions,
so the same file times another checkout's kernel when copied there.
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
RTOL = 2.0 ** -6
BF16_PEAK = 989e12
HBM_RATE = 3.35e12


def stage(rng, c: int):
    """A stage's packed bf16 weights and plan, random (fan-in scaled)."""
    def tens(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    convs = [[(tens(k, c, c, scale=(c * k) ** -0.5), tens(c, scale=0.1),
               tens(k, c, c, scale=(c * k) ** -0.5), tens(c, scale=0.1))
              for _ in ds] for k, ds in zip(KERNEL_SIZES, DILATIONS)]
    w, b, plan = fm.pack_mrf(convs, KERNEL_SIZES, DILATIONS)
    w, b = w.bfloat16().cuda(), b.bfloat16().cuda()
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


def bound_ms(b: int, t: int, c: int, w, bias, plan) -> float:
    flops = 2.0 * b * t * c * c * sum(
        2 * k * len(d) for k, d in zip(plan.kernel_sizes, plan.dilations))
    nbytes = 4.0 * b * t * c + 2.0 * (w.numel() + bias.numel())
    return 1e3 * max(flops / BF16_PEAK, nbytes / HBM_RATE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=0,
                    help="launches timed per shape (default: ~3e6 / (B*T), "
                         "3 to 30, as chip_smoke.py phase 19)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_mrf_bf16: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    rng = np.random.default_rng(SEED)
    sums: dict = {}
    with torch.no_grad(), exact_numerics(True):
        for c, hop in STAGES:
            w, bias, wk, plan = stage(rng, c)
            tile = fm.tile_plan(plan, dtype=torch.bfloat16)
            print(f"C={c}: " + ", ".join(
                f"{k} {v}" for k, v in vars(tile).items()
                if k not in ("channels", "dtype")))
            for kind, batches in (("serve", SERVE), ("bench", BENCH)):
                for n, codes in batches:
                    t = codes * hop
                    x = torch.from_numpy(rng.standard_normal(
                        (n, t, c)).astype(np.float32)).cuda().bfloat16()
                    got = fm.mrf_fused(x, w, bias, plan, wk=wk)
                    again = fm.mrf_fused(x, w, bias, plan, wk=wk)
                    want = fm.mrf_fused_reference(x, w, bias, plan)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    lim = RTOL * float(want.float().abs().max())
                    same = torch.equal(got, again)
                    if not (err <= lim and same):
                        raise AssertionError(
                            f"B={n} T={t} C={c}: max |diff| {err} (limit "
                            f"{lim}), two launches bit-equal: {same}")
                    reps = args.reps or max(3, min(30, int(3e6 / (n * t))))
                    ms = cuda_ms(lambda: fm.mrf_fused(x, w, bias, plan,
                                                      wk=wk), reps)
                    bnd = bound_ms(n, t, c, w, bias, plan)
                    tb = fm.tile_plan(plan, (n, t), dtype=torch.bfloat16).tb
                    print(f"{kind} B={n} T={t:7d} C={c:2d} tile {tb}: kernel "
                          f"{ms:.4f} ms  bound {bnd:.4f} ms "
                          f"({100 * bnd / ms:.1f}%)  max|diff| {err:.3e} "
                          f"(limit {lim:.3e})")
                    key = (kind, c)
                    m, bd = sums.get(key, (0.0, 0.0))
                    sums[key] = (m + ms, bd + bnd)
                    del x, got, again, want
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
