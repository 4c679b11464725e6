"""Time row 7 (`csrc/int8_conv.cu`) alone, in both of its outputs, at every
distinct site of the int8 serves and of bench.py's batch, with `--vocoder`
the int8 vocoders around it, and with `--model` (no card) the launch
model of its design.

    python -m parrot_tts_tpu_torch.scripts.time_int8_conv \
        [--dtypes float32 bfloat16] [--vocoder] [--reps N] [--device cpu]
    python -m parrot_tts_tpu_torch.scripts.time_int8_conv --model

Run from the root of a checkout, on a machine with a CUDA card; it builds
the checkout's kernel. The sites are chip_smoke.py's (`int8_sites`: every
int8 conv of a V1 vocoder batch under int8-static, "int8" and
"int8-tail"), over phase 4's vocoder batches, (2, 128), (1, 256), (3, 512)
and (3, 1024) rows x codes, and bench.py's batch as the int8 serves launch
it, 64 x 256 codes (250 in the 256-code bucket). In float32 every mode; in
bfloat16 the dynamic modes, whose convs write bf16 (the bf16 int8-static
serve's write float32, the float32 sites). Inputs are random from a seed,
with the scale each serve passes (per row, or one vector broadcast over
the batch). Each site's launch is held to its plain version
(`int8_conv_reference`) bit for bit, and a site that differs fails the
run at its end. Times are the device time per launch of launches queued
behind a spin kernel (CUDA events, `chip_smoke.queued_ms`), each beside
its bound (the int8 operations at 1,979 TOP/s or the bytes at 3.35 TB/s,
whichever takes longer), summed per batch, per serve, per stage (the
sites' Ci) and for bench.py's batch; then a launch's fixed cost, each of
FIXED_SITES's shapes at T_out = 1. `--vocoder` serves
random codes of the same batches through `VocoderSynthesizer` in each
int8 mode and dtype (V1, weights seeded; int8-static calibrated on the
batch): ms per set of batches (CUDA events around each synthesize, the
waveforms read back; median of 5 after a warm one), the device's busy
time in one more (torch.profiler: the union of its kernels' intervals)
and the row-7 launches. It only calls public functions, so the same file
times another checkout's kernel when copied there. The card's name and
power limit come first. With `--device cpu` it runs the plain version at
the given batches and prints the same keys with "not measured" for every
time (a rehearsal). `--model` prints, per V1 stage and launch size, the
plan's tile, the bytes, operations and bound, and the launch model
described in PERF.md (no card; no time is measured).
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

import chip_smoke
from parrot_tts_tpu_torch.core.config import VocoderModelConfig
from parrot_tts_tpu_torch.ops import qconv

SEED = 20261019
SERVE = ((2, 128), (1, 256), (3, 512), (3, 1024))
BENCH = (64, 256)
MODES = {"float32": ("int8-static", "int8", "int8-tail"),
         "bfloat16": ("int8", "int8-tail")}
INT8_PEAK, HBM_RATE = 1979e12, 3.35e12
# the shapes of a launch's fixed cost, (Ci, Co, K, dilation) at T_out = 1:
# chip_smoke.py's INT8_FIXED_SITES, kept here so that a parent's
# chip_smoke.py need not have it
FIXED_SITES = ((16, 16, 3, 1), (64, 64, 11, 5), (256, 256, 11, 5),
               (512, 1280, 3, 1))
# --model: an SM's share of the memory rate (bytes/s) and its int8 rate
# (OP/s), with wgmma m64nNk32's share of the peak by N (the measured
# rates of scripts/exp_wgmma_rate.py's s8 mode replace these when known)
SM_BYTES, SM_OPS = HBM_RATE / 132, INT8_PEAK / 132
WGMMA_SHARE = {16: 0.40, 32: 0.66, 64: 0.97, 128: 0.97}


def site_bound(key) -> tuple[float, float, float]:
    """(operations, bytes, bound ms) of an int8_sites key."""
    n, t, ci, co, k, d, pads, _, _, bf16 = key
    t_out = t + pads[0] + pads[1] - d * (k - 1)
    ops = 2.0 * n * t_out * k * ci * co
    nbytes = (n * t * ci + k * ci * co + 8.0 * co
              + (2 if bf16 else 4) * n * t_out * co)
    return ops, nbytes, 1e3 * max(ops / INT8_PEAK, nbytes / HBM_RATE)


def inputs(key, gen, device):
    n, t, ci, co, k, _, _, _, per_row, _ = key
    xq = torch.randint(-127, 128, (n, t, ci), generator=gen,
                       dtype=torch.int8).to(device)
    wt = torch.randint(-127, 128, (k, co, ci), generator=gen,
                       dtype=torch.int8).to(device)
    scale = (torch.rand(*((n,) if per_row else ()), co, generator=gen)
             * 1e-4 + 1e-6).to(device).expand(n, -1)
    bias = (torch.randn(co, generator=gen) * 0.1).to(device)
    return xq, wt, scale, bias


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def share(bound_ms, ms) -> str:
    return "" if ms is None else f" ({100 * bound_ms / ms:.1f}%)"


def run_sites(dtype: str, batches, bench, reps: int, device: str,
              failed: list) -> None:
    """Gate and time every distinct site of `batches` and of bench.py's
    batch in dtype's modes; print per site, batch, serve and stage."""
    vcfg = VocoderModelConfig(dtype=dtype)
    out_dtype = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(SEED)
    on_card = device == "cuda"
    times: dict = {}
    for mode in MODES[dtype]:
        for n, codes in (*batches, bench):
            for key in chip_smoke.int8_sites(vcfg, n, codes, mode):
                if key in times:
                    continue
                n_, t, ci, co, k, d, pads, leaky, per_row, bf16 = key
                xq, wt, scale, bias = inputs(key, gen, device)
                want_dtype = torch.bfloat16 if bf16 else torch.float32

                def kern():
                    return qconv.int8_conv(xq, wt, scale, bias, pads=pads,
                                           dilation=d, leaky=leaky,
                                           out_dtype=want_dtype)

                got = kern()
                want = qconv.int8_conv_reference(
                    xq, wt, scale, bias, pads=pads, dilation=d, leaky=leaky,
                    out_dtype=want_dtype)
                same = bool(torch.equal(got, want))
                if not same:
                    failed.append(f"{dtype} {key}: not bit-identical")
                ms = (chip_smoke.queued_ms(kern, reps, warmup=2) if on_card
                      else None)
                times[key] = ms
                bnd = site_bound(key)[2]
                print(f"site {dtype} B={n_} T={t} Ci={ci} Co={co} K={k} d={d}"
                      f" leaky={int(leaky is not None)} per_row="
                      f"{int(per_row)} out {'bf16' if bf16 else 'f32'}: "
                      f"kernel {fmt(ms)}  bound {bnd:.4f} ms{share(bnd, ms)}"
                      f"  bit-identical {same}")
                del xq, wt, got, want

    def total(sites: dict) -> tuple:
        bnd = sum(site_bound(key)[2] * c for key, c in sites.items())
        if not on_card:
            return None, bnd
        return sum(times[key] * c for key, c in sites.items()), bnd

    for mode in MODES[dtype]:
        serve: dict = {}
        for n, codes in batches:
            sites = chip_smoke.int8_sites(vcfg, n, codes, mode)
            for key, c in sites.items():
                serve[key] = serve.get(key, 0) + c
            ms, bnd = total(sites)
            print(f"batch {dtype} {mode} {n}x{codes}: kernel {fmt(ms)}  "
                  f"bound {bnd:.4f} ms{share(bnd, ms)}")
        ms, bnd = total(serve)
        print(f"serve {dtype} {mode}: kernel {fmt(ms)}  bound {bnd:.4f} ms"
              f"{share(bnd, ms)}  launches {sum(serve.values())}")
        for ci in sorted({key[2] for key in serve}):
            ms, bnd = total({key: c for key, c in serve.items()
                             if key[2] == ci})
            print(f"stage {dtype} {mode} Ci={ci}: kernel {fmt(ms)}  bound "
                  f"{bnd:.4f} ms{share(bnd, ms)}")
        ms, bnd = total(chip_smoke.int8_sites(vcfg, *bench, mode))
        print(f"bench {dtype} {mode} {bench[0]}x{bench[1]}: kernel {fmt(ms)}"
              f"  bound {bnd:.4f} ms{share(bnd, ms)}")
    for ci, co, k, d in FIXED_SITES:
        pad = d * (k - 1) // 2
        key = (1, 1, ci, co, k, d, (pad, pad), 0.1, True, dtype != "float32")
        xq, wt, scale, bias = inputs(key, gen, device)
        ms = (chip_smoke.queued_ms(lambda: qconv.int8_conv(
            xq, wt, scale, bias, pads=(pad, pad), dilation=d, leaky=0.1,
            out_dtype=out_dtype), reps, warmup=2) if on_card else None)
        print(f"fixed cost {dtype} Ci={ci} Co={co} K={k} d={d}: {fmt(ms)} "
              "per launch (T_out = 1, queued)")
    one = torch.zeros(1, device=device)
    ms = (chip_smoke.queued_ms(lambda: one.add_(1.0), reps, warmup=2)
          if on_card else None)
    print(f"fixed cost {dtype} of a one-element PyTorch kernel: {fmt(ms)} "
          "per launch (queued), the card's launch-to-launch floor")


def vocoder_readings(dtype: str) -> None:
    """The int8 vocoders on the serve's and bench.py's batches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer
    from parrot_tts_tpu_torch.models.vocoder import generator

    rng = np.random.default_rng(SEED)
    state = generator.init_code_generator(
        VocoderModelConfig(), torch.Generator().manual_seed(SEED))
    for mode in ("int8-static", "int8", "int8-tail"):
        cfg = VocoderModelConfig(dtype=dtype, quant=mode)
        synth = VocoderSynthesizer(state, cfg)
        for kind, batches in (("serve", SERVE), ("bench", ((64, 250),))):
            work = [(list(rng.integers(0, cfg.num_embeddings,
                                       size=(n, codes))),
                     list(rng.integers(0, cfg.num_speakers, size=(n,))))
                    for n, codes in batches]
            if mode == "int8-static":
                synth.calibrate(*work[-1])

            def serve():
                for code, spk in work:
                    synth.synthesize(code, spk)

            before = qconv.INT8_CONV.launches
            serve()
            launches = qconv.INT8_CONV.launches - before
            times = sorted(chip_smoke.cuda_ms(serve, 1, warmup=0)
                           for _ in range(5))
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
            print(f"vocoder {dtype} {mode} {kind} batches {batches}: "
                  f"{times[2]:.3f} ms (median of 5, {times[0]:.3f}-"
                  f"{times[-1]:.3f}), device busy "
                  f"{f'{busy / 1e3:.3f} ms' if spans else 'not measured'}, "
                  f"{launches} row-7 launches")
        del synth


def model(fixed_us: float = 4.0) -> None:
    """The launch model of PERF.md section 6, from conv_plan: per
    stage Ci and launch size, the tile, bytes, operations, bound, shared
    memory, accumulator registers, and a modelled time: a fixed cost per
    launch (`fixed_us`, a guess until measured) plus, for each SM, its
    share of the tiles, two at a time (one per consumer), each taking the
    larger of its output and input bytes at an SM's share of the memory
    rate and its products at wgmma's rate for its width (WGMMA_SHARE).
    Summed per batch and per serve (phase 4's batches), float32
    int8-static and bf16 "int8"."""
    for dtype, mode in (("float32", "int8-static"), ("bfloat16", "int8")):
        vcfg = VocoderModelConfig(dtype=dtype)
        out_bytes = 4 if dtype == "float32" else 2
        serve = [0.0, 0.0]
        for n, codes in (*SERVE, BENCH):
            per_stage: dict = {}
            for key, c in chip_smoke.int8_sites(vcfg, n, codes,
                                                mode).items():
                b, t, ci, co, k, d, pads, _, _, _ = key
                plan = qconv.conv_plan(b, t, ci, k, co, pads, d,
                                       out_bytes=out_bytes)
                ops, nbytes, bnd = site_bound(key)
                rows, bn = plan["bm"], plan["bn"]
                tile_bytes = (rows * bn * out_bytes
                              + (rows + (k - 1) * d) * ci / plan["tiles_n"])
                tile_ops = 2.0 * rows * bn * k * ci
                tile_s = max(tile_bytes / SM_BYTES,
                             tile_ops / (SM_OPS * WGMMA_SHARE[bn]))
                waves = -(-plan["tiles"] // plan["grid"])
                ms = 1e-3 * fixed_us + 1e3 * waves * tile_s
                s = per_stage.setdefault(ci, [0, 0.0, 0.0, 0.0, 0.0, set()])
                for i, v in enumerate((c, c * ops, c * nbytes, c * bnd,
                                       c * ms)):
                    s[i] += v
                s[5].add((bn, rows, plan["ck"], plan["stages"],
                          plan["tiles"], plan["grid"], plan["smem"],
                          rows // 64 * bn // 2))
            batch = [0.0, 0.0]
            for ci, (cnt, ops, nbytes, bnd, ms, plans) in sorted(
                    per_stage.items()):
                batch[0] += bnd
                batch[1] += ms
                print(f"model {dtype} {mode} {n}x{codes} Ci={ci}: {cnt} "
                      f"launches, {nbytes / 1e6:.2f} MB, {ops / 1e9:.2f} GOP,"
                      f" bound {bnd:.4f} ms, modelled {ms:.4f} ms; plans "
                      "(bn, rows, ck, stages, tiles, grid, smem, accumulator "
                      "registers per consumer thread): "
                      + "; ".join(str(p) for p in sorted(plans)))
            print(f"model {dtype} {mode} {n}x{codes}: bound {batch[0]:.4f} ms,"
                  f" modelled {batch[1]:.4f} ms")
            if (n, codes) != BENCH:
                serve = [serve[0] + batch[0], serve[1] + batch[1]]
        print(f"model {dtype} {mode} serve: bound {serve[0]:.4f} ms, "
              f"modelled {serve[1]:.4f} ms ({100 * serve[0] / serve[1]:.1f}%"
              f" of the bound) at a fixed cost of {fixed_us} us a launch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtypes", nargs="+", choices=tuple(MODES),
                    default=list(MODES))
    ap.add_argument("--vocoder", action="store_true",
                    help="also the int8 vocoders on the same batches")
    ap.add_argument("--reps", type=int, default=10,
                    help="launches timed per site (queued)")
    ap.add_argument("--batches", nargs="+", default=None,
                    help="vocoder batches as ROWSxCODES (default: phase 4's)")
    ap.add_argument("--bench", default="x".join(map(str, BENCH)),
                    help="bench.py's batch as ROWSxCODES (default: 64x256)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--model", action="store_true",
                    help="print the launch model instead (no card)")
    ap.add_argument("--fixed-us", type=float, default=4.0,
                    help="--model's fixed cost per launch, us")
    args = ap.parse_args(argv)
    if args.model:
        model(args.fixed_us)
        return 0
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("time_int8_conv: no CUDA device")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    def shape(text):
        return tuple(int(v) for v in text.split("x"))

    batches = (SERVE if args.batches is None else
               tuple(shape(s) for s in args.batches))
    failed: list = []
    with torch.no_grad():
        for dtype in args.dtypes:
            run_sites(dtype, batches, shape(args.bench), args.reps,
                      args.device, failed)
        if args.vocoder and args.device == "cuda":
            for dtype in args.dtypes:
                vocoder_readings(dtype)
    if failed:
        raise AssertionError("\n".join(failed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
