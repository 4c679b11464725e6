"""Time row 1's modes (`flash_attention(..., passes=3)`, 3xTF32, and
`passes=1`, 1-pass TF32) alone and in the decode modes that run them.

    python -m parrot_tts_tpu_torch.scripts.time_one_pass [--passes 3 1]
        [--reps N]

Run from the root of a checkout, on a machine with a CUDA card; it builds
the checkout's kernels. Two parts, after the card's name and power limit:

1. each mode given at (B, H, T, d) = (5, 2, 2048, 128), the serving
   phase's largest decode batch, and (64, 2, 2048, 128), the full decode
   batch of part 2; random q, k, v from a seed, key padding with one
   all-masked row. The 3xTF32 mode is held to the IEEE float32 plain
   version within 1e-5 (chip_smoke.py phase 3's gate), the 1-pass mode to
   its plain version with chip_smoke.py's `one_pass_gate`; the all-masked
   row is 0. Then the mode's ms (CUDA events over back-to-back calls,
   mean), beside its bound (4*B*H*T^2*d operations, three times over in
   3xTF32, on the TF32 tensor cores at 494.7 TFLOP/s) and SDPA's ms (in
   float32 beside the 3xTF32 mode, with TF32 allowed beside the 1-pass
   one). Where the module has the mode's pre-pass (`split_operands`,
   `one_pass_operands`), the pre-pass and the kernel are also timed alone,
   each queued behind a spin kernel so that the host's time per call does
   not set the pace (chip_smoke.py's `queued_ms`).
2. TTE seconds of one 64 x (128 -> 2048) decode batch (chip_smoke.py
   phase 4's: the full-width TTE on seeded weights, the 2048 bucket's
   requests repeated to the batch size) in "selective", "hybrid",
   exact=True and "selective-high", over 3 warm decodes (CUDA events).

It calls only public functions, so the same file times another checkout's
kernels when copied there.
"""

from __future__ import annotations

import argparse
import math
import subprocess

import numpy as np
import torch

import chip_smoke
from parrot_tts_tpu_torch.core.config import (TTEModelConfig,
                                              VocoderModelConfig)
from parrot_tts_tpu_torch.core.device import exact_numerics
from parrot_tts_tpu_torch.infer.tte_infer import decode_buckets
from parrot_tts_tpu_torch.ops import flash_attention as fa

SEED = 20261018
SHAPES = ((5, 2048, 128), (64, 2048, 128))   # (B, T, d), H = 2
MODES = ("selective", "hybrid", True, "selective-high")
REPEATS = 3
TF32_PEAK = 494.7e12


def inputs(b: int, t: int, d: int):
    gen = torch.Generator(device="cuda").manual_seed(SEED + b)
    q, k, v = (torch.randn((b, 2, t, d), generator=gen, device="cuda")
               for _ in range(3))
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    lengths[0] = t
    mask = torch.arange(t, device="cuda")[None, :] >= lengths[:, None]
    mask[b - 1] = True
    return q, k, v, mask


# each mode's pre-pass and kernel, where the module has them
KERNELS = {3: ("split_operands", "split_attention"),
           1: ("one_pass_operands", "one_pass_attention")}


def gate(passes: int, q, k, v, mask, scale) -> str:
    """The mode against its plain version (module docstring); raises."""
    b = q.shape[0]
    keep = torch.arange(b, device="cuda") != b - 1
    with exact_numerics(True):
        got = fa.flash_attention(q, k, v, mask, scale, passes=passes)
        ieee = fa.flash_attention_reference(q, k, v, mask, scale)
        torch.cuda.synchronize()
        if got[b - 1].any():
            raise AssertionError(f"B={b}: the all-masked row is not 0")
        if passes == 3:
            err = float((got[keep] - ieee[keep]).abs().max())
            if not err <= chip_smoke.ATOL:
                raise AssertionError(f"B={b}: max |diff| {err} from IEEE")
            return f"max|diff| {err:.3e} from IEEE (<= {chip_smoke.ATOL})"
        plain = fa.flash_attention_reference(q, k, v, mask, scale, passes=1)
        err, rms, from_ieee, tol, rms_tol = chip_smoke.one_pass_gate(
            got[keep], plain[keep], ieee[keep], v)
    if not (err <= tol and rms <= rms_tol and from_ieee > 1e-5):
        raise AssertionError(f"B={b}: max |diff| {err} (<= {tol}), RMS "
                             f"{rms} (<= {rms_tol}), {from_ieee} from IEEE")
    return (f"max|diff| {err:.3e} (<= {tol:.3e}), RMS {rms:.3e} (<= "
            f"{rms_tol:.3e})")


def part_kernel(passes: int, reps: int) -> None:
    for b, t, d in SHAPES:
        q, k, v, mask = inputs(b, t, d)
        scale = 1.0 / math.sqrt(d)
        held = gate(passes, q, k, v, mask, scale)
        bnd = bound_ms(passes, b, t, d)
        with exact_numerics(True):
            ms = chip_smoke.cuda_ms(lambda: fa.flash_attention(
                q, k, v, mask, scale, passes=passes), reps)
            split = ""
            prep_name, kernel_name = KERNELS[passes]
            if hasattr(fa, prep_name):
                prep_fn, kernel_fn = (getattr(fa, prep_name),
                                      getattr(fa, kernel_name))
                kv = prep_fn(k, v, mask)
                prep = chip_smoke.queued_ms(lambda: prep_fn(k, v, mask), reps)
                kern = chip_smoke.queued_ms(lambda: kernel_fn(q, kv, scale),
                                            reps)
                split = (f" = pre-pass {prep:.4f} + kernel {kern:.4f} "
                         f"(kernel {100 * bnd / kern:.1f}% of the bound)")
                del kv
        attend = ~mask[:, None, None, :]
        with exact_numerics(passes == 3):
            sdpa = chip_smoke.cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=attend, scale=scale), reps)
        print(f"{'3xTF32' if passes == 3 else '1-pass'} B={b} H=2 T={t} "
              f"d={d}: {held}; mode {ms:.4f} ms{split}; bound {bnd:.4f} ms "
              f"({100 * bnd / ms:.1f}% of the mode); sdpa "
              f"{'float32' if passes == 3 else 'TF32'} {sdpa:.4f} ms")
        del q, k, v, mask
        torch.cuda.empty_cache()


def bound_ms(passes: int, b: int, t: int, d: int) -> float:
    return 1e3 * passes * 4.0 * b * 2 * t * t * d / TF32_PEAK


def part_decode() -> None:
    tts = chip_smoke.make_tts(TTEModelConfig(n_speaker=4),
                              VocoderModelConfig())
    tokens = [tts.tokenize(t) for t in chip_smoke.TEXTS]
    samples = [(s, i % 4) for i, s in enumerate(tokens)]
    s_len, out_len, idxs = next(p for p in tts.plan(tokens) if p[1] == 2048)
    rows = [samples[idxs[j % len(idxs)]] for j in range(tts.batch_size)]
    full = [(s_len, out_len, list(range(len(rows))))]
    for mode in MODES:
        def decode():
            decode_buckets(tts.tte, rows, full, batch_size=len(rows),
                           exact=mode, device=tts.device)
        decode()
        fa.FLASH_FWD.launches = fa.FLASH_FWD.one_pass = 0
        secs = [chip_smoke.cuda_ms(decode, 1, warmup=0) / 1e3
                for _ in range(REPEATS)]
        print(f"TTE seconds, one batch of {len(rows)} x ({s_len} -> "
              f"{out_len}), exact={mode!r}: mean {np.mean(secs):.6f} over "
              f"{REPEATS} warm decodes (min {min(secs):.6f}, max "
              f"{max(secs):.6f}); row-1 launches per decode "
              f"{fa.FLASH_FWD.launches // REPEATS} ("
              f"{fa.FLASH_FWD.one_pass // REPEATS} 1-pass)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--passes", type=int, nargs="+", choices=(1, 3),
                    default=[3, 1], help="row 1's modes to time in part 1 "
                    "(default 3 1)")
    ap.add_argument("--reps", type=int, default=20,
                    help="calls timed per shape (default 20)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_one_pass: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for passes in args.passes:
        part_kernel(passes, args.reps)
    part_decode()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
