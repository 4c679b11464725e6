"""Models behind row 6's float32 design (`csrc/fused_mrf.cu::mrf_kernel`),
computed on the CPU: no time is measured.

    python -m parrot_tts_tpu_torch.scripts.model_fused_mrf [--numerics]

Tiles: for each way of holding the strips and the weight ring in the
SM's 227 KB, the longest tile at V1's halo (60) for C = 64, 32 and 16 and
the work of one fused serve (chip_smoke.py phase 4's vocoder batches:
(2, 128), (1, 256), (3, 512), (3, 1024) rows x codes at 80, 160 and 320
samples a code): each launch takes the tile with the least rows computed
(in whole rounds of one 64-row unit per warpgroup) x taps x waves of
blocks on 132 SMs, and the work is summed over the launches and divided
by the same count for the output rows alone (the bound's work).

--numerics: the kernel's walk on one random stage (B = 1, fan-in scaled
weights), each product 3xTF32 on TF32 values taken by bit operations,
each k-step's three products added to a float32 sum that truncates toward
zero (a model of the tensor cores' accumulator), either carried from the
bias over a whole conv or restarted per tap and added in IEEE float32:
max |diff| against the IEEE plain version over 1e-5 max |plain|, the gate
chip_smoke.py phase 5 holds the kernel to.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from parrot_tts_tpu_torch.ops import fused_mrf as fm

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3
SERVE = ((2, 128), (1, 256), (3, 512), (3, 1024))
HOP = {64: 80, 32: 160, 16: 320}
UNITS = {64: (2, 3), 32: (3, 4), 16: (4, 5)}   # warpgroups x units
SMS = 132


def tap_rows(plan, tb: int, step: int) -> int:
    """Rows the convs of one block compute, in whole rounds, x taps."""
    return sum(-(-(hi - lo) // step) * step * plan.kernel_sizes[br]
               for br, _, _, _, _, lo, hi in fm.conv_walk(plan, tb))


def serve_work(c: int, row_bytes: int, ring: int) -> tuple[int, float]:
    """(longest tile, work / bound work) of one fused serve's launches."""
    plan = fm.MRFPlan(c, KS, DS, 60)
    nwg, units = UNITS[c]
    rows = min((fm.SMEM_BYTES - ring - 256) // row_bytes, 64 * nwg * units)
    tb_max = (rows - 120) // 16 * 16
    work = need = 0
    for n, codes in SERVE:
        t = codes * HOP[c]

        def cost(tb):
            return -(-n * -(-t // tb) // SMS) * tap_rows(plan, tb, 64 * nwg)

        work += min(cost(tb) for tb in range(128, tb_max + 1, 16))
        need += n * t * sum(2 * k * 3 for k in KS) / SMS
    return tb_max, work / need


def tiles() -> None:
    stride = fm._strip_stride
    options = {
        "cp.async ring: Y and LT strips, 2 slots of 32-input slabs":
            lambda c: (8 * stride(c), 2 * 2 * min(32, c) * c * 4),
        "(a) Y, A's hi and lo planes, 32 KB ring":
            lambda c: (12 * c, 32768),
        "(a) Y, A's hi and lo planes, 16 KB ring":
            lambda c: (12 * c, 16384),
        "(b) Y and Z strips, A split in registers, 24 KB ring":
            lambda c: (8 * stride(c), 24576),
    }
    for name, layout in options.items():
        got = [serve_work(c, *layout(c)) for c in (64, 32, 16)]
        print(f"{name}: longest tile "
              + " / ".join(str(tb) for tb, _ in got) + ", work / bound work "
              + " / ".join(f"{w:.3f}" for _, w in got)
              + " (C = 64 / 32 / 16)")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (11 significant bits), to nearest even."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x0FFF + ((u >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)      # the tensor cores read lo's top 11 significant bits
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def to_zero(s: torch.Tensor) -> torch.Tensor:
    """float64 to float32, truncated toward zero."""
    f = s.float()
    return torch.where(f.double().abs() > s.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def conv(src, w, bias, lo, hi, k, d, pad, carried: bool):
    acc = bias.expand(hi - lo, -1).clone()
    for tap in range(k):
        a = src[lo + tap * d - pad:hi + tap * d - pad]
        part = None
        for c0 in range(0, src.shape[1], 8):
            ah, al = split(a[:, c0:c0 + 8])
            bh, bl = split(w[tap, c0:c0 + 8])
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                p = x.double() @ y.double()
                if carried:
                    acc = to_zero(acc.double() + p)
                else:
                    part = p.float() if part is None else to_zero(
                        part.double() + p)
        if not carried:
            acc = acc + part
    return acc


def stage(x, w, b, plan, carried: bool) -> torch.Tensor:
    t, c = x.shape
    h, length = plan.halo, t + 2 * plan.halo
    strip = torch.zeros(length, c)
    strip[h:h + t] = x
    valid = torch.zeros(length, dtype=torch.bool)
    valid[h:h + t] = True
    pairs = {(i, j): (w1, b1, w2, b2)
             for i, j, w1, b1, w2, b2, _, _ in fm._unpack(w, b, plan)}
    mean = None
    for i, k in enumerate(plan.kernel_sizes):
        y, z = strip.clone(), torch.zeros(length, c)
        for br, j, cv, d, pad, lo, hi in fm.conv_walk(plan, t):
            if br != i:
                continue
            w1, b1, w2, b2 = pairs[(i, j)]
            src = torch.maximum(y, 0.1 * y) if cv == 0 else z
            acc = conv(src, w1 if cv == 0 else w2, b1 if cv == 0 else b2,
                       lo, hi, k, d if cv == 0 else 1, pad, carried)
            acc = torch.where(valid[lo:hi, None], acc, 0.0)
            if cv == 0:
                z[lo:hi] = torch.maximum(acc, 0.1 * acc)
            else:
                y[lo:hi] = y[lo:hi] + acc
        mean = y[h:h + t] if mean is None else mean + y[h:h + t]
    return mean * (1.0 / len(plan.kernel_sizes))


def numerics() -> None:
    for c, t in ((64, 600), (32, 900), (16, 1500), (120, 300)):
        rng = np.random.default_rng(c)

        def tens(*shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale)
                                    .astype(np.float32))
        convs = [[(tens(k, c, c, scale=(c * k) ** -0.5), tens(c, scale=0.1),
                   tens(k, c, c, scale=(c * k) ** -0.5), tens(c, scale=0.1))
                  for _ in ds] for k, ds in zip(KS, DS)]
        w, b, plan = fm.pack_mrf(convs, KS, DS)
        x = tens(1, t, c)
        want = fm.mrf_fused_reference(x, w, b, plan)[0]
        lim = 1e-5 * float(want.abs().max())
        for carried in (True, False):
            err = float((stage(x[0], w, b, plan, carried) - want).abs().max())
            how = "carried over a conv" if carried else "restarted per tap"
            print(f"C={c} T={t} sums {how}: "
                  f"max |diff| {err:.3e}, {err / lim:.3f} of the gate")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--numerics", action="store_true",
                    help="also the truncating-accumulator model")
    args = ap.parse_args()
    tiles()
    if args.numerics:
        numerics()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
