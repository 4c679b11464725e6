"""The fused MRF kernel's tile plan, strip walk and 3xTF32 arithmetic
(row 6: `csrc/fused_mrf.cu`), emulated in plain torch on the CPU.

The kernel runs only on the card. What surrounds it is Python the CPU
reaches: `ops/fused_mrf.py::kernel_weights` (the weight slabs the kernel
streams: TF32 hi and lo halves, K-major, k permuted), `tile_plan` (time
tile, wgmma n, units per warpgroup, strides, shared memory) and
`conv_walk` (the strip rows each conv computes). `emulate` repeats the
kernel's walk on that plan: a block's strip of tb + 2 * halo rows loaded
from x with zeros outside [0, T), each conv on its rows only (the dilated
conv sums into the Z strip and leaves leaky(t) there, the plain conv adds
to y), every conv's output re-zeroed outside [0, T), the ragged last
tile, the branch mean in branch order; and its arithmetic: 3xTF32 products
(the split of tests/test_torch_tf32_split.py) of one k-step (8 input
channels) at a time, summed from the bias over `sum_taps` taps (the whole
conv at C <= 64), each later group of taps from zero, and each group's
partial added in float32 to the strip. The emulation sums in IEEE
float32 where the tensor cores truncate (`scripts/model_fused_mrf.py
--numerics` models that). Rows the kernel never writes are NaN in the
emulation, so a walk that read one would show. It is a model of the
kernel, not its plain version: the card holds the kernel to
`mrf_fused_reference` (tests/test_torch_kernels.py, chip_smoke.py phase
5).

Checked here: the emulation stays within the 1e-5 * max |plain| the card's
kernel is held to, against the port's plain version and against the JAX
package's fused kernel (interpret mode, folded layout); one TF32 product
does not; the plan fits every channel count the fused route sends, in
shared memory and registers; `_check` refuses the others.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from parrot_tts_tpu.ops import fused_mrf as jax_fused
from parrot_tts_tpu_torch.models.vocoder.generator import FUSED_BELOW_CHANNELS
from parrot_tts_tpu_torch.ops import fused_mrf as fm
from tests.test_torch_fused_mrf import DS, KS, _jax_resblocks, _port_pack
from tests.test_torch_tf32_split import mm_1xtf32, mm_3xtf32

MRF_RTOL = chip_smoke.MRF_RTOL
ROUTED = range(fm.CHANNEL_QUANTUM, FUSED_BELOW_CHANNELS, fm.CHANNEL_QUANTUM)


def leaky(v):
    return torch.maximum(v, fm.LRELU_SLOPE * v)


def emulate(x, w, b, plan, tb, mm=mm_3xtf32):
    """csrc/fused_mrf.cu on x (B, T, C) with time tile tb, in torch."""
    bsz, t, c = x.shape
    tile = fm.tile_plan(plan)
    kc, group = fm.CHANNEL_QUANTUM, tile.sum_taps
    h, length = plan.halo, tb + 2 * plan.halo
    pairs = {(i, j): (w1, b1, w2, b2)
             for i, j, w1, b1, w2, b2, _, _ in fm._unpack(w, b, plan)}
    walk = fm.conv_walk(plan, tb)
    nb = len(plan.kernel_sizes)
    out = torch.full_like(x, math.nan)
    for blk in range(-(-t // tb)):
        rows = torch.arange(length) + blk * tb - h      # sequence rows
        valid = (rows >= 0) & (rows < t)
        strip = torch.zeros((bsz, length, c))
        strip[:, valid] = x[:, rows[valid]]
        mean = None
        for i, k in enumerate(plan.kernel_sizes):
            rem = sum(p1 + p2 for p1, p2 in plan.pads(i))
            y = torch.full((bsz, length, c), math.nan)  # never-written rows
            y[:, h - rem:h + tb + rem] = strip[:, h - rem:h + tb + rem]
            z = torch.full((bsz, length, c), math.nan)
            for br, j, cv, d, pad, lo, hi in walk:
                if br != i:
                    continue
                w1, b1, w2, b2 = pairs[(i, j)]
                wk, bias = (w1, b1) if cv == 0 else (w2, b2)
                src = leaky(y) if cv == 0 else z
                keep = valid[lo:hi, None]
                for g0 in range(0, k, group):      # a partial per group
                    acc = (bias.expand(bsz, hi - lo, c) if g0 == 0
                           else torch.zeros(bsz, hi - lo, c))
                    for tap in range(g0, min(k, g0 + group)):
                        shift = tap * d - pad
                        a = src[:, lo + shift:hi + shift]
                        for ci in range(0, c, kc):
                            acc = acc + mm(a[..., ci:ci + kc],
                                           wk[tap, ci:ci + kc])
                    if cv == 1:
                        y[:, lo:hi] = torch.where(keep, y[:, lo:hi] + acc,
                                                  y[:, lo:hi])
                    else:
                        z[:, lo:hi] = acc if g0 == 0 else z[:, lo:hi] + acc
                if cv == 0:
                    z[:, lo:hi] = torch.where(keep, leaky(z[:, lo:hi]), 0.0)
            assert (lo, hi) == (h, h + tb)              # the branch's end
            mean = y[:, h:h + tb] if mean is None else mean + y[:, h:h + tb]
        mean = mean * (1.0 / nb)
        n = min(tb, t - blk * tb)
        out[:, blk * tb:blk * tb + n] = mean[:, :n]
    return out


def _inputs(seed, b, t, c):
    rng = np.random.default_rng(seed)

    def tens(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    convs = [[(tens(k, c, c, scale=(c * k) ** -0.5), tens(c, scale=0.1),
               tens(k, c, c, scale=(c * k) ** -0.5), tens(c, scale=0.1))
              for _ in ds] for k, ds in zip(KS, DS)]
    w, bias, plan = fm.pack_mrf(convs, KS, DS)
    x = tens(b, t, c)
    if b > 1:
        x[1, 2 * t // 3:] = 0.0           # a row that ends early
    return x, w, bias, plan


@pytest.mark.parametrize("c", ROUTED)
def test_tile_plan_fits_every_routed_channel_count(c):
    """At V1's halo every channel count the fused route sends gets a tile:
    the strips and the ring in shared memory, the units within the
    warpgroups' rounds, one wgmma n of C and slabs of one k-step, a stride
    that keeps the A fragment loads off shared bank conflicts; a launch's
    tile does no more work (its waves of blocks times a block's rows) than
    the largest tile would."""
    plan = fm.MRFPlan(c, KS, DS, 60)
    tile = fm.tile_plan(plan)
    length = tile.tb + 2 * plan.halo
    assert tile.tb >= 16 and tile.tb % 16 == 0
    assert tile.smem_bytes <= fm.SMEM_BYTES
    assert tile.wgmma_n == c and tile.k_chunk == 8
    assert -(-length // fm.UNIT_ROWS) <= tile.warpgroups * tile.rounds
    # a unit's C / 2 sums and 8 registers of split A fragment a thread,
    # within what 128 threads a warpgroup leave of the SM's 64K registers
    assert tile.rounds * (c // 2 + 8) <= {4: 88, 3: 128,
                                          2: 192}[tile.warpgroups]
    # A: float2 loads at row * S + 2t by a half warp (g 0-3, t 0-3)
    assert tile.strip_stride % 32 in (8, 24)
    assert tile.recompute >= 1.0
    tb_max = (fm.max_strip_rows(c) - 2 * plan.halo) // 16 * 16
    step = fm.UNIT_ROWS * tile.warpgroups

    def work(tb, b, t):
        rows = sum(-(-(hi - lo) // step) * step
                   for *_, lo, hi in fm.conv_walk(plan, tb))
        return -(-b * -(-t // tb) // fm.H100_SMS) * rows

    for b, t in ((1, 300), (2, 10240), (3, 81920), (3, 327680)):
        tb = fm.tile_plan(plan, (b, t)).tb
        assert min(2 * plan.halo, tb_max) <= tb <= tb_max and tb % 16 == 0
        assert work(tb, b, t) <= work(tb_max, b, t)


def test_v1_tiles():
    """The tiles the kernel's header states for V1's three fused stages:
    (tb, wgmma n, warpgroups, units per warpgroup, weight slots, taps a
    partial sum covers) and the recompute."""
    got = {c: fm.tile_plan(fm.MRFPlan(c, KS, DS, 60)) for c in (64, 32, 16)}
    assert {c: (t.tb, t.wgmma_n, t.warpgroups, t.rounds, t.slab_ksteps,
                t.ring_slots, t.sum_taps)
            for c, t in got.items()} == {64: (240, 64, 2, 3, 2, 3, 11),
                                         32: (496, 32, 3, 4, 4, 4, 22),
                                         16: (688, 16, 3, 5, 2, 12, 44)}
    assert [round(got[c].recompute, 2) for c in (64, 32, 16)] == [1.36, 1.2,
                                                                  1.15]
    # sums carried over whole convs at V1 (kernel sizes up to 11)
    assert all(t.sum_taps >= max(KS) for t in got.values())


@pytest.mark.parametrize("c", range(8, 121, 8))
def test_shared_memory_plan_fits_every_width(c):
    """csrc/fused_mrf.cu's float32 shared memory at every width: a full
    and an empty mbarrier per weight slot (padded to 128 bytes), the ring
    of slabs of whole k-steps of a tap (hi and lo halves, 64 C bytes a
    k-step, at most 8 KB a slab), two strips of tb + 2 * halo rows of the
    padded stride, within the 227 KB a block may take at the longest
    tile, and no longer tile fits both shared memory and the warpgroups'
    units."""
    plan = fm.MRFPlan(c, KS, DS, 60)
    tile = fm.tile_plan(plan)
    slots, slab = tile.ring_slots, 64 * c * tile.slab_ksteps
    assert (c // 8) % tile.slab_ksteps == 0 and slab <= fm.SLAB_BYTES
    assert 3 <= slots <= 12 and slab * slots <= max(fm.RING_BYTES, 4 * slab)
    tb_max = (fm.max_strip_rows(c) - 2 * plan.halo) // 16 * 16

    def smem(tb):
        return (-(-16 * slots // 128) * 128 + slab * slots
                + 8 * (tb + 2 * plan.halo) * tile.strip_stride)

    assert tile.tb <= tb_max and tile.smem_bytes == smem(tile.tb)
    assert smem(tb_max) <= fm.SMEM_BYTES == 232448
    longer = tb_max + 16 + 2 * plan.halo
    assert (smem(tb_max + 16) > fm.SMEM_BYTES or -(-longer // fm.UNIT_ROWS)
            > tile.warpgroups * tile.rounds)


def test_conv_walk_reads_only_rows_it_wrote():
    """Each conv reads rows the previous step wrote (the loaded strip or
    the previous conv's rows), all inside the strip."""
    plan = fm.MRFPlan(8, KS, DS, 60)
    tb = 48
    length = tb + 2 * plan.halo
    for i in range(len(KS)):
        rem = sum(p1 + p2 for p1, p2 in plan.pads(i))
        y_rows = (plan.halo - rem, plan.halo + tb + rem)
        lt_rows = None
        for br, j, cv, d, pad, lo, hi in fm.conv_walk(plan, tb):
            if br != i:
                continue
            need = (lo - pad, hi + pad)
            have = y_rows if cv == 0 else lt_rows
            assert have[0] <= need[0] and need[1] <= have[1]
            assert 0 <= need[0] and need[1] <= length
            if cv == 0:
                lt_rows = (lo, hi)
            else:
                y_rows = (lo, hi)
        assert y_rows == (plan.halo, plan.halo + tb)


@pytest.mark.parametrize("c", [8, 16, 24, 48, 64])
def test_kernel_weights_are_the_slabs_the_kernel_streams(c):
    """Walked in the kernel's order (conv, tap, chunk of k_chunk input
    channels), each slab's hi and lo halves, K-major [k_chunk / 4][Co][4]
    with the k order of the A fragment, add up exactly to the packed
    kernel, and hi is a TF32 value."""
    _, w, b, plan = _inputs(1, 1, 10, c)
    wk = fm.kernel_weights(w, plan)
    kc = fm.tile_plan(plan).k_chunk
    assert wk.shape == (2 * w.numel(),)
    off = 0
    for i, _, w1, _, w2, _, _, _ in fm._unpack(w, b, plan):
        for kern in (w1, w2):
            for tap in range(plan.kernel_sizes[i]):
                for ch in range(c // kc):
                    hi, lo = wk[off:off + 2 * kc * c].reshape(2, kc // 4, c, 4)
                    off += 2 * kc * c
                    assert not (hi.view(torch.int32) & 0x1FFF).any()
                    slab = (hi + lo).permute(0, 2, 1).reshape(kc, c)  # [k][co]
                    ci = [ch * kc + 8 * (k // 8) + fm._K_ORDER[k % 8]
                          for k in range(kc)]
                    assert torch.equal(slab, kern[tap, ci, :])
    assert off == wk.numel()


@pytest.mark.parametrize("b,t,c,tb", [(2, 300, 16, None), (1, 257, 8, 16),
                                      (3, 100, 16, 48), (1, 40, 8, None),
                                      (1, 70, 72, 32)])
def test_emulated_kernel_within_the_card_gate(b, t, c, tb):
    """The kernel's walk and 3xTF32 k-steps stay within MRF_RTOL of the
    IEEE float32 plain version (ragged last tiles, tiles shorter than the
    halo, a tile longer than T, a row that ends early, a width whose sums
    are added in groups of taps); one TF32 product does not."""
    x, w, bias, plan = _inputs(t + c, b, t, c)
    tb = tb or fm.tile_plan(plan, (b, t)).tb
    want = fm.mrf_fused_reference(x, w, bias, plan)
    got = emulate(x, w, bias, plan, tb)
    assert torch.isfinite(got).all()
    lim = MRF_RTOL * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= lim, (err, lim)
    err_1x = float((emulate(x, w, bias, plan, tb, mm_1xtf32)
                    - want).abs().max())
    assert err_1x > lim, (err_1x, lim)


def test_emulated_kernel_matches_jax_fused_kernel(rng):
    """Against the JAX package's fused kernel (interpret mode, folded:
    192 rows of 2 x 8 lanes = 384 samples of 8 channels)."""
    g, channels, t = 2, 8, 192
    rbs = _jax_resblocks(channels)
    xf = rng.standard_normal((2, t, g * channels)).astype(np.float32)
    flat, plan = jax_fused.pack_mrf(rbs, g, KS, DS, jnp.float32)
    want = np.asarray(jax_fused.mrf_fused(jnp.asarray(xf), flat, plan))
    w, b, port_plan = _port_pack(rbs)
    x = torch.from_numpy(xf.reshape(2, t * g, channels))
    tb = fm.tile_plan(port_plan, (2, t * g)).tb
    got = emulate(x, w, b, port_plan, tb).reshape(2, t, g * channels)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= MRF_RTOL * float(np.abs(want).max()), err


@pytest.mark.parametrize("c", [4, 12, 128, 136])
def test_check_refuses_channel_counts_the_kernel_does_not_take(c):
    x, w, b, plan = _inputs(0, 1, 20, c)
    with pytest.raises(ValueError, match="channels"):
        fm._check(x, w, b, plan)


def test_check_refuses_a_halo_the_strips_cannot_hold():
    x, w, b, plan = _inputs(0, 1, 20, 120)
    fm._check(x, w, b, plan)                 # V1's halo at 120 channels
    long = fm.MRFPlan(120, KS, ((1, 3, 5), (1, 3, 5), (1, 3, 25)),
                      5 + 15 + 125 + 15)
    with pytest.raises(ValueError, match="halo"):
        fm._check(x, w, b, long)
