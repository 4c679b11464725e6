"""The launch plans and tile walks of the two int8 tensor-core kernels
(rows 7 and 8: `csrc/int8_conv.cu`, `csrc/int8_gemm.cu`), on the CPU.

The kernels run only on the card. What surrounds them is Python the CPU
reaches: `ops/qconv.py::conv_plan` / `gemm_plan` (tile width, branch,
ring, grid, workspaces) and `conv_tile` / `gemm_tile` (the order in which
the persistent blocks walk their tiles). Here an emulation in torch
repeats each kernel's index arithmetic on that plan (the TMA boxes with
their zero fill, the slab read from row tap*dil on, the 32-byte k-steps,
the masked N tile, the store clipped at the tensor's edge) and must give
the plain version's bits. Also: the build hash covers included headers.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from parrot_tts_tpu_torch.core import kernels
from parrot_tts_tpu_torch.core.config import VocoderModelConfig
from parrot_tts_tpu_torch.ops import qconv

# the card test's shapes (tests/test_torch_kernels.py):
# (B, T, Ci, Co, K, dilation, pads, leaky)
CARD_CONV = [
    (2, 1000, 64, 64, 11, 5, (25, 25), 0.1),
    (3, 777, 16, 16, 7, 3, (9, 9), None),
    (1, 130, 512, 1280, 3, 1, (1, 1), None),
    (2, 50, 24, 40, 4, 2, (3, 0), 0.1),
    (1, 1, 8, 8, 1, 1, (0, 0), None),
]
CARD_GEMM = [(1, 1, 1), (17, 33, 9), (128, 256, 128), (1000, 1000, 1000),
             (300, 4096, 260)]


def v1_sites(n: int, codes: int) -> list[tuple]:
    """Every distinct int8 site shape of a V1 vocoder batch of n rows of
    `codes` codes, under all three int8 modes: (B, T, Ci, Co, K, d, pads,
    leaky)."""
    vcfg = VocoderModelConfig()
    keys = set()
    for mode in chip_smoke.INT8_SITES:
        keys |= set(chip_smoke.int8_sites(vcfg, n, codes, mode))
    return sorted({key[:8] for key in keys}, key=repr)


SMALL_SITES = v1_sites(2, 2)          # T = 10 .. 640 rows: 1-2 time tiles
FULL_SITES = v1_sites(3, 1024)        # the serve's largest vocoder batch


def emulate_conv(xq, wt, scale, bias, *, pads, dilation, leaky, plan,
                 out_dtype=torch.float32):
    """csrc/int8_conv.cu's arithmetic on `plan`, in torch: returns the
    (B, T_out, co_p) output buffer, how often each element was stored and
    which consumer warpgroup stored it."""
    b, t, ci = xq.shape
    k, co, _ = wt.shape
    ci_p, t_x, bn, rows, ck = (plan["ci_p"], plan["t_x"], plan["bn"],
                               plan["bm"], plan["ck"])
    # the buffers the kernel's tensor maps describe: (ci_p, t_x, B) and
    # (ci_p, Co, K); a padded operand is the zeroed workspace
    x = torch.zeros((b, t_x, ci_p), dtype=torch.int64)
    x[:, :t, :ci] = xq.long()
    if not plan["pad_x"]:
        assert (t_x, ci_p) == (t, ci)
    w = torch.zeros((k, co, ci_p), dtype=torch.int64)
    w[:, :, :ci] = wt.long()
    out = torch.full((b, plan["t_out"], plan["co_p"]), float("nan"),
                     dtype=out_dtype)
    stores = torch.zeros(out.shape, dtype=torch.int64)
    owner = torch.full(out.shape, -1, dtype=torch.int64)
    assert plan["grid"] % plan["tiles_n"] == 0

    def box(rows_, cols, src_rows, src_cols, src):
        """A TMA box: rows_ x cols of src at signed coordinates, zero
        outside the tensor."""
        r = torch.arange(rows_) + src_rows
        c = torch.arange(cols) + src_cols
        ok = ((r >= 0) & (r < src.shape[0]))[:, None] & (c < src.shape[1])
        vals = src[r.clamp(0, src.shape[0] - 1)][:, c.clamp(max=src.shape[1]
                                                           - 1)]
        return torch.where(ok, vals, torch.zeros_like(vals))

    def weights(n0, c):
        """A chunk's weight box {ck, bn, K} at (c * ck, n0, 0): (K, bn, ck),
        channels past Co and Ci zero."""
        return torch.stack([box(bn, ck, n0, c * ck, w[tap])
                            for tap in range(k)])

    for block in range(plan["grid"]):
        n0 = block % plan["tiles_n"] * bn      # the block's channel tile
        # resident: loaded once per block, chunk by chunk
        wres = ([weights(n0, c) for c in range(plan["n_chunks"])]
                if plan["resident"] else None)
        for local, tile in enumerate(range(block, plan["tiles"],
                                           plan["grid"])):
            bb, t0, tn0 = qconv.conv_tile(plan, tile)
            assert tn0 == n0
            acc = torch.zeros((rows, bn), dtype=torch.int64)
            for c in range(plan["n_chunks"]):
                # the slab: rows of ck bytes, n_rbox boxes {ck, box_rows};
                # at ci_p = 16 one copy of the input's rows where they lie
                # inside the batch row, and a zero plane beside them
                slab = torch.zeros((plan["slab"], ck), dtype=torch.int64)
                row0 = t0 - pads[0]
                assert plan["planes"] == (ci_p == 16)
                if plan["planes"] and 0 <= row0 <= t_x - plan["slab"]:
                    slab[:, :16] = x[bb, row0:row0 + plan["slab"]]
                else:
                    for q in range(plan["n_rbox"]):
                        r0 = q * plan["box_rows"]
                        slab[r0:r0 + plan["box_rows"]] = box(
                            plan["box_rows"], ck, row0 + r0, c * ck, x[bb])
                wch = wres[c] if plan["resident"] else weights(n0, c)
                for tap in range(k):
                    for ks in range(ck // 32):
                        kk = slice(32 * ks, 32 * ks + 32)
                        for mb in range(plan["mb"]):
                            start = mb * 64 + tap * dilation
                            assert start + 64 <= plan["slab"]
                            acc[mb * 64:mb * 64 + 64] += (
                                slab[start:start + 64, kk] @ wch[tap][:, kk].T)
            # the epilogue: the same two float32 roundings; in float32 the
            # leaky, in bf16 the packed pair's rounding and leaky
            cols = n0 + torch.arange(bn)
            inside = cols < co
            sc = torch.where(inside, scale[bb, cols.clamp(max=co - 1)],
                             torch.zeros(()))
            y = acc.to(torch.float32) * sc
            if bias is not None:
                y = y + torch.where(inside, bias[cols.clamp(max=co - 1)],
                                    torch.zeros(()))
            if out_dtype == torch.bfloat16:
                y = y.bfloat16()
                if leaky is not None:
                    y = packed_leaky_bf16(y, leaky)
            elif leaky is not None:
                y = torch.maximum(y, leaky * y)
            # the stores: boxes of EC channels x up to 256 of the tile's
            # rows, clipped at T_out and at Co
            ec = min(bn, 128 // out.element_size())
            box_rows = min(rows, 256)
            for c0 in range(0, bn, ec):
                for r0 in range(0, rows, box_rows):
                    rows_ = slice(t0 + r0, min(t0 + r0 + box_rows,
                                               plan["t_out"]))
                    chans = slice(n0 + c0, min(n0 + c0 + ec, co))
                    if rows_.start >= rows_.stop or chans.start >= chans.stop:
                        continue
                    out[bb, rows_, chans] = y[r0:r0 + rows_.stop - rows_.start,
                                              c0:c0 + chans.stop - chans.start]
                    stores[bb, rows_, chans] += 1
                    owner[bb, rows_, chans] = local % 2
    return out, stores, owner


def packed_leaky_bf16(y16: torch.Tensor, slope: float) -> torch.Tensor:
    """The kernel's bf16 leaky ReLU on packed pairs: __hmul2(s16, y16), one
    rounding of the product (exact in float32) to bf16, then __hmax2."""
    s16 = torch.tensor(slope, dtype=torch.bfloat16).float()
    return torch.maximum(y16, (s16 * y16.float()).bfloat16())


def _conv_inputs(shape, seed):
    b, t, ci, co, k, dil, pads, leaky = shape
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (b, t, ci)).astype(np.int8))
    wt = torch.from_numpy(rng.integers(-127, 128, (k, co, ci)).astype(np.int8))
    scale = torch.from_numpy((rng.random((b, co)) * 1e-4 + 1e-6)
                             .astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(co).astype(np.float32))
    return xq, wt, scale, bias


# weights past what a block keeps: the ring streams them
STREAMED_CONV = [(1, 100, 2048, 96, 11, 1, (5, 5), 0.1)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SMALL_SITES + CARD_CONV + STREAMED_CONV,
                         ids=lambda s: "B{}-T{}-Ci{}-Co{}-K{}-d{}".format(*s))
def test_conv_tile_walk_is_bit_identical_to_plain(shape, out_dtype):
    """Every output element is stored once, the consumers take a block's
    tiles in turn, and the emulated kernel gives int8_conv_reference's
    bits in either output type, at a short-T version of every distinct V1
    site shape, at the card test's shapes and at one whose weights
    stream."""
    b, t, ci, co, k, dil, pads, leaky = shape
    xq, wt, scale, bias = _conv_inputs(shape, t + ci + co + k)
    out_bytes = 2 if out_dtype == torch.bfloat16 else 4
    plan = qconv.conv_plan(b, t, ci, k, co, pads, dil, sms=7,
                           out_bytes=out_bytes)
    assert plan["resident"] == (shape not in STREAMED_CONV)
    got, stores, owner = emulate_conv(xq, wt, scale, bias, pads=pads,
                                      dilation=dil, leaky=leaky, plan=plan,
                                      out_dtype=out_dtype)
    want = qconv.int8_conv_reference(xq, wt, scale, bias, pads=pads,
                                     dilation=dil, leaky=leaky,
                                     out_dtype=out_dtype)
    assert torch.equal(stores[..., :co], torch.ones_like(want,
                                                         dtype=torch.int64))
    assert torch.equal(got[..., :co], want)
    assert set(owner[..., :co].unique().tolist()) <= {0, 1}


def test_conv_tile_walk_covers_every_row_once_at_full_size():
    """At the serve's largest batch (3 x 1024 codes), every site's walk
    over (batch row, time tile, channel tile) takes each tile exactly
    once, the tiles cover every output row and channel, and every tile of
    a block has the block's channel tile (whose weights it keeps)."""
    for b, t, ci, co, k, dil, pads, _ in FULL_SITES:
        plan = qconv.conv_plan(b, t, ci, k, co, pads, dil)
        assert plan["grid"] % plan["tiles_n"] == 0
        seen = []
        for block in range(plan["grid"]):
            walk = [qconv.conv_tile(plan, tile)
                    for tile in range(block, plan["tiles"], plan["grid"])]
            assert {n0 for _, _, n0 in walk} <= {
                block % plan["tiles_n"] * plan["bn"]}
            seen += walk
        assert len(seen) == len(set(seen)) == plan["tiles"]
        rows = {(bb, t0) for bb, t0, _ in seen}
        assert rows == {(bb, t0) for bb in range(b)
                        for t0 in range(0, plan["t_out"], plan["bm"])}
        assert {n0 for _, _, n0 in seen} == set(range(0, co, plan["bn"]))


def test_conv_plan_at_every_v1_site():
    """No V1 site takes the padded branch; each plan keeps its weights
    resident, fits shared memory with at least four stages (two for each
    consumer) and reads whole
    chunks of Ci; the narrow stages take one channel tile of Co and the
    widest rows their width allows."""
    for b, t, ci, co, k, dil, pads, _ in FULL_SITES:
        for out_bytes in (4, 2):
            plan = qconv.conv_plan(b, t, ci, k, co, pads, dil,
                                   out_bytes=out_bytes)
            assert plan["branch"] == "tma" and plan["workspace_bytes"] == 0
            assert plan["resident"]
            assert 4 <= plan["stages"] <= qconv.CONV_STAGES
            assert plan["stages"] % 2 == 0
            assert plan["smem"] <= qconv.SMEM_MAX
            assert plan["ck"] in qconv.CONV_CHUNKS and (
                plan["ck"] <= ci or plan["ck"] == 32)
            assert plan["n_chunks"] * plan["ck"] >= ci
            assert plan["box_rows"] <= 256 and plan["box_rows"] % 8 == 0
            assert plan["slab"] >= plan["bm"] + (k - 1) * dil
            assert plan["grid"] == plan["tiles_n"] * min(
                b * plan["tiles_m"], qconv.H100_SMS // plan["tiles_n"])
            if co <= 64:
                assert plan["bn"] == co and plan["tiles_n"] == 1
                assert plan["bm"] == qconv.CONV_TILE_ROWS[co]


def test_conv_plan_spreads_a_small_launch_over_the_sms():
    """At the serve's smallest batch (2 x 128 codes) every site's launch
    has a tile for every SM, or tiles of at most 128 rows (512-row tiles
    would leave most SMs idle); the grid takes every tile up to the
    SMs."""
    for b, t, ci, co, k, dil, pads, _ in v1_sites(2, 128):
        for out_bytes in (4, 2):
            plan = qconv.conv_plan(b, t, ci, k, co, pads, dil,
                                   out_bytes=out_bytes)
            assert plan["tiles"] >= qconv.H100_SMS or plan["bm"] <= 128
            assert plan["grid"] >= min(plan["tiles"], qconv.H100_SMS
                                       - plan["tiles_n"] + 1)


@pytest.mark.parametrize("shape,branch,pads_", [
    (CARD_CONV[0], "tma", (False, False, False)),
    (CARD_CONV[1], "tma", (False, False, False)),
    (CARD_CONV[2], "tma", (False, False, False)),
    (CARD_CONV[3], "padded", (True, True, False)),    # Ci 24: rows of 24 B
    (CARD_CONV[4], "padded", (True, True, False)),    # Ci 8
    ((1, 20, 16, 6, 3, 1, (1, 1), None), "padded", (False, False, True)),
])
def test_conv_plan_branch_and_workspaces(shape, branch, pads_):
    b, t, ci, co, k, dil, pads, _ = shape
    plan = qconv.conv_plan(b, t, ci, k, co, pads, dil)
    assert plan["branch"] == branch
    assert (plan["pad_x"], plan["pad_w"], plan["pad_out"]) == pads_
    want = ((b * plan["t_x"] * plan["ci_p"] if pads_[0] else 0)
            + (k * co * plan["ci_p"] if pads_[1] else 0)
            + (4 * b * plan["t_out"] * plan["co_p"] if pads_[2] else 0))
    assert plan["workspace_bytes"] == want
    assert plan["ci_p"] % 16 == 0 and plan["co_p"] % 4 == 0


def test_conv_plan_pads_an_unaligned_operand_and_an_empty_input():
    plan = qconv.conv_plan(2, 64, 64, 3, 64, (1, 1), 1, x_aligned=False)
    assert plan["branch"] == "padded" and plan["pad_x"] and not plan["pad_w"]
    plan = qconv.conv_plan(2, 64, 64, 3, 64, (1, 1), 1, w_aligned=False)
    assert plan["pad_w"] and not plan["pad_x"]
    plan = qconv.conv_plan(1, 0, 16, 3, 16, (2, 2), 1)   # T = 0, pads only
    assert plan["t_x"] == 1 and plan["pad_x"] and plan["t_out"] == 2


@pytest.mark.parametrize("ci,co,k,tile", [
    (16, 16, 3, (16, 8, True)), (32, 32, 3, (32, 4, True)),
    (64, 64, 11, (64, 2, True)), (128, 128, 3, (128, 1, True)),
    (128, 256, 3, (128, 1, True)),     # two channel tiles, each resident
    (24, 40, 4, (64, 2, True)),        # Co off the widths: a masked tile
    (128, 128, 7, (128, 1, True)),     # 112 KB of weights
    (256, 256, 3, (128, 1, True)), (256, 256, 11, (32, 2, True)),
    (512, 1280, 3, (64, 1, True)),
])
def test_conv_plan_tile_widths(ci, co, k, tile):
    """With enough rows for every SM: the modelled best tile, which keeps
    its weights resident, is the longest at the narrow widths
    (CONV_TILE_ROWS) and the widest (up to the one that covers Co) where
    the weights leave room for a deep ring; 256 channels at K = 11, whose
    64-channel weights (176 KB) would leave one 64-row tile and a ring of
    one-k-step slabs, take 32, and 512 inputs 64-row tiles (their slabs
    are read once per channel tile, from L2); the ring is as deep as fits,
    at most
    CONV_STAGES, at least 4 and even: two slots or more for each
    consumer."""
    plan = qconv.conv_plan(3, 1 << 17, ci, k, co, ((k - 1) // 2,) * 2, 1)
    assert (plan["bn"], plan["mb"], plan["resident"]) == tile
    assert 4 <= plan["stages"] <= qconv.CONV_STAGES
    assert plan["stages"] % 2 == 0
    assert plan["tiles"] >= qconv.H100_SMS


@pytest.mark.parametrize("t,ci,co,k,tile", [
    (640, 256, 256, 11, (32, 1)),    # 80 tiles of 64 rows x 32 channels
    (1024, 512, 1280, 3, (64, 1)),   # 320 tiles: 64 channels cover the SMs
    (20480, 32, 32, 3, (32, 4)),     # 80 tiles of 256 rows, not 40 of 512
    (2560, 128, 128, 3, (64, 1)),    # 80 tiles, not 40 of 128 channels
])
def test_conv_plan_gives_a_small_streamed_launch_more_tiles(t, ci, co, k,
                                                            tile):
    """A launch with fewer rows than the SMs could take in long tiles
    takes shorter and narrower ones (the model's per-SM time is one tile
    then): its weights stay resident either way, loaded once per block."""
    plan = qconv.conv_plan(1, t, ci, k, co, ((k - 1) // 2,) * 2, 1)
    assert (plan["bn"], plan["mb"]) == tile
    assert plan["grid"] == min(plan["tiles"], qconv.H100_SMS
                               // plan["tiles_n"] * plan["tiles_n"])


def test_packed_bf16_leaky_equals_the_plain_version():
    """The kernel's bf16 leaky ReLU on packed pairs (__hmul2: the product
    of bf16(slope) and a bf16 value, exact in float32, rounded once;
    then __hmax2) gives ops/activation.py::leaky_relu's bits, over values
    of every sign and binade the epilogue can round to, zeros and the
    V1 slope."""
    from parrot_tts_tpu_torch.ops.activation import leaky_relu

    rng = np.random.default_rng(7)
    mant = rng.uniform(1.0, 2.0, 200_000)
    expo = rng.integers(-126, 127, 200_000)
    sign = rng.choice([-1.0, 1.0], 200_000)
    y = torch.from_numpy((sign * mant * 2.0 ** expo).astype(np.float32))
    y = torch.cat([y, torch.tensor([0.0, -0.0, 1e-38, -1e-38])])
    y16 = y.bfloat16()
    for slope in (0.1, 0.2, 0.01):
        s16 = torch.tensor(slope, dtype=torch.bfloat16).double()
        exact = s16 * y16.double()
        assert torch.equal(exact, (s16.float() * y16.float()).double())
        assert torch.equal(packed_leaky_bf16(y16, slope),
                           leaky_relu(y16, slope))


def test_conv_plan_rejects_a_slab_that_leaves_no_ring():
    with pytest.raises(ValueError):
        qconv.conv_plan(1, 100_000, 256, 11, 256, (10_000, 10_000), 2_000)


def test_conv_check_rejects_32_bit_overflow():
    """B*T*Ci = 2^31 is refused (the kernel's indices are 32-bit), one row
    less is taken; meta tensors, so nothing is allocated."""
    wt = torch.empty((1, 16, 16), dtype=torch.int8, device="meta")
    scale = torch.empty(16, device="meta").expand(2**16, -1)
    for t, ok in ((2**11, False), (2**11 - 1, True)):
        xq = torch.empty((2**16, t, 16), dtype=torch.int8, device="meta")
        if ok:
            qconv._check(xq, wt, scale, None, (0, 0), 1)
        else:
            with pytest.raises(ValueError):
                qconv._check(xq, wt, scale, None, (0, 0), 1)


def emulate_gemm(a, b, plan):
    """csrc/int8_gemm.cu's int8 walk on `plan`, in torch: the A buffer
    (m, lda), the B^T workspace (n, ldb), 128-byte k blocks read through
    zero-filled boxes, the store clipped at (m, n)."""
    m, k = a.shape
    n = b.shape[1]
    ap = torch.zeros((m, plan["lda"]), dtype=torch.int64)
    ap[:, :k] = a.long()
    bt = torch.zeros((n, plan["ldb"]), dtype=torch.int64)
    bt[:, :k] = b.long().T
    c = torch.full((m, plan["ldc"]), -(2**40), dtype=torch.int64)
    stores = torch.zeros((m, n), dtype=torch.int64)
    bm, bn = qconv.GEMM_BM, qconv.GEMM_BN
    for block in range(plan["grid"]):
        for tile in range(block, plan["tiles"], plan["grid"]):
            mt, nt = qconv.gemm_tile(plan, tile)
            acc = torch.zeros((bm, bn), dtype=torch.int64)
            for kb in range(-(-k // 128)):
                ks = slice(kb * 128, (kb + 1) * 128)
                at = torch.zeros((bm, 128), dtype=torch.int64)
                blk = ap[mt * bm:(mt + 1) * bm, :k][:, ks]
                at[:blk.shape[0], :blk.shape[1]] = blk
                btt = torch.zeros((bn, 128), dtype=torch.int64)
                blk = bt[nt * bn:(nt + 1) * bn, :k][:, ks]
                btt[:blk.shape[0], :blk.shape[1]] = blk
                acc += at @ btt.T
            rows = slice(mt * bm, min((mt + 1) * bm, m))
            cols = slice(nt * bn, min((nt + 1) * bn, n))
            c[rows, cols] = acc[:rows.stop - rows.start, :cols.stop - cols.start]
            stores[rows, cols] += 1
    return c[:, :n], stores


@pytest.mark.parametrize("m,k,n", CARD_GEMM + [(300, 200, 700)])
def test_gemm_tile_walk_equals_plain(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    plan = qconv.gemm_plan(m, k, n, torch.int8, sms=5)
    got, stores = emulate_gemm(a, b, plan)
    assert torch.equal(stores, torch.ones_like(stores))
    assert torch.equal(got.to(torch.int32), qconv.matmul_reference(a, b))


@pytest.mark.parametrize("m,k,n", CARD_GEMM + [(8192, 4096, 4096)])
def test_gemm_tile_order_covers_each_tile_once(m, k, n):
    plan = qconv.gemm_plan(m, k, n, torch.int8)
    seen = [qconv.gemm_tile(plan, tile) for block in range(plan["grid"])
            for tile in range(block, plan["tiles"], plan["grid"])]
    assert sorted(seen) == [(i, j) for i in range(plan["tiles_m"])
                            for j in range(plan["tiles_n"])]
    if (m, k, n) == (8192, 4096, 4096):
        # one group of tiles is GEMM_GROUP tile rows by every tile column,
        # so the blocks in flight share rows of A and columns of B in L2
        group = {qconv.gemm_tile(plan, tile) for tile in
                 range(qconv.GEMM_GROUP * plan["tiles_n"])}
        assert group == {(i, j) for i in range(qconv.GEMM_GROUP)
                         for j in range(plan["tiles_n"])}


@pytest.mark.parametrize("m,k,n,dtype,branch,workspaces", [
    (8192, 4096, 4096, torch.int8, "tma", {"bt": (4096, 4096)}),
    (8192, 4096, 4096, torch.bfloat16, "tma", {}),
    (1000, 1000, 1000, torch.int8, "padded",
     {"a": (1000, 1008), "bt": (1000, 1008)}),
    (1000, 1000, 1000, torch.bfloat16, "tma", {}),
    (17, 33, 9, torch.int8, "padded",
     {"a": (17, 48), "bt": (9, 48), "c": (17, 12)}),
    (17, 33, 9, torch.bfloat16, "padded",
     {"a": (17, 40), "b": (33, 16), "c": (17, 12)}),
    (300, 4096, 260, torch.bfloat16, "padded", {"b": (4096, 264)}),
    (1, 1, 1, torch.bfloat16, "padded", {"a": (1, 8), "b": (1, 8),
                                         "c": (1, 4)}),
])
def test_gemm_plan_branch_and_workspaces(m, k, n, dtype, branch, workspaces):
    plan = qconv.gemm_plan(m, k, n, dtype)
    assert plan["route"] == "wgmma" and plan["branch"] == branch
    assert plan["workspaces"] == workspaces
    esize = 1 if dtype == torch.int8 else 2
    # every row the kernel reads or writes by TMA is a multiple of 16 bytes
    assert plan["lda"] * esize % 16 == plan["ldb"] * esize % 16 == 0
    assert plan["ldc"] * 4 % 16 == 0 and plan["ldc"] >= n
    assert plan["grid"] == min(plan["tiles"], qconv.H100_SMS)


def test_gemm_plan_pads_an_unaligned_a_and_routes_float32():
    plan = qconv.gemm_plan(64, 128, 70, torch.int8, a_aligned=False)
    assert plan["pad_a"] and plan["workspaces"]["a"] == (64, 128)
    plan = qconv.gemm_plan(64, 128, 64, torch.bfloat16, b_aligned=False)
    assert plan["pad_b"] and plan["workspaces"]["b"] == (128, 64)
    assert qconv.gemm_plan(64, 128, 70, torch.float32)["route"] == "sgemm"


def test_time_int8_conv_rehearses_on_the_cpu(capsys):
    """scripts/time_int8_conv.py on the CPU at one code per row: every
    site of both outputs bit-identical to the plain version, every key
    printed (site, batch, serve, stage, bench, fixed cost and the launch
    floor), and no time:
    a CPU run measures nothing on the card."""
    from parrot_tts_tpu_torch.scripts import time_int8_conv

    assert time_int8_conv.main(["--device", "cpu", "--batches", "1x1",
                                "--bench", "1x1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    for dtype, modes in time_int8_conv.MODES.items():
        mine = [line for line in lines if line.split()[1] == dtype
                or line.startswith(f"fixed cost {dtype}")]
        for key in ("site", "batch", "serve", "stage", "bench"):
            assert any(line.startswith(f"{key} {dtype}") for line in mine)
        assert {line.split()[2].rstrip(":") for line in mine
                if line.startswith("serve")} == set(modes)
        # each fixed-cost shape and the card's launch-to-launch floor
        assert sum(line.startswith("fixed cost") for line in mine) == len(
            time_int8_conv.FIXED_SITES) + 1
    sites = [line for line in lines if line.startswith("site")]
    assert sites and all(line.endswith("bit-identical True")
                         for line in sites)
    for line in lines:
        assert "not measured" in line and " ms " not in line.split(
            "bound")[0], line


def test_time_int8_conv_model_sums_the_serve_bound():
    """--model's serve bound is chip_smoke.py's bound of a serve (PERF.md
    section 6: 2.8549 ms float32 int8-static, 1.8303 ms bf16 "int8")."""
    import contextlib
    import io

    from parrot_tts_tpu_torch.scripts import time_int8_conv

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert time_int8_conv.main(["--model", "--fixed-us", "0"]) == 0
    serves = [line for line in out.getvalue().splitlines()
              if " serve: bound" in line]
    assert [line.split("bound ")[1].split(" ms")[0] for line in serves] == [
        "2.8549", "1.8303"]


def test_exp_wgmma_rate_lists_its_s8_cases(capsys):
    """The wgmma rate script's s8 mode: m64nNk32 at N = 16 to 256, each
    built into the source; --list measures nothing."""
    from parrot_tts_tpu_torch.scripts import exp_wgmma_rate

    assert exp_wgmma_rate.main(["--only", "s8", "--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert {line.split()[0] for line in lines} == {
        f"m64n{n}k32" for n in (16, 32, 64, 128, 256)}
    assert all(line.endswith(": not measured") for line in lines)
    src = exp_wgmma_rate.source()
    for n, w, u, lay in exp_wgmma_rate.CASES:
        if lay == "s8":
            assert f"rate_{n}_{w}_{u}_7(" in src
            assert f"wgmma_s8<{n}>" in src


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """An edit of a header that a source includes (directly or through
    another header) changes the source's library path; an edit of a
    header it does not include does not."""
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    assert [p.name for p in kernels.sources("k")] == ["k.cu", "a.cuh",
                                                      "b.cuh"]
    before = kernels.library_path("k")
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert kernels.library_path("k") == before
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    edited = kernels.library_path("k")
    assert edited != before
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// x\n')
    assert kernels.library_path("k") not in (before, edited)


def test_the_int8_sources_include_the_shared_header():
    for name in ("int8_gemm", "int8_conv"):
        assert [p.name for p in kernels.sources(name)] == [f"{name}.cu",
                                                           "sm90.cuh"]


def test_v1_site_list_is_complete():
    """The sites above are every distinct shape the three int8 serves
    launch (chip_smoke.int8_sites), at least one of each polyphase
    upsample and each (K, dilation) of the MRF."""
    assert len(SMALL_SITES) == len(FULL_SITES)
    cis = {s[2] for s in FULL_SITES}
    assert cis == {16, 32, 64, 128, 256, 512}
    assert {(s[4], s[5]) for s in FULL_SITES if s[2] == s[3]} >= {
        (k, d) for k in (3, 7, 11) for d in (1, 3, 5)}
