"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (tests/conftest.py imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked `cuda` skip where there is no CUDA device.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from parrot_tts_tpu_torch.core.device import exact_numerics
from parrot_tts_tpu_torch.ops import flash_attention as fa
from parrot_tts_tpu_torch.ops import flash_dropout as fd
from parrot_tts_tpu_torch.ops import fused_mrf, qconv, quant
from parrot_tts_tpu_torch.ops.precision import round_tf32


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(rng, b, h, t, d, device="cpu", all_masked_row=None):
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                .astype(np.float32)).to(device)
               for _ in range(3))
    lengths = rng.integers(1, t + 1, size=b)
    lengths[0] = t
    mask = np.arange(t)[None, :] >= lengths[:, None]      # True = ignore
    if all_masked_row is not None:
        mask[all_masked_row] = True
    return q, k, v, torch.from_numpy(mask).to(device)


@pytest.mark.parametrize("bad", ["dtype", "width", "shape", "mask", "layout",
                                 "aligned"])
def test_wrapper_rejects_what_the_kernel_does_not_take(rng, bad):
    q, k, v, mask = _inputs(rng, 2, 2, 8, 128)
    if bad == "dtype":
        k = k.double()
    elif bad == "width":
        q, k, v = (x[..., :32].contiguous() for x in (q, k, v))
    elif bad == "shape":
        v = v[:, :, :4].contiguous()
    elif bad == "mask":
        mask = mask.to(torch.uint8)
    elif bad == "aligned":       # cp.async copies 16 bytes at a time
        buf = torch.empty(v.numel() + 1)
        v = buf[1:].view(v.shape).copy_(v)
        assert v.is_contiguous() and v.data_ptr() % 16
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        fa._check(q, k, v, mask)


def test_cpu_tensors_take_the_plain_version(rng):
    q, k, v, mask = _inputs(rng, 2, 2, 8, 16)
    before = fa.FLASH_FWD.launches, fa.SPLIT_PREP.launches
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, mask, 0.25),
        fa.flash_attention_reference(q, k, v, mask, 0.25), rtol=0, atol=0)
    assert (fa.FLASH_FWD.launches, fa.SPLIT_PREP.launches) == before


def test_one_pass_on_cpu_is_its_plain_version(rng):
    q, k, v, mask = _inputs(rng, 2, 2, 40, 64, all_masked_row=1)
    before = fa.FLASH_FWD.launches, fa.FLASH_FWD.one_pass
    prep = fa.ONE_PASS_PREP.launches
    got = fa.flash_attention(q, k, v, mask, 0.125, passes=1)
    torch.testing.assert_close(
        got, fa.flash_attention_reference(q, k, v, mask, 0.125, passes=1),
        rtol=0, atol=0)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert (fa.FLASH_FWD.launches, fa.FLASH_FWD.one_pass) == before
    assert fa.ONE_PASS_PREP.launches == prep
    for passes in (0, 2):
        with pytest.raises(ValueError):
            fa.flash_attention(q, k, v, mask, 0.125, passes=passes)


def test_one_pass_gate_tells_rounding_apart(rng, monkeypatch):
    """chip_smoke.py's 1-pass gate passes the plain version with its
    scores summed in another order (d permuted), as the kernel sums them,
    and fails one that truncates where it should round and the IEEE
    version (the 3xTF32 mode's result)."""
    q, k, v, mask = _inputs(rng, 4, 2, 500, 128, all_masked_row=2)
    scale = 128 ** -0.5
    keep = torch.arange(4) != 2
    want = fa.flash_attention_reference(q, k, v, mask, scale, passes=1)
    ieee = fa.flash_attention_reference(q, k, v, mask, scale)
    perm = torch.from_numpy(rng.permutation(128))
    reordered = fa.flash_attention_reference(q[..., perm], k[..., perm], v,
                                             mask, scale, passes=1)
    monkeypatch.setattr(fa, "round_tf32", lambda x: (
        x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32))
    truncated = fa.flash_attention_reference(q, k, v, mask, scale, passes=1)

    def gate(got):
        err, rms, from_ieee, tol, rms_tol = chip_smoke.one_pass_gate(
            got[keep], want[keep], ieee[keep], v)
        return err <= tol, rms <= rms_tol, from_ieee > 1e-5

    assert not torch.equal(reordered, want)
    assert gate(reordered) == (True, True, True)
    assert gate(truncated)[1:] == (False, True)
    assert gate(ieee)[1:] == (False, False)


def test_one_pass_operands_are_the_kernels_layout(rng):
    """The pre-pass's plain version lays each key tile out as
    csrc/flash_attn_fwd.cu's 1-pass kernel reads it: K rounded to TF32 as
    [D / 4][BK][4] (the B operand of S = Q Kᵀ, K-major), the key bias, and
    Vᵀ rounded as [BK / 4][D][4] whose logical k of every 8 holds key
    _K_ORDER[k], the key of the P fragment's logical k (accumulator keys
    2t, 2t + 1 at k t, t + 4): so the products over the tile's logical k
    are P V over its keys."""
    b, h, t, d, bk = 2, 2, 70, 64, fa.BK
    q, k, v, mask = _inputs(rng, b, h, t, d, all_masked_row=1)
    kv = fa.one_pass_operands(k, v, mask)
    n = -(-t // bk)
    assert kv.shape == (b * h, n, 2 * d * bk + bk)
    tiles_k = kv[..., :d * bk].reshape(b * h, n, d // 4, bk, 4)
    bias = kv[..., d * bk:d * bk + bk]
    tiles_v = kv[..., d * bk + bk:].reshape(b * h, n, bk // 4, d, 4)
    keys = torch.arange(n * bk)
    tile, key = keys // bk, keys % bk
    dd = torch.arange(d)
    # key j's d at [d / 4][j % BK][d % 4] of tile j / BK; 0 past T
    got_k = tiles_k[:, tile[:, None], dd // 4, key[:, None], dd % 4]
    want_k = torch.nn.functional.pad(
        round_tf32(k), (0, 0, 0, n * bk - t)).reshape(b * h, -1, d)
    assert torch.equal(got_k, want_k)
    valid = torch.nn.functional.pad(~mask, (0, n * bk - t))
    assert torch.equal(bias.reshape(b, h, -1),
                       torch.where(valid, 0.0, float("-inf"))[:, None]
                       .expand(b, h, -1))
    # logical key p of a tile, at [p / 4][d][p % 4], is key
    # 8 (p / 8) + _K_ORDER[p % 8]
    p = torch.arange(bk)
    got_v = tiles_v[:, :, p[:, None] // 4, dd, p[:, None] % 4]
    order = 8 * (p // 8) + torch.tensor(fa._K_ORDER)[p % 8]
    want_v = torch.nn.functional.pad(
        round_tf32(v), (0, 0, 0, n * bk - t)).reshape(b * h, n, bk, d)
    assert torch.equal(got_v, want_v[:, :, order])
    # the P fragment of k-step kc (a0..a3 = accumulator elements 4kc, 4kc+2,
    # 4kc+1, 4kc+3: rows g, g+8 at keys 8kc+2t, 8kc+2t+1) is logical k t /
    # t + 4 of keys 8kc+2t / 8kc+2t+1: its product with the logical Vᵀ is
    # P V over the tile's keys
    pk = torch.rand(5, bk)
    logical = torch.empty_like(pk)
    for kc in range(bk // 8):
        for tt in range(4):
            logical[:, 8 * kc + tt] = pk[:, 8 * kc + 2 * tt]
            logical[:, 8 * kc + tt + 4] = pk[:, 8 * kc + 2 * tt + 1]
    torch.testing.assert_close(logical.double() @ got_v[0, 0].double(),
                               pk.double() @ want_v[0, 0].double(),
                               rtol=1e-12, atol=0)
    # the tiles hold the attention's whole operands: its plain version
    # from them is the 1-pass plain version
    assert torch.equal(fa.one_pass_attention(q, kv, 0.125),
                       fa.flash_attention_reference(q, k, v, mask, 0.125,
                                                    passes=1))


@pytest.mark.parametrize("t,d", [(70, 64), (33, 128)])
def test_split_operands_are_the_kernels_layout(rng, t, d):
    """The 3xTF32 pre-pass's plain version lays each key tile out as
    csrc/flash_attn_fwd.cu's 3xTF32 kernel reads it: K's TF32 hi plane then
    its lo plane, each [D / 4][BK][4] (the B operand of S = Q Kᵀ,
    K-major), the key bias, then Vᵀ's hi and lo planes, each
    [BK / 4][D][4] with the keys of every 8 in _K_ORDER (the P fragment's
    order, as in the 1-pass tiles). hi is a TF32 value, the split is
    tf32x3.cuh's (Veltkamp's, which rounds to nearest, ties to even, as
    ops/fused_mrf.py's bit split does), and hi + lo is K or V exactly."""
    b, h, bk = 2, 2, fa.BK
    q, k, v, mask = _inputs(rng, b, h, t, d, all_masked_row=1)
    # ties at TF32's rounding point, both signs, as some of k's values
    k.view(-1)[:64] = ((k.view(-1)[:64].view(torch.int32) & ~0x1FFF) | 0x1000
                       ).view(torch.float32)
    kv = fa.split_operands(k, v, mask)
    n = -(-t // bk)
    assert kv.shape == (b * h, n, 4 * d * bk + bk)
    plane = d * bk
    keys = torch.arange(n * bk)
    tile, key = keys // bk, keys % bk
    dd = torch.arange(d)
    p = torch.arange(bk)
    order = 8 * (p // 8) + torch.tensor(fa._K_ORDER)[p % 8]

    def planes(x, off):
        return [x[..., off + i * plane:off + (i + 1) * plane]
                for i in range(2)]

    pad = (0, 0, 0, n * bk - t)
    for (hi, lo), src in ((planes(kv, 0), k), (planes(kv, 2 * plane + bk), v)):
        want = torch.nn.functional.pad(src, pad).reshape(b * h, n, bk, d)
        whi, wlo = fused_mrf.tf32_split(want)
        if src is k:        # key j's d at [d / 4][j % BK][d % 4] of tile j / BK
            def at(x):
                x = x.reshape(b * h, n, d // 4, bk, 4)
                return x[:, tile[:, None], dd // 4, key[:, None], dd % 4
                         ].reshape(b * h, n, bk, d)
            want_hi, want_lo = whi, wlo
        else:               # logical key p at [p / 4][d][p % 4]
            def at(x):
                x = x.reshape(b * h, n, bk // 4, d, 4)
                return x[:, :, p[:, None] // 4, dd, p[:, None] % 4]
            want_hi, want_lo = whi[:, :, order], wlo[:, :, order]
        assert torch.equal(at(hi), want_hi) and torch.equal(at(lo), want_lo)
        assert torch.equal(at(hi) + at(lo), want if src is k
                           else want[:, :, order])
        assert not bool((hi.view(torch.int32) & 0x1FFF).any())   # TF32
    bias = kv[..., 2 * plane:2 * plane + bk]
    valid = torch.nn.functional.pad(~mask, (0, n * bk - t))
    assert torch.equal(bias.reshape(b, h, -1),
                       torch.where(valid, 0.0, float("-inf"))[:, None]
                       .expand(b, h, -1))
    # the tiles hold the attention's whole operands: its plain version
    # from them is the IEEE plain version
    assert torch.equal(fa.split_attention(q, kv, d ** -0.5),
                       fa.flash_attention_reference(q, k, v, mask, d ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,masked", [(1, 128, True), (1, 64, False),
                                        (70, 64, True), (2049, 128, True)])
def test_split_prep_kernel_is_its_plain_version_on_card(cuda_device, t, d,
                                                        masked):
    """The 3xTF32 pre-pass kernel writes its plain version's tiles bit for
    bit: the same Veltkamp split in float32 operations rounded to nearest,
    the same layout, zero keys past T."""
    rng = np.random.default_rng(t + d + 1)
    _, k, v, mask = _inputs(rng, 3, 2, t, d, cuda_device,
                            all_masked_row=2 if masked else None)
    mask = mask if masked else None
    before = fa.SPLIT_PREP.launches, fa.ONE_PASS_PREP.launches
    got = fa.split_operands(k, v, mask)
    torch.cuda.synchronize()
    assert (fa.SPLIT_PREP.launches, fa.ONE_PASS_PREP.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(got, fa.split_operands_reference(k, v, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,masked", [(1, 128, True), (1, 64, False),
                                        (70, 64, True), (2049, 128, True)])
def test_one_pass_prep_kernel_is_its_plain_version_on_card(cuda_device, t, d,
                                                           masked):
    """The pre-pass kernel writes its plain version's tiles bit for bit:
    the same cvt.rna rounding, the same layout, zero keys past T."""
    rng = np.random.default_rng(t + d)
    _, k, v, mask = _inputs(rng, 3, 2, t, d, cuda_device,
                            all_masked_row=2 if masked else None)
    mask = mask if masked else None
    before = fa.ONE_PASS_PREP.launches
    got = fa.one_pass_operands(k, v, mask)
    torch.cuda.synchronize()
    assert fa.ONE_PASS_PREP.launches == before + 1
    assert torch.equal(got, fa.one_pass_operands_reference(k, v, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(777, 128), (2048, 128), (130, 64),
                                 # T = 1, ragged against the 128-query
                                 # blocks and 32-key tiles, both widths
                                 (1, 128), (1, 64), (63, 64), (129, 128),
                                 (3583, 128), (1000, 64)])
def test_one_pass_kernel_matches_its_plain_version_on_card(cuda_device, t, d):
    """Row 1's 1-pass TF32 mode against its plain version, which rounds
    q, k, P (tile by tile, against the running row max) and v to TF32 where
    the kernel does: both take exact products of the same TF32 values, so
    they differ by float32 sums in another order and the rare weight this
    sends to the neighbouring TF32 value; chip_smoke.py phase 3's gate
    (`one_pass_gate`: max and RMS) holds, and the kernel rounds (> 1e-5
    from IEEE)."""
    rng = np.random.default_rng(t + d)
    q, k, v, mask = _inputs(rng, 4, 2, t, d, cuda_device, all_masked_row=2)
    scale = 1.0 / math.sqrt(d)
    before = (fa.FLASH_FWD.launches, fa.FLASH_FWD.one_pass,
              fa.ONE_PASS_PREP.launches)
    got = fa.flash_attention(q, k, v, mask, scale, passes=1)
    torch.cuda.synchronize()
    assert (fa.FLASH_FWD.launches, fa.FLASH_FWD.one_pass,
            fa.ONE_PASS_PREP.launches) == tuple(n + 1 for n in before)
    with exact_numerics(True):
        want = fa.flash_attention_reference(q, k, v, mask, scale, passes=1)
        ieee = fa.flash_attention_reference(q, k, v, mask, scale)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    keep = torch.arange(4, device=cuda_device) != 2
    err, rms, from_ieee, tol, rms_tol = chip_smoke.one_pass_gate(
        got[keep], want[keep], ieee[keep], v)
    assert err <= tol and rms <= rms_tol, (err, tol, rms, rms_tol)
    assert from_ieee > 1e-5                            # it does round


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(1, 128), (64, 128), (500, 128),
                                 (768, 128), (130, 64), (2048, 128)]
                         # ragged against the 192-query blocks and 32-key
                         # tiles, at both head widths
                         + [(t, d) for d in (64, 128)
                            for t in (1, 63, 65, 127, 129, 777, 191, 193,
                                      385)])
def test_kernel_matches_plain_on_card(cuda_device, t, d):
    """Row 1's 3xTF32 mode (its pre-pass, then its kernel) against the IEEE
    float32 plain version: within 1e-5, the all-masked row exactly 0."""
    rng = np.random.default_rng(t)
    q, k, v, mask = _inputs(rng, 4, 2, t, d, cuda_device,
                            all_masked_row=2)
    scale = 1.0 / math.sqrt(d)
    before = (fa.FLASH_FWD.launches, fa.FLASH_FWD.one_pass,
              fa.SPLIT_PREP.launches)
    got = fa.flash_attention(q, k, v, mask, scale)
    torch.cuda.synchronize()
    assert (fa.FLASH_FWD.launches, fa.FLASH_FWD.one_pass,
            fa.SPLIT_PREP.launches) == (before[0] + 1, before[1],
                                        before[2] + 1)
    with exact_numerics(True):
        want = fa.flash_attention_reference(q, k, v, mask, scale)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    # 3xTF32 products and IEEE float32 softmax against IEEE float32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_kernel_without_mask_and_on_a_side_stream(cuda_device):
    rng = np.random.default_rng(1)
    q, k, v, _ = _inputs(rng, 2, 2, 300, 128, cuda_device)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        got = fa.flash_attention(q, k, v, None, 0.1)
    torch.cuda.synchronize()
    with exact_numerics(True):
        want = fa.flash_attention_reference(q, k, v, None, 0.1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# ---- row 7: the int8 conv (ops/qconv.py, csrc/int8_conv.cu) -----------------


def _qconv_inputs(rng, b, t, ci, co, k, device="cpu", bias=True):
    def tens(a):
        return torch.from_numpy(a).to(device)
    return (tens(rng.integers(-127, 128, size=(b, t, ci)).astype(np.int8)),
            tens(rng.integers(-127, 128, size=(k, co, ci)).astype(np.int8)),
            tens((rng.random((b, co)) * 1e-4 + 1e-6).astype(np.float32)),
            tens(rng.standard_normal(co).astype(np.float32)) if bias else None)


@pytest.mark.parametrize("bad", ["x_dtype", "w_dtype", "fit", "scale",
                                 "scale_layout", "bias", "layout", "pads",
                                 "empty"])
def test_int8_conv_rejects_what_the_kernel_does_not_take(rng, bad):
    xq, wq, scale, bias = _qconv_inputs(rng, 2, 16, 8, 4, 3)
    pads, dil = (1, 1), 1
    if bad == "x_dtype":
        xq = xq.to(torch.int32)
    elif bad == "w_dtype":
        wq = wq.float()
    elif bad == "fit":
        wq = wq[:, :, :4].contiguous()
    elif bad == "scale":
        scale = scale[0]
    elif bad == "scale_layout":
        scale = scale.t().contiguous().t()
    elif bad == "bias":
        bias = bias.double()
    elif bad == "layout":
        xq = xq.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "pads":
        pads = (-1, 1)
    else:
        pads, dil = (0, 0), 9
    with pytest.raises((TypeError, ValueError)):
        qconv._check(xq, wq, scale, bias, pads, dil)


@pytest.mark.parametrize("leaky", [None, 0.1])
def test_int8_conv_cpu_tensors_take_the_plain_version(rng, leaky):
    xq, wq, scale, bias = _qconv_inputs(rng, 2, 20, 12, 8, 5)
    before = qconv.INT8_CONV.launches
    got = qconv.int8_conv(xq, wq, scale, bias, pads=(4, 4), dilation=2,
                          leaky=leaky)
    want = qconv.int8_conv_reference(xq, wq, scale, bias, pads=(4, 4),
                                     dilation=2, leaky=leaky)
    assert got.shape == (2, 20, 8) and torch.equal(got, want)
    assert qconv.INT8_CONV.launches == before


def test_int8_conv_takes_a_broadcast_scale(rng):
    """A per-channel (Co,) scale expanded over the batch (stride 0) passes
    the checks and gives what the materialized (B, Co) scale gives."""
    xq, wq, scale, bias = _qconv_inputs(rng, 3, 20, 12, 8, 3)
    sw = scale[0]
    qconv._check(xq, wq, sw.expand(3, -1), bias, (1, 1), 1)
    got = qconv.int8_conv(xq, wq, sw.expand(3, -1), bias, pads=(1, 1))
    want = qconv.int8_conv(xq, wq, sw.expand(3, -1).contiguous(), bias,
                           pads=(1, 1))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("b,t,ci,co,k,dil,pads,leaky,bias", [
    (2, 1000, 64, 64, 11, 5, (25, 25), 0.1, True),   # a V1 stage-3 MRF conv
    (3, 777, 16, 16, 7, 3, (9, 9), None, True),      # narrow, ragged T
    (1, 130, 512, 1280, 3, 1, (1, 1), None, True),   # stage-1 polyphase upsample
    (2, 50, 24, 40, 4, 2, (3, 0), 0.1, False),       # Ci, Co off the tiles
    (1, 1, 8, 8, 1, 1, (0, 0), None, True),
    (1, 100, 2048, 96, 11, 1, (5, 5), 0.1, True),    # weights streamed
])
def test_int8_conv_bit_identical_to_plain_on_card(cuda_device, b, t, ci, co,
                                                  k, dil, pads, leaky, bias,
                                                  broadcast):
    rng = np.random.default_rng(t)
    xq, wq, scale, bvec = _qconv_inputs(rng, b, t, ci, co, k, cuda_device,
                                        bias)
    if broadcast:                  # the serving path's per-channel scale
        scale = scale[0].expand(b, -1)
    before = qconv.INT8_CONV.launches
    got = qconv.int8_conv(xq, wq, scale, bvec, pads=pads, dilation=dil,
                          leaky=leaky)
    torch.cuda.synchronize()
    assert qconv.INT8_CONV.launches == before + 1
    want = qconv.int8_conv_reference(xq, wq, scale, bvec, pads=pads,
                                     dilation=dil, leaky=leaky)
    assert got.shape == want.shape and torch.equal(got, want)


def test_int8_conv_bf16_cpu_tensors_take_the_plain_version(rng):
    """A bf16 output on the CPU: the plain version, rounded once and the
    leaky ReLU taken in bf16; other output types raise."""
    xq, wq, scale, bias = _qconv_inputs(rng, 2, 20, 16, 8, 3)
    got = qconv.int8_conv(xq, wq, scale, bias, pads=(1, 1), leaky=0.1,
                          out_dtype=torch.bfloat16)
    y = qconv.int8_conv_reference(xq, wq, scale, bias, pads=(1, 1))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.maximum(y.bfloat16(),
                                          y.bfloat16() * 0.10009765625))
    with pytest.raises(TypeError, match="out_dtype"):
        qconv.int8_conv(xq, wq, scale, bias, pads=(1, 1),
                        out_dtype=torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,ci,co,k,dil,pads,leaky,bias", [
    (2, 1000, 64, 64, 11, 5, (25, 25), 0.1, True),   # a V1 stage-3 MRF conv
    (3, 777, 16, 16, 7, 3, (9, 9), None, True),      # narrow, ragged T
    (1, 130, 512, 1280, 3, 1, (1, 1), None, False),  # stage-1 upsample, bf16
    (2, 50, 24, 44, 4, 2, (3, 0), 0.1, False),       # Co off the 8s: padded
    (2, 300, 32, 32, 3, 1, (1, 1), 0.1, True),       # bn 32: 64-byte rows
    (1, 100, 2048, 96, 11, 1, (5, 5), 0.1, True),    # weights streamed
])
def test_int8_conv_bf16_output_bit_identical_on_card(cuda_device, b, t, ci,
                                                     co, k, dil, pads, leaky,
                                                     bias):
    rng = np.random.default_rng(t + 1)
    xq, wq, scale, bvec = _qconv_inputs(rng, b, t, ci, co, k, cuda_device,
                                        bias)
    before = qconv.INT8_CONV.launches
    got = qconv.int8_conv(xq, wq, scale, bvec, pads=pads, dilation=dil,
                          leaky=leaky, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert qconv.INT8_CONV.launches == before + 1
    want = qconv.int8_conv_reference(xq, wq, scale, bvec, pads=pads,
                                     dilation=dil, leaky=leaky,
                                     out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ci", [16, 32, 48, 64, 128, 256])
def test_int8_conv_slab_read_from_every_row_shift(cuda_device, ci):
    """The activation slab lies in the swizzle of its chunk's rows (32, 64
    or 128 bytes; channels past Ci zero) and each tap reads it from row
    tap * dilation on, the wgmma descriptor's start moved by whole rows:
    at every dilation 1-9 (tap shifts of every residue mod 8, and past one
    swizzle atom) the kernel gives the plain version's bits, in both
    outputs."""
    rng = np.random.default_rng(ci)
    for dil in range(1, 10):
        for out_dtype in (torch.float32, torch.bfloat16):
            xq, wq, scale, bvec = _qconv_inputs(rng, 2, 301, ci, 32, 3,
                                                cuda_device)
            got = qconv.int8_conv(xq, wq, scale, bvec, pads=(dil, dil),
                                  dilation=dil, leaky=0.1,
                                  out_dtype=out_dtype)
            want = qconv.int8_conv_reference(xq, wq, scale, bvec,
                                             pads=(dil, dil), dilation=dil,
                                             leaky=0.1, out_dtype=out_dtype)
            assert torch.equal(got, want), (dil, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,ci,co,k,dil,pads,leaky", [
    (3, 1250, 256, 256, 11, 5, (25, 25), 0.1),     # a V1 stage-1 MRF conv
    (2, 1250, 256, 512, 3, 1, (1, 1), None),       # stage-2 polyphase upsample
    (2, 999, 16, 16, 7, 1, (3, 3), None),          # narrow, ragged T
])
def test_dynamic_int8_conv_on_card_equals_cpu(cuda_device, b, t, ci, co, k,
                                              dil, pads, leaky):
    """The dynamic int8 conv (per-row quantize, the kernel with the (B, Co)
    scale s_x[b]*s_w[co]) on the card gives the bits of its CPU run, which
    takes the plain version: the quantizer is exact IEEE arithmetic on
    both devices."""
    rng = np.random.default_rng(t)
    x = torch.from_numpy((rng.standard_normal((b, t, ci))
                          * rng.random((b, 1, 1)) * 3).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, ci, co)) * 0.05)
                         .astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(co).astype(np.float32))
    want = quant.int8_conv_nwc(x, w, bias, pads=pads, rhs_dilation=dil,
                               leaky=leaky)
    before = qconv.INT8_CONV.launches
    got = quant.int8_conv_nwc(x.to(cuda_device), w.to(cuda_device),
                              bias.to(cuda_device), pads=pads,
                              rhs_dilation=dil, leaky=leaky)
    torch.cuda.synchronize()
    assert qconv.INT8_CONV.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_dynamic_int8_conv_batch_invariant_on_card(cuda_device):
    """A quiet row gives the same bits alone and beside a loud row."""
    rng = np.random.default_rng(3)
    quiet = torch.from_numpy((rng.standard_normal((1, 640, 64)) * 0.01)
                             .astype(np.float32)).to(cuda_device)
    loud = torch.from_numpy((rng.standard_normal((1, 640, 64)) * 10.0)
                            .astype(np.float32)).to(cuda_device)
    w = torch.from_numpy((rng.standard_normal((3, 64, 64)) * 0.2)
                         .astype(np.float32)).to(cuda_device)
    solo = quant.int8_conv_nwc(quiet, w, None, pads=(1, 1))
    pair = quant.int8_conv_nwc(torch.cat([quiet, loud]), w, None, pads=(1, 1))
    assert torch.equal(solo[0], pair[0])


# ---- row 8: the GEMM (ops/qconv.py::matmul, csrc/int8_gemm.cu) --------------

# bf16 and float32: the kernel and the plain float32 matmul sum the same
# float32 products (bf16 products are exact in float32) in another order.
# Two orders of K float32 sums of random terms differ by about
# 2^-24 * sqrt(K) * max |sum| / 6 typically; MM_RTOL * sqrt(K) * max |plain|
# leaves a margin of ~1000 and still catches a wrong tile, row or column,
# which errs by the order of max |plain|.
MM_RTOL = 1e-5


def _mm_inputs(rng, m, k, n, dtype, device="cpu"):
    if dtype == torch.int8:
        a, b = (rng.integers(-127, 128, size=s).astype(np.int8)
                for s in ((m, k), (k, n)))
        return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in ((m, k), (k, n)))
    return (torch.from_numpy(a).to(device, dtype),
            torch.from_numpy(b).to(device, dtype))


def mm_close(got, want, k) -> None:
    """The kernel's result against the plain one: int32 equal, float within
    MM_RTOL * sqrt(K) of max |plain|."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.int32:
        assert torch.equal(got, want)
        return
    err = float((got - want).abs().max())
    assert err <= MM_RTOL * math.sqrt(k) * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (17, 33, 9), (128, 256, 128),
                                   (1000, 1000, 1000), (300, 4096, 260)])
def test_matmul_kernel_matches_plain_on_card(cuda_device, m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    a, b = _mm_inputs(rng, m, k, n, dtype, cuda_device)
    before = qconv.MATMUL.launches
    got = qconv.matmul(a, b)
    torch.cuda.synchronize()
    assert qconv.MATMUL.launches == before + 1
    mm_close(got, qconv.matmul_reference(a, b), k)


@pytest.mark.cuda
def test_matmul_kernel_takes_an_unaligned_row(cuda_device):
    """A view whose rows start off a 16-byte boundary is read bytewise."""
    rng = np.random.default_rng(5)
    a, b = _mm_inputs(rng, 64, 128, 70, torch.int8, cuda_device)
    buf = torch.empty(a.numel() + 1, dtype=torch.int8, device=cuda_device)
    a_off = buf[1:].view(64, 128)
    a_off.copy_(a)
    assert a_off.is_contiguous() and a_off.data_ptr() % 16 != 0
    got = qconv.matmul(a_off, b)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv.matmul_reference(a, b))


# ---- row 6: the fused MRF stage (ops/fused_mrf.py, csrc/fused_mrf.cu) -------

KS = (3, 7, 11)
DS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


def _mrf_inputs(rng, b, t, c, device="cpu"):
    def tens(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device)
    convs = [[(tens(k, c, c, scale=(c * k) ** -0.5), tens(c, scale=0.1),
               tens(k, c, c, scale=(c * k) ** -0.5), tens(c, scale=0.1))
              for _ in ds] for k, ds in zip(KS, DS)]
    w, bias, plan = fused_mrf.pack_mrf(convs, KS, DS)
    return tens(b, t, c), w, bias, plan


@pytest.mark.parametrize("bad", ["dtype", "channels", "shape", "layout",
                                 "weights"])
def test_fused_mrf_rejects_what_the_kernel_does_not_take(rng, bad):
    x, w, b, plan = _mrf_inputs(rng, 2, 40, 16)
    if bad == "dtype":
        x = x.double()
    elif bad == "channels":
        x, w, b, plan = _mrf_inputs(rng, 2, 40, 12)
    elif bad == "shape":
        x = x[:, :, :8].contiguous()
    elif bad == "layout":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        w = w[:-1].contiguous()
    with pytest.raises((TypeError, ValueError)):
        fused_mrf._check(x, w, b, plan)


def test_fused_mrf_cpu_tensors_take_the_plain_version(rng):
    x, w, b, plan = _mrf_inputs(rng, 2, 50, 8)
    before = fused_mrf.FUSED_MRF.launches
    got = fused_mrf.mrf_fused(x, w, b, plan)
    assert torch.equal(got, fused_mrf.mrf_fused_reference(x, w, b, plan))
    assert fused_mrf.FUSED_MRF.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c", [
    (2, 5120, 64), (3, 1013, 32), (1, 20480, 16), (2, 7, 16), (1, 300, 8),
    # V1's three stage widths at a ragged T with rows of three lengths
    (3, 2999, 64), (3, 4001, 32), (3, 6007, 16),
    # other widths the route may send; above C = 64 the sums are added in
    # float32 per group of taps
    (2, 1000, 24), (2, 700, 48), (2, 333, 96), (1, 400, 120),
    (2, 10243, 80), (2, 20483, 112)])
def test_fused_mrf_matches_plain_on_card(cuda_device, b, t, c):
    rng = np.random.default_rng(t)
    x, w, bias, plan = _mrf_inputs(rng, b, t, c, cuda_device)
    for r in range(1, b):            # shorter rows, zero past their lengths
        x[r, t * (b - r) // b:] = 0.0
    before = fused_mrf.FUSED_MRF.launches
    got = fused_mrf.mrf_fused(x, w, bias, plan)
    torch.cuda.synchronize()
    assert fused_mrf.FUSED_MRF.launches == before + 1
    with exact_numerics(True):
        want = fused_mrf.mrf_fused_reference(x, w, bias, plan)
    # IEEE float32 both; only the order of the sums differs
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c", [
    (2, 5120, 64), (3, 1013, 32), (1, 20480, 16), (2, 7, 16),
    (3, 2999, 64), (3, 4001, 32), (3, 6007, 16),
    # many waves of blocks, each ending on a ragged tile: (2, 327680, 16)
    # is a 1024-code batch's C = 16 launch
    (5, 20000, 64), (3, 100003, 32), (2, 327680, 16),
    # the other widths: resident at 8, a zero plane at odd C / 8 (8, 24,
    # 120), rings of 3 to 12 slots
    (3, 40003, 8), (2, 10007, 24), (3, 5001, 48), (2, 3001, 96),
    (2, 2003, 120)])
def test_fused_mrf_bf16_matches_plain_on_card(cuda_device, b, t, c):
    """Row 6's bf16 mode against its bf16 plain version: both round at the
    JAX kernel's points and sum in float32 in another order, so an element
    moves by an ulp now and then and the chain carries it on: max |diff|
    <= 2^-6 max |plain| (4 ulps at the top binade)."""
    rng = np.random.default_rng(t)
    x, w, bias, plan = _mrf_inputs(rng, b, t, c, cuda_device)
    for r in range(1, b):
        x[r, t * (b - r) // b:] = 0.0
    x, w, bias = x.bfloat16(), w.bfloat16(), bias.bfloat16()
    before = fused_mrf.FUSED_MRF.launches
    got = fused_mrf.mrf_fused(x, w, bias, plan)
    torch.cuda.synchronize()
    assert fused_mrf.FUSED_MRF.launches == before + 1
    with exact_numerics(True):
        want = fused_mrf.mrf_fused_reference(x, w, bias, plan)
    assert got.dtype == torch.bfloat16
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -6 * float(want.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c", [(3, 40961, 64), (2, 81923, 32),
                                   (3, 163843, 16), (2, 163841, 8),
                                   (2, 40963, 24), (2, 20483, 48),
                                   (2, 10241, 96), (2, 10243, 120)])
def test_fused_mrf_bf16_launches_are_bit_equal_on_card(cuda_device, b, t, c):
    """Row 6's bf16 mode gives the same bits twice: every block owns its
    rows and sums in a fixed order (no atomics), whatever the order in
    which the weight slabs land."""
    rng = np.random.default_rng(c)
    x, w, bias, plan = _mrf_inputs(rng, b, t, c, cuda_device)
    x, w, bias = x.bfloat16(), w.bfloat16(), bias.bfloat16()
    wk = fused_mrf.kernel_weights(w, plan)
    first = fused_mrf.mrf_fused(x, w, bias, plan, wk=wk)
    second = fused_mrf.mrf_fused(x, w, bias, plan, wk=wk)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c", [(3, 40961, 64), (2, 81923, 32),
                                   (3, 163843, 16), (2, 163841, 8),
                                   (2, 40963, 24), (2, 20483, 48),
                                   (2, 10241, 96), (2, 10243, 120)])
def test_fused_mrf_launches_are_bit_equal_on_card(cuda_device, b, t, c):
    """Row 6's float32 mode gives the same bits twice: every block owns its
    rows and sums in a fixed order (no atomics), whatever the order in
    which the weight slabs land."""
    rng = np.random.default_rng(c)
    x, w, bias, plan = _mrf_inputs(rng, b, t, c, cuda_device)
    wk = fused_mrf.kernel_weights(w, plan)
    first = fused_mrf.mrf_fused(x, w, bias, plan, wk=wk)
    second = fused_mrf.mrf_fused(x, w, bias, plan, wk=wk)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# ---- rows 2-5: flash attention with dropout (ops/flash_dropout.py,
# csrc/flash_dropout.cu) ------------------------------------------------------


def _fd_inputs(rng, b, h, t, d, device="cpu", all_padded_row=None):
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                    .astype(np.float32)).to(device)
                   for _ in range(4))
    lengths = rng.integers(1, t + 1, size=b)
    lengths[0] = t
    pad = np.arange(t)[None, :] >= lengths[:, None]
    if all_padded_row is not None:
        pad[all_padded_row] = True
    bias = fd.padding_bias(torch.from_numpy(pad), b, t, "cpu").to(device)
    return q, k, v, do, bias


@pytest.mark.parametrize("bad", ["dtype", "width", "shape", "bias", "layout",
                                 "p"])
def test_flash_dropout_rejects_what_the_kernels_do_not_take(rng, bad):
    q, k, v, _, bias = _fd_inputs(rng, 2, 2, 8, 128)
    p = 0.1
    if bad == "dtype":
        v = v.double()
    elif bad == "width":
        q, k, v = (x[..., :32].contiguous() for x in (q, k, v))
    elif bad == "shape":
        k = k[:, :, :4].contiguous()
    elif bad == "bias":
        bias = bias[:, :4].contiguous()
    elif bad == "layout":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        p = 1.0
    with pytest.raises((TypeError, ValueError)):
        fd._check(q, k, v, bias, p)


def test_flash_dropout_cpu_tensors_take_the_plain_versions(rng):
    q, k, v, do, bias = _fd_inputs(rng, 2, 2, 12, 64)
    before = (fd.FWD.launches, fd.DQ.launches, fd.DKV.launches,
              fd.KEEP_MASK.launches)
    o, lse = fd.flash_dropout_fwd(q, k, v, bias, 5, 0.1, 0.125)
    want_o, want_lse = fd.flash_attention_dropout_reference(
        q, k, v, bias, 5, 0.1, 0.125)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    ops = fd.to_bf16(q, k, v, do)
    dq, delta, bits = fd.flash_dropout_dq(q, k, v, bias, 5, o, lse, do, 0.1,
                                          0.125, operands=ops)
    dk, dv = fd.flash_dropout_dkv(q, k, v, bias, 5, delta, lse, do, 0.1,
                                  0.125, bits=bits, operands=ops)
    assert all(torch.equal(a, b) for a, b in zip(
        (dq, delta), fd.flash_dropout_dq_reference(q, k, v, bias, 5, o, lse,
                                                   do, 0.1, 0.125)))
    assert bits is None      # the plain dK/dV draws the mask from the seed
    assert all(torch.equal(a, b) for a, b in zip(
        (dk, dv), fd.flash_dropout_dkv_reference(q, k, v, bias, 5, delta,
                                                 lse, do, 0.1, 0.125)))
    assert torch.equal(fd.keep_mask(2, 2, 12, 5, 0.1, "cpu"),
                       fd.keep_mask_reference(2, 2, 12, 5, 0.1))
    assert before == (fd.FWD.launches, fd.DQ.launches, fd.DKV.launches,
                      fd.KEEP_MASK.launches)


# Kernels against plain on the same mask. Both round every product operand
# to bf16 at the same points and sum in float32, but in another order, so
# a few operands (about 1 in 10^4 P or dS values) land on the other bf16
# neighbour; each such moves the outputs of its row by at most one bf16
# ulp of one term. So the largest difference stays within 2^-8 of the
# largest value (FD_MAX), and the rms difference, which any systematic
# fault (a wrong mask element, tile or row) would raise, within 1e-4 of
# the rms value (FD_RMS); both floored at 1 for outputs near zero.
FD_MAX, FD_RMS = 2.0**-8, 1e-4


def _close(got, want, what):
    diff = (got - want).abs()
    err, lim = float(diff.max()), FD_MAX * max(1.0, float(want.abs().max()))
    assert err <= lim, f"{what}: max |diff| {err} > {lim}"
    rms = float(diff.pow(2).mean().sqrt())
    lim = FD_RMS * max(1.0, float(want.pow(2).mean().sqrt()))
    assert rms <= lim, f"{what}: rms diff {rms} > {lim}"


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("t,d", [(1, 128), (63, 128), (65, 128), (100, 128),
                                 (129, 128), (256, 128), (777, 128),
                                 (1024, 128), (2048, 128), (200, 64),
                                 (333, 64), (777, 64)])
def test_flash_dropout_kernels_match_plain_on_card(cuda_device, t, d, p):
    """At T ragged against the backward's 64-row tiles and its two-stage
    copy ring; dQ's keep bits are the plain mask's."""
    rng = np.random.default_rng(t)
    b, h, seed, scale = 3, 2, 12345 + t, 1.0 / math.sqrt(d)
    q, k, v, do, bias = _fd_inputs(rng, b, h, t, d, cuda_device,
                                   all_padded_row=1 if t > 1 else None)
    before = (fd.FWD.launches, fd.DQ.launches, fd.DKV.launches)
    ops = fd.to_bf16(q, k, v, do)
    o, lse = fd.flash_dropout_fwd(q, k, v, bias, seed, p, scale,
                                  operands=ops[:3])
    torch.cuda.synchronize()
    want_o, want_lse = fd.flash_attention_dropout_reference(
        q, k, v, bias, seed, p, scale)
    _close(o, want_o, "O")
    # lse: rows with no valid key hold -1e30 on both sides
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-5)
    # the backward of both on the plain forward's O and lse, and dK/dV of
    # both on the plain D
    dq, delta, bits = fd.flash_dropout_dq(q, k, v, bias, seed, want_o,
                                          want_lse, do, p, scale, operands=ops)
    want_dq, want_delta = fd.flash_dropout_dq_reference(
        q, k, v, bias, seed, want_o, want_lse, do, p, scale)
    args = (q, k, v, bias, seed, want_delta, want_lse, do, p, scale)
    dk, dv = fd.flash_dropout_dkv(*args, bits=bits, operands=ops)
    torch.cuda.synchronize()
    assert (fd.FWD.launches, fd.DQ.launches, fd.DKV.launches) == tuple(
        n + 1 for n in before)
    _close(dq, want_dq, "dQ")
    _close(delta, want_delta, "D")
    # the kernel's dK/dV reads dQ's bits, the plain one draws from the seed
    want_dk, want_dv = fd.flash_dropout_dkv_reference(*args)
    _close(dk, want_dk, "dK")
    _close(dv, want_dv, "dV")
    if p:
        assert torch.equal(bits, fd.pack_keep_bits(fd.keep_mask_reference(
            b, h, t, seed, p, cuda_device))), "dQ kernel's keep bits"
    else:
        assert bits is None


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,p", [(1, 1, 1, 0.1), (2, 2, 130, 0.1),
                                     (1, 3, 257, 0.5), (2, 1, 64, 0.0)])
def test_keep_mask_kernel_bit_identical_on_card(cuda_device, b, h, t, p):
    before = fd.KEEP_MASK.launches
    got = fd.keep_mask(b, h, t, 99 + t, p, cuda_device)
    torch.cuda.synchronize()
    assert fd.KEEP_MASK.launches == before + 1
    assert torch.equal(got, fd.keep_mask_reference(b, h, t, 99 + t, p,
                                                   cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_flash_dropout_autograd_runs_the_kernels_on_card(cuda_device, p):
    """One launch of each kernel; the forward casts q, k, v once and saves
    those copies, the backward casts dO alone and both backward kernels
    read the saved copies; O and the gradients against plain."""
    rng = np.random.default_rng(8)
    q, k, v, do, bias = _fd_inputs(rng, 2, 2, 333, 128, cuda_device,
                                   all_padded_row=1)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    casts = []
    real = fd.to_bf16

    def counting(*xs):
        casts.append(len(xs))
        return real(*xs)

    before = (fd.FWD.launches, fd.DQ.launches, fd.DKV.launches)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fd, "to_bf16", counting)
        o = fd.flash_attention_dropout(q, k, v, bias, 11, p, 0.1)
        saved = o.grad_fn.saved_tensors
        o.backward(do)
    torch.cuda.synchronize()
    assert casts == [3, 1]
    assert (fd.FWD.launches, fd.DQ.launches, fd.DKV.launches) == tuple(
        n + 1 for n in before)
    assert all(torch.equal(a, b) for a, b in zip(
        saved[:3], real(q.detach(), k.detach(), v.detach())))
    qkv = (q.detach(), k.detach(), v.detach(), bias, 11)
    want_o, lse = fd.flash_attention_dropout_reference(*qkv, p, 0.1)
    _close(o.detach(), want_o, "O")
    want_dq, delta = fd.flash_dropout_dq_reference(*qkv, o.detach(), lse,
                                                   do, p, 0.1)
    want_dk, want_dv = fd.flash_dropout_dkv_reference(*qkv, delta, lse, do,
                                                      p, 0.1)
    _close(q.grad, want_dq, "dQ")
    # dK/dV read the kernel's D, written by the dQ launch before them
    _close(k.grad, want_dk, "dK")
    _close(v.grad, want_dv, "dV")
