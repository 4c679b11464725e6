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

from parrot_tts_tpu_torch.core.device import exact_numerics
from parrot_tts_tpu_torch.ops import flash_attention as fa
from parrot_tts_tpu_torch.ops import flash_dropout as fd
from parrot_tts_tpu_torch.ops import fused_mrf, qconv, quant


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


@pytest.mark.parametrize("bad", ["dtype", "width", "shape", "mask", "layout"])
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
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        fa._check(q, k, v, mask)


def test_cpu_tensors_take_the_plain_version(rng):
    q, k, v, mask = _inputs(rng, 2, 2, 8, 16)
    before = fa.FLASH_FWD.launches
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, mask, 0.25),
        fa.flash_attention_reference(q, k, v, mask, 0.25), rtol=0, atol=0)
    assert fa.FLASH_FWD.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(1, 128), (64, 128), (500, 128),
                                 (768, 128), (130, 64), (2048, 128)])
def test_kernel_matches_plain_on_card(cuda_device, t, d):
    rng = np.random.default_rng(t)
    q, k, v, mask = _inputs(rng, 4, 2, t, d, cuda_device,
                            all_masked_row=2)
    scale = 1.0 / math.sqrt(d)
    before = fa.FLASH_FWD.launches
    got = fa.flash_attention(q, k, v, mask, scale)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD.launches == before + 1
    with exact_numerics(True):
        want = fa.flash_attention_reference(q, k, v, mask, scale)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    # IEEE float32 both; only the order of the sums differs
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
@pytest.mark.parametrize("b,t,c", [(2, 5120, 64), (3, 1013, 32),
                                   (1, 20480, 16), (2, 7, 16), (1, 300, 8)])
def test_fused_mrf_matches_plain_on_card(cuda_device, b, t, c):
    rng = np.random.default_rng(t)
    x, w, bias, plan = _mrf_inputs(rng, b, t, c, cuda_device)
    if b > 1:
        x[1, t // 2:] = 0.0          # a shorter row, zero past its length
    before = fused_mrf.FUSED_MRF.launches
    got = fused_mrf.mrf_fused(x, w, bias, plan)
    torch.cuda.synchronize()
    assert fused_mrf.FUSED_MRF.launches == before + 1
    with exact_numerics(True):
        want = fused_mrf.mrf_fused_reference(x, w, bias, plan)
    # IEEE float32 both; only the order of the sums differs
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


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
    o, lse = fd.flash_dropout_fwd(q, k, v, bias, seed, p, scale)
    torch.cuda.synchronize()
    want_o, want_lse = fd.flash_attention_dropout_reference(
        q, k, v, bias, seed, p, scale)
    _close(o, want_o, "O")
    # lse: rows with no valid key hold -1e30 on both sides
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-5)
    # the backward of both on the plain forward's O and lse, and dK/dV of
    # both on the plain D
    ops = fd.to_bf16(q, k, v, do)
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
def test_flash_dropout_autograd_runs_the_kernels_on_card(cuda_device):
    rng = np.random.default_rng(7)
    q, k, v, do, bias = _fd_inputs(rng, 2, 2, 200, 128, cuda_device)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = (fd.FWD.launches, fd.DQ.launches, fd.DKV.launches)
    o = fd.flash_attention_dropout(q, k, v, bias, 3, 0.1, 0.1)
    o.backward(do)
    torch.cuda.synchronize()
    assert (fd.FWD.launches, fd.DQ.launches, fd.DKV.launches) == tuple(
        n + 1 for n in before)
    qkv = (q.detach(), k.detach(), v.detach(), bias, 3)
    lse = fd.flash_attention_dropout_reference(*qkv, 0.1, 0.1)[1]
    want_dq, delta = fd.flash_dropout_dq_reference(*qkv, o.detach(), lse, do,
                                                   0.1, 0.1)
    want_dk, want_dv = fd.flash_dropout_dkv_reference(*qkv, delta, lse, do,
                                                      0.1, 0.1)
    _close(q.grad, want_dq, "dQ")
    # dK/dV read the kernel's D, written by the dQ launch before them
    _close(k.grad, want_dk, "dK")
    _close(v.grad, want_dv, "dV")
