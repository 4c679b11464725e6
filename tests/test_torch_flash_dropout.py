"""The port's flash attention with dropout (parrot_tts_tpu_torch.ops.
flash_dropout): its plain versions against the JAX package's Pallas kernels
(interpret mode, dropout_p = 0, as tests/test_flash_dropout.py runs them),
its backward formulas against autograd under dropout, and its Philox keep
mask against known answers and its own properties. The CUDA kernels are
held to these plain versions on the card (tests/test_torch_kernels.py,
chip_smoke.py phase 10)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parrot_tts_tpu.ops import flash_dropout as jfd
from parrot_tts_tpu_torch.ops import flash_dropout as fd

B, H, T, D = 2, 2, 256, 128
SCALE = 1.0 / math.sqrt(D)


def _t(x):
    return torch.from_numpy(np.array(x))


def _check(got, want, max_rel, rms_rel, what):
    """max |diff| <= max_rel * max|want|; rms diff <= rms_rel * rms(want)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    assert diff.max() <= max_rel * np.abs(want).max(), (what, diff.max())
    rms, rms_want = np.sqrt((diff**2).mean()), np.sqrt((want**2).mean())
    assert rms <= rms_rel * rms_want, (what, rms, rms_want)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((B, H, T, D)).astype(np.float32)
                   for _ in range(4))
    kpm = np.zeros((B, T), bool)
    kpm[0, 200:] = True
    kpm[1, 100:] = True
    bias = np.where(kpm, jfd.NEG_BIAS, 0.0).astype(np.float32)
    return q, k, v, do, bias


@pytest.fixture(scope="module")
def jax_forward(inputs):
    q, k, v, _, bias = inputs
    o, lse = jfd._forward(*(jnp.asarray(x) for x in (q, k, v, bias)),
                          jnp.array([7], jnp.int32), 0.0, SCALE, 128, 128)
    return np.asarray(o), np.asarray(lse)


# Plain against the JAX kernels at p = 0. Both round every product operand
# to bf16 and sum in float32, but the JAX forward rounds P against the
# running row max of each 128-key block, the plain version against the
# final one, so O differs by bf16 rounding of P (2^-9 relative per
# operand): max within 2^-8 of max|O|, rms within 2e-3 of rms(O). lse is
# float32 arithmetic on both sides (1e-6 relative). The backward takes the
# same P = exp(S - lse) on both sides and differs only where the order of
# float32 sums flips an operand's bf16 rounding: max within 2^-8, rms
# within 1e-4.
def test_plain_forward_matches_jax_interpret(inputs, jax_forward):
    q, k, v, _, bias = inputs
    o, lse = fd.flash_attention_dropout_reference(
        _t(q), _t(k), _t(v), _t(bias), 7, 0.0, SCALE)
    o_j, lse_j = jax_forward
    _check(o, o_j, 2.0**-8, 2e-3, "O")
    np.testing.assert_allclose(lse.numpy(), lse_j[..., 0], rtol=1e-6, atol=0)


def test_plain_backward_matches_jax_interpret(inputs, jax_forward):
    q, k, v, do, bias = inputs
    o_j, lse_j = jax_forward
    dq_j, dk_j, dv_j = jfd._backward(
        *(jnp.asarray(x) for x in (q, k, v, bias)), jnp.array([7], jnp.int32),
        jnp.asarray(o_j), jnp.asarray(lse_j), jnp.asarray(do), 0.0, SCALE,
        128, 128)
    qkv = (_t(q), _t(k), _t(v), _t(bias), 7)
    rest = (_t(lse_j[..., 0]), _t(do), 0.0, SCALE)
    dq, delta = fd.flash_dropout_dq_reference(*qkv, _t(o_j), *rest)
    dk, dv = fd.flash_dropout_dkv_reference(*qkv, delta, *rest)
    for what, got, want in (("dQ", dq, dq_j), ("dK", dk, dk_j),
                            ("dV", dv, dv_j)):
        _check(got, want, 2.0**-8, 1e-4, what)


def test_backward_formulas_match_autograd_under_dropout(inputs):
    """At p = 0.1 the written-out dQ/dK/dV (D = rowsum(dO . O) standing in
    for rowsum(P . dPd)) against float64 autograd of the same attention on
    the same mask. The plain versions round operands to bf16 (2^-9 relative
    each): max within 2e-2 of max|grad|, rms within 1e-2 of rms(grad). A
    wrong D would be off by order 1."""
    q, k, v, do, bias = inputs
    p, seed = 0.1, 11
    keep = fd.keep_mask_reference(B, H, T, seed, p).bool()

    def attention(q, k, v):
        s = q @ k.transpose(-1, -2) * SCALE + _t(bias).double()[:, None,
                                                                 None, :]
        return (torch.where(keep, torch.softmax(s, -1), 0.0) / (1 - p)) @ v

    q64, k64, v64 = (_t(x).double().requires_grad_() for x in (q, k, v))
    o64 = attention(q64, k64, v64)
    o64.backward(_t(do).double())

    o, lse = fd.flash_attention_dropout_reference(
        _t(q), _t(k), _t(v), _t(bias), seed, p, SCALE)
    _check(o, o64.detach(), 2e-2, 1e-2, "O")
    qkv = (_t(q), _t(k), _t(v), _t(bias), seed)
    dq, delta = fd.flash_dropout_dq_reference(*qkv, o, lse, _t(do), p, SCALE)
    dk, dv = fd.flash_dropout_dkv_reference(*qkv, delta, lse, _t(do), p,
                                            SCALE)
    for what, got, want in (("dQ", dq, q64.grad), ("dK", dk, k64.grad),
                            ("dV", dv, v64.grad)):
        _check(got, want, 2e-2, 1e-2, what)


def test_autograd_function_gives_the_plain_gradients(inputs):
    """On CPU tensors `flash_attention_dropout`'s backward is the plain
    formulas, bit for bit, and bias gets no gradient."""
    q, k, v, do, bias = inputs
    qt, kt, vt = (_t(x).clone().requires_grad_() for x in (q, k, v))
    o = fd.flash_attention_dropout(qt, kt, vt, _t(bias), 5, 0.1, SCALE)
    o.backward(_t(do))
    o_ref, lse = fd.flash_attention_dropout_reference(
        _t(q), _t(k), _t(v), _t(bias), 5, 0.1, SCALE)
    assert torch.equal(o.detach(), o_ref)
    qkv = (_t(q), _t(k), _t(v), _t(bias), 5)
    rest = (lse, _t(do), 0.1, SCALE)
    dq, delta = fd.flash_dropout_dq_reference(*qkv, o_ref, *rest)
    assert torch.equal(qt.grad, dq)
    dk, dv = fd.flash_dropout_dkv_reference(*qkv, delta, *rest)
    assert torch.equal(kt.grad, dk) and torch.equal(vt.grad, dv)


@pytest.mark.parametrize("key,counter,want", [
    (0, (0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    (0x0123456789ABCDEF, (0, 0, 5, 0),
     (0xB341ED12, 0x7899C9CC, 0x8D35F144, 0x68EBA6FB)),
])
def test_philox_known_answers(key, counter, want):
    """torch's own at::Philox4_32 (key = seed (lo, hi), counter (0, 0,
    subsequence, 0)) gives these words."""
    got = fd.philox4x32(key, *(torch.tensor(c) for c in counter))
    assert tuple(int(w) for w in got) == want


def test_threshold_is_the_jax_packages():
    for p in (0.0, 0.1, 0.5, 0.999, 1.0):
        assert fd.threshold(p) == jfd._threshold(p)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_within_five_sigma(p):
    mask = fd.keep_mask_reference(2, 3, 300, 2024, p)
    n = mask.numel()
    rate = float(mask.double().mean())
    assert abs(rate - (1 - p)) <= 5 * math.sqrt(p * (1 - p) / n), rate


def test_sub_block_equals_the_slice_of_the_full_mask():
    """The mask is a function of (seed, bh, i, j) alone: a tile drawn on
    its own, element by element from the definition (word j % 4 of the
    block at counter (j // 4, i, bh, 0)), equals that tile of the whole
    (a ragged one, T = 203)."""
    full = fd.keep_mask_reference(2, 2, 203, 77, 0.1)
    bh, i, j = torch.broadcast_tensors(torch.arange(1, 4)[:, None, None],
                                       torch.arange(64, 128)[None, :, None],
                                       torch.arange(150, 203)[None, None, :])
    words = torch.stack(fd.philox4x32(77, j // 4, i, bh, 0), dim=-1)
    word = torch.gather(words, -1, (j % 4)[..., None])[..., 0]
    tile = (word >= fd.threshold(0.1)).to(torch.int32)
    assert torch.equal(tile, full.reshape(4, 203, 203)[1:4, 64:128, 150:203])


def test_seeds_and_heads_give_different_masks():
    a = fd.keep_mask_reference(1, 2, 128, 1, 0.1)
    b = fd.keep_mask_reference(1, 2, 128, 2, 0.1)
    assert not torch.equal(a, b)
    assert not torch.equal(a[0, 0], a[0, 1])
    assert torch.equal(a, fd.keep_mask_reference(1, 2, 128, 1, 0.1))
    assert fd.keep_mask_reference(1, 1, 64, 3, 0.0).all()
