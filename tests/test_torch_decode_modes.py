"""The port's mixed-precision TTE decode modes ("selective",
"selective-high", "hybrid"; `models/tte/parrot.py`, `ops/precision.py`,
`infer/tte_infer.py`) against the JAX package's, on the CPU.

The same weights (a seeded JAX init carried across by convert.py) and
numpy batches go through both. On the CPU the JAX package computes every
mode in float32, while the port emulates the card's arithmetic: the
decoder's products are rounded to TF32 ("selective"); "selective-high" is
IEEE float32 on the card, the exact decode itself. So durations and totals
must be equal (the encoder section is IEEE float32 in both), logits within
a tolerance derived from the mode's rounding, and codes equal wherever the
JAX logits' top-2 margin exceeds twice the largest logit difference (no
argmax can flip there).
"""

import functools
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.infer.serving import ParrotTTS as JaxParrotTTS
from parrot_tts_tpu.infer.tte_infer import decode_buckets as jax_decode_buckets
from parrot_tts_tpu.models.tte import parrot as jax_parrot
from parrot_tts_tpu_torch.infer.serving import ParrotTTS
from parrot_tts_tpu_torch.infer.tte_infer import decode_buckets
from parrot_tts_tpu_torch.models.tte import parrot
from parrot_tts_tpu_torch.ops import flash_attention as fa
from parrot_tts_tpu_torch.ops import precision as prec
from tests.test_torch_tf32_split import (_inputs, attention_3xtf32,
                                         mm_1xtf32, tf32_nearest)
from tests.test_torch_tte import (CFG, configs, jax_params, make_batch,
                                  port_model)

# logits against JAX's float32 (|l| <= ~4.1 at this config): IEEE float32
# in another order (the exact decode reads ~1.2e-6 here), so 1e-5; 1-pass
# TF32 rounds each operand by <= 2^-11, so each product moves by <= 2^-10
# relative: 2^-10 of the logits' scale, 4e-3 (it reads ~3.3e-4)
LOGIT_ATOL = {"selective-high": 1e-5, "selective": 4e-3}
JAX_MODE = {"selective": True, "selective-high": "high"}
OUT_LEN = 128


@functools.lru_cache(maxsize=None)
def jax_fns():
    infer = jax.jit(jax_parrot.infer_codes,
                    static_argnames=("cfg", "out_len", "exact",
                                     "with_margin"))
    logits = jax.jit(jax_parrot.apply_parrot,
                     static_argnames=("cfg", "out_len", "inference",
                                      "selective_exact"))
    return infer, logits


def _batch():
    rng = np.random.default_rng(12)
    return make_batch(rng, [14, 9, 3, 11], 16, CFG["vocab_size"],
                      CFG["n_speaker"])


@pytest.mark.parametrize("mode", ["selective", "selective-high"])
def test_selective_modes_match_jax(mode):
    jcfg, tcfg = configs()
    params = jax_params(jcfg)
    model = port_model(params, tcfg)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    infer, apply = jax_fns()
    j_codes, j_mask, j_total, j_margin = (np.asarray(x) for x in infer(
        params, jbatch, cfg=jcfg, out_len=OUT_LEN, exact=mode,
        with_margin=True))
    j_logits = np.asarray(apply(params, jbatch, cfg=jcfg, out_len=OUT_LEN,
                                inference=True,
                                selective_exact=JAX_MODE[mode])[0])

    codes, mask, total, margin = (x.numpy() for x in parrot.infer_codes(
        model, batch, out_len=OUT_LEN, exact=mode, with_margin=True,
        device="cpu"))
    tb = parrot.to_batch(batch, torch.device("cpu"))
    with torch.no_grad():
        logits = parrot.apply_parrot(model, tb, out_len=OUT_LEN,
                                     exact=mode)[0].numpy()
    three = parrot.infer_codes(model, batch, out_len=OUT_LEN, exact=mode,
                               device="cpu")
    assert len(three) == 3 and np.array_equal(three[0].numpy(), codes)
    with torch.no_grad():
        exact = parrot.apply_parrot(model, tb, out_len=OUT_LEN)[0].numpy()
    assert np.array_equal(logits, exact) == (mode == "selective-high")

    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_array_equal(total, j_total)
    assert j_mask.sum() > 20                     # the decode is not empty
    dlogit = float(np.abs(logits - j_logits)[j_mask].max())
    assert dlogit <= LOGIT_ATOL[mode], dlogit
    top2 = np.sort(j_logits, axis=-1)[..., -2:]
    clear = j_mask & (top2[..., 1] - top2[..., 0] > 2 * dlogit)
    assert clear.sum() > 0.5 * j_mask.sum()
    np.testing.assert_array_equal(codes[clear], j_codes[clear])
    np.testing.assert_allclose(margin, j_margin, atol=2 * dlogit, rtol=0)


def test_code_margin_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 9, 7)).astype(np.float32)
    logits[1, 3, 2] = logits[1, 3].max() + 1.0        # a clear frame
    logits[2, 5, :2] = 9.0                            # an exact tie
    mask = rng.random((4, 9)) < 0.7
    mask[2, 5] = True
    mask[3] = False                                   # no valid frame: inf
    want = np.asarray(jax_parrot._code_margin(jnp.asarray(logits),
                                              jnp.asarray(mask)))
    got = parrot.code_margin(torch.from_numpy(logits),
                             torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2] == 0.0 and np.isinf(got[3])


@pytest.mark.parametrize("threshold", [float("inf"), 0.0])
def test_hybrid_decode_matches_jax(threshold):
    """threshold inf flags every sample (all re-decoded in
    "selective-high"), 0.0 none (all keep the "selective" units): the
    bookkeeping of tests/test_infer.py's hybrid test, against the JAX
    package's hybrid decode on the same weights."""
    jcfg, tcfg = configs()
    params = jax_params(jcfg)
    model = port_model(params, tcfg)
    batch = _batch()
    samples = [(batch["phones"][i][batch["src_mask"][i]],
                int(batch["speaker"][i])) for i in range(4)]
    plan = [(16, OUT_LEN, [0, 1, 2, 3])]
    infer, _ = jax_fns()
    want = jax_decode_buckets(infer, params, jcfg, samples, plan,
                              batch_size=4, exact="hybrid",
                              margin_threshold=threshold)
    stats = {}
    got = decode_buckets(model, samples, plan, batch_size=4, exact="hybrid",
                         margin_threshold=threshold, device="cpu",
                         stats=stats)
    flagged = 4 if threshold == float("inf") else 0
    assert stats == {"decode_batches": 1 + (flagged > 0),
                     "hybrid_flagged": flagged}
    taken = "selective-high" if flagged else "selective"
    alone = decode_buckets(model, samples, plan, batch_size=4, exact=taken,
                           device="cpu")
    for g, a, w in zip(got, alone, want):
        np.testing.assert_array_equal(g, a)
        assert len(g) == len(w) > 0                  # durations exact
    # codes against JAX off the frames test_selective_modes_match_jax
    # allows to differ
    codes = np.concatenate(got)
    agree = float(np.mean(codes == np.concatenate(want)))
    assert agree == 1.0 if taken == "selective-high" else agree >= 0.95


@pytest.mark.parametrize("op", ["linear", "conv1d"])
def test_precision_ops_against_ieee(op):
    """The CPU emulation of the card's products: "tf32" within the 1-pass
    bound, each product moved by <= 2^-10 of |x| |w| (both operands
    rounded by <= 2^-11), plus float32 sums; "ieee" is F.linear / F.conv1d
    itself; no other mode is taken."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 41, 48)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    if op == "linear":
        w = torch.from_numpy(rng.standard_normal((24, 48)).astype(np.float32))
        run = lambda x, w, b, m: prec.linear(x, w, b, m)  # noqa: E731
        plain = lambda x, w, b: torch.nn.functional.linear(x, w, b)  # noqa
    else:
        w = torch.from_numpy(rng.standard_normal((24, 48, 9))
                             .astype(np.float32))
        run = lambda x, w, b, m: prec.conv1d(x, w, b, m, padding=4)  # noqa
        plain = lambda x, w, b: torch.nn.functional.conv1d(  # noqa: E731
            x.transpose(1, 2), w, b, padding=4).transpose(1, 2)
    ieee = plain(x, w, b)
    assert torch.equal(run(x, w, b, "ieee"), ieee)
    assert torch.equal(run(x, w, b, None), ieee)
    scale = float(ieee.abs().max())
    exact = plain(x.double(), w.double(), b.double())
    bound = 2.0**-10 * plain(x.abs().double(), w.abs().double(), None)
    one = run(x, w, b, "tf32").double()
    assert bool(((one - exact).abs() <= bound + 1e-6 * scale).all())
    assert float((one - exact).abs().max()) > 10 * float(
        (ieee.double() - exact).abs().max())       # it does round
    for mode in ("high", "3xtf32"):
        with pytest.raises(ValueError):
            run(x, w, b, mode)


def test_round_tf32_is_round_to_nearest_ties_away():
    """ops/precision.py's own rounding (the card's cvt.rna): the bit
    rounding of tests/test_torch_tf32_split.py (ties to even) but at exact
    ties, which go away from zero; within 2^-11 of x."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(4096)
                         .astype(np.float32) * 3.0)
    ties = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11),
                         1.0 + 3 * 2.0**-11, 0.0])
    assert prec.round_tf32(ties).tolist() == [
        1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0 + 2.0**-9, 0.0]
    x[:4] = ties
    off_tie = (x.view(torch.int32) & 0x1FFF) != 0x1000
    assert torch.equal(prec.round_tf32(x)[off_tie], tf32_nearest(x)[off_tie])
    assert bool(((prec.round_tf32(x) - x).abs() <= 2.0**-11 * x.abs()).all())


def test_parrot_tts_defaults_to_selective_high():
    for cls in (ParrotTTS, JaxParrotTTS):
        default = inspect.signature(cls).parameters["exact"].default
        assert default == "selective-high", cls


@pytest.mark.parametrize("b,h,t,d", [(2, 2, 37, 64), (3, 2, 130, 128)])
def test_one_pass_plain_version_is_the_tf32_emulation(b, h, t, d):
    """Row 1's 1-pass plain version (q, k, P, v rounded to TF32, exact
    products) against tests/test_torch_tf32_split.py's model of the kernel
    with one TF32 product (the same roundings, sums in 32-wide partials).
    The scores differ by float32's reordering, which can send a weight to
    the neighbouring TF32 value (<= 2^-10 of it), so the outputs agree to
    2^-10 max |v|; off the IEEE version by more than the 3xTF32 mode's
    1e-5, and by less than 1e-2 (the scores' rounding at |s| <~ 4)."""
    q, k, v, mask = _inputs(t + d + 1, b, h, t, d)
    scale = d ** -0.5
    got = fa.flash_attention(q, k, v, mask, scale, passes=1)
    model = attention_3xtf32(q, k, v, mask, scale, mm_1xtf32)
    assert float((got - model).abs().max()) <= 2.0**-10 * float(
        v.abs().max())
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))
    ieee = fa.flash_attention_reference(q, k, v, mask, scale)
    err = float((got - ieee).abs().max())
    assert 1e-5 < err < 1e-2, err


def test_default_serve_decodes_selective_high_beside_the_exact_vocoder():
    """ParrotTTS() decodes in "selective-high" and records it; its vocoder
    runs as exact=True's, so the exact serve's vocoder given the default
    serve's units gives its waveforms bit for bit."""
    from tests.test_torch_serving import (SPEAKERS, TEXTS, jax_weights,
                                          port_tts)

    _, tte, _, voc = jax_weights()
    tts = port_tts(tte, voc)
    wavs = tts.tts(TEXTS, speakers=SPEAKERS)
    assert tts.last_stats["exact"] == "selective-high"
    assert tts.vocoder.exact is True
    units = tts.predict_units([tts.tokenize(t) for t in TEXTS], SPEAKERS)
    exact = port_tts(tte, voc, exact=True)
    for got, want in zip(exact.vocoder.synthesize(units, SPEAKERS), wavs):
        np.testing.assert_array_equal(got, want)
    hybrid = port_tts(tte, voc, exact="hybrid")
    hybrid.tts(TEXTS, speakers=SPEAKERS)
    assert hybrid.last_stats["hybrid_flagged"] <= len(TEXTS)
    with pytest.raises(ValueError, match="not a decode mode"):
        port_tts(tte, voc, exact="high")
