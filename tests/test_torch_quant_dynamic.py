"""The port's dynamic int8 vocoder modes ("int8", "int8-tail": ops/quant.py's
per-row quantizer and dynamic conv, conv1d / conv_transpose1d(quant=True),
the generator's int8 sites and the synthesizer) against the JAX package on
the CPU.

The port has no folded tail. Its "int8" is held to JAX with
fold_tail=False, its "int8-tail" to JAX with fold_tail=True (the default
the mode's site set is defined by): every packed column of a folded conv
holds each tap of its unfolded channel once, and zeros otherwise, so the
per-column weight scales, the per-row activation scales and the int32 sums
are the same numbers in both layouts. The int8 values are exact; the float
convs around the int8 sites sum in another order, and a float32
difference before a quantizer can move one rounding to its neighbour,
hence rtol 1e-6 per op and atol 1e-4 on the waveform (in [-1, 1]).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.core.config import VocoderModelConfig as JaxVocoderConfig
from parrot_tts_tpu.models.vocoder import generator as jax_gen
from parrot_tts_tpu.ops import conv as jax_conv
from parrot_tts_tpu.ops import quant as jax_quant
from parrot_tts_tpu_torch.convert import generator_state_from_jax
from parrot_tts_tpu_torch.core.config import VocoderModelConfig
from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer
from parrot_tts_tpu_torch.models.vocoder import generator as gen
from parrot_tts_tpu_torch.ops import conv as conv_ops
from parrot_tts_tpu_torch.ops import fused_mrf, quant

# the JAX package's test config (tests/test_quant.py): stages of 64/32/16
TINY = dict(
    upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4),
    upsample_initial_channel=128, resblock_kernel_sizes=(3, 7),
    resblock_dilation_sizes=((1, 3), (1, 3)), num_embeddings=40,
    embedding_dim=16, model_in_dim=32, multispkr="_", num_speakers=4)
# a first stage of stride 5: an odd code length leaves it unfolded in JAX
ODD = dict(TINY, upsample_rates=(5, 4, 2), upsample_kernel_sizes=(11, 8, 4))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("kind", ["per_row", "per_row_zero_row",
                                  "per_tensor", "per_tensor_zeros"])
def test_dynamic_quantizers_match_jax(rng, kind):
    x = (rng.standard_normal((3, 20, 6)) * [[[0.01]], [[1.0]], [[30.0]]]
         ).astype(np.float32)
    x[1, 0, 0] = np.abs(x[1]).max() / 127 * 2.5          # a .5 tie
    if kind.endswith("zero_row"):
        x[0] = 0.0
    if kind.endswith("zeros"):
        x[:] = 0.0
    fn, jfn = ((quant.quantize_per_row, jax_quant.quantize_per_row)
               if kind.startswith("per_row") else
               (quant.quantize_per_tensor, jax_quant.quantize_per_tensor))
    q, s = fn(torch.from_numpy(x))
    jq, js = jfn(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == np.shape(js)
    np.testing.assert_array_equal(q.numpy(), _np(jq))
    np.testing.assert_array_equal(s.numpy(), _np(js))
    assert bool((s > 0).all())


@pytest.mark.parametrize("k,d,pads,ci,co,leaky", [
    (3, 1, (1, 1), 16, 16, None),
    (11, 5, (25, 25), 24, 12, 0.1),     # a dilated conv, its leaky fused
    (7, 3, (9, 9), 8, 20, 0.1),
    (3, 1, (1, 1), 32, 64, None),       # a polyphase upsample's pads and
    (2, 1, (1, 0), 16, 40, None),       # asymmetric ones
])
def test_int8_conv_nwc_matches_jax(rng, k, d, pads, ci, co, leaky):
    x = (rng.standard_normal((2, 37, ci)) * [[[0.1]], [[3.0]]]
         ).astype(np.float32)
    w = (rng.standard_normal((k, ci, co)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(co) * 0.1).astype(np.float32)
    got = quant.int8_conv_nwc(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), pads=pads,
                              rhs_dilation=d, leaky=leaky).numpy()
    want = jax_quant.int8_conv_nwc(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), pads=pads, rhs_dilation=d)
    if leaky is not None:
        want = jax.nn.leaky_relu(want, leaky)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, _np(want), rtol=1e-6, atol=0)


def test_int8_conv_nwc_is_batch_invariant(rng):
    """tests/test_quant.py::test_int8_conv_batch_invariance, bit for bit."""
    quiet = torch.from_numpy((rng.standard_normal((1, 32, 16)) * 0.01)
                             .astype(np.float32))
    loud = torch.from_numpy((rng.standard_normal((1, 32, 16)) * 10.0)
                            .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 16, 16)) * 0.2)
                         .astype(np.float32))
    solo = quant.int8_conv_nwc(quiet, w, None, pads=(1, 1))
    pair = quant.int8_conv_nwc(torch.cat([quiet, loud]), w, None, pads=(1, 1))
    assert torch.equal(solo[0], pair[0])


@pytest.mark.parametrize("u,k", [(5, 11), (4, 8), (2, 4)])
def test_conv_transpose1d_quant_matches_jax(rng, u, k):
    cin, cout, pad = 24, 12, (k - u) // 2
    x = (rng.standard_normal((2, 15, cin))).astype(np.float32)
    w = (rng.standard_normal((k, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    want = jax_conv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), stride=u, padding=pad,
                                     quant=True)
    got = conv_ops.conv_transpose1d(
        torch.from_numpy(x), torch.from_numpy(np.transpose(w, (1, 2, 0))),
        torch.from_numpy(b), stride=u, padding=pad, quant=True).numpy()
    assert got.shape == want.shape == (2, 15 * u, cout)
    np.testing.assert_allclose(got, _np(want), rtol=1e-6, atol=1e-7)


def test_conv_transpose1d_quant_without_polyphase_form_runs_float(rng):
    """K - 2*padding != stride: a one-time warning, then the float conv,
    as the JAX package does."""
    x = torch.from_numpy(rng.standard_normal((1, 9, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 4, 7)).astype(np.float32))
    conv_ops._WARNED_QUANT_FALLBACK.discard((7, 3, 1))
    with pytest.warns(UserWarning, match="polyphase"):
        got = conv_ops.conv_transpose1d(x, w, None, stride=3, padding=1,
                                        quant=True)
    assert torch.equal(got, conv_ops.conv_transpose1d(x, w, None, stride=3,
                                                      padding=1))


def _build(cfg: dict, resblock: str, mode: str, fold_tail: bool,
           fused_mrf_: bool = False, seed: int = 0):
    """JAX params and the port's CodeGenerator on the same (folded)
    kernels: the port loads JAX's weight-norm-folded kernels themselves,
    since a last-bit difference in the fold could move a weight across an
    int8 rounding boundary."""
    jcfg = JaxVocoderConfig(**cfg, resblock=resblock, quant=mode,
                            fold_tail=fold_tail, fused_mrf=fused_mrf_)
    tcfg = VocoderModelConfig(**cfg, resblock=resblock, quant=mode,
                              fused_mrf=fused_mrf_)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_gen.init_code_generator, static_argnums=1)(jax.random.key(seed),
                                                       jcfg))
    folded = jax_gen.fold_params(jax.tree_util.tree_map(jnp.asarray, params))
    port = gen.fold_params(generator_state_from_jax(params, tcfg))

    def put(name, w, layout):
        port[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(np.asarray(w), layout)))

    put("conv_pre", folded["conv_pre"]["w"], (2, 1, 0))
    put("conv_post", folded["conv_post"]["w"], (2, 1, 0))
    for i, up in enumerate(folded["ups"]):
        put(f"ups.{i}", up["w"], (1, 2, 0))
    for i, rb in enumerate(folded["resblocks"]):
        for name in ("convs1", "convs2", "convs"):
            for j, c in enumerate(rb.get(name, ())):
                put(f"resblocks.{i}.{name}.{j}", c["w"], (2, 1, 0))
    model = gen.CodeGenerator(tcfg, weight_norm=False)
    model.load_state_dict(port, strict=True)
    model.eval().pack_fused_mrf()
    model.pack_int8()
    return jcfg, folded, model


def _serve_both(monkeypatch, jcfg, folded, model, code, spkr):
    """Both generators on the same codes, counting each one's int8 convs."""
    counts = {"jax": 0, "port": 0}
    real_j, real_p = jax_quant.int8_conv_nwc, quant.int8_conv_nwc_qweight

    def spy_j(*a, **kw):
        counts["jax"] += 1
        return real_j(*a, **kw)

    def spy_p(*a, **kw):
        counts["port"] += 1
        return real_p(*a, **kw)

    monkeypatch.setattr(jax_quant, "int8_conv_nwc", spy_j)
    monkeypatch.setattr(quant, "int8_conv_nwc_qweight", spy_p)
    want = _np(jax_gen.apply_code_generator(folded, jnp.asarray(code),
                                            jnp.asarray(spkr), jcfg))
    got = gen.apply_code_generator(model, code, spkr, device="cpu").numpy()
    monkeypatch.undo()
    return got, want, counts


def _codes(rng, t):
    return (rng.integers(0, 40, size=(2, t)).astype(np.int32),
            rng.integers(0, 4, size=(2,)).astype(np.int32))


@pytest.mark.parametrize("mode,fold_tail", [("int8", False),
                                            ("int8-tail", True)])
@pytest.mark.parametrize("resblock", ["1", "2"])
def test_generator_dynamic_modes_match_jax(rng, monkeypatch, mode, fold_tail,
                                           resblock):
    jcfg, folded, model = _build(TINY, resblock, mode, fold_tail)
    code, spkr = _codes(rng, 24)
    got, want, counts = _serve_both(monkeypatch, jcfg, folded, model, code,
                                    spkr)
    assert got.shape == want.shape == (2, 24 * 32, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # per stage an upsample and 2 ResBlocks of 2 pairs (ResBlock1: 2 convs
    # a pair); "int8-tail" leaves the first upsample float: every stage is
    # below 128 channels and folds right after it
    per_stage = 2 * 2 * (2 if resblock == "1" else 1)
    assert counts["port"] == counts["jax"] == 3 * (1 + per_stage) - (
        mode == "int8-tail")


@pytest.mark.parametrize("t,sites", [(7, 2 * 8 + 1), (8, 3 * 8 + 2)])
def test_int8_tail_follows_jax_fold_bookkeeping(rng, monkeypatch, t, sites):
    """A first stage of stride 5 and 64 channels folds by 2 only when 5*t
    is even. At odd t JAX leaves it unfolded and float, folds the next
    stage by 4, and quantizes from there on; the port quantizes the same
    sites."""
    jcfg, folded, model = _build(ODD, "1", "int8-tail", True)
    code, spkr = _codes(rng, t)
    got, want, counts = _serve_both(monkeypatch, jcfg, folded, model, code,
                                    spkr)
    assert gen.quant_plan(model.cfg, t)[0] == (False, t % 2 == 0)
    assert counts["port"] == counts["jax"] == sites
    assert got.shape == want.shape == (2, t * 40, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fused_mrf_with_int8_tail_fuses_nothing(rng, monkeypatch):
    """int8 supersedes the fused MRF: with every stage quantized, no stage
    is packed or launched, and the output is JAX's."""
    jcfg, folded, model = _build(TINY, "1", "int8-tail", True,
                                 fused_mrf_=True)
    calls = []
    monkeypatch.setattr(fused_mrf, "mrf_fused",
                        lambda *a: calls.append(a) or None)
    code, spkr = _codes(rng, 24)
    got = gen.apply_code_generator(model, code, spkr, device="cpu").numpy()
    want = _np(jax_gen.apply_code_generator(folded, jnp.asarray(code),
                                            jnp.asarray(spkr), jcfg))
    assert not calls
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # under "int8" no stage is packed at all
    _, _, model8 = _build(TINY, "1", "int8", False, fused_mrf_=True)
    assert model8.mrf_plans == {}


def test_dynamic_mode_without_packed_weights_raises(rng):
    _, _, model = _build(TINY, "1", "int8", False)
    fresh = gen.CodeGenerator(model.cfg, weight_norm=False)
    fresh.load_state_dict(model.state_dict(), strict=True)
    code, spkr = _codes(rng, 8)
    with pytest.raises(RuntimeError, match="pack_int8"):
        gen.apply_code_generator(fresh, code, spkr, device="cpu")
    fresh.pack_int8()
    assert torch.equal(
        gen.apply_code_generator(fresh, code, spkr, device="cpu"),
        gen.apply_code_generator(model, code, spkr, device="cpu"))


@pytest.mark.parametrize("mode", ["int8", "int8-tail"])
def test_synthesizer_serves_dynamic_modes(rng, mode):
    """VocoderSynthesizer packs the int8 weights itself and serves within
    the JAX package's 15 dB envelope of the float synthesizer
    (tests/test_quant.py); deterministic and finite."""
    cfg = VocoderModelConfig(**TINY, quant=mode)
    params = jax.tree_util.tree_map(np.asarray, jax_gen.init_code_generator(
        jax.random.key(0), JaxVocoderConfig(**TINY)))
    state = generator_state_from_jax(params, cfg)
    codes = [rng.integers(0, 40, size=n).astype(np.int32)
             for n in (24, 24, 60)]
    spk = [0, 1, 2]
    base = VocoderSynthesizer(state, dataclasses.replace(cfg, quant="none"),
                              device="cpu").synthesize(codes, spk)
    synth = VocoderSynthesizer(state, cfg, device="cpu")
    got = synth.synthesize(codes, spk)
    again = synth.synthesize(codes, spk)
    for a, a2, b, c in zip(got, again, base, codes):
        np.testing.assert_array_equal(a, a2)
        assert a.shape == b.shape == (len(c) * 32,) and np.isfinite(a).all()
        snr = 10 * np.log10(float((b ** 2).mean())
                            / max(float(((a - b) ** 2).mean()), 1e-12))
        assert snr > 15.0, f"{mode} SNR {snr:.1f} dB"
