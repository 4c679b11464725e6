"""The port's int8-static vocoder (ops/quant.py, ops/qconv.py's plain
version, the polyphase packing, models/vocoder/generator_staticq.py and the
synthesizer's calibration) against the JAX package on the CPU.

The JAX side runs with fold_tail=False, the layout the port serves: its
sites are then as wide as the port's. The int8 values are exact in both;
the float convs around them differ only in summation order, hence rtol
1e-5 on the calibrated scales and atol 1e-4 on the waveform.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.core.config import VocoderModelConfig as JaxVocoderConfig
from parrot_tts_tpu.models.vocoder import generator as jax_gen
from parrot_tts_tpu.models.vocoder import generator_staticq as jax_sq
from parrot_tts_tpu.ops import conv as jax_conv
from parrot_tts_tpu.ops import quant as jax_quant
from parrot_tts_tpu_torch.convert import generator_state_from_jax
from parrot_tts_tpu_torch.core.config import VocoderModelConfig
from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer
from parrot_tts_tpu_torch.models.vocoder import generator as gen
from parrot_tts_tpu_torch.models.vocoder import generator_staticq as sq
from parrot_tts_tpu_torch.ops import conv as conv_ops
from parrot_tts_tpu_torch.ops import qconv, quant

TINY = dict(
    resblock="1", upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4),
    upsample_initial_channel=128, resblock_kernel_sizes=(3, 7),
    resblock_dilation_sizes=((1, 3), (1, 3)), num_embeddings=40,
    embedding_dim=16, model_in_dim=32, multispkr="_", num_speakers=4)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("kind", ["per_out_channel", "static", "zeros"])
def test_quantize_matches_jax(rng, kind):
    """int8 values equal to JAX's (half-to-even rounding, clip at 127,
    the all-zero guard)."""
    w = (rng.standard_normal((5, 16, 8)) * 0.3).astype(np.float32)
    if kind == "zeros":
        w[:, :, 3] = 0.0
    if kind in ("per_out_channel", "zeros"):
        q, s = quant.quantize_per_out_channel(torch.from_numpy(w))
        jq, js = jax_quant.quantize_per_out_channel(jnp.asarray(w))
        np.testing.assert_array_equal(q.numpy(), _np(jq))
        np.testing.assert_array_equal(s.numpy(), _np(js))
        assert q.dtype == torch.int8
        return
    x = (rng.standard_normal((2, 30, 16)) * 2).astype(np.float32)
    # scales that put some values exactly on .5 and some beyond the clip
    s = np.abs(x).max(axis=(0, 1)).astype(np.float32) / 200.0
    x[0, 0] = s * 2.5
    q = quant.quantize_static(torch.from_numpy(x), torch.from_numpy(s))
    jq = jax_quant.quantize_static(jnp.asarray(x), jnp.asarray(s))
    np.testing.assert_array_equal(q.numpy(), _np(jq))
    assert int(np.abs(q.numpy()).max()) == 127


@pytest.mark.parametrize("dilation", [1, 3])
def test_int8_conv_qin_matches_jax(rng, dilation):
    k, ci, co = 5, 24, 12
    xq = rng.integers(-127, 128, size=(2, 40, ci)).astype(np.int8)
    sx = (rng.random(ci) * 0.05 + 0.01).astype(np.float32)
    w = (rng.standard_normal((k, ci, co)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(co) * 0.1).astype(np.float32)
    pad = (k - 1) * dilation // 2
    got = quant.int8_conv_qin(torch.from_numpy(xq), torch.from_numpy(sx),
                              torch.from_numpy(w), torch.from_numpy(b),
                              pads=(pad, pad), rhs_dilation=dilation)
    want = jax_quant.int8_conv_qin(jnp.asarray(xq), jnp.asarray(sx),
                                   jnp.asarray(w), jnp.asarray(b),
                                   pads=(pad, pad), rhs_dilation=dilation)
    assert got.shape == want.shape == (2, 40, co)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=0)


def test_int8_conv_plain_version_is_exact_with_leaky(rng):
    """The plain version is the exact integer conv, then acc·scale + bias
    and max(y, 0.1·y), with asymmetric pads and per-row scales."""
    xq = rng.integers(-127, 128, size=(3, 17, 9)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(3, 9, 6)).astype(np.int8)
    scale = (rng.random((3, 6)) * 1e-3).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    wt = np.ascontiguousarray(wq.transpose(0, 2, 1))     # (K, Co, Ci)
    got = qconv.int8_conv(torch.from_numpy(xq), torch.from_numpy(wt),
                          torch.from_numpy(scale), torch.from_numpy(bias),
                          pads=(2, 0), leaky=0.1).numpy()
    xp = np.pad(xq.astype(np.int64), ((0, 0), (2, 0), (0, 0)))
    acc = sum(np.einsum("btc,cd->btd", xp[:, j:j + 17], wq[j].astype(np.int64))
              for j in range(3))
    y = acc.astype(np.float32) * scale[:, None, :] + bias
    np.testing.assert_array_equal(got, np.maximum(y, np.float32(0.1) * y))


@pytest.mark.parametrize("u,k", [(5, 11), (4, 8), (2, 4), (3, 5)])
def test_polyphase_weights_match_jax(rng, u, k):
    w = rng.standard_normal((k, 6, 4)).astype(np.float32)
    pad = (k - u) // 2
    got, gl, gq = conv_ops.polyphase_weights(torch.from_numpy(w), u, pad)
    want, wl, wq = jax_conv.polyphase_weights(jnp.asarray(w), u, pad)
    assert (gl, gq) == (wl, wq)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def _build(seed=0, fold_tail=False):
    jcfg = JaxVocoderConfig(**TINY, fold_tail=fold_tail)
    tcfg = VocoderModelConfig(**TINY, quant="int8-static")
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_gen.init_code_generator, static_argnums=1)(jax.random.key(seed),
                                                       jcfg))
    state = generator_state_from_jax(params, tcfg)
    folded = jax_gen.fold_params(jax.tree_util.tree_map(jnp.asarray, params))
    # the port serves JAX's weight-norm-folded kernels themselves: a last-bit
    # difference in the fold would move a weight across an int8 rounding
    # boundary
    port = gen.fold_params(state)

    def put(name, w, layout):
        port[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(np.asarray(w), layout)))

    put("conv_pre", folded["conv_pre"]["w"], (2, 1, 0))
    put("conv_post", folded["conv_post"]["w"], (2, 1, 0))
    for i, up in enumerate(folded["ups"]):
        put(f"ups.{i}", up["w"], (1, 2, 0))
    for i, rb in enumerate(folded["resblocks"]):
        for name in ("convs1", "convs2"):
            for j, c in enumerate(rb[name]):
                put(f"resblocks.{i}.{name}.{j}", c["w"], (2, 1, 0))
    model = gen.CodeGenerator(tcfg, weight_norm=False)
    model.load_state_dict(port, strict=True)
    return jcfg, tcfg, folded, model.eval(), state


def _batch(rng, t=24):
    code = rng.integers(0, TINY["num_embeddings"], size=(2, t)).astype(np.int32)
    spkr = rng.integers(0, TINY["num_speakers"], size=(2,)).astype(np.int32)
    return code, spkr


@pytest.mark.parametrize("residual_int8", [False, True])
def test_calibrate_qscales_matches_jax(rng, residual_int8):
    jcfg, tcfg, folded, model, _ = _build()
    code, spkr = _batch(rng)
    want = jax_sq.calibrate_qscales(folded, jnp.asarray(code),
                                    jnp.asarray(spkr), jcfg, margin=1.2,
                                    residual_int8=residual_int8)
    got = sq.calibrate_qscales(model, code, spkr, margin=1.2,
                               residual_int8=residual_int8, device="cpu")
    widths = sq.site_widths(tcfg, residual_int8)
    assert len(got) == len(want) == len(widths)
    # per stage: the upsample input (+ the stage input) and 2 ResBlocks x
    # 2 pairs x 2 conv inputs (+ the pair's output)
    r = int(residual_int8)
    assert len(widths) == 3 * (1 + r + 2 * 2 * (2 + r))
    for g, w, c in zip(got, want, widths):
        assert g.dtype == torch.float32 and g.shape == (c,)
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5, atol=0)


@pytest.mark.parametrize("residual_int8", [False, True])
def test_staticq_serving_matches_jax_with_jax_scales(rng, tmp_path,
                                                     residual_int8):
    """JAX calibrates and saves its scales; the port loads the npz and
    serves the same codes."""
    jcfg, tcfg, folded, model, _ = _build()
    code, spkr = _batch(rng)
    qs = jax_sq.calibrate_qscales(folded, jnp.asarray(code),
                                  jnp.asarray(spkr), jcfg,
                                  residual_int8=residual_int8)
    path = tmp_path / "qscales.npz"
    jax_sq.save_qscales(path, qs)
    code2, spkr2 = _batch(rng)               # a batch kept out of calibration
    want = _np(jax_sq.apply_code_generator_staticq(
        folded, jnp.asarray(code2), jnp.asarray(spkr2), qs, jcfg,
        residual_int8=residual_int8))
    q = sq.quantize_generator(model, sq.load_qscales(path, tcfg,
                                                     residual_int8),
                              residual_int8=residual_int8, device="cpu")
    got = sq.apply_code_generator_staticq(model, code2, spkr2, q,
                                          device="cpu").numpy()
    assert got.shape == want.shape == (2, 24 * 32, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_qscales_guards_refuse_stale_or_folded_scales(rng, tmp_path):
    jcfg, tcfg, folded, model, _ = _build()
    code, spkr = _batch(rng)
    qs = sq.calibrate_qscales(model, code, spkr, device="cpu")
    with pytest.raises(ValueError, match="sites"):
        sq.quantize_generator(model, qs[:-2], device="cpu")
    with pytest.raises(ValueError, match="sites"):   # residual_int8 mismatch
        sq.quantize_generator(model, qs, residual_int8=True, device="cpu")
    wide = list(qs)
    wide[3] = torch.cat([wide[3], wide[3]])
    with pytest.raises(ValueError, match="wide"):
        sq.quantize_generator(model, wide, device="cpu")
    # JAX's default fold_tail=True: same site count, g*C-wide folded sites
    jcfg_f, _, folded_f, _, _ = _build(fold_tail=True)
    qs_f = jax_sq.calibrate_qscales(folded_f, jnp.asarray(code),
                                    jnp.asarray(spkr), jcfg_f)
    assert len(qs_f) == len(qs)
    path = tmp_path / "folded.npz"
    jax_sq.save_qscales(path, qs_f)
    with pytest.raises(ValueError, match="do not transfer"):
        sq.load_qscales(path, tcfg)


def test_qscales_save_load_roundtrip(rng, tmp_path):
    _, tcfg, _, model, _ = _build()
    code, spkr = _batch(rng)
    qs = sq.calibrate_qscales(model, code, spkr, device="cpu")
    sq.save_qscales(tmp_path / "q.npz", qs)
    qs2 = sq.load_qscales(tmp_path / "q.npz", tcfg)
    y1, y2 = (sq.apply_code_generator_staticq(
        model, code, spkr, sq.quantize_generator(model, q, device="cpu"),
        device="cpu") for q in (qs, qs2))
    assert torch.equal(y1, y2)


def test_synthesizer_int8_static_lazy_calibration(rng):
    """VocoderSynthesizer(quant='int8-static') calibrates on its first
    batch and serves within the JAX package's 15 dB envelope of the float
    synthesizer (tests/test_quant.py)."""
    _, tcfg, _, _, state = _build()
    cfg_f = dataclasses.replace(tcfg, quant="none")
    codes = [rng.integers(0, 40, size=n).astype(np.int32) for n in (24, 24, 60)]
    spk = [0, 1, 2]
    base = VocoderSynthesizer(state, cfg_f, device="cpu").synthesize(codes, spk)
    synth = VocoderSynthesizer(state, tcfg, device="cpu")
    got = synth.synthesize(codes, spk)
    assert synth.staticq is not None
    assert len(synth.staticq.scales) == len(sq.site_widths(tcfg))
    for a, b in zip(got, base):
        assert a.shape == b.shape and np.isfinite(a).all()
        snr = 10 * np.log10(float((b ** 2).mean())
                            / max(float(((a - b) ** 2).mean()), 1e-12))
        assert snr > 15.0, f"int8-static SNR {snr:.1f} dB"
    # explicit calibration replaces the lazy one; serving is deterministic
    lazy = synth.staticq
    synth.calibrate([codes[0], codes[1]], [0, 1])
    assert synth.staticq is not lazy
    again = synth.synthesize(codes, spk)
    np.testing.assert_array_equal(again[2], synth.synthesize(codes, spk)[2])


def test_weight_cache_gives_the_same_bits(rng, monkeypatch):
    """Quantizing every conv's weight once (`quantize_generator`) gives the
    int8 bits that quantizing on every call gives, as the JAX package
    does: each conv of the serve equals `int8_conv_qin` on its float
    weight and its input site's scales."""
    _, tcfg, _, model, _ = _build()
    code, spkr = _batch(rng)
    qs = sq.calibrate_qscales(model, code, spkr, device="cpu")
    q = sq.quantize_generator(model, qs, device="cpu")
    # one weight per conv: an upsample and 2 x 2 x 2 ResBlock convs a stage
    assert len(q.convs) == 3 * (1 + 8) == len(sq.site_widths(tcfg))
    seen = {}
    for conv, (site, (wt, sw), b) in q.convs.items():
        w, _ = sq._site_conv(model, conv)
        wq2, sw2 = quant.quantize_weight_qin(w, qs[site])
        assert torch.equal(wt, wq2) and torch.equal(sw, sw2)
        assert wt.shape == (w.shape[0], w.shape[2], w.shape[1])
        assert wt.is_contiguous()
        seen[site] = conv
    assert sorted(seen) == list(range(len(qs)))
    calls = []
    real = quant.int8_conv_qweight
    monkeypatch.setattr(quant, "int8_conv_qweight",
                        lambda xq, qw, b, **kw: calls.append(qw)
                        or real(xq, qw, b, **kw))
    got = sq.apply_code_generator_staticq(model, code, spkr, q, device="cpu")
    # the serve reads the prepared weights themselves, each once
    assert len(calls) == len(q.convs)
    assert {id(qw) for qw in calls} == {id(v[1]) for v in q.convs.values()}
    assert got.shape == (2, 24 * 32, 1) and torch.isfinite(got).all()
