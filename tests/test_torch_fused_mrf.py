"""The port's fused MRF stage (ops/fused_mrf.py) and the generator's fused
route against the JAX package on the CPU.

The JAX kernel runs in interpret mode on the folded layout; the port's
plain version runs on the unfolded (B, T, C) layout, the one its CUDA
kernel takes. Both are float32 compositions of the same convs, so they
agree up to summation order: atol 2e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.core.config import VocoderModelConfig as JaxVocoderConfig
from parrot_tts_tpu.models.vocoder import generator as jax_gen
from parrot_tts_tpu.ops import fused_mrf as jax_fused
from parrot_tts_tpu.ops.weight_norm import WN_AXES_CONV1D, wn_resolve
from parrot_tts_tpu_torch.convert import generator_state_from_jax
from parrot_tts_tpu_torch.core.config import VocoderModelConfig
from parrot_tts_tpu_torch.models.vocoder import generator as gen
from parrot_tts_tpu_torch.ops import fused_mrf

KS = (3, 7, 11)
DS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


def _jax_resblocks(channels, seed=0):
    key = jax.random.key(seed)
    return [{name: [{"w": wn_resolve(c, WN_AXES_CONV1D), "b": c["b"]}
                    for c in rb[name]] for name in ("convs1", "convs2")}
            for rb in (jax_gen.init_resblock1(jax.random.fold_in(key, i),
                                              channels, k, d)
                       for i, (k, d) in enumerate(zip(KS, DS)))]


def _port_pack(rbs):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    convs = [[(t(c1["w"]), t(c1["b"]), t(c2["w"]), t(c2["b"]))
              for c1, c2 in zip(rb["convs1"], rb["convs2"])] for rb in rbs]
    return fused_mrf.pack_mrf(convs, KS, DS)


def test_plan_halo_is_counted_in_samples():
    _, _, plan = _port_pack(_jax_resblocks(8))
    # k = 11: 5 + 15 + 25 (dilated) + 3 x 5 (plain)
    assert plan.halo == 60
    assert plan.pads(2) == [(5, 5), (15, 5), (25, 5)]


@pytest.mark.parametrize("g,channels,t", [(2, 8, 192), (4, 4, 384)])
def test_reference_matches_jax_fused_kernel(rng, g, channels, t):
    """t folded rows of g*channels lanes = g*t samples of `channels`."""
    rbs = _jax_resblocks(channels)
    xf = rng.standard_normal((2, t, g * channels)).astype(np.float32)
    flat, plan = jax_fused.pack_mrf(rbs, g, KS, DS, jnp.float32)
    want = jax_fused.mrf_fused(jnp.asarray(xf), flat, plan)
    assert want is not None
    w, b, port_plan = _port_pack(rbs)
    x = torch.from_numpy(xf.reshape(2, t * g, channels))        # unfold
    got = fused_mrf.mrf_fused_reference(x, w, b, port_plan)
    np.testing.assert_allclose(got.reshape(2, t, g * channels).numpy(),
                               np.asarray(want), atol=2e-5, rtol=0)


CFG = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
           upsample_initial_channel=32, model_in_dim=16, num_embeddings=20,
           embedding_dim=8, num_speakers=3)


@pytest.mark.parametrize("weight_norm", [False, True])
def test_generator_fused_route_matches_jax(rng, monkeypatch, weight_norm):
    """A tiny generator with fused_mrf=True against JAX's fused, folded
    serving forward. With weight norm folded both stages (16 and 8
    channels) take the fused route; with weight norm live neither does
    (the choice is static)."""
    jcfg = JaxVocoderConfig(**CFG, fused_mrf=True)
    tcfg = VocoderModelConfig(**CFG, fused_mrf=True)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_gen.init_code_generator, static_argnums=1)(jax.random.key(1),
                                                       jcfg))
    code = rng.integers(0, 20, size=(2, 96)).astype(np.int32)
    spkr = np.array([0, 2], np.int32)
    want = np.asarray(jax_gen.apply_code_generator(
        jax_gen.fold_params(jax.tree_util.tree_map(jnp.asarray, params)),
        jnp.asarray(code), jnp.asarray(spkr), jcfg))

    state = generator_state_from_jax(params, tcfg)
    model = gen.CodeGenerator(tcfg, weight_norm=weight_norm)
    with torch.no_grad():
        model.load_state_dict(state if weight_norm else gen.fold_params(state),
                              strict=True)
    model.pack_fused_mrf()
    assert sorted(model.mrf_plans) == ([] if weight_norm else [0, 1])
    calls = []
    real = fused_mrf.mrf_fused_reference
    monkeypatch.setattr(fused_mrf, "mrf_fused_reference",
                        lambda x, *a: calls.append(x.shape) or real(x, *a))
    got = gen.apply_code_generator(model.eval(), code, spkr,
                                   device="cpu").numpy()
    assert calls == ([] if weight_norm else [(2, 96 * 4, 16), (2, 96 * 16, 8)])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_fused_route_equals_unfused_composition(rng):
    """Port against port: fused_mrf on and off give the same waveform on
    one set of folded weights (the composition is the plain version)."""
    tcfg = VocoderModelConfig(**CFG, fused_mrf=True)
    state = gen.fold_params(gen.init_code_generator(
        tcfg, torch.Generator().manual_seed(3)))
    code = rng.integers(0, 20, size=(1, 40))
    ys = []
    for cfg in (tcfg, dataclasses.replace(tcfg, fused_mrf=False)):
        model = gen.CodeGenerator(cfg, weight_norm=False)
        model.load_state_dict(state, strict=True)
        model.pack_fused_mrf()
        ys.append(gen.apply_code_generator(model.eval(), code, [1],
                                           device="cpu"))
    torch.testing.assert_close(ys[0], ys[1], atol=1e-6, rtol=0)


def test_fused_route_needs_its_packed_stages(rng):
    """The fused stages run on weights packed once; an unpacked model
    refuses rather than repack on every forward, and the packs are not
    part of the state_dict."""
    tcfg = VocoderModelConfig(**CFG, fused_mrf=True)
    state = gen.fold_params(gen.init_code_generator(
        tcfg, torch.Generator().manual_seed(4)))
    model = gen.CodeGenerator(tcfg, weight_norm=False)
    model.load_state_dict(state, strict=True)
    code = rng.integers(0, 20, size=(1, 12))
    with pytest.raises(RuntimeError, match="pack_fused_mrf"):
        gen.apply_code_generator(model.eval(), code, [0], device="cpu")
    model.pack_fused_mrf()
    assert set(model.state_dict()) == set(state)
    w, b, plan = gen.pack_stage(model, 1)
    assert torch.equal(model.mrf_w1, w) and torch.equal(model.mrf_b1, b)
    assert model.mrf_plans[1] == plan and plan.channels == 8
    y = gen.apply_code_generator(model, code, [0], device="cpu")
    assert y.shape == (1, 12 * 16, 1) and torch.isfinite(y).all()


@pytest.mark.parametrize("channels,widths", [(16, (8, 4)), (48, (24, 12))])
def test_fused_route_pads_a_stage_off_the_kernels_quantum(rng, monkeypatch,
                                                          channels, widths):
    """A fused stage whose width is not a multiple of 8 (4 and 12 here)
    runs the kernel at the next multiple of 8 on zero-padded weights,
    biases and input channels, which stay 0 through the stage; the result
    is JAX's serving forward with fused_mrf=True on the same weights (it
    folds and fuses where its lane layout takes the length)."""
    cfg = dict(CFG, upsample_initial_channel=channels)
    jcfg = JaxVocoderConfig(**cfg, fused_mrf=True)
    tcfg = VocoderModelConfig(**cfg, fused_mrf=True)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_gen.init_code_generator, static_argnums=1)(jax.random.key(2),
                                                       jcfg))
    code = rng.integers(0, 20, size=(2, 32)).astype(np.int32)
    spkr = np.array([1, 2], np.int32)
    want = np.asarray(jax_gen.apply_code_generator(
        jax_gen.fold_params(jax.tree_util.tree_map(jnp.asarray, params)),
        jnp.asarray(code), jnp.asarray(spkr), jcfg))

    model = gen.CodeGenerator(tcfg, weight_norm=False)
    with torch.no_grad():
        model.load_state_dict(gen.fold_params(
            generator_state_from_jax(params, tcfg)), strict=True)
    model.pack_fused_mrf()
    kernel = [-(-c // 8) * 8 for c in widths]
    assert [model.mrf_plans[i].channels for i in (0, 1)] == kernel
    w, b, _ = gen.pack_stage(model, 1)
    c = widths[1]
    taps = w.reshape(-1, kernel[1], kernel[1])        # (tap, Ci, Co)
    assert not taps[:, c:].any() and not taps[:, :, c:].any()
    assert not b.reshape(-1, kernel[1])[:, c:].any()
    calls = []
    real = fused_mrf.mrf_fused_reference
    monkeypatch.setattr(fused_mrf, "mrf_fused_reference",
                        lambda x, *a: calls.append(x.shape) or real(x, *a))
    got = gen.apply_code_generator(model.eval(), code, spkr,
                                   device="cpu").numpy()
    assert calls == [(2, 32 * 4, kernel[0]), (2, 32 * 16, kernel[1])]
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
