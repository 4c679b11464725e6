"""Port vocoder generator (parrot_tts_tpu_torch.models.vocoder) against the
JAX package.

The JAX side runs in float32 with its TPU lowerings (folded tail,
polyphase transposed conv) on the CPU; the port runs plain cuDNN-layout
convs. The two agree up to float32 reassociation, hence atol 2e-5 on a
waveform in [-1, 1].
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.core.config import VocoderModelConfig as JaxVocoderConfig
from parrot_tts_tpu.infer import synthesize as jax_synthesize
from parrot_tts_tpu.models.vocoder import generator as jax_gen
from parrot_tts_tpu_torch.convert import generator_state_from_jax
from parrot_tts_tpu_torch.core.config import VocoderModelConfig
from parrot_tts_tpu_torch.infer import synthesize
from parrot_tts_tpu_torch.models.vocoder import generator as gen

SMALL = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
             upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
             resblock_dilation_sizes=((1, 3), (1, 3)), num_embeddings=40,
             embedding_dim=8, model_in_dim=16, num_speakers=4)


def build(resblock="1", seed=0):
    jcfg = JaxVocoderConfig(resblock=resblock, **SMALL)
    tcfg = VocoderModelConfig(resblock=resblock, **SMALL)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_gen.init_code_generator, static_argnums=1)(jax.random.key(seed),
                                                       jcfg))
    model = gen.CodeGenerator(tcfg)
    model.load_state_dict(generator_state_from_jax(params, tcfg), strict=True)
    return jcfg, tcfg, params, model.eval()


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_code_generator_matches_jax(rng, resblock):
    jcfg, _, params, model = build(resblock)
    code = rng.integers(0, SMALL["num_embeddings"], size=(2, 48)).astype(np.int32)
    spkr = np.array([1, 3], np.int32)
    want = np.asarray(jax_gen.apply_code_generator(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(code),
        jnp.asarray(spkr), jcfg))
    got = gen.apply_code_generator(model, code, spkr, device="cpu").numpy()
    assert got.shape == want.shape == (2, 48 * 8, 1)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_folded_params_same_waveform(rng):
    _, tcfg, _, model = build()
    folded = gen.CodeGenerator(tcfg, weight_norm=False)
    with torch.no_grad():
        folded.load_state_dict(gen.fold_params(model.state_dict()), strict=True)
    code = rng.integers(0, SMALL["num_embeddings"], size=(1, 20))
    a = gen.apply_code_generator(model, code, [2], device="cpu")
    b = gen.apply_code_generator(folded.eval(), code, [2], device="cpu")
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_upsample_cond_matches_jax_and_checks_divisibility(rng):
    sig = rng.standard_normal((2, 3, 5)).astype(np.float32)
    want = np.asarray(jax_gen.upsample_cond(jnp.asarray(sig), 20))
    got = gen.upsample_cond(torch.from_numpy(sig), 20).numpy()
    np.testing.assert_array_equal(got, want)
    assert gen.upsample_cond(torch.ones(2), 7).shape == (2, 1, 7)
    with pytest.raises(NotImplementedError, match="misalignment"):
        gen.upsample_cond(torch.from_numpy(sig), 21)


@pytest.mark.parametrize("kind", ["noise", "silence"])
def test_peak_normalize_matches_jax(rng, kind):
    wav = (rng.standard_normal(400) * 0.3).astype(np.float32)
    if kind == "silence":
        wav[:] = 0.0
    np.testing.assert_array_equal(synthesize.peak_normalize(wav),
                                  jax_synthesize.peak_normalize(wav))
    assert synthesize.peak_normalize(np.zeros(0, np.float32)).shape == (0,)


def test_generator_quant_modes():
    """Every quant mode is ported; an unknown one raises."""
    for mode in ("none", "int8", "int8-tail", "int8-static"):
        gen.CodeGenerator(VocoderModelConfig(**SMALL, quant=mode))
    with pytest.raises(ValueError):
        gen.CodeGenerator(VocoderModelConfig(**SMALL, quant="int4"))


@pytest.mark.parametrize("quant", ["none", "int8", "int8-tail"])
def test_f0_generator_matches_jax(rng, quant):
    """f0=True: the f0 channel joins conv_pre's input (model_in_dim 2E + 1)
    in float and the dynamic int8 modes, whose conv_pre stays float; the
    float mode within atol 2e-5 of the JAX package."""
    cfg = dict(SMALL, model_in_dim=17, f0=True)
    jcfg, tcfg = JaxVocoderConfig(**cfg), VocoderModelConfig(**cfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_gen.init_code_generator, static_argnums=1)(jax.random.key(3),
                                                       jcfg))
    model = gen.CodeGenerator(dataclasses.replace(tcfg, quant=quant),
                              weight_norm=False)
    model.load_state_dict(gen.fold_params(generator_state_from_jax(
        params, tcfg)), strict=True)
    model.eval().pack_int8()
    assert model.conv_pre.weight.shape[1] == 17
    code = rng.integers(0, 40, size=(2, 24)).astype(np.int32)
    spkr = np.array([0, 3], np.int32)
    f0 = rng.uniform(80, 250, (2, 1, 24)).astype(np.float32)
    got = gen.apply_code_generator(model, code, spkr, extra_feats={"f0": f0},
                                   device="cpu").numpy()
    assert got.shape == (2, 24 * 8, 1) and np.isfinite(got).all()
    if quant == "none":
        want = np.asarray(jax_gen.apply_code_generator(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(code),
            jnp.asarray(spkr), jcfg, extra_feats={"f0": jnp.asarray(f0)}))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
