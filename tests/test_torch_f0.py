"""Port f0 conditioning (parrot_tts_tpu_torch.{ops.f0, the generator's
extra_feats, VocoderSynthesizer(f0=), VocoderLoader(with_f0=True), the
f0 GAN step}) against the JAX package on the CPU.

Tolerances: the pitch tracker's FFT is pocketfft here and XLA's DFT in
JAX, so voiced f0 agrees within F0_ATOL Hz (measured ~1e-4) while voicing,
a threshold, must be equal on the fixtures of tests/test_f0.py. The
pooling and the unvoiced-gap interpolation are exact. Waveforms of the
tiny generator within 1e-5 (in [-1, 1]); the f0 GAN step at
tests/test_torch_gan.py's tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.core import config as jax_config
from parrot_tts_tpu.data import vocoder_data as jax_vocoder_data
from parrot_tts_tpu.infer import synthesize as jax_synthesize
from parrot_tts_tpu.models.vocoder import generator as jax_gen
from parrot_tts_tpu.ops import f0 as jax_f0
from parrot_tts_tpu.train import vocoder as jax_train
from parrot_tts_tpu_torch.convert import (generator_state_from_jax,
                                          vocoder_train_state_from_jax)
from parrot_tts_tpu_torch.core.config import (MelConfig, VocoderModelConfig,
                                              VocoderTrainConfig)
from parrot_tts_tpu_torch.data import vocoder_data
from parrot_tts_tpu_torch.data.audio_io import read_wav, write_wav
from parrot_tts_tpu_torch.data.manifest import write_manifest
from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer
from parrot_tts_tpu_torch.models.vocoder import generator as gen
from parrot_tts_tpu_torch.ops import f0 as f0_ops
from parrot_tts_tpu_torch.train import vocoder as voc_train

from tests.test_torch_gan import (MEL, SPE, STEP_CFG, TINY, at_count,
                                  port_state_dicts, rel_err, tiny_batch)

RATE = 16000
F0_ATOL = 1e-2          # Hz, on voiced frames
WAV_ATOL = 1e-5
# tests/test_f0.py's tiny generator with the f0 channel: 2E + 1
GEN = dict(resblock="1", upsample_rates=(5, 4), upsample_kernel_sizes=(11, 8),
           upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
           resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), num_embeddings=30,
           embedding_dim=8, model_in_dim=17, multispkr="_", num_speakers=4,
           f0=True)


def sine(freq, n=RATE, amp=0.5):
    t = np.arange(n) / RATE
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def chirp(n=8960):
    """tests/test_f0.py's 100 -> 300 Hz linear chirp over a GAN segment."""
    f_inst = 100.0 + 200.0 * (np.arange(n) / RATE) / (n / RATE)
    return (0.5 * np.sin(2 * np.pi * np.cumsum(f_inst) / RATE)
            ).astype(np.float32)


FIXTURES = {
    "sines": lambda: np.stack([sine(f) for f in (120.0, 220.0, 330.0)]),
    "chirp": lambda: chirp()[None],
    "silence": lambda: np.zeros((1, RATE), np.float32),
    "noise": lambda: np.random.default_rng(0).normal(
        0, 0.1, (1, RATE)).astype(np.float32),
    "gap": lambda: np.concatenate([sine(150, RATE // 2),
                                   np.zeros(RATE // 4, np.float32),
                                   sine(200, RATE // 2)])[None],
}


@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_estimate_f0_matches_jax(name, interp):
    audio = FIXTURES[name]()
    want = np.asarray(jax_f0.estimate_f0(jnp.asarray(audio), interp=interp))
    got = f0_ops.estimate_f0(audio, device="cpu", interp=interp)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=F0_ATOL)
    if name in ("sines", "gap"):
        assert (want > 0).mean() > 0.5     # the fixture exercises voicing


def test_estimate_f0_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        f0_ops.estimate_f0(np.zeros((1, 4000), np.float32))


@pytest.mark.parametrize("code_len", [20, 25, 30])
def test_f0_to_code_rate_is_exact(rng, code_len):
    track = rng.uniform(50, 300, (3, 1, 103)).astype(np.float32)
    track[rng.random(track.shape) < 0.5] = 0.0
    want = np.asarray(jax_f0.f0_to_code_rate(jnp.asarray(track), code_len))
    got = f0_ops.f0_to_code_rate(torch.from_numpy(track), code_len).numpy()
    np.testing.assert_array_equal(got, want)


def test_interp_unvoiced_is_exact(rng):
    f0 = rng.uniform(50, 300, (4, 90)).astype(np.float32)
    f0[rng.random(f0.shape) < 0.6] = 0.0
    f0[0, :10] = 0.0            # leading gap: held at the first voiced
    f0[1, -10:] = 0.0           # trailing gap: held at the last voiced
    f0[2] = 0.0                 # nothing voiced: stays 0
    f0[3, 40:60] = 0.0          # an interior gap: bridged
    want = np.asarray(jax_f0._interp_unvoiced(jnp.asarray(f0)))
    got = f0_ops._interp_unvoiced(torch.from_numpy(f0)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[2].any() and (got[:2] > 0).all()


def test_f0_for_codes_matches_jax():
    wavs = [sine(180.0, 5000), chirp(8960), np.zeros(700, np.float32)]
    lens = [15, 28, 3]
    want = jax_f0.f0_for_codes(wavs, lens)
    got = f0_ops.f0_for_codes(wavs, lens, device="cpu")
    for g, w, n in zip(got, want, lens):
        assert g.shape == w.shape == (n,) and g.dtype == np.float32
        np.testing.assert_array_equal(g > 0, w > 0)
        np.testing.assert_allclose(g, w, rtol=0, atol=F0_ATOL)
    assert (want[1] > 0).all() and not want[2].any()


def build_gen(cfg=GEN, seed=0):
    jcfg = jax_config.VocoderModelConfig(**cfg)
    tcfg = VocoderModelConfig(**cfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_gen.init_code_generator, static_argnums=1)(jax.random.key(seed),
                                                       jcfg))
    return jcfg, tcfg, params, generator_state_from_jax(params, tcfg)


def _code_inputs(rng, b=2, t=10):
    return (rng.integers(0, 30, size=(b, t)).astype(np.int32),
            rng.integers(0, 4, size=(b,)).astype(np.int32))


@pytest.mark.parametrize("feats", ["f0", "f0+emb", "emb", "f0, gate off"])
def test_code_generator_extra_feats_match_jax(rng, feats):
    """f0 (raw Hz) and a generic feature are upsample-concatenated in
    sorted-name order; with cfg.f0 off an f0 feature is dropped."""
    cfg = dict(GEN)
    extra = {}
    if "f0" in feats:
        extra["f0"] = rng.uniform(80, 250, (2, 1, 10)).astype(np.float32)
    if "emb" in feats:
        extra["emb"] = rng.standard_normal((2, 2, 5)).astype(np.float32)
    cfg["f0"] = feats in ("f0", "f0+emb")
    cfg["model_in_dim"] = 16 + cfg["f0"] + 2 * ("emb" in feats)
    jcfg, tcfg, params, state = build_gen(cfg)
    model = gen.CodeGenerator(tcfg)
    model.load_state_dict(state, strict=True)
    code, spkr = _code_inputs(rng)
    want = np.asarray(jax_gen.apply_code_generator(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(code),
        jnp.asarray(spkr), jcfg, extra_feats=extra))
    got = gen.apply_code_generator(model, code, spkr, extra_feats=extra,
                                   device="cpu").numpy()
    assert got.shape == want.shape == (2, 200, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=WAV_ATOL)
    if feats == "f0, gate off":
        np.testing.assert_array_equal(
            got, gen.apply_code_generator(model, code, spkr,
                                          device="cpu").numpy())


def test_misaligned_f0_track_raises(rng):
    _, tcfg, _, state = build_gen()
    model = gen.CodeGenerator(tcfg)
    model.load_state_dict(state, strict=True)
    code, spkr = _code_inputs(rng)
    with pytest.raises(NotImplementedError, match="misalignment"):
        gen.apply_code_generator(model, code, spkr, device="cpu",
                                 extra_feats={"f0": np.ones((2, 1, 7))})


def test_synthesizer_f0_matches_jax(rng, tmp_path):
    """Per-bucket repeat-padding of codes and f0 tracks, trimmed output,
    to_wavs; f0 is required by an f0 model."""
    jcfg, tcfg, params, state = build_gen()
    codes = [rng.integers(0, 30, size=n).astype(np.int32)
             for n in (100, 128, 40)]
    f0 = [rng.uniform(80, 250, n).astype(np.float32) for n in (100, 128, 40)]
    spk = [0, 1, 3]
    want = jax_synthesize.VocoderSynthesizer(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg).synthesize(
            codes, spk, f0=f0)
    synth = VocoderSynthesizer(state, tcfg, device="cpu")
    got = synth.synthesize(codes, spk, f0=f0)
    for g, w, c in zip(got, want, codes):
        assert g.shape == w.shape == (len(c) * 20,)
        np.testing.assert_allclose(g, w, rtol=0, atol=WAV_ATOL)
    with pytest.raises(ValueError, match="f0-conditioned"):
        synth.synthesize(codes, spk)
    paths = synth.to_wavs(codes, spk, tmp_path, names=["a", "b", "c"], f0=f0)
    assert [p.name for p in paths] == ["a_gen.wav", "b_gen.wav", "c_gen.wav"]
    wav, sr = read_wav(paths[2])
    assert sr == 16000 and wav.shape == (40 * 20,)


@pytest.mark.parametrize("mode", ["fused", "int8", "int8-tail"])
def test_synthesizer_serves_f0_in_every_mode(rng, mode):
    """fused_mrf=True within 1e-5 of the float serve; the dynamic int8
    modes within the JAX package's 15 dB envelope of it, deterministic;
    in each a changed f0 changes the waveform."""
    _, tcfg, _, state = build_gen()
    codes = [rng.integers(0, 30, size=n).astype(np.int32) for n in (64, 100)]
    f0 = [rng.uniform(80, 250, n).astype(np.float32) for n in (64, 100)]
    spk = [0, 2]
    base = VocoderSynthesizer(state, tcfg, device="cpu").synthesize(
        codes, spk, f0=f0)
    cfg = (dataclasses.replace(tcfg, fused_mrf=True) if mode == "fused"
           else dataclasses.replace(tcfg, quant=mode))
    synth = VocoderSynthesizer(state, cfg, device="cpu")
    got = synth.synthesize(codes, spk, f0=f0)
    moved = synth.synthesize(codes, spk, f0=[x * 0.5 for x in f0])
    for a, a2, b, m in zip(got, synth.synthesize(codes, spk, f0=f0), base,
                           moved):
        np.testing.assert_array_equal(a, a2)
        assert a.shape == b.shape and np.isfinite(a).all()
        assert not np.allclose(a, m)
        if mode == "fused":
            np.testing.assert_allclose(a, b, rtol=0, atol=WAV_ATOL)
        else:
            snr = 10 * np.log10(float((b ** 2).mean())
                                / max(float(((a - b) ** 2).mean()), 1e-12))
            assert snr > 15.0, f"{mode} SNR {snr:.1f} dB"


def test_int8_static_refuses_f0():
    _, tcfg, params, state = build_gen()
    cfg = dataclasses.replace(tcfg, quant="int8-static")
    with pytest.raises(ValueError, match="int8-static"):
        VocoderSynthesizer(state, cfg, device="cpu")
    with pytest.raises(ValueError, match="int8-static"):
        jax_synthesize.VocoderSynthesizer(
            params, dataclasses.replace(build_gen()[0], quant="int8-static"))


def write_tone_corpus(root, n=5, seed=4):
    """16 kHz harmonic tones of 0.3-0.9 s under noise over two speakers,
    and a manifest of random codes at 320 samples per code."""
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        n_samp = int(rng.integers(4800, 14400))
        t = np.arange(n_samp) / RATE
        f = rng.uniform(90, 250)
        wav = sum(np.sin(2 * np.pi * f * k * t) / k for k in (1, 2, 3))
        path = root / "wavs" / f"{('en_f', 'en_m')[i % 2]}_{i:03d}.wav"
        write_wav(path, 0.3 * wav + 0.02 * rng.standard_normal(n_samp), RATE)
        entries.append({"audio": str(path), "hubert": " ".join(
            map(str, rng.integers(0, 30, n_samp // 320)))})
    write_manifest(root / "train.txt", entries)
    return root / "train.txt"


def test_loader_f0_matches_jax(tmp_path):
    manifest = write_tone_corpus(tmp_path)
    kw = dict(segment_size=3200, code_hop_size=320)
    got = list(vocoder_data.VocoderLoader(
        vocoder_data.VocoderDataset(manifest, **kw), 2, seed=3, with_f0=True,
        device="cpu").batches(0))
    want = list(jax_vocoder_data.VocoderLoader(
        jax_vocoder_data.VocoderDataset(manifest, **kw), 2, seed=3,
        with_f0=True).batches(0))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["audio"], w["audio"])
        assert g["f0"].shape == w["f0"].shape == (2, 1, 10)
        assert g["f0"].dtype == np.float32
        np.testing.assert_array_equal(g["f0"] > 0, w["f0"] > 0)
        np.testing.assert_allclose(g["f0"], w["f0"], rtol=0, atol=F0_ATOL)
        assert (w["f0"] > 0).mean() > 0.5


F0_TINY = dict(TINY, f0=True, model_in_dim=TINY["model_in_dim"] + 1)


def f0_batch():
    """tiny_batch() with a code-rate pitch track; some frames unvoiced."""
    b = tiny_batch()
    rng = np.random.default_rng(5)
    f0 = rng.uniform(80, 250, b["code"].shape).astype(np.float32)
    f0[rng.random(f0.shape) < 0.3] = 0.0
    return {**b, "f0": f0[:, None, :]}


def test_f0_train_step_matches_jax():
    """One f0 GAN step from the same state as JAX: metrics rtol 1e-5, the
    three networks' gradients (first moments) rel 1e-4, the generator's
    updated parameters atol 1e-6; the f0 column of conv_pre gets a
    gradient."""
    from parrot_tts_tpu.models.vocoder import convert as jax_convert

    jm = jax_config.VocoderModelConfig(**F0_TINY)
    jt = jax_config.VocoderTrainConfig(**STEP_CFG)
    mcfg = VocoderModelConfig(**F0_TINY)
    g_sd = voc_train.init_state(0, mcfg, "cpu").gen.state_dict()
    _, mpd_sd, msd_sd = port_state_dicts()
    g = jax_convert.generator_params_from_torch(g_sd, jm)
    mpd = jax_convert.mpd_params_from_torch(mpd_sd)
    msd = jax_convert.msd_params_from_torch(msd_sd)
    opt_g, opt_d = jax_train.make_optimizers(jt, SPE)
    start = jax.tree_util.tree_map(np.asarray, jax_train.VocoderTrainState(
        gen_params=g, mpd_params=mpd, msd_params=msd,
        opt_g_state=at_count(opt_g.init(g), SPE - 1),
        opt_d_state=at_count(opt_d.init((mpd, msd)), SPE - 1),
        step=jnp.asarray(SPE - 1, jnp.int32)))
    batch = f0_batch()
    end, want_metrics = jax_train.train_step(
        jax.tree_util.tree_map(jnp.asarray, start),
        {k: jnp.asarray(v) for k, v in batch.items()}, jm, jt,
        jax_config.MelConfig(**MEL), SPE)

    state = voc_train.init_state(1, mcfg, "cpu")
    state.load_state_dict(vocoder_train_state_from_jax(start, mcfg))
    metrics = voc_train.train_step(
        state, voc_train.to_batch(batch, "cpu"), mcfg,
        VocoderTrainConfig(**STEP_CFG), MelConfig(**MEL), SPE)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5)
    want = vocoder_train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, end), mcfg)
    got = state.state_dict()
    assert rel_err(got["mu_g"], want["mu_g"]) <= 1e-4
    for net in ("mpd", "msd"):
        g_d, w_d = ({k: d[k] for k in d if k.startswith(net)}
                    for d in (got["mu_d"], want["mu_d"]))
        assert rel_err(g_d, w_d) <= 1e-4, net
    for k, w in want["gen"].items():
        np.testing.assert_allclose(got["gen"][k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6)
    f0_col = got["mu_g"]["conv_pre.weight_v"][:, -1, :]
    assert f0_col.abs().max() > 0
