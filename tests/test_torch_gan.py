"""Port vocoder GAN training (parrot_tts_tpu_torch.{ops.stft,
ops.weight_norm, models.vocoder.discriminator, models.vocoder.losses,
train.vocoder, data.vocoder_data, pipeline.train_vocoder}) against the JAX
package.

The generator is the JAX tests' tiny one (tests/test_train_steps.py); the
discriminators have their fixed full widths. Weights are made once by the
port's seeded init, read into the JAX package by its own converters
(`models/vocoder/convert.py`), and the JAX state is carried back into the
port by `convert.vocoder_train_state_from_jax`, so both packages start a
step from the same numbers. The JAX step is compiled once per module.

Tolerances: float32 sums in another order on the two CPU backends. STFT
magnitudes rtol 1e-5 with atol 1e-6 (the port's FFT and the JAX package's
DFT matmul each carry ~1e-5 relative error on the smallest bins against a
float64 transform); discriminator scores and feature maps rtol 1e-5, atol
1e-6; losses and the step's metrics rtol 1e-5; the step's gradients
|dg|/|g| <= 1e-4 per network (read from the first AdamW moment, which is
(1 - b1) g after one update from zero moments); the spectral-norm vectors
atol 1e-5; AdamW fed the same gradients atol 1e-6.

`test_gan_step_on_card` needs a CUDA device and no JAX; run it on the
card with `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_gan.py -k on_card`.
"""

import dataclasses
import functools
import json
import shutil

import numpy as np
import pytest
import torch

from parrot_tts_tpu_torch.convert import (mpd_state_from_jax,
                                          msd_state_from_jax,
                                          vocoder_train_state_from_jax)
from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
from parrot_tts_tpu_torch.core.config import (MelConfig, PipelineConfig,
                                              VocoderModelConfig,
                                              VocoderTrainConfig)
from parrot_tts_tpu_torch.data import vocoder_data
from parrot_tts_tpu_torch.data.audio_io import write_wav
from parrot_tts_tpu_torch.data.manifest import write_manifest
from parrot_tts_tpu_torch.models.vocoder import discriminator as disc
from parrot_tts_tpu_torch.models.vocoder import losses
from parrot_tts_tpu_torch.ops import conv as conv_ops
from parrot_tts_tpu_torch.ops import stft, weight_norm
from parrot_tts_tpu_torch.pipeline import train_vocoder
from parrot_tts_tpu_torch.train import schedules
from parrot_tts_tpu_torch.train import vocoder as voc_train

try:
    import jax
    import jax.numpy as jnp
    import optax

    from parrot_tts_tpu.core import config as jax_config
    from parrot_tts_tpu.data import vocoder_data as jax_vocoder_data
    from parrot_tts_tpu.models.vocoder import convert as jax_convert
    from parrot_tts_tpu.models.vocoder import discriminator as jax_disc
    from parrot_tts_tpu.models.vocoder import losses as jax_losses
    from parrot_tts_tpu.ops import stft as jax_stft
    from parrot_tts_tpu.ops import weight_norm as jax_wn
    from parrot_tts_tpu.train import schedules as jax_schedules
    from parrot_tts_tpu.train import vocoder as jax_train
except ImportError:     # the card machine has no JAX: only the card test runs
    jax = None

TINY = dict(resblock="1", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), num_embeddings=12,
            embedding_dim=4, model_in_dim=8, multispkr="_", num_speakers=2)
MEL = dict(n_fft=64, num_mels=8, hop_size=16, win_size=64, fmax=None)
HOP, TC = 16, 16         # samples per code, codes per crop
LR, SPE = 1e-3, 10       # learning rate, steps per epoch
# the parity step's recipe: it starts at step SPE - 1, the last of an
# epoch, with zero moments, so a schedule read at the wrong count would
# halve the learning rate
STEP_CFG = dict(learning_rate=LR, lr_decay=0.5)


def tiny_batch(seed=0, b=2, tc=TC):
    rng = np.random.default_rng(seed)
    return {"audio": (rng.standard_normal((b, tc * HOP)) * 0.2
                      ).astype(np.float32),
            "code": rng.integers(0, 12, size=(b, tc)).astype(np.int32),
            "spkr": np.arange(b, dtype=np.int32) % 2}


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def rel_err(got: dict, want: dict) -> float:
    num = sum(float((got[k] - want[k]).double().pow(2).sum()) for k in want)
    den = sum(float(want[k].double().pow(2).sum()) for k in want)
    return (num / den) ** 0.5


@functools.lru_cache(maxsize=None)
def port_state_dicts(seed=0):
    """The port's seeded init (generator, MPD, MSD state dicts)."""
    st = voc_train.init_state(seed, VocoderModelConfig(**TINY), "cpu")
    return tuple({k: v.clone() for k, v in m.state_dict().items()}
                 for m in (st.gen, st.mpd, st.msd))


@functools.lru_cache(maxsize=None)
def tiny_state():
    """A seeded port state that no test changes."""
    return voc_train.init_state(0, VocoderModelConfig(**TINY), "cpu")


def jax_disc_params():
    """The port's seeded MPD and MSD, read by the JAX package's converters
    (the reference state_dict keys)."""
    _, mpd, msd = port_state_dicts()
    return (jax_convert.mpd_params_from_torch(mpd),
            jax_convert.msd_params_from_torch(msd))


def port_discs():
    _, mpd_sd, msd_sd = port_state_dicts()
    mpd, msd = disc.MultiPeriodDiscriminator(), disc.MultiScaleDiscriminator()
    mpd.load_state_dict(mpd_sd, strict=True)
    msd.load_state_dict(msd_sd, strict=True)
    return mpd, msd


def at_count(opt_state, n):
    """An optax chain state with every count (Adam's, the schedule's) at
    n."""
    return tuple(part._replace(count=jnp.asarray(n, jnp.int32))
                 if "count" in getattr(part, "_fields", ()) else part
                 for part in opt_state)


@pytest.fixture(scope="module")
def jax_step():
    """A JAX VocoderTrainState at step SPE - 1 with zero moments made from
    the port's init, and the state and metrics after one JAX train_step
    on tiny_batch()."""
    jm = jax_config.VocoderModelConfig(**TINY)
    jt = jax_config.VocoderTrainConfig(**STEP_CFG)
    g_sd, _, _ = port_state_dicts()
    g = jax_convert.generator_params_from_torch(g_sd, jm)
    mpd, msd = jax_disc_params()
    opt_g, opt_d = jax_train.make_optimizers(jt, SPE)
    start = jax_train.VocoderTrainState(
        gen_params=g, mpd_params=mpd, msd_params=msd,
        opt_g_state=at_count(opt_g.init(g), SPE - 1),
        opt_d_state=at_count(opt_d.init((mpd, msd)), SPE - 1),
        step=jnp.asarray(SPE - 1, jnp.int32))
    start = jax.tree_util.tree_map(np.asarray, start)
    end, metrics = jax_train.train_step(
        jax.tree_util.tree_map(jnp.asarray, start),
        {k: jnp.asarray(v) for k, v in tiny_batch().items()}, jm, jt,
        jax_config.MelConfig(**MEL), SPE)
    return (start, jax.tree_util.tree_map(np.asarray, end),
            {k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("n_fft,win", [(64, 64), (64, 48), (64, 32)])
def test_stft_and_mel_match_jax(n_fft, win):
    y = tiny_batch(1)["audio"]
    want = jax_stft.stft_magnitude(jnp.asarray(y), n_fft, HOP, win,
                                   pad=(n_fft - HOP) // 2)
    got = stft.stft_magnitude(torch.from_numpy(y), n_fft, HOP, win)
    assert got.shape == want.shape
    close(got, want)
    kw = dict(n_fft=n_fft, num_mels=8, hop_size=HOP, win_size=win, fmax=None)
    close(stft.mel_spectrogram(torch.from_numpy(y), **kw),
          jax_stft.mel_spectrogram(jnp.asarray(y), **kw))


def test_reflect_pad_is_numpy_reflect():
    x = torch.arange(10.0).reshape(1, 10)
    for left, right in ((3, 2), (0, 4), (5, 0), (0, 0)):
        np.testing.assert_array_equal(
            conv_ops.reflect_pad(x, left, right).numpy(),
            np.pad(x.numpy(), ((0, 0), (left, right)), mode="reflect"))
    with pytest.raises(ValueError):
        conv_ops.reflect_pad(x, 10, 0)


@pytest.mark.parametrize("update", [True, False])
def test_sn_resolve_matches_jax(update):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((5, 3, 7)).astype(np.float32)   # (K, I, O)
    u = rng.standard_normal(7).astype(np.float32)
    v = rng.standard_normal(15).astype(np.float32)
    wk, new = jax_wn.sn_resolve({"w": jnp.asarray(w), "u": jnp.asarray(u),
                                 "sn_v": jnp.asarray(v)}, update=update)
    got, pu, pv = weight_norm.sn_resolve(
        torch.from_numpy(w.transpose(2, 1, 0).copy()), torch.from_numpy(u),
        torch.from_numpy(v), update=update)
    close(got.permute(2, 1, 0), wk)
    close(pu, new["u"])
    close(pv, new["sn_v"])


def _inputs(seed=3, b=2, t=TC * HOP):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, t, 1)) * 0.3).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("stacked", [False, True])
def test_mpd_matches_jax(stacked):
    y, y_hat = _inputs()
    mpd_p, _ = jax_disc_params()
    want = jax.jit(functools.partial(jax_disc.apply_mpd, stacked=stacked))(
        mpd_p, jnp.asarray(y), jnp.asarray(y_hat))
    mpd, _ = port_discs()
    with torch.no_grad():
        got = disc.apply_mpd(mpd, torch.from_numpy(y),
                             torch.from_numpy(y_hat), stacked=stacked)
    for s_got, s_want in zip(got[0] + got[1], want[0] + want[1]):
        close(s_got, s_want)
    n = 0
    for fg, fw in zip(got[2] + got[3], want[2] + want[3]):
        for a, b in zip(fg, fw):            # NCHW against NHWC
            close(a.permute(0, 2, 3, 1), b)
            n += 1
    assert n == 2 * 5 * 6


@pytest.mark.parametrize("stacked", [False, True])
def test_msd_matches_jax(stacked):
    y, y_hat = _inputs(4)
    _, msd_p = jax_disc_params()
    want = jax.jit(functools.partial(jax_disc.apply_msd, update_sn=True,
                                     stacked=stacked))(
        msd_p, jnp.asarray(y), jnp.asarray(y_hat))
    _, msd = port_discs()
    with torch.no_grad():
        got = disc.apply_msd(msd, torch.from_numpy(y),
                             torch.from_numpy(y_hat), update_sn=True,
                             stacked=stacked)
    for s_got, s_want in zip(got[0] + got[1], want[0] + want[1]):
        close(s_got, s_want)
    for fg, fw in zip(got[2] + got[3], want[2] + want[3]):
        for a, b in zip(fg, fw):            # NCW against NWC
            close(a.transpose(1, 2), b)
    # the power-iteration state after the call (two advances)
    new = msd_state_from_jax(jax.tree_util.tree_map(np.asarray, want[4]))
    sd = msd.state_dict()
    keys = [k for k in new if k.startswith("discriminators.0.")
            and k.endswith(("weight_u", "weight_v"))]
    assert len(keys) == 16
    for k in keys:
        close(sd[k], new[k], rtol=0, atol=1e-5)
        if sd[k].numel() > 1:                # conv_post's u is (1,): 1.0
            assert not torch.equal(sd[k], port_state_dicts()[2][k])


def test_losses_match_jax():
    rng = np.random.default_rng(5)

    def maps(n):
        return [[rng.standard_normal((2, 3, 4 + i)).astype(np.float32)
                 for i in range(n)] for _ in range(3)]

    fr, fg = maps(4), maps(4)
    def t(fm):
        return [[torch.from_numpy(x) for x in d] for d in fm]

    def j(fm):
        return [[jnp.asarray(x) for x in d] for d in fm]

    close(losses.feature_loss(t(fr), t(fg)),
          jax_losses.feature_loss(j(fr), j(fg)))
    dr = [rng.standard_normal((2, 7 + i)).astype(np.float32) for i in range(5)]
    dg = [rng.standard_normal((2, 7 + i)).astype(np.float32) for i in range(5)]
    got = losses.discriminator_loss([torch.from_numpy(x) for x in dr],
                                    [torch.from_numpy(x) for x in dg])
    want = jax_losses.discriminator_loss([jnp.asarray(x) for x in dr],
                                         [jnp.asarray(x) for x in dg])
    close(got[0], want[0])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        close(a, b)
    got = losses.generator_loss([torch.from_numpy(x) for x in dg])
    want = jax_losses.generator_loss([jnp.asarray(x) for x in dg])
    close(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        close(a, b)
    m1, m2 = (rng.standard_normal((2, 9, 8)).astype(np.float32)
              for _ in range(2))
    close(losses.mel_l1_loss(torch.from_numpy(m1), torch.from_numpy(m2)),
          jax_losses.mel_l1_loss(jnp.asarray(m1), jnp.asarray(m2)))


def test_exponential_schedule_matches_jax():
    spe = 7
    want = jax_schedules.exponential_epoch_schedule(2e-4, 0.999, spe)
    got = schedules.exponential_epoch_schedule(2e-4, 0.999, spe)
    for step in (0, spe - 1, spe, 3 * spe):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    assert got(spe - 1) == 2e-4 and got(spe) < 2e-4


def test_adamw_update_matches_optax():
    """The same gradients into the port's AdamW and optax.adamw, three
    updates across an epoch boundary."""
    rng = np.random.default_rng(6)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    tcfg = VocoderTrainConfig(learning_rate=1e-2)
    jopt, _ = jax_train.make_optimizers(
        jax_config.VocoderTrainConfig(learning_rate=1e-2), 2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opts = voc_train.make_optimizers([tp["a"]], [tp["b"]])
    for count in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in
                                   grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        voc_train.set_hyperparameters(opts, tcfg, 2, count)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        for opt in opts:
            opt.step()
        for k in tp:
            close(tp[k].detach(), jp[k], rtol=0, atol=1e-6)


def update_err(got: dict, want: dict, start: dict) -> float:
    """|dp_got - dp_want| / |dp_want| of the updates dp = p - start."""
    return rel_err({k: got[k] - start[k] for k in want},
                   {k: want[k] - start[k] for k in want})


def test_train_step_matches_jax(jax_step, monkeypatch):
    """One full GAN step from the same state: metrics, gradients of all
    three networks, the updated networks and second moments, and the
    spectral-norm vectors after four power iterations (two per MSD call,
    two calls)."""
    start, end, want_metrics = jax_step
    mcfg = VocoderModelConfig(**TINY)
    state = voc_train.init_state(1, mcfg, "cpu")   # overwritten entirely
    first = vocoder_train_state_from_jax(start, mcfg)
    state.load_state_dict(first)
    advances: dict = {}
    real = weight_norm.sn_power_iteration

    def counted(w, u, *args):
        advances[w.data_ptr()] = advances.get(w.data_ptr(), 0) + 1
        return real(w, u, *args)

    monkeypatch.setattr(weight_norm, "sn_power_iteration", counted)
    monkeypatch.setattr(disc, "sn_power_iteration", counted)
    metrics = voc_train.train_step(
        state, voc_train.to_batch(tiny_batch(), "cpu"), mcfg,
        VocoderTrainConfig(**STEP_CFG), MelConfig(**MEL), SPE)
    assert sorted(advances.values()) == [4] * 8
    assert state.step == SPE
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5)
    want = vocoder_train_state_from_jax(end, mcfg)
    got = state.state_dict()
    assert got["step"] == want["step"] == SPE
    # gradients (from zero moments, mu = (1 - b1) g) and second moments
    # (nu = (1 - b2) g^2, so twice the gradients' relative error)
    for part, bound in (("mu", 1e-4), ("nu", 2e-4)):
        nets = {"G": (got[f"{part}_g"], want[f"{part}_g"])}
        for net in ("mpd", "msd"):
            nets[net] = tuple({k: d[k] for k in d if k.startswith(net)}
                              for d in (got[f"{part}_d"], want[f"{part}_d"]))
        for net, (g, w) in nets.items():
            assert g.keys() == w.keys()
            assert rel_err(g, w) <= bound, (part, net)
    # the updated networks. The generator's parameters within 1e-6; the
    # discriminators' updates in norm: where a gradient is as small as
    # AdamW's eps (1e-8) the update g / (|g| + eps) turns float32
    # rounding of g into an error of up to ~1e-2 of lr in that element
    for k, w in want["gen"].items():
        close(got["gen"][k], w, rtol=0, atol=1e-6)
    for net in ("mpd", "msd"):
        names = {k[len(net) + 1:] for k in want["mu_d"]
                 if k.startswith(net + ".")}
        assert names and names <= want[net].keys()
        err = update_err(*({k: d[k] for k in names}
                           for d in (got[net], want[net], first[net])))
        assert err <= 1e-4, (net, err)
    sn = [k for k in want["msd"] if k.startswith("discriminators.0.")
          and k.endswith(("weight_u", "weight_v"))]
    for k in sn:
        close(got["msd"][k], want["msd"][k], rtol=0, atol=1e-5)


def test_jax_converters_read_the_port_state():
    """Port state -> the JAX package's converters -> the port's converters
    gives the same state, spectral-norm buffers included."""
    _, mpd, msd = port_state_dicts()
    back = (mpd_state_from_jax(jax.tree_util.tree_map(
                np.asarray, jax_convert.mpd_params_from_torch(mpd))),
            msd_state_from_jax(jax.tree_util.tree_map(
                np.asarray, jax_convert.msd_params_from_torch(msd))))
    for sd, rt in zip((mpd, msd), back):
        assert sd.keys() == rt.keys()
        for k in sd:
            assert torch.equal(sd[k], rt[k]), k


def test_val_step_matches_jax():
    mcfg = VocoderModelConfig(**TINY)
    g_sd, _, _ = port_state_dicts()
    state = voc_train.init_state(0, mcfg, "cpu")
    b = tiny_batch(7)
    mel_cfg = MelConfig(**MEL)
    batch = voc_train.to_batch(b, "cpu")
    batch["mel"] = voc_train.loss_mel(batch["audio"], mel_cfg)
    got = voc_train.val_step(state.gen, batch, mcfg, mel_cfg)
    jm = jax_config.VocoderModelConfig(**TINY)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jb["mel"] = jnp.asarray(batch["mel"].numpy())
    want = jax_train.val_step(jax_convert.generator_params_from_torch(
        g_sd, jm), jb, jm, jax_config.MelConfig(**MEL))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_bf16_disc_step_updates_all_networks():
    """disc_dtype=bfloat16: finite metrics, all three networks move, the
    parameters and moments stay float32."""
    mcfg = VocoderModelConfig(**TINY)
    state = voc_train.init_state(0, mcfg, "cpu")
    before = [next(m.parameters()).detach().clone()
              for m in (state.gen, state.mpd, state.msd)]
    metrics = voc_train.train_step(
        state, voc_train.to_batch(tiny_batch(), "cpu"), mcfg,
        VocoderTrainConfig(learning_rate=LR, disc_dtype="bfloat16"),
        MelConfig(**MEL), SPE)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for b, m in zip(before, (state.gen, state.mpd, state.msd)):
        assert not torch.equal(b, next(m.parameters()))
    assert all(p.dtype == torch.float32 for p in state.d_params().values())
    assert all(v.dtype == torch.float32
               for v in state.moments()["mu_d"].values())


def write_wav_corpus(root, n_train=5, n_val=2, seed=8):
    """16 kHz wavs of 0.6-2.5 segments' length (short ones take the
    repeat-pad path) over two speakers, and train/val manifests of random
    codes at HOP samples per code (a few codes more or fewer than the
    audio holds)."""
    rng = np.random.default_rng(seed)
    seg = TC * HOP
    for split, n in (("train", n_train), ("val", n_val)):
        entries = []
        for i in range(n):
            spk = ("en_f", "en_m")[i % 2]
            path = root / "wavs" / f"{spk}_{split}_{i:03d}.wav"
            n_samp = int(rng.integers(int(0.6 * seg), int(2.5 * seg)))
            write_wav(path, rng.uniform(-0.5, 0.5, n_samp), 16000)
            n_code = n_samp // HOP + int(rng.integers(-2, 3))
            entries.append({"audio": str(path), "hubert": " ".join(
                map(str, rng.integers(0, 12, n_code)))})
        write_manifest(root / f"{split}.txt", entries)
    return root


def test_loader_yields_the_jax_batches(tmp_path):
    root = write_wav_corpus(tmp_path)
    kw = dict(segment_size=TC * HOP, code_hop_size=HOP)
    pds = vocoder_data.VocoderDataset(root / "train.txt", **kw)
    jds = jax_vocoder_data.VocoderDataset(root / "train.txt", **kw)
    assert pds.spkr_to_id == jds.spkr_to_id == {"en_f": 0, "en_m": 1}
    for batch_size, procs in ((2, 1), (8, 2)):   # 8 > 5 items: np.resize
        for index in range(procs):
            args = dict(seed=3, process_index=index, process_count=procs)
            pl = vocoder_data.VocoderLoader(pds, batch_size, **args)
            jl = jax_vocoder_data.VocoderLoader(jds, batch_size, **args)
            for epoch in (0, 1):
                got, want = list(pl.batches(epoch)), list(jl.batches(epoch))
                assert len(got) == len(want) >= 1
                for g, w in zip(got, want):
                    assert g.keys() == w.keys()
                    assert g["filenames"] == w["filenames"]
                    for k in ("audio", "code", "spkr"):
                        assert g[k].dtype == w[k].dtype
                        np.testing.assert_array_equal(g[k], w[k])


def tiny_pipeline(**train):
    train = {"checkpoint_interval": 1, **train}
    return PipelineConfig(
        mel=MelConfig(**MEL), vocoder_model=VocoderModelConfig(**TINY),
        vocoder_train=VocoderTrainConfig(
            batch_size=2, learning_rate=LR, segment_size=TC * HOP,
            code_hop_size=HOP, summary_interval=1, validation_interval=2,
            **train))


def test_pipeline_trains_checkpoints_crashes_and_resumes(tmp_path,
                                                         monkeypatch):
    """A crash at step 2 right after its checkpoint, a resumed run to step
    3, then a run with resume=False that starts from step 0."""
    root = write_wav_corpus(tmp_path)
    cfg = tiny_pipeline(checkpoint_interval=2)
    run_dir = tmp_path / "run"
    starts = []
    real = voc_train.train_step

    def spy(state, *args, **kwargs):
        starts.append(state.step)
        spy.state = state
        return real(state, *args, **kwargs)

    monkeypatch.setattr(voc_train, "train_step", spy)
    with pytest.raises(RuntimeError, match="simulated crash"):
        train_vocoder.run(cfg, data_dir=root, run_dir=run_dir,
                          crash_at_step=2, device="cpu")
    assert starts == [0, 1]
    mgr = CheckpointManager(run_dir / "ckpt")
    assert mgr.latest_step() == 2
    saved, live = mgr.restore(), spy.state.state_dict()
    for part in ("gen", "mpd", "msd", "mu_g", "nu_g", "mu_d", "nu_d"):
        assert saved[part].keys() == live[part].keys()
        for k, v in live[part].items():
            assert torch.equal(saved[part][k], v), (part, k)
    assert saved["step"] == 2
    fresh = voc_train.init_state(5, cfg.vocoder_model, "cpu")
    fresh.load_state_dict(saved)
    assert all(torch.equal(a, b) for a, b in zip(
        fresh.msd.buffers(), spy.state.msd.buffers()))

    starts.clear()
    out = train_vocoder.run(cfg, data_dir=root, run_dir=run_dir,
                            max_steps=3, device="cpu")
    assert out == {"steps": 3, "epochs": 2} and starts == [2]
    assert mgr.latest_step() == 3 and mgr.restore()["step"] == 3
    logs = run_dir / "logs"
    tags = [json.loads(line)["tag"]
            for line in (logs / "metrics.jsonl").read_text().splitlines()]
    assert tags.count("loss_gen_all") == 3
    assert tags.count("train_audio_seconds_per_second") == 3
    assert tags.count("validation/mel_spec_error") == 1
    assert sorted(p.name for p in (logs / "audio").iterdir()) == [
        "generated_y_hat_0_2.wav", "generated_y_hat_1_2.wav"]
    assert json.loads((run_dir / "ckpt" / "config.json").read_text())[
        "upsample_initial_channel"] == 16

    starts.clear()
    out = train_vocoder.run(cfg, data_dir=root, run_dir=run_dir,
                            max_steps=1, resume=False, device="cpu")
    assert out["steps"] == 1 and starts == [0]
    shutil.rmtree(run_dir)        # ~0.85 GB per checkpoint: the discriminators


def test_pipeline_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_vocoder.run(PipelineConfig(), data_dir=tmp_path)


@pytest.mark.parametrize("change,error", [
    (dict(quant="int8"), ValueError), (dict(quant="int8-static"), ValueError),
    (dict(fused_mrf=True), ValueError), (dict(f0=True), NotImplementedError)])
def test_untrainable_configs_raise(change, error):
    mcfg = dataclasses.replace(VocoderModelConfig(**TINY), **change)
    with pytest.raises(error):
        voc_train.init_state(0, mcfg, "cpu")
    state = tiny_state()
    with pytest.raises(error):
        voc_train.train_step(state, voc_train.to_batch(tiny_batch(), "cpu"),
                             mcfg, VocoderTrainConfig(), MelConfig(**MEL), 1)


def test_loader_refuses_f0(tmp_path):
    root = write_wav_corpus(tmp_path, n_train=1, n_val=1)
    ds = vocoder_data.VocoderDataset(root / "train.txt",
                                     segment_size=TC * HOP, code_hop_size=HOP)
    with pytest.raises(NotImplementedError):
        vocoder_data.VocoderLoader(ds, 2, with_f0=True)


def test_port_vocoder_configs_match_jax():
    """The port's copies keep the JAX defaults and names; the port's
    MelConfig leaves out `center`, which no trainer reads."""
    def mel_fields(cfg):
        return {k: v for k, v in dataclasses.asdict(cfg).items()
                if k != "center"}

    p, jp = PipelineConfig(), jax_config.PipelineConfig()
    for mine, theirs in ((VocoderTrainConfig(),
                          jax_config.VocoderTrainConfig()),
                         (p.vocoder_train, jp.vocoder_train)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for mine, theirs in ((MelConfig(), jax_config.MelConfig()),
                         (p.mel, jp.mel)):
        assert dataclasses.asdict(mine) == mel_fields(theirs)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def adamw_expected(start: dict, mu: dict, nu: dict, count: int,
                   cfg: VocoderTrainConfig) -> dict:
    """optax.adamw's parameters after the update that left moments mu, nu
    (the update after `count` updates, in epoch 0), in float64."""
    bc1, bc2 = 1 - cfg.adam_b1 ** (count + 1), 1 - cfg.adam_b2 ** (count + 1)
    return {k: start[k].double() - cfg.learning_rate * (
        (mu[k].double() / bc1) / ((nu[k].double() / bc2).sqrt() + 1e-8)
        + 0.01 * start[k].double()) for k in mu}


@pytest.mark.cuda
def test_gan_step_on_card(cuda_device):
    """The tiny GAN step on the card (IEEE float32) against the CPU port
    from the same state: metrics within 1e-4, each network's gradients
    |dg|/|g| <= 1e-3 and second moments 2e-3, the spectral-norm vectors
    within 1e-5; and every updated parameter on the card equal to optax's
    AdamW update from the card's own moments, within 4 float32 ulps of
    the parameter and 1e-6 of the update (its float32 arithmetic)."""
    mcfg, mel_cfg = VocoderModelConfig(**TINY), MelConfig(**MEL)
    tcfg = VocoderTrainConfig(**STEP_CFG)
    first = tiny_state().state_dict()
    out = []
    for device in ("cpu", cuda_device):
        state = voc_train.init_state(0, mcfg, device)
        metrics = voc_train.train_step(
            state, voc_train.to_batch(tiny_batch(), device), mcfg, tcfg,
            mel_cfg, SPE, exact=True)
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: {n: t.cpu() for n, t in v.items()}
                     if isinstance(v, dict) else v
                     for k, v in state.state_dict().items()}))
    (m_cpu, s_cpu), (m_gpu, s_gpu) = out
    for k in m_cpu:
        np.testing.assert_allclose(m_gpu[k], m_cpu[k], rtol=1e-4)
    for part, bound in (("mu_g", 1e-3), ("mu_d", 1e-3), ("nu_g", 2e-3),
                        ("nu_d", 2e-3)):
        assert rel_err(s_gpu[part], s_cpu[part]) <= bound, part
    for net, tag, prefix in (("gen", "g", ""), ("mpd", "d", "mpd."),
                             ("msd", "d", "msd.")):
        mu, nu = ({k[len(prefix):]: v for k, v in s_gpu[f"{m}_{tag}"].items()
                   if k.startswith(prefix)} for m in ("mu", "nu"))
        want = adamw_expected(first[net], mu, nu, 0, tcfg)
        for k, w in want.items():
            p0 = first[net][k].double()
            tol = (4 * np.spacing(np.maximum(p0.abs(), w.abs()).float()
                                  .numpy()) + 1e-6 * (w - p0).abs().numpy())
            err = (s_gpu[net][k].double() - w).abs().numpy()
            assert (err <= tol).all(), (net, k, float((err / tol).max()))
    for k, v in s_cpu["msd"].items():
        if k.startswith("discriminators.0.") and k.endswith(
                ("weight_u", "weight_v")):
            np.testing.assert_allclose(s_gpu["msd"][k], v, atol=1e-5)
