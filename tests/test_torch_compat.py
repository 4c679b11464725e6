"""The port's reference-checkpoint loaders (parrot_tts_tpu_torch.compat)
against the JAX package's (parrot_tts_tpu.compat, which needs torch only).

The reference mount is absent here, so the four reference-format
checkpoints are written in-process from seeded port modules, in the
reference's layouts: a Lightning .ckpt with "parrot."-prefixed keys and
hyper-parameters, a vocoder `g_<step>` ({'generator': sd}) and
`do_<step>` ({'mpd', 'msd', 'optim_g', 'optim_d', 'steps', 'epoch'}), and
an aligner checkpoint ({'model', 'optim', 'config', 'symbols'}) whose LSTM
has two biases per direction, as torch trains them. Each is loaded
through both packages and the outputs compared on the same input at the
existing parity tests' tolerances.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu import compat as jax_compat
from parrot_tts_tpu.models.tte import parrot as jax_parrot
from parrot_tts_tpu.models.vocoder import discriminator as jax_disc
from parrot_tts_tpu.models.vocoder import generator as jax_gen
from parrot_tts_tpu.train import aligner as jax_atrain
from parrot_tts_tpu_torch import compat
from parrot_tts_tpu_torch.convert import msd_state_from_jax, tte_state_from_jax
from parrot_tts_tpu_torch.core.config import AlignerModelConfig
from parrot_tts_tpu_torch.models.aligner import model as amodel
from parrot_tts_tpu_torch.models.tte import parrot
from parrot_tts_tpu_torch.models.vocoder import discriminator as disc
from parrot_tts_tpu_torch.models.vocoder import generator as gen
from parrot_tts_tpu_torch.train import aligner as atrain

from tests import test_torch_gan as gan_t
from tests import test_torch_tte as tte_t
from tests import test_torch_vocoder as voc_t


def test_tte_lightning_ckpt(tmp_path, rng):
    """Decode within test_torch_tte's tolerances: durations and masks
    equal, codes equal where JAX's top-2 margin exceeds 1e-3."""
    jcfg, tcfg = tte_t.configs()
    sd = tte_state_from_jax(tte_t.jax_params(jcfg), tcfg)
    path = tmp_path / "epoch=0-step=11000.ckpt"
    torch.save({"state_dict": {f"parrot.{k}": v for k, v in sd.items()},
                "hyper_parameters": {"note": "test"}, "epoch": 0}, path)
    model, hp = compat.load_tte_lightning_ckpt(path, tcfg, device="cpu")
    params, jhp = jax_compat.load_tte_lightning_ckpt(path, jcfg)
    assert hp == jhp == {"note": "test"}
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())
    # a plain Parrot state_dict loads too
    torch.save(sd, tmp_path / "plain.pt")
    plain, none = compat.load_tte_lightning_ckpt(tmp_path / "plain.pt", tcfg,
                                                 device="cpu")
    assert none is None and plain.state_dict().keys() == sd.keys()

    batch = tte_t.make_batch(rng, [14, 9, 3], 16, tte_t.CFG["vocab_size"],
                             tte_t.CFG["n_speaker"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        j_logits, j_mask, _ = jax_parrot.apply_parrot(
            params, jb, jcfg, out_len=128, inference=True)
    j_codes, _, j_total = jax_parrot.infer_codes(params, jb, jcfg,
                                                 out_len=128, exact=True)
    codes, mask, total = parrot.infer_codes(model, batch, out_len=128,
                                            device="cpu")
    j_logits, j_mask = np.asarray(j_logits), np.asarray(j_mask)
    np.testing.assert_array_equal(mask.numpy(), j_mask)
    np.testing.assert_array_equal(total.numpy(), np.asarray(j_total))
    assert j_mask.sum() > 20
    top2 = np.sort(j_logits, axis=-1)[..., -2:]
    clear = j_mask & (top2[..., 1] - top2[..., 0] > 1e-3)
    np.testing.assert_array_equal(codes.numpy()[clear],
                                  np.asarray(j_codes)[clear])


def test_vocoder_generator_ckpt(tmp_path, rng):
    """The weight-norm generator (weight_g / weight_v) of a `g_<step>`
    file: waveforms within test_torch_vocoder's 2e-5."""
    jcfg, tcfg, _, model = voc_t.build(seed=3)
    torch.save({"generator": model.state_dict()}, tmp_path / "g_00750000")
    got_model = compat.load_vocoder_generator_ckpt(tmp_path / "g_00750000",
                                                   tcfg, device="cpu")
    assert any(k.endswith("weight_g") for k in got_model.state_dict())
    params = jax_compat.load_vocoder_generator_ckpt(tmp_path / "g_00750000",
                                                    jcfg)
    code = rng.integers(0, voc_t.SMALL["num_embeddings"], size=(2, 30))
    spkr = np.array([1, 3], np.int32)
    want = np.asarray(jax_gen.apply_code_generator(
        params, jnp.asarray(code), jnp.asarray(spkr), jcfg))
    got = gen.apply_code_generator(got_model, code, spkr, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_vocoder_discriminator_ckpt(tmp_path):
    """MPD and MSD (spectral norm as weight_orig / weight_u / weight_v)
    of a `do_<step>` file: every score within test_torch_gan's 1e-5
    relative, and the MSD's power-iteration vectors after the call within
    1e-5."""
    _, mpd_sd, msd_sd = gan_t.port_state_dicts(seed=2)
    path = tmp_path / "do_00001234"
    torch.save({"mpd": mpd_sd, "msd": msd_sd, "optim_g": {}, "optim_d": {},
                "steps": 1234, "epoch": 5}, path)
    mpd, msd, meta = compat.load_vocoder_discriminator_ckpt(path,
                                                            device="cpu")
    mpd_p, msd_p, jmeta = jax_compat.load_vocoder_discriminator_ckpt(path)
    assert meta == jmeta == {"steps": 1234, "epoch": 5}
    assert "discriminators.0.convs.0.weight_orig" in msd.state_dict()
    y, y_hat = gan_t._inputs()
    with torch.no_grad():
        got_p = disc.apply_mpd(mpd, torch.from_numpy(y),
                               torch.from_numpy(y_hat))
        got_s = disc.apply_msd(msd, torch.from_numpy(y),
                               torch.from_numpy(y_hat), update_sn=True)
    want_p = jax_disc.apply_mpd(mpd_p, jnp.asarray(y), jnp.asarray(y_hat))
    want_s = jax_disc.apply_msd(msd_p, jnp.asarray(y), jnp.asarray(y_hat),
                                update_sn=True)
    for got, want in ((got_p, want_p), (got_s, want_s)):
        assert len(got[0]) == len(want[0]) > 0
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            gan_t.close(a, b)
    new = msd_state_from_jax(jax.tree_util.tree_map(np.asarray, want_s[4]))
    sd = msd.state_dict()
    keys = [k for k in new if k.endswith(("weight_u", "weight_v"))
            and k.startswith("discriminators.0.")]
    assert keys
    for k in keys:
        gan_t.close(sd[k], new[k], rtol=0, atol=1e-5)


def test_aligner_ckpt(tmp_path, rng):
    """The reference's LSTM keeps bias_ih and bias_hh; the port sums them
    into bias_ih (bias_hh held at 0), the JAX package into its one bias:
    eval posteriors within test_torch_aligner's 1e-6."""
    cfg = AlignerModelConfig(n_mels=8, conv_dim=16, lstm_dim=8,
                             num_symbols=12)
    sd = amodel.init_aligner(cfg, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    for name in amodel.FROZEN:            # torch's second bias, not zero
        sd[name] = torch.rand(sd[name].shape, generator=g) - 0.5
    for i in range(3):                    # trained BN statistics
        sd[f"convs.{i}.bnorm.running_mean"] = torch.rand(16, generator=g)
        sd[f"convs.{i}.bnorm.running_var"] = 0.5 + torch.rand(16, generator=g)
    symbols = ["_", "a", "b"]
    path = tmp_path / "aligner.pt"
    torch.save({"model": sd, "optim": {}, "config": {"n_mels": 8},
                "symbols": symbols}, path)
    model, config, syms = compat.load_aligner_ckpt(path, device="cpu")
    assert model.cfg == cfg and config == {"n_mels": 8} and syms == symbols
    got_sd = model.state_dict()
    for name in amodel.FROZEN:
        ih = name.replace("bias_hh", "bias_ih")
        assert torch.equal(got_sd[name], torch.zeros_like(sd[name]))
        assert torch.equal(got_sd[ih], sd[ih] + sd[name])
    params, bn, jconfig, jsyms = jax_compat.load_aligner_ckpt(path)
    assert jconfig == config and jsyms == symbols
    mel = rng.standard_normal((2, 64, 8)).astype(np.float32)
    want = jax_atrain.posteriors(params, bn, jnp.asarray(mel))
    got = atrain.posteriors(model, torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
