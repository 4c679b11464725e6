"""Port aligner (parrot_tts_tpu_torch.{models.aligner, ops.ctc,
train.aligner, ops.stft.librosa_mel_spectrogram, data.aligner_data})
against the JAX package at a tiny config, on the same numpy-seeded inputs
with the JAX weights carried by `aligner_state_from_jax`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.core.config import AlignerModelConfig as JaxModelConfig
from parrot_tts_tpu.core.config import AlignerTrainConfig as JaxTrainConfig
from parrot_tts_tpu.data import aligner_data as jax_data
from parrot_tts_tpu.models.aligner import model as jax_model
from parrot_tts_tpu.ops import ctc as jax_ctc
from parrot_tts_tpu.ops import stft as jax_stft
from parrot_tts_tpu.train import aligner as jax_train
from parrot_tts_tpu_torch.convert import aligner_state_from_jax
from parrot_tts_tpu_torch.core.config import (AlignerModelConfig,
                                              AlignerTrainConfig,
                                              aligner_configs_from_json,
                                              aligner_configs_to_json)
from parrot_tts_tpu_torch.data import aligner_data
from parrot_tts_tpu_torch.models.aligner import model as amodel
from parrot_tts_tpu_torch.ops import ctc, stft
from parrot_tts_tpu_torch.train import aligner as atrain

MODEL = dict(n_mels=8, conv_dim=16, lstm_dim=8, num_symbols=12)
TRAIN = dict(learning_rate=1e-3, batch_size=3, grad_clip=1.0,
             mel_bucket_sizes=(32, 64), token_bucket_sizes=(8, 16))
LR = TRAIN["learning_rate"]


def jax_start(seed=0):
    params, bn = jax_model.init_aligner(jax.random.key(seed),
                                        JaxModelConfig(**MODEL))
    return params, bn


def port_model(params, bn) -> amodel.Aligner:
    m = amodel.Aligner(AlignerModelConfig(**MODEL))
    m.load_state_dict(aligner_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params), bn), strict=True)
    return m


def make_batch(rng, t=64, l=10, b=3):
    """Ragged lengths, every row with enough frames for its labels."""
    mel_lengths = np.asarray([t, t - 9, t - 23][:b], np.int32)
    token_lengths = np.asarray([l, l - 3, l - 5][:b], np.int32)
    tokens = np.zeros((b, l), np.int32)
    for i, n in enumerate(token_lengths):
        tokens[i, :n] = rng.integers(1, MODEL["num_symbols"], n)
    return {"mel": rng.standard_normal((b, t, MODEL["n_mels"])).astype(
                np.float32),
            "mel_lengths": mel_lengths, "tokens": tokens,
            "token_lengths": token_lengths}


def bn_stats(model):
    return [(model.convs[i].bnorm.running_mean.detach().numpy(),
             model.convs[i].bnorm.running_var.detach().numpy())
            for i in range(3)]


@pytest.mark.parametrize("train", [False, True])
def test_aligner_forward_and_bn_stats_match_jax(rng, train):
    """Logits within 1e-5 (float32 on both sides; the LSTM runs 64 steps),
    and in training mode the new BN running statistics within 1e-6."""
    params, bn = jax_start()
    model = port_model(params, bn)
    mel = rng.standard_normal((3, 40, MODEL["n_mels"])).astype(np.float32)
    want, new_bn = jax_model.apply_aligner(params, bn, jnp.asarray(mel),
                                           train=train)
    with torch.no_grad():
        got = amodel.apply_aligner(model, torch.from_numpy(mel), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for (mean, var), st in zip(bn_stats(model), new_bn["bns"]):
        np.testing.assert_allclose(mean, np.asarray(st.mean), atol=1e-6)
        np.testing.assert_allclose(var, np.asarray(st.var), atol=1e-6,
                                   rtol=1e-6)
    assert model.training     # apply_aligner leaves the mode as it was


def test_state_round_trips_through_jax_converter():
    """aligner_state_from_jax -> the JAX package's params_from_torch gives
    the JAX tree back exactly (the summed LSTM bias plus zeros)."""
    params, bn = jax_start(3)
    sd = aligner_state_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                bn)
    amodel.Aligner(AlignerModelConfig(**MODEL)).load_state_dict(sd,
                                                                strict=True)
    back, back_bn = jax_model.params_from_torch(sd)
    for a, b in zip(jax.tree_util.tree_leaves((back, back_bn)),
                    jax.tree_util.tree_leaves((params, bn))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_seeded_init_loads_and_repeats():
    cfg = AlignerModelConfig(**MODEL)
    a = amodel.init_aligner(cfg, torch.Generator().manual_seed(5))
    b = amodel.init_aligner(cfg, torch.Generator().manual_seed(5))
    amodel.Aligner(cfg).load_state_dict(a, strict=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not a["rnn.bias_hh_l0"].any()
    trained = atrain.trained(amodel.Aligner(cfg))
    assert "rnn.bias_hh_l0" not in trained and "rnn.bias_ih_l0" in trained


def test_ctc_loss_and_gradient_match_optax(rng):
    """The mean CTC loss within 1e-6 relative of JAX's (optax) over ragged
    rows, a repeated label, and a row too short for its labels: (T=4,
    labels [1, 1, 1]) needs 5 frames, so optax's log(0) = -1e5 gives a
    finite ~1e5 / 3, which the port matches where torch's own ctc_loss
    gives inf. The gradient with respect to the logits within 1e-6 of
    JAX's on the feasible rows. On the infeasible row the log-alphas are
    ~-1e5, where float32 rounds by 2^-7, so neither package's gradient is
    better than ~1e-4 there: both within 5e-4 of the port's float64
    gradient."""
    b, t, v, l = 4, 20, 9, 6
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    labels = rng.integers(1, v, size=(b, l)).astype(np.int32)
    labels[1, 2] = labels[1, 1]                # a repeated label
    labels[3, :3] = 1                          # the infeasible row
    logit_lens = np.asarray([20, 17, 15, 4], np.int32)
    label_lens = np.asarray([6, 4, 5, 3], np.int32)

    def jloss(x):
        return jax_ctc.ctc_loss_torch_mean(
            x, jnp.asarray(logit_lens), jnp.asarray(labels),
            jnp.asarray(label_lens))

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = ctc.ctc_loss_torch_mean(
        x, torch.from_numpy(logit_lens).long(),
        torch.from_numpy(labels).long(), torch.from_numpy(label_lens).long())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy()[:3], np.asarray(want_g)[:3],
                               atol=1e-6)
    x64 = torch.tensor(logits.astype(np.float64), requires_grad=True)
    ctc.ctc_loss_torch_mean(
        x64, torch.from_numpy(logit_lens).long(),
        torch.from_numpy(labels).long(),
        torch.from_numpy(label_lens).long()).backward()
    for g in (x.grad.numpy()[3], np.asarray(want_g)[3]):
        np.testing.assert_allclose(g, x64.grad.numpy()[3], atol=5e-4)

    # the infeasible row alone: finite, ~1e5 / 3, equal to optax's
    row = slice(3, 4)
    j_row = jax_ctc.ctc_loss_torch_mean(
        jnp.asarray(logits[row]), jnp.asarray(logit_lens[row]),
        jnp.asarray(labels[row]), jnp.asarray(label_lens[row]))
    p_row = ctc.ctc_loss_torch_mean(
        torch.from_numpy(logits[row]), torch.from_numpy(logit_lens[row]),
        torch.from_numpy(labels[row]), torch.from_numpy(label_lens[row]))
    assert 3e4 < float(p_row) < 4e4
    np.testing.assert_allclose(float(p_row), float(j_row), rtol=1e-6)
    torch_ctc = torch.nn.functional.ctc_loss(
        torch.from_numpy(logits[row]).log_softmax(-1).transpose(0, 1),
        torch.from_numpy(labels[row, :3]).long(), torch.tensor([4]),
        torch.tensor([3]))
    assert torch.isinf(torch_ctc)


def test_ctc_ignores_padded_frames(rng):
    """A row's loss and gradient come from its own frames alone: padded
    frames filled with zeros or with large values give the same bits and
    get a zero gradient; and a row's loss is the same in a batch as
    alone."""
    logits = rng.standard_normal((2, 30, 7)).astype(np.float32)
    labels = torch.tensor([[1, 2, 3], [4, 4, 0]])
    lens, lab_lens = torch.tensor([21, 17]), torch.tensor([3, 2])
    out = []
    for fill in (0.0, 1e3):
        x = logits.copy()
        x[0, 21:] = fill
        x[1, 17:] = fill
        x = torch.tensor(x, requires_grad=True)
        loss = ctc.ctc_loss(x, lens, labels, lab_lens)
        loss.sum().backward()
        out.append((loss.detach(), x.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert not out[1][1][0, 21:].any() and not out[1][1][1, 17:].any()
    alone = ctc.ctc_loss(torch.from_numpy(logits[1:, :17]), lens[1:],
                         labels[1:, :2], lab_lens[1:])
    np.testing.assert_allclose(float(alone[0]), float(out[0][0][1]),
                               rtol=1e-6)


def _adam_state(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0]


def test_three_train_steps_match_jax_with_nan_skip(rng):
    """Three steps from the same weights on both sides; the second batch
    holds a NaN frame. Port and JAX: losses within 1e-5 relative (the
    second NaN on both); the skipped step leaves the port's parameters, BN
    statistics, moments and count bit-unchanged and still counts; after
    the third, BN statistics within 1e-6 and parameters within 1e-3 lr of
    JAX's (Adam's first updates are ~lr * sign(g)), moments within 1e-4 of
    each tensor's largest."""
    params, bn = jax_start(1)
    mcfg, tcfg = JaxModelConfig(**MODEL), JaxTrainConfig(**TRAIN)
    js = jax_train.init_state(jax.random.key(1), mcfg, tcfg)
    ps = atrain.init_state(0, AlignerModelConfig(**MODEL), "cpu")
    ps.model.load_state_dict(aligner_state_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), js.bn_state))
    batches = [make_batch(rng) for _ in range(3)]
    batches[1]["mel"][1, 5, 3] = np.nan
    ptcfg = AlignerTrainConfig(**TRAIN)
    for i, b in enumerate(batches):
        before = {k: v.clone() for k, v in ps.model.state_dict().items()}
        moments = {k: v.clone() for k, v in ps.mu.items()}
        js, jm = jax_train.train_step(
            js, {k: jnp.asarray(v) for k, v in b.items()}, tcfg)
        pm = atrain.train_step(ps, atrain.to_batch(b, "cpu"), ptcfg)
        jl, pl = float(jm["ctc_loss"]), float(pm["ctc_loss"])
        if i == 1:
            assert np.isnan(jl) and np.isnan(pl)
            after = ps.model.state_dict()
            assert all(torch.equal(before[k], after[k]) for k in before)
            assert all(torch.equal(moments[k], ps.mu[k]) for k in moments)
            assert ps.count == 1 and ps.step == 2
        else:
            np.testing.assert_allclose(pl, jl, rtol=1e-5)
    adam = _adam_state(js.opt_state)
    assert ps.count == int(adam.count) == 2 and ps.step == int(js.step) == 3
    want = aligner_state_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), js.bn_state)
    got = ps.model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):   # the JAX state has none
            assert int(got[k]) == 2, k
            continue
        tol = 1e-6 if "running" in k else 1e-3 * LR
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=tol,
                                   err_msg=k)
    for name in ("mu", "nu"):
        jm = aligner_state_from_jax(
            jax.tree_util.tree_map(np.asarray, getattr(adam, name)),
            js.bn_state)
        mine = getattr(ps, name)
        assert set(mine) == set(atrain.trained(ps.model)) < set(jm)
        for k in mine:
            w = jm[k]
            d = float((mine[k] - w).abs().max())
            assert d <= 1e-4 * float(w.abs().max()) + 1e-12, (name, k, d)


def test_posteriors_match_jax(rng):
    """Eval-mode softmax posteriors within 1e-6."""
    params, bn = jax_start(2)
    mel = rng.standard_normal((2, 64, MODEL["n_mels"])).astype(np.float32)
    want = jax_train.posteriors(params, bn, jnp.asarray(mel))
    got = atrain.posteriors(port_model(params, bn), torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_librosa_mel_matches_jax_on_a_ragged_padded_batch(rng):
    """The aligner's mel (centred, n_fft 1024, hop 320, no eps) of a
    zero-padded batch of three wavs of different lengths: log-mel within
    1e-4 of JAX's (rfft against the JAX package's framed DFT matmul), and
    1 + T // 320 frames."""
    lens = (4000, 5123, 2900)
    batch = np.zeros((3, max(lens)), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = 0.3 * rng.standard_normal(n)
    want = np.asarray(jax_stft.librosa_mel_spectrogram(jnp.asarray(batch)))
    got = stft.librosa_mel_spectrogram(torch.from_numpy(batch)).numpy()
    assert got.shape == (3, 1 + max(lens) // 320, 80)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_aligner_loader_yields_the_jax_batches(tmp_path, rng):
    import pickle

    (tmp_path / "mels").mkdir()
    (tmp_path / "tokens").mkdir()
    index = []
    for i in range(11):
        n, l = int(rng.integers(10, 80)), int(rng.integers(2, 20))
        np.save(tmp_path / "mels" / f"u{i}.npy",
                rng.standard_normal((n, 8)).astype(np.float32))
        np.save(tmp_path / "tokens" / f"u{i}.npy",
                rng.integers(1, 12, l).astype(np.int64))
        index.append((f"u{i}", n, l))
    with open(tmp_path / "dataset.pkl", "wb") as f:
        pickle.dump(index, f)
    args = (3, (32, 64), (8, 16))
    for epoch in (0, 1):
        want = list(jax_data.AlignerLoader(
            jax_data.AlignerDataset(tmp_path), *args).batches(epoch))
        got = list(aligner_data.AlignerLoader(
            aligner_data.AlignerDataset(tmp_path), *args).batches(epoch))
        assert len(got) == len(want) > 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


def test_aligner_configs_round_trip_and_match_jax():
    import dataclasses

    m, t = AlignerModelConfig(**MODEL), AlignerTrainConfig(**TRAIN)
    assert aligner_configs_from_json(aligner_configs_to_json(m, t)) == (m, t)
    for port, jx in ((AlignerModelConfig(), JaxModelConfig()),
                     (AlignerTrainConfig(), JaxTrainConfig())):
        assert dataclasses.asdict(port) == dataclasses.asdict(jx)
