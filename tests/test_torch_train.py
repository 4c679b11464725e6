"""Port TTE training (parrot_tts_tpu_torch.{train,pipeline,data,core}) against
the JAX package: loss, schedule, the clip + AdamW update, train steps at
dropout 0, eval, the bucketed loader, checkpoints, and the training
pipeline end to end on the CPU at a tiny size."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from parrot_tts_tpu.core.config import TTEModelConfig as JaxTTEConfig
from parrot_tts_tpu.core.config import TTETrainConfig as JaxTrainConfig
from parrot_tts_tpu.core.config import TransformerStackConfig as JaxStack
from parrot_tts_tpu.data import tte_data as jax_data
from parrot_tts_tpu.data.manifest import write_manifest
from parrot_tts_tpu.models.tte.loss import tte_loss as jax_tte_loss
from parrot_tts_tpu.text.tokenizer import save_symbols
from parrot_tts_tpu.train import tte as jax_train
from parrot_tts_tpu.train.schedules import (
    cosine_warmup_schedule as jax_schedule)
from parrot_tts_tpu_torch.convert import tte_state_from_jax
from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
from parrot_tts_tpu_torch.core.config import (PipelineConfig, TTEModelConfig,
                                              TTETrainConfig,
                                              TransformerStackConfig)
from parrot_tts_tpu_torch.data import tte_data
from parrot_tts_tpu_torch.models.tte.loss import tte_loss
from parrot_tts_tpu_torch.pipeline import train_tte
from parrot_tts_tpu_torch.train import tte as train
from parrot_tts_tpu_torch.train.schedules import cosine_warmup_schedule

MODEL = dict(d_model=16, conv_n_filter=32, conv_kernel_sizes=(9, 1),
             max_len=64, dur_n_filter=8, dur_kernel_size=3, hubert_codes=20,
             n_speaker=2, vocab_size=10, pad_idx=0)
TRAIN = dict(init_lr=1e-2, warmup_steps=1, total_steps=100, grad_acc_steps=2,
             grad_clip=1.0)
OUT_LEN = 24


def configs(dropout=0.0, dur_dropout=0.0):
    jcfg = JaxTTEConfig(**MODEL, dur_dropout_p=dur_dropout,
                        encoder=JaxStack(1, 2, dropout),
                        decoder=JaxStack(1, 2, dropout))
    tcfg = TTEModelConfig(**MODEL, dur_dropout_p=dur_dropout,
                          encoder=TransformerStackConfig(1, 2, dropout),
                          decoder=TransformerStackConfig(1, 2, dropout))
    return jcfg, tcfg


def make_batch(rng, b=4, s=8, t=OUT_LEN):
    durs = rng.integers(1, 4, size=(b, s)).astype(np.int32)
    codes = np.full((b, t), MODEL["hubert_codes"], np.int32)
    tgt_mask = np.zeros((b, t), bool)
    for i, total in enumerate(durs.sum(axis=1)):
        n = min(int(total), t)
        codes[i, :n] = rng.integers(0, MODEL["hubert_codes"], size=n)
        tgt_mask[i, :n] = True
    src_mask = np.ones((b, s), bool)
    src_mask[1, 6:] = False
    durs[~src_mask] = 0
    return {"phones": rng.integers(2, 10, size=(b, s)).astype(np.int32),
            "duration": durs, "codes": codes, "src_mask": src_mask,
            "tgt_mask": tgt_mask,
            "speaker": rng.integers(0, 2, size=(b,)).astype(np.int32),
            "sample_weight": np.asarray([1, 1, 1, 0], np.float32)}


def jax_start(jcfg, jtcfg):
    state = jax_train.init_state(jax.random.key(0), jcfg, jtcfg)
    return state, jax.tree_util.tree_map(np.asarray, state.params)


def port_start(params, tcfg):
    state = train.init_state(0, tcfg, "cpu")
    state.model.load_state_dict(tte_state_from_jax(params, tcfg), strict=True)
    return state


def test_tte_loss_matches_jax(rng):
    b, s, t, c = 3, 7, 11, 20
    logits = rng.standard_normal((b, t, c)).astype(np.float32)
    log_dur = rng.standard_normal((b, s)).astype(np.float32)
    codes = rng.integers(0, c + 1, size=(b, t)).astype(np.int32)   # c = pad
    durs = rng.integers(0, 5, size=(b, s)).astype(np.int32)
    src_mask = rng.random((b, s)) > 0.3
    weight = np.asarray([1.0, 0.0, 0.5], np.float32)
    for w in (None, weight):
        want = jax_tte_loss(jnp.asarray(logits), jnp.asarray(log_dur),
                            jnp.asarray(codes), jnp.asarray(durs),
                            jnp.asarray(src_mask), num_codes=c,
                            sample_weight=None if w is None else
                            jnp.asarray(w))
        got = tte_loss(torch.from_numpy(logits), torch.from_numpy(log_dur),
                       torch.from_numpy(codes), torch.from_numpy(durs),
                       torch.from_numpy(src_mask), num_codes=c,
                       sample_weight=None if w is None else
                       torch.from_numpy(w))
        # float32 on both sides, sums in another order
        for g, j in zip(got, want):
            np.testing.assert_allclose(float(g), float(j), rtol=1e-6)


def test_cosine_warmup_schedule_matches_jax():
    """The port evaluates in double precision, the JAX schedule in
    float32: equal to float32 rounding of each term (2e-6 relative, and
    1e-7 of init_lr absolute where the cosine nears 0)."""
    got = cosine_warmup_schedule(3e-4, 10, 50)
    want = jax_schedule(3e-4, 10, 50)
    for step in range(0, 60):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=2e-6,
                                   atol=1e-7 * 3e-4)
    assert got(0) == 0.0


def test_clip_and_adamw_update_match_optax(rng):
    """Three applies of the port's update on a random pytree against optax
    clip_by_global_norm -> adamw: the first under warmup (lr 0), one with a
    gradient norm above the clip and one below. float32 on both sides (the
    port's lr and bias corrections in double, rounded once): moments 1e-6
    relative, parameters 1e-6 relative or one float32 ulp at |p| < 4."""
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (3.0, 5.0, 0.01)]
    cfg = TTETrainConfig(init_lr=1e-2, warmup_steps=1, total_steps=20,
                         weight_decay=0.05, grad_clip=1.0, grad_acc_steps=1)

    opt = optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip),
        optax.adamw(jax_schedule(cfg.init_lr, cfg.warmup_steps,
                                 cfg.total_steps),
                    b1=0.9, b2=0.999, eps=1e-8,
                    weight_decay=cfg.weight_decay))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = opt.init(jp)

    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()})
    state = train.TTETrainState(
        model=module, mu={k: torch.zeros(s) for k, s in shapes.items()},
        nu={k: torch.zeros(s) for k, s in shapes.items()},
        acc={k: torch.zeros(s) for k, s in shapes.items()})
    for g in grads:
        updates, opt_state = opt.update({k: jnp.asarray(v) for k, v in
                                         g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in g.items():
            state.acc[k].copy_(torch.from_numpy(v))
        train._apply_update(state, cfg)
        adam = opt_state[1][0]
        for k in shapes:
            np.testing.assert_allclose(module[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=4.8e-7)
            np.testing.assert_allclose(state.mu[k].numpy(),
                                       np.asarray(adam.mu[k]), rtol=1e-6,
                                       atol=1e-9)
            np.testing.assert_allclose(state.nu[k].numpy(),
                                       np.asarray(adam.nu[k]), rtol=1e-6,
                                       atol=1e-12)
    assert state.count == int(adam.count) == 3


# Train steps at dropout 0 against JAX. The JAX package on the CPU takes
# its float32 XLA attention; the port's training attention rounds its
# operands to bf16 (2^-9 relative each), as the kernels on the card do.
# Losses: 1e-3 relative. AdamW's first moment is linear in the gradient:
# within 5e-2 of its largest value per tensor (bf16 noise on 8-wide heads),
# the second within 1e-1. AdamW moves an element by about lr * sign(g) in
# its first steps, so an element whose gradient is near 0 can move the
# other way: every parameter within 2 lr of JAX's (one update at lr > 0),
# and at most 1% of them further than 0.1 lr.
def _compare_to_jax(jax_state, jax_losses, state, losses, tcfg):
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-3)
    assert state.count == int(jax_state.opt_state.inner_opt_state[1][0].count)
    lr = TRAIN["init_lr"]
    want = tte_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_state.params), tcfg)
    got = state.model.state_dict()
    far = total = 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        assert float(d.max()) <= 2 * lr, k
        far += int((d > 0.1 * lr).sum())
        total += d.numel()
    assert far <= 0.01 * total, far / total
    adam = jax_state.opt_state.inner_opt_state[1][0]
    for name, rel in (("mu", 5e-2), ("nu", 1e-1)):
        jm = tte_state_from_jax(
            jax.tree_util.tree_map(np.asarray, getattr(adam, name)), tcfg)
        for k, w in jm.items():
            d = float((getattr(state, name)[k] - w).abs().max())
            assert d <= rel * float(w.abs().max()) + 1e-12, (name, k, d)


def test_train_step_matches_jax_at_dropout_0(rng):
    jcfg, tcfg = configs()
    jtcfg, ptcfg = JaxTrainConfig(**TRAIN), TTETrainConfig(**TRAIN)
    batches = [make_batch(rng) for _ in range(4)]   # 2 optimizer steps
    js, params = jax_start(jcfg, jtcfg)
    ps = port_start(params, tcfg)
    p0 = {k: v.clone() for k, v in ps.model.state_dict().items()}
    jl, pl = [], []
    for i, b in enumerate(batches):
        js, jm = jax_train.train_step(
            js, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.key(1), jcfg, jtcfg, OUT_LEN)
        pm = train.train_step(ps, train.to_batch(b, "cpu"), 1, tcfg, ptcfg,
                              OUT_LEN)
        jl.append(float(jm["total_loss"]))
        pl.append(float(pm["total_loss"]))
        if i == 0:   # the first micro-step only accumulates
            assert all(torch.equal(p0[k], v) for k, v in
                       ps.model.state_dict().items())
    assert ps.step == 4 and ps.mini_step == 0
    _compare_to_jax(js, jl, ps, pl, tcfg)


def test_train_step_k_matches_jax_at_dropout_0(rng):
    jcfg, tcfg = configs()
    jtcfg, ptcfg = JaxTrainConfig(**TRAIN), TTETrainConfig(**TRAIN)
    batches = [make_batch(rng) for _ in range(4)]
    js, params = jax_start(jcfg, jtcfg)
    ps = port_start(params, tcfg)
    jl, pl = [], []
    for grp in (batches[:2], batches[2:]):
        stacked = {k: np.stack([b[k] for b in grp]) for k in grp[0]}
        js, jm = jax_train.train_step_k(
            js, {k: jnp.asarray(v) for k, v in stacked.items()},
            jax.random.key(1), jcfg, jtcfg, OUT_LEN)
        pm = train.train_step_k(ps, train.to_batch(stacked, "cpu"), 1, tcfg,
                                ptcfg, OUT_LEN)
        jl.append(float(jm["total_loss"]))
        pl.append(float(pm["total_loss"]))
    assert ps.step == 4
    _compare_to_jax(js, jl, ps, pl, tcfg)


def test_train_step_k_is_k_train_steps_with_dropout(rng):
    """One code path: with attention and duration-predictor dropout on,
    train_step_k over a stack gives bit for bit what train_step gives
    micro-batch by micro-batch."""
    _, tcfg = configs(dropout=0.1, dur_dropout=0.5)
    ptcfg = TTETrainConfig(**{**TRAIN, "grad_acc_steps": 3})
    batches = [make_batch(rng) for _ in range(3)]
    a = train.init_state(5, tcfg, "cpu")
    b = train.init_state(5, tcfg, "cpu")
    for bt in batches:
        ma = train.train_step(a, train.to_batch(bt, "cpu"), 9, tcfg, ptcfg,
                              OUT_LEN)
    stacked = {k: np.stack([bt[k] for bt in batches]) for k in batches[0]}
    mb = train.train_step_k(b, train.to_batch(stacked, "cpu"), 9, tcfg, ptcfg,
                            OUT_LEN)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa["params"][k], sb["params"][k])
               for k in sa["params"])
    assert all(torch.equal(sa["mu"][k], sb["mu"][k]) for k in sa["mu"])


def test_dropout_streams_come_from_seed_and_step_alone(rng):
    _, tcfg = configs(dropout=0.1, dur_dropout=0.5)
    ptcfg = TTETrainConfig(**TRAIN)
    batch = train.to_batch(make_batch(rng), "cpu")
    state = train.init_state(3, tcfg, "cpu")

    def loss(seed, step):
        with torch.no_grad():
            return float(train.loss_fn(state.model, batch, tcfg, OUT_LEN,
                                       (seed, step))[0])

    assert loss(1, 0) == loss(1, 0)
    assert len({loss(1, 0), loss(1, 1), loss(2, 0)}) == 3
    # no dropout: the deterministic forward of eval_step
    det = float(train.eval_step(state.model, batch, tcfg,
                                OUT_LEN)["total_loss"])
    assert det not in {loss(1, 0), loss(1, 1)}


def test_eval_step_matches_jax(rng):
    """eval_step: float32 attention (row 1's plain version) on both sides,
    sums in another order: 1e-5 relative."""
    jcfg, tcfg = configs(dropout=0.1, dur_dropout=0.5)
    _, params = jax_start(jcfg, JaxTrainConfig(**TRAIN))
    ps = port_start(params, tcfg)
    b = make_batch(rng)
    want = jax_train.eval_step(params, {k: jnp.asarray(v) for k, v in
                                        b.items()}, jcfg, OUT_LEN)
    got = train.eval_step(ps.model, train.to_batch(b, "cpu"), tcfg, OUT_LEN)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def write_corpus(tmp_path, rng, n_train=13, n_val=3):
    """A TTE corpus in the manifest / speakers / symbols format."""
    align = tmp_path / "aligner"
    align.mkdir()
    save_symbols(align / "symbols.json", [" ", "a", "b", "c"])
    root = tmp_path / "tte"
    root.mkdir()
    (root / "speakers.json").write_text(json.dumps({"en_f": 0, "en_m": 1}))
    for split, n in (("train", n_train), ("val", n_val)):
        entries = []
        for i in range(n):
            n_char = int(rng.integers(3, 14))
            durs = rng.integers(1, 4, size=n_char)
            entries.append({
                "audio": f"/x/en_{split}_{i:03d}.wav",
                "characters": " ".join(rng.choice(["a", "b", "c", "sil"],
                                                  size=n_char)),
                "hubert": " ".join(map(str, rng.integers(
                    0, MODEL["hubert_codes"], size=int(durs.sum())))),
                "duration": " ".join(map(str, durs)),
                "speaker": "en_f" if i % 2 else "en_m",
            })
        write_manifest(root / f"{split}.txt", entries)
    return root, align


def test_bucketed_loader_yields_the_jax_batches(tmp_path, rng):
    root, align = write_corpus(tmp_path, rng)
    jds = jax_data.TTEDataset(root, align, "train", MODEL["hubert_codes"])
    pds = tte_data.TTEDataset(root, align, "train", MODEL["hubert_codes"])
    for shuffle in (True, False):
        jl = jax_data.BucketedLoader(jds, 3, (8, 16), (16, 32), seed=4,
                                     shuffle=shuffle)
        pl = tte_data.BucketedLoader(pds, 3, (8, 16), (16, 32), seed=4,
                                     shuffle=shuffle)
        for epoch in (0, 1):
            want, got = list(jl.batches(epoch)), list(pl.batches(epoch))
            assert len(got) == len(want) >= 4
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in w:
                    if k == "ids":
                        assert g[k] == w[k]
                    else:
                        assert g[k].dtype == w[k].dtype
                        np.testing.assert_array_equal(g[k], w[k])


def test_checkpoint_restores_params_moments_and_step(tmp_path, rng):
    _, tcfg = configs(dropout=0.1)
    ptcfg = TTETrainConfig(**TRAIN)
    state = train.init_state(1, tcfg, "cpu")
    for _ in range(3):   # mid-accumulation: acc and mini_step are live
        train.train_step(state, train.to_batch(make_batch(rng), "cpu"), 2,
                         tcfg, ptcfg, OUT_LEN)
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(1, state.state_dict(), metadata={"step": 1})
    assert mgr.latest_step() == 1
    fresh = train.init_state(7, tcfg, "cpu")
    sd, meta = mgr.restore(with_metadata=True)
    fresh.load_state_dict(sd)
    assert meta == {"step": 1}
    a, b = state.state_dict(), fresh.state_dict()
    for part in ("params", "mu", "nu", "acc"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])
    assert (b["count"], b["mini_step"], b["step"]) == (1, 1, 3)


def test_pipeline_trains_crashes_and_resumes_on_cpu(tmp_path, rng):
    root, align = write_corpus(tmp_path, rng)
    _, tcfg = configs(dropout=0.1, dur_dropout=0.5)
    cfg = PipelineConfig(
        root_path=str(root), alignment_path=str(align), tte_model=tcfg,
        tte_train=TTETrainConfig(
            init_lr=1e-3, warmup_steps=1, total_steps=4, batch_size=3,
            grad_acc_steps=2, log_every=1, val_every=2, save_every=1,
            src_buckets=(8, 16), tgt_buckets=(16, 32)))
    run_dir = tmp_path / "run"
    with pytest.raises(RuntimeError, match="simulated crash"):
        train_tte.run(cfg, run_dir=run_dir, crash_at_step=2, device="cpu")
    mgr = CheckpointManager(run_dir / "ckpt")
    assert mgr.latest_step() == 2
    assert mgr.restore()["step"] == 4          # micro-steps
    out = train_tte.run(cfg, run_dir=run_dir, device="cpu")
    assert out["steps"] == 4
    sd, meta = mgr.restore(with_metadata=True)
    assert sd["step"] == 8 and sd["count"] == 4 and meta["step"] == 4
    assert np.isfinite(meta["val_total_loss"])
    # metrics.csv is the resumed run's (a new CsvLogger rewrites it, as in
    # the JAX package); metrics.jsonl appends across both runs
    rows = (run_dir / "logs" / "metrics.csv").read_text().splitlines()
    assert rows[0].startswith("step,total_loss")
    assert [r.split(",")[0] for r in rows[1:]] == ["3", "4"]
    assert json.loads((run_dir / "ckpt" / "config.json").read_text())[
        "n_speaker"] == 2
    tags = [json.loads(line)["tag"] for line in
            (run_dir / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert tags.count("train_total_loss") == 4 and "val_total_loss" in tags


def test_pipeline_defaults_to_the_card():
    """Without device="cpu" the pipeline wants a CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_tte.run(PipelineConfig(), run_dir="unused")


def test_port_pipeline_config_is_a_subset_of_jax(rng):
    """The port's config copies keep the JAX defaults and names."""
    from parrot_tts_tpu.core.config import PipelineConfig as JaxPipeline

    jt = dataclasses.asdict(JaxTrainConfig())
    assert dataclasses.asdict(TTETrainConfig()) == jt
    jp = JaxPipeline()
    p = PipelineConfig()
    assert (p.root_path, p.alignment_path) == (jp.root_path,
                                               jp.alignment_path)
