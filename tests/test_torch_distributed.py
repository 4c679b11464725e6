"""The port's data-parallel and tensor-parallel paths over a real process
group: ONE spawn of two gloo processes on the CPU (`tests/
torch_dist_worker.py`, which imports torch and the port alone), held
against one process on the global batch and against the JAX package.

The spawn meets through a `file://` store under the test's temporary
directory (no TCP port to collide with other test workers) and must end
within DEADLINE_S: on expiry both children are killed and the test fails
with their stderr, so nothing can hang.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.train import tte as jax_train
from parrot_tts_tpu_torch.convert import (generator_state_from_jax,
                                          tte_state_from_jax)
from parrot_tts_tpu_torch.core.config import (MelConfig, TTETrainConfig,
                                              VocoderModelConfig,
                                              VocoderTrainConfig)
from parrot_tts_tpu_torch.data.tte_data import pick_bucket
from parrot_tts_tpu_torch.infer.serving import ParrotTTS
from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer
from parrot_tts_tpu_torch.infer.tte_infer import decode_buckets
from parrot_tts_tpu_torch.models.tte import parrot
from parrot_tts_tpu_torch.models.tte.fold import fold_tte_params
from parrot_tts_tpu_torch.ops import flash_dropout as fd
from parrot_tts_tpu_torch.text.cleaners import english_cleaners
from parrot_tts_tpu_torch.text.tokenizer import DFATokenizer
from parrot_tts_tpu_torch.train import tte as train
from parrot_tts_tpu_torch.train import vocoder as voc_train

from tests import test_torch_gan as gan_t
from tests import test_torch_serving as serve_t
from tests import test_torch_train as train_t
from tests.torch_dist_worker import record_dropout

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
DEADLINE_S = 180
RUN_SEED = 1
TP_TOL = 2e-5           # TP logits against replicated (the JAX test's atol)
WORKER_THREADS = 2      # torch threads per worker (torch_dist_worker.py)


def spawn(tmp: Path, spec: dict) -> list[dict]:
    """Run the worker on WORLD ranks; their outputs, rank order."""
    path = tmp / "spec.pt"
    torch.save(spec, path)
    store = f"file://{tmp / 'store'}"
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist_worker", str(path), str(r),
         str(WORLD), store], cwd=REPO, env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    end = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                    + f.read()[-4000:])
        f.close()
    if any(p.returncode != 0 for p in procs):
        pytest.fail("distributed workers failed or passed the "
                    f"{DEADLINE_S} s deadline:\n" + "\n".join(text))
    return [torch.load(f"{path}.{r}", weights_only=False)
            for r in range(WORLD)]


def tte_case(dropout: float, dur_dropout: float):
    jcfg, tcfg = train_t.configs(dropout=dropout, dur_dropout=dur_dropout)
    return jcfg, tcfg, TTETrainConfig(**train_t.TRAIN)


def one_process_tte(state_dict, tcfg, train_cfg, batch) -> dict:
    """The 1-process step on the global batch, as the worker takes it."""
    state = train.init_state(0, tcfg, "cpu")
    state.model.load_state_dict(state_dict, strict=True)
    masks, drops = record_dropout(fd, parrot)
    with masks, drops:
        m1 = train.train_step(state, train.to_batch(batch, "cpu"), RUN_SEED,
                              tcfg, train_cfg, train_t.OUT_LEN)
        grad = {k: v.clone() for k, v in state.acc.items()}
        m2 = train.train_step(state, train.to_batch(batch, "cpu"), RUN_SEED,
                              tcfg, train_cfg, train_t.OUT_LEN)
    return {"losses": [float(m["total_loss"]) for m in (m1, m2)],
            "grad": grad, "params": state.model.state_dict(),
            "masks": masks.seen, "drops": drops.seen}


def serve_inputs():
    """test_torch_serving's tiny TTE and vocoder, requests and plan."""
    jcfg, tte, jvcfg, voc = serve_t.jax_weights()
    tcfg, vcfg = serve_t.port_configs()
    tte_sd = tte_state_from_jax(tte, tcfg)
    voc_sd = generator_state_from_jax(voc, vcfg)
    rng = np.random.default_rng(5)
    seqs = [rng.integers(2, tcfg.vocab_size, size=n) for n in (5, 9, 14, 7,
                                                                20, 3)]
    samples = [(s, i % tcfg.n_speaker) for i, s in enumerate(seqs)]
    by: dict = {}
    for i, s in enumerate(seqs):
        by.setdefault(pick_bucket((8, 16, 32), len(s)), []).append(i)
    plan = [(s_len, s_len * 4, idx) for s_len, idx in sorted(by.items())]
    voc_codes = [rng.integers(0, vcfg.num_embeddings, size=n).astype(np.int32)
                 for n in (37, 100, 60, 37, 90)]
    return dict(serve_cfgs=(tcfg, vcfg), serve_tte=tte_sd,
                serve_tte_folded=fold_tte_params(tte_sd), serve_voc=voc_sd,
                samples=samples, plan=plan, batch_size=4,
                voc_codes=voc_codes, voc_speakers=[0, 1, 2, 0, 1],
                symbols=serve_t.SYMBOLS, src_buckets=serve_t.SRC_BUCKETS,
                texts=serve_t.TEXTS, speakers=serve_t.SPEAKERS)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The spec, the worker outputs and the parent's references."""
    rng = np.random.default_rng(3)
    batch = train_t.make_batch(rng)          # row 3 is a filler (weight 0)
    # ranks hold rows (0, 1) and (2, 3): unequal valid codes and tokens
    valid = (batch["codes"] != train_t.MODEL["hubert_codes"]) \
        * batch["sample_weight"][:, None]
    assert valid[:2].sum() != valid[2:].sum()
    jcfg, tcfg0, train_cfg = tte_case(0.0, 0.0)
    _, tcfg1, _ = tte_case(0.1, 0.5)
    js, params = train_t.jax_start(jcfg, TTE_JAX_TRAIN())
    tte_sd = train_t.port_start(params, tcfg0).model.state_dict()

    gcfgs = (VocoderModelConfig(**gan_t.TINY),
             VocoderTrainConfig(**gan_t.STEP_CFG), MelConfig(**gan_t.MEL))
    gan_state = voc_train.init_state(0, gcfgs[0], "cpu")
    gan_batch = gan_t.tiny_batch(b=4)

    tp_rng = np.random.default_rng(7)
    tp_state = parrot.init_parrot(tcfg0, torch.Generator().manual_seed(11))
    spec = {"tte_cfgs": {"p0": (tcfg0, train_cfg), "p1": (tcfg1, train_cfg)},
            "tte_state": tte_sd, "tte_batch": batch, "run_seed": RUN_SEED,
            "out_len": train_t.OUT_LEN,
            "gan_cfgs": gcfgs, "gan_state": gan_state.state_dict(),
            "gan_batch": gan_batch, "gan_spe": gan_t.SPE,
            "tp_cfg": tcfg0, "tp_state": tp_state,
            "tp_batch": train_t.make_batch(tp_rng),
            **serve_inputs()}
    outs = spawn(tmp_path_factory.mktemp("dist"), spec)
    return spec, outs, js


def TTE_JAX_TRAIN():
    from parrot_tts_tpu.core.config import TTETrainConfig as JaxTrainConfig

    return JaxTrainConfig(**train_t.TRAIN)


def grad_rel(got: dict, want: dict) -> float:
    num = sum(float((got[k] - want[k]).double().pow(2).sum()) for k in want)
    den = sum(float(want[k].double().pow(2).sum()) for k in want)
    return (num / den) ** 0.5


def test_group_and_mesh(run):
    _, outs, _ = run
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o["world"] == WORLD and o["n_data"] == WORLD for o in outs)


@pytest.mark.parametrize("key", ["p0", "p1"])
def test_tte_step_equals_the_global_batch_step(run, key):
    """Two micro-steps (one optimizer step) over 2 ranks against one
    process on the global batch: the summed gradient within 1e-6 of the
    global one (|dg|/|g|), losses within 1e-6, parameters within 1e-6 of
    lr, and bit-equal across the ranks. p1 runs attention dropout 0.1 and
    duration-predictor dropout 0.5, so it fails unless each rank draws its
    rows of the global masks."""
    spec, outs, _ = run
    tcfg, train_cfg = spec["tte_cfgs"][key]
    want = one_process_tte(spec["tte_state"], tcfg, train_cfg,
                           spec["tte_batch"])
    lr = train_t.TRAIN["init_lr"]
    for o in outs:
        got = o["tte"][key]
        assert grad_rel(got["grad"], want["grad"]) <= 1e-6
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        for k, w in want["params"].items():
            assert float((got["params"][k] - w).abs().max()) <= 1e-6 * lr, k
    a, b = (o["tte"][key]["params"] for o in outs)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_tte_step_matches_jax_at_dropout_0(run):
    """The 2-rank step against the JAX package's train_step on the global
    batch, at test_torch_train's tolerances."""
    spec, outs, js = run
    jcfg, tcfg, _ = tte_case(0.0, 0.0)
    b = {k: jnp.asarray(v) for k, v in spec["tte_batch"].items()}
    jl = []
    for _ in range(2):
        js, jm = jax_train.train_step(js, b, jax.random.key(RUN_SEED), jcfg,
                                      TTE_JAX_TRAIN(), train_t.OUT_LEN)
        jl.append(float(jm["total_loss"]))
    got = outs[0]["tte"]["p0"]
    state = train.init_state(0, tcfg, "cpu")
    state.load_state_dict(got["state"])
    train_t._compare_to_jax(js, jl, state, got["losses"], tcfg)


def test_dropout_masks_are_the_global_rows(run):
    """Each rank's attention keep masks (forward and backward draws) and
    duration-predictor drops are its rows of the 1-process masks."""
    spec, outs, _ = run
    tcfg, train_cfg = spec["tte_cfgs"]["p1"]
    want = one_process_tte(spec["tte_state"], tcfg, train_cfg,
                           spec["tte_batch"])
    assert want["masks"] and want["drops"]
    for r, o in enumerate(outs):
        got = o["tte"]["p1"]
        for kind in ("masks", "drops"):
            assert len(got[kind]) == len(want[kind])
            for g, w in zip(got[kind], want[kind]):
                n = g.shape[0]
                assert torch.equal(g.bool(), w[r * n:(r + 1) * n].bool())
        # and not rank 0's: the ranks' masks differ
    assert not torch.equal(outs[0]["tte"]["p1"]["masks"][0],
                           outs[1]["tte"]["p1"]["masks"][0])


def test_gan_step_equals_the_global_batch_step(run):
    """2 ranks x 2 rows against one process on 4 rows, at
    test_torch_gan's step tolerances; every parameter and spectral-norm
    vector bit-equal across the ranks."""
    spec, outs, _ = run
    mcfg, tcfg, mel_cfg = spec["gan_cfgs"]
    state = voc_train.init_state(0, mcfg, "cpu")
    state.load_state_dict(spec["gan_state"])
    first = state.state_dict()
    first = {k: ({n: t.clone() for n, t in v.items()}
                 if isinstance(v, dict) else v) for k, v in first.items()}
    metrics = voc_train.train_step(
        state, voc_train.to_batch(spec["gan_batch"], "cpu"), mcfg, tcfg,
        mel_cfg, spec["gan_spe"])
    want = state.state_dict()
    got = outs[0]["gan"]["state"]
    for k, v in metrics.items():
        np.testing.assert_allclose(outs[0]["gan"]["metrics"][k], float(v),
                                   rtol=1e-5)
    for part, bound in (("mu_g", 1e-4), ("mu_d", 1e-4), ("nu_g", 2e-4),
                        ("nu_d", 2e-4)):
        assert gan_t.rel_err(got[part], want[part]) <= bound, part
    for k, w in want["gen"].items():
        gan_t.close(got["gen"][k], w, rtol=0, atol=1e-6)
    for net in ("mpd", "msd"):
        names = [k for k in want[net] if f"{net}.{k}" in want["mu_d"]]
        assert names
        err = gan_t.update_err(*({k: d[k] for k in names}
                                 for d in (got[net], want[net], first[net])))
        assert err <= 1e-4, (net, err)
    for k in want["msd"]:
        if k.endswith(("weight_u", "weight_v")):
            gan_t.close(got["msd"][k], want["msd"][k], rtol=0, atol=1e-5)
    a, b = (o["gan"]["state"] for o in outs)
    for net in ("gen", "mpd", "msd"):
        assert all(torch.equal(a[net][k], b[net][k]) for k in a[net]), net


def test_sharded_serving_equals_one_process(run):
    """decode_buckets, VocoderSynthesizer and ParrotTTS over 2 ranks: the
    units equal the 1-process decode's; each waveform bit-equal to a solo
    serve of its rank's rows (the shard's row count) and within 1e-5 of
    the unsharded serve; both ranks get the global outputs."""
    spec, outs, _ = run
    tcfg, vcfg = spec["serve_cfgs"]
    model = parrot.Parrot(tcfg, folded=True)
    model.load_state_dict(spec["serve_tte_folded"], strict=True)
    want_codes = decode_buckets(model.eval(), spec["samples"], spec["plan"],
                                batch_size=spec["batch_size"], device="cpu")
    synth = VocoderSynthesizer(spec["serve_voc"], vcfg, device="cpu")
    codes, spk = spec["voc_codes"], spec["voc_speakers"]
    whole = synth.synthesize(codes, spk)
    # the workers' thread count: the CPU convs' sums follow it
    threads = torch.get_num_threads()
    torch.set_num_threads(WORKER_THREADS)
    # the rows of each bucket, padded to 2 x rows with repeats of row 0
    from parrot_tts_tpu_torch.infer.synthesize import CODE_BUCKETS
    by: dict = {}
    for i, c in enumerate(codes):
        by.setdefault(pick_bucket(CODE_BUCKETS, len(c)), []).append(i)
    solo: dict = {}
    for idx in by.values():
        pad = idx + [idx[0]] * (-len(idx) % WORLD)
        n = len(pad) // WORLD
        for r in range(WORLD):
            rows = pad[r * n:(r + 1) * n]
            for gi, w in zip(rows, synth.synthesize([codes[i] for i in rows],
                                                    [spk[i] for i in rows])):
                solo.setdefault(gi, w)
    torch.set_num_threads(threads)
    tts = ParrotTTS(spec["serve_tte"], tcfg, spec["serve_voc"], vcfg,
                    DFATokenizer(spec["symbols"]), english_cleaners,
                    src_buckets=spec["src_buckets"], exact=True, device="cpu")
    want_tts = tts.tts(spec["texts"], spec["speakers"])
    for o in outs:
        got = o["serve"]
        assert all(np.array_equal(a, b) for a, b in zip(got["codes"],
                                                        want_codes))
        for i, w in enumerate(got["wavs"]):
            np.testing.assert_array_equal(w, solo[i])
            np.testing.assert_allclose(w, whole[i], rtol=0, atol=1e-5)
        assert len(got["tts"]) == len(want_tts)
        for a, b in zip(got["tts"], want_tts):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["audio_seconds"],
                                   tts.last_stats["audio_seconds"])


def test_tensor_parallel_forward_equals_replicated(run):
    """TP=2 over the 2 ranks (one head, half the filters and half the
    head's codes each): the deterministic training forward's logits and
    log-durations within TP_TOL of the replicated forward's, and the
    folded decode's codes equal where the replicated top-2 margin exceeds
    2 TP_TOL."""
    spec, outs, _ = run
    tcfg = spec["tp_cfg"]
    model = parrot.Parrot(tcfg)
    model.load_state_dict(spec["tp_state"], strict=True)
    b = spec["tp_batch"]
    batch = {**parrot.to_batch(b, "cpu"),
             "duration": torch.as_tensor(b["duration"], dtype=torch.int64),
             "tgt_mask": torch.as_tensor(b["tgt_mask"])}
    with torch.no_grad():
        logits, _, log_dur = parrot.apply_parrot_train(
            model.eval(), batch, out_len=spec["out_len"])
    folded = parrot.Parrot(tcfg, folded=True)
    folded.load_state_dict(fold_tte_params(spec["tp_state"]), strict=True)
    with torch.no_grad():
        dl, dmask, _ = parrot.apply_parrot(folded.eval(),
                                           parrot.to_batch(b, "cpu"),
                                           out_len=spec["out_len"])
    codes, mask, total = parrot.infer_codes(folded, b,
                                            out_len=spec["out_len"],
                                            device="cpu")
    margin = torch.topk(dl, 2, dim=-1).values
    clear = (margin[..., 0] - margin[..., 1]) > 2 * TP_TOL
    for o in outs:
        tp = o["tp"]
        assert tp["head_rows"] == tcfg.hubert_codes // 2
        torch.testing.assert_close(tp["logits"], logits, atol=TP_TOL,
                                   rtol=1e-5)
        torch.testing.assert_close(tp["log_dur"], log_dur, atol=TP_TOL,
                                   rtol=1e-5)
        assert torch.equal(tp["mask"], mask) and torch.equal(tp["total"],
                                                             total)
        assert torch.equal(tp["codes"][clear & dmask], codes[clear & dmask])
        assert int((clear & dmask).sum()) > 0
