"""Port offline supervision pipeline (parrot_tts_tpu_torch.pipeline.
{aligner_preprocess, train_aligner, extract_durations, prepare_tte})
against the JAX package's on a tiny synthetic corpus, file for
file: symbols, clean texts, tokens, dataset.pkl, durations, manifests and
speakers.json equal; mels within 1e-4."""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax

from parrot_tts_tpu.core.config import AlignerModelConfig as JaxModelConfig
from parrot_tts_tpu.models.aligner import model as jax_model
from parrot_tts_tpu.pipeline import aligner_preprocess as jax_pre
from parrot_tts_tpu.pipeline import extract_durations as jax_ext
from parrot_tts_tpu.pipeline import prepare_tte as jax_prep
from parrot_tts_tpu_torch import cli
from parrot_tts_tpu_torch.convert import aligner_state_from_jax
from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
from parrot_tts_tpu_torch.core.config import (AlignerModelConfig,
                                              AlignerTrainConfig)
from parrot_tts_tpu_torch.data.audio_io import write_wav
from parrot_tts_tpu_torch.data.manifest import write_manifest
from parrot_tts_tpu_torch.models.aligner import model as amodel
from parrot_tts_tpu_torch.ops import monotonic_align as ma
from parrot_tts_tpu_torch.pipeline import (aligner_preprocess,
                                           extract_durations, prepare_tte,
                                           train_aligner)
from parrot_tts_tpu_torch.train import aligner as atrain

SR = 16_000
SPEAKERS = ["en_f", "en_m"]
TEXTS = ["Hello world!", "the cat sat", "a dog ran by", "we sing 2 songs",
         "tea and rice", "go home now"]


def write_corpus(root, seed=0):
    """<root>/<speaker>/{wavs,txt}/<speaker>_utt_<i>.{wav,txt}, 0.25-0.35 s."""
    rng = np.random.default_rng(seed)
    for spk in SPEAKERS:
        (root / spk / "wavs").mkdir(parents=True)
        (root / spk / "txt").mkdir(parents=True)
        for i, text in enumerate(TEXTS):
            n = SR // 4 + 320 * i
            t = np.arange(n) / SR
            wav = (0.3 * np.sin(2 * np.pi * (120 + 40 * rng.random()) * t)
                   * (0.5 + 0.5 * rng.random(n)))
            name = f"{spk}_utt_{i:03d}"
            write_wav(root / spk / "wavs" / f"{name}.wav", wav, SR)
            (root / spk / "txt" / f"{name}.txt").write_text(text)
    return root


def files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Both packages' preprocess of one corpus: (corpus, jax_dir, port_dir,
    symbols)."""
    base = tmp_path_factory.mktemp("aligner_pipeline")
    corpus = write_corpus(base / "corpus")
    jdir, pdir = base / "jax", base / "port"
    symbols = jax_pre.clean_corpus(corpus, jdir)
    assert aligner_preprocess.clean_corpus(corpus, pdir) == symbols
    for spk in SPEAKERS:
        jax_pre.compute_mels_and_tokens(corpus / spk, jdir / spk, symbols,
                                        batch_size=4)
        aligner_preprocess.compute_mels_and_tokens(
            corpus / spk, pdir / spk, symbols, batch_size=4, device="cpu")
    return corpus, jdir, pdir, symbols


def test_preprocess_writes_the_jax_files(prepared):
    """Symbols, clean texts, tokens and dataset.pkl byte-equal; each mel
    of the zero-padded batches (80 bins, 1 + len // 320 frames) within
    1e-4 of JAX's (rfft against the JAX framed DFT matmul)."""
    _, jdir, pdir, _ = prepared
    assert files(jdir) == files(pdir)
    n_mels = 0
    for rel in files(jdir):
        if "mels" in rel.parts:
            want, got = np.load(jdir / rel), np.load(pdir / rel)
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_allclose(got, want, atol=1e-4)
            n_mels += 1
        else:
            assert (jdir / rel).read_bytes() == (pdir / rel).read_bytes(), rel
    assert n_mels == len(SPEAKERS) * len(TEXTS)


def test_extract_all_durations_writes_the_jax_durations(prepared, tmp_path):
    """Both packages' extract_all_durations on the JAX package's mels
    with the same weights (a
    seeded JAX aligner with its output layer scaled by 8, so that paths
    are not near-ties), in dijkstra and beam modes: every durations file
    equal. The port's posteriors give every item a best-path margin above
    1e-5, so the equality does not hang on a near-tie."""
    _, jdir, _, symbols = prepared
    mcfg = dict(n_mels=80, conv_dim=16, lstm_dim=8,
                num_symbols=len(symbols) + 1)
    params, bn = jax_model.init_aligner(jax.random.key(4),
                                        JaxModelConfig(**mcfg))
    params["lin"] = {k: v * 8 for k, v in params["lin"].items()}
    model = amodel.Aligner(AlignerModelConfig(**mcfg))
    model.load_state_dict(aligner_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params), bn), strict=True)
    model.eval()
    for method in ("dijkstra", "beam"):
        for spk in SPEAKERS:
            want_dir, got_dir = tmp_path / method / "jax", tmp_path / method / "port"
            for d in (want_dir, got_dir):
                shutil.copytree(jdir / spk, d / spk,
                                ignore=shutil.ignore_patterns("outputs"))
            jax_ext.extract_all_durations(want_dir / spk, params, bn,
                                          batch_size=4, method=method)
            timings = {}
            stats = extract_durations.extract_all_durations(
                got_dir / spk, model, batch_size=4, method=method,
                timings=timings)
            assert stats == {"items": len(TEXTS)}
            assert set(timings) == {"device_s", "dp_s", "wall_s"}
            out = "outputs/durations"
            assert files(want_dir / spk / out) == files(got_dir / spk / out)
            for rel in files(want_dir / spk / out):
                np.testing.assert_array_equal(
                    np.load(got_dir / spk / out / rel),
                    np.load(want_dir / spk / out / rel))
    with open(jdir / SPEAKERS[0] / "dataset.pkl", "rb") as f:
        index = pickle.load(f)
    for stem, n_frames, _ in index:
        mel = np.load(jdir / SPEAKERS[0] / "mels" / f"{stem}.npy")
        tok = np.load(jdir / SPEAKERS[0] / "tokens" / f"{stem}.npy")
        post = atrain.posteriors(model, torch.from_numpy(mel[None]))[0]
        durs, gap = ma.extract_durations_margin(tok, post.numpy())
        assert durs.sum() == n_frames and gap > 1e-5, (stem, gap)


def _hubert_txt(corpus, jdir, path):
    """Synthetic units: one per mel frame less 0-2, so adjust_duration
    edits some rows (and skips none)."""
    rng = np.random.default_rng(1)
    entries = []
    for spk in SPEAKERS:
        with open(jdir / spk / "dataset.pkl", "rb") as f:
            index = pickle.load(f)
        for stem, n_frames, _ in index:
            n = n_frames - int(rng.integers(0, 3))
            entries.append({"audio": str(corpus / spk / "wavs" / f"{stem}.wav"),
                            "hubert": " ".join(map(str, rng.integers(0, 50, n))),
                            "duration": n * 320 / SR})
    write_manifest(path, entries)


def test_build_tte_manifests_and_vocoder_split_write_the_jax_files(
        prepared, tmp_path):
    """Given one alignment directory (tokens and a durations file per
    item), build_tte_manifests writes train.txt, val.txt and speakers.json
    byte-equal to the JAX package's, and prepare_vocoder_split its split."""
    corpus, jdir, _, _ = prepared
    align = tmp_path / "aligner"
    shutil.copytree(jdir, align)
    rng = np.random.default_rng(2)
    for spk in SPEAKERS:
        with open(align / spk / "dataset.pkl", "rb") as f:
            index = pickle.load(f)
        (align / spk / "outputs" / "durations").mkdir(parents=True,
                                                      exist_ok=True)
        for stem, n_frames, n_tok in index:
            # first and last at least 3, so adjust_duration can take 2
            durs = rng.multinomial(n_frames - 6, np.full(n_tok, 1 / n_tok))
            durs[0] += 3
            durs[-1] += 3
            np.save(align / spk / "outputs" / "durations" / f"{stem}.npy",
                    durs.astype(np.int32))
    hubert = tmp_path / "hubert.txt"
    _hubert_txt(corpus, jdir, hubert)
    want = jax_prep.build_tte_manifests(hubert, align, tmp_path / "jax",
                                        val_size=3, seed=0)
    got = prepare_tte.build_tte_manifests(hubert, align, tmp_path / "port",
                                          val_size=3, seed=0)
    assert got == want and got["skipped"] == 0
    assert got["train"] + got["val"] == len(SPEAKERS) * len(TEXTS)
    for name in ("train.txt", "val.txt", "speakers.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    assert (prepare_tte.prepare_vocoder_split(hubert, tmp_path / "pv", seed=3)
            == jax_prep.prepare_vocoder_split(hubert, tmp_path / "jv", seed=3))
    for name in ("train.txt", "val.txt"):
        assert ((tmp_path / "pv" / name).read_bytes()
                == (tmp_path / "jv" / name).read_bytes())
    for total, durs in ((10, [4, 3, 3]), (10, [4, 3, 5]), (10, [1, 1, 11]),
                        (10, [1, 8, 3]), (10, [2, 7, 3]), (10, [3, 3])):
        assert (prepare_tte.adjust_duration(total, durs)
                == jax_prep.adjust_duration(total, durs))


def test_train_aligner_logs_checkpoints_crashes_and_resumes(prepared,
                                                            tmp_path):
    """train_aligner on one speaker at a tiny width on the CPU: CTC_Loss and
    Params scalars, the three text artifacts, config.json and checkpoints;
    crash_at_step raises without the epoch save; a rerun resumes from the
    last checkpoint and reaches max_steps; extract-durations' files sum
    to each item's frames."""
    _, _, pdir, symbols = prepared
    data = tmp_path / "spk"
    shutil.copytree(pdir / SPEAKERS[0], data)
    mcfg = AlignerModelConfig(n_mels=80, conv_dim=16, lstm_dim=8,
                              num_symbols=len(symbols) + 1)
    tcfg = AlignerTrainConfig(batch_size=4, epochs=3, plot_steps=2,
                              checkpoint_steps=2, mel_bucket_sizes=(32,),
                              token_bucket_sizes=(16,))
    with pytest.raises(RuntimeError, match="simulated crash at step 3"):
        train_aligner.train_aligner(data, symbols, tcfg, model_cfg=mcfg,
                                    crash_at_step=3, epoch_saves=False,
                                    device="cpu")
    mgr = CheckpointManager(data / "ckpt")
    assert mgr.latest_step() == 2
    out = train_aligner.train_aligner(data, symbols, tcfg, model_cfg=mcfg,
                                      max_steps=5, device="cpu")
    assert out["steps"] == 5 and np.isfinite(out["ctc_loss"])
    assert mgr.latest_step() == 5 and mgr.restore()["step"] == 5
    logs = data / "logs"
    recs = [json.loads(l) for l in (logs / "metrics.jsonl").read_text()
            .splitlines()]
    steps = [r["step"] for r in recs if r["tag"] == "CTC_Loss"]
    assert steps == [1, 2, 3, 3, 4, 5]      # the crashed run logged step 3
    assert {"Params/batch_size", "Params/learning_rate"} <= {
        r["tag"] for r in recs}
    for tag in ("Text_Prediction", "Text_Target",
                "Text_Target_Duration_Repeated"):
        assert (logs / "text" / f"{tag}_4.txt").exists(), tag
    assert (data / "ckpt" / "config.json").exists()
    model = amodel.Aligner(mcfg)
    model.load_state_dict(mgr.restore()["params"], strict=True)
    extract_durations.extract_all_durations(data, model.eval(), batch_size=4)
    with open(data / "dataset.pkl", "rb") as f:
        for stem, n_frames, n_tok in pickle.load(f):
            durs = np.load(data / "outputs" / "durations" / f"{stem}.npy")
            assert len(durs) == n_tok and durs.sum() == n_frames


def test_pipeline_defaults_to_the_card(prepared, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    corpus, _, pdir, symbols = prepared
    with pytest.raises(RuntimeError, match="CUDA"):
        aligner_preprocess.compute_mels_and_tokens(
            corpus / SPEAKERS[0], tmp_path / "x", symbols)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_aligner.train_aligner(pdir / SPEAKERS[0], symbols,
                                    AlignerTrainConfig())


def test_card_training_needs_the_cublas_pin(prepared, monkeypatch):
    """On the card train_aligner refuses to start without cuBLAS's
    workspace pinned (torch reads the variable at the process's first
    cuBLAS call, too early for train_aligner to set it); the CLI's main
    pins it before any subcommand runs."""
    _, _, pdir, symbols = prepared
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    monkeypatch.setattr(train_aligner, "resolve_device",
                        lambda device: torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        train_aligner.train_aligner(pdir / SPEAKERS[0], symbols,
                                    AlignerTrainConfig())
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
