"""The port's CLI (python -m parrot_tts_tpu_torch.cli): the JAX CLI's
subcommands and arguments plus --device, and the single-process pipeline
driven end to end through it on the CPU at a tiny config (the aligner,
TTE and vocoder widths patched small; the subcommands, their arguments
and the JSON line each prints as a user runs them)."""

import argparse
import dataclasses
import functools
import json
import pickle
from unittest import mock

import numpy as np
import pytest
import torch

from parrot_tts_tpu import cli as jax_cli
from parrot_tts_tpu_torch import cli
from parrot_tts_tpu_torch.core import config as port_config
from parrot_tts_tpu_torch.core.checkpoint import (CheckpointManager,
                                                  save_config_json)
from parrot_tts_tpu_torch.core.config import (HubertConfig, PipelineConfig,
                                              TransformerStackConfig,
                                              TTEModelConfig, TTETrainConfig,
                                              VocoderModelConfig, to_json)
from parrot_tts_tpu_torch.data.audio_io import read_wav
from parrot_tts_tpu_torch.data.manifest import read_manifest, write_manifest
from parrot_tts_tpu_torch.models.hubert import model as hub
from parrot_tts_tpu_torch.models.vocoder import generator as gen
from parrot_tts_tpu_torch.pipeline import train_aligner as train_aligner_mod

from tests.test_torch_aligner_pipeline import SPEAKERS, TEXTS, write_corpus

TTE = TTEModelConfig(d_model=16, conv_n_filter=32, max_len=128,
                     encoder=TransformerStackConfig(1, 2, 0.0),
                     decoder=TransformerStackConfig(1, 2, 0.0),
                     dur_n_filter=8, hubert_codes=50)
TTE_TRAIN = TTETrainConfig(batch_size=2, grad_acc_steps=1, warmup_steps=0,
                           log_every=1, val_every=100, save_every=100,
                           src_buckets=(32,), tgt_buckets=(64,))
VOC = VocoderModelConfig(
    upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
    upsample_initial_channel=16, resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 2),), num_embeddings=50, embedding_dim=8,
    model_in_dim=16, num_speakers=2)


def _describe(parser: argparse.ArgumentParser) -> dict:
    """{subcommand: {option strings: (dest, default, type, choices,
    required, action, nargs)}}, help texts aside."""
    subs = [a for a in parser._actions
            if isinstance(a, argparse._SubParsersAction)][0]
    out = {}
    for name, sub in subs.choices.items():
        out[name] = {
            tuple(a.option_strings): (
                a.dest, a.default, a.type,
                tuple(a.choices) if a.choices else None, a.required,
                type(a).__name__, a.nargs)
            for a in sub._actions if not isinstance(a, argparse._HelpAction)}
    return out


def _jax_parser() -> argparse.ArgumentParser:
    """The parser the JAX CLI's main() builds, caught at parse_args."""
    caught = []

    def catch(self, *args, **kwargs):
        caught.append(self)
        raise SystemExit(0)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", catch):
        with pytest.raises(SystemExit):
            jax_cli.main(["preprocess-text"])
    return caught[0]


def test_parser_is_the_jax_parser_plus_device():
    want, got = _describe(_jax_parser()), _describe(cli.build_parser())
    assert list(got) == list(want) and len(got) == 13
    assert set(cli.DISPATCH) == set(jax_cli.DISPATCH)
    for name, opts in got.items():
        dev = opts.pop(("--device",))
        assert dev[:2] == ("device", None), name
        assert opts == want[name], name


def _run(capsys, *argv) -> dict:
    """main(argv) and the JSON object of its last stdout line."""
    cli.main([str(a) for a in argv])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _tiny_pipeline_config(**kw):
    return PipelineConfig(tte_model=TTE, tte_train=TTE_TRAIN, **kw)


@pytest.fixture
def tiny(monkeypatch):
    """The aligner, TTE and TTE-training widths the CLI takes by default,
    made tiny."""
    monkeypatch.setattr(train_aligner_mod, "AlignerModelConfig",
                        functools.partial(port_config.AlignerModelConfig,
                                          conv_dim=16, lstm_dim=8))
    monkeypatch.setattr(port_config, "PipelineConfig", _tiny_pipeline_config)


def test_pipeline_end_to_end_on_the_cpu(tmp_path, capsys, tiny):
    """run-aligner-pipeline -> ingest-units -> prepare-tte -> train-tte
    --max-steps 1 -> infer-tte -> prepare-vocoder -> synthesize, each with
    --device cpu, each printing the JAX CLI's JSON keys."""
    corpus = write_corpus(tmp_path / "corpus")
    runs = tmp_path / "runs"
    align = runs / "aligner"
    out = _run(capsys, "run-aligner-pipeline", "--dataset-dir", corpus,
               "--out-dir", align, "--epochs", 1, "--batch-size", 4,
               "--device", "cpu")
    assert out == {spk: "ok" for spk in SPEAKERS}
    units, rng = [], np.random.default_rng(0)
    for spk in SPEAKERS:
        with open(align / spk / "dataset.pkl", "rb") as f:
            index = pickle.load(f)
        assert len(index) == len(TEXTS)
        cfg = json.loads((align / spk / "ckpt" / "config.json").read_text())
        assert cfg["model"]["conv_dim"] == 16
        for stem, n_frames, n_tok in index:
            durs = np.load(align / spk / "outputs" / "durations"
                           / f"{stem}.npy")
            assert len(durs) == n_tok and durs.sum() == n_frames
            # one unit per mel frame (the clips are too short for
            # adjust_duration to take a frame off an edge token)
            units.append({"audio": str(corpus / spk / "wavs" / f"{stem}.wav"),
                          "hubert": " ".join(map(str, rng.integers(
                              0, 50, n_frames))),
                          "duration": n_frames * 320 / 16000})
    raw = runs / "raw_hubert.txt"
    write_manifest(raw, units + [{"audio": "no_units.wav"}])
    hubert = runs / "hubert.txt"
    assert _run(capsys, "ingest-units", "--hubert-txt", raw, "--out", hubert,
                "--device", "cpu") == {"entries": len(units), "dropped": 1}

    tte = runs / "TTE"
    out = _run(capsys, "prepare-tte", "--hubert-txt", hubert,
               "--alignment-path", align, "--out-dir", tte, "--val-size", 2,
               "--device", "cpu")
    assert out["train"] == len(units) - 2 and out["val"] == 2
    assert out["skipped"] == 0 and set(out["speakers"]) == set(SPEAKERS)

    out = _run(capsys, "train-tte", "--root-path", tte, "--alignment-path",
               align, "--max-steps", 1, "--device", "cpu")
    assert out["steps"] == 1
    preds = tte / "predictions.txt"
    out = _run(capsys, "infer-tte", "--root-path", tte, "--alignment-path",
               align, "--ckpt-dir", tte / "ckpt", "--out", preds,
               "--device", "cpu")
    assert out == {"predictions": str(preds), "items": 2}
    assert len(read_manifest(preds)) == 2

    voc = runs / "vocoder"
    out = _run(capsys, "prepare-vocoder", "--hubert-txt", hubert,
               "--out-dir", voc, "--device", "cpu")
    assert out["train"] + out["val"] == len(units) and out["val"] == 1

    # a vocoder checkpoint as vocoder training saves it, at a tiny width
    ckpt = runs / "vocoder_run" / "ckpt"
    CheckpointManager(ckpt).save(1, {"gen": gen.init_code_generator(
        VOC, torch.Generator().manual_seed(0))})
    save_config_json(ckpt, to_json(VOC))
    gen_dir = runs / "gen"
    out = _run(capsys, "synthesize", "--manifest", hubert, "--ckpt-dir", ckpt,
               "--out-dir", gen_dir, "--copy-gt", "-n", 3, "--device", "cpu")
    assert out["wavs"] == 3 and out["gt"] == 3 and out["rtf"] > 0
    entries = read_manifest(hubert)[:3]
    for e in entries:
        stem = e["audio"].rsplit("/", 1)[1][:-4]
        wav, sr = read_wav(gen_dir / f"{stem}_gen.wav")
        assert sr == 16000
        assert len(wav) == len(e["hubert"].split()) * VOC.total_upsample
        assert (gen_dir / f"{stem}_gt.wav").exists()

    # --mesh over the one given device writes the same waveforms
    mesh_dir = runs / "gen_mesh"
    out = _run(capsys, "synthesize", "--manifest", hubert, "--ckpt-dir", ckpt,
               "--out-dir", mesh_dir, "-n", 3, "--mesh", "--device", "cpu")
    assert out["wavs"] == 3
    for e in entries:
        stem = e["audio"].rsplit("/", 1)[1][:-4]
        np.testing.assert_array_equal(read_wav(mesh_dir / f"{stem}_gen.wav")[0],
                                      read_wav(gen_dir / f"{stem}_gen.wav")[0])
    # --dtype bfloat16 overrides the checkpoint config's float32: the
    # float32 wavs within the bf16 budget, SNR >= 40 dB and max |diff|
    # 4e-3 plus two int16 steps of the written files (V1's 2e-3 does not
    # hold at this width for the JAX package either: its own bf16 waveform
    # is more than 2e-3 from its float32 one here, and the port's bf16
    # matches it; test_torch_bf16.py::test_cli_width_bf16_is_the_jax_packages)
    bf16_dir = runs / "gen_bf16"
    out = _run(capsys, "synthesize", "--manifest", hubert, "--ckpt-dir", ckpt,
               "--out-dir", bf16_dir, "-n", 3, "--dtype", "bfloat16",
               "--device", "cpu")
    assert out["wavs"] == 3
    assert len(list(bf16_dir.glob("*_gen.wav"))) == 3
    for e in entries:
        stem = e["audio"].rsplit("/", 1)[1][:-4]
        got, want = (read_wav(d / f"{stem}_gen.wav")[0] / 32768.0
                     for d in (bf16_dir, gen_dir))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 4e-3 + 2 / 32768.0
        assert 10 * np.log10((want ** 2).sum()
                             / ((got - want) ** 2).sum()) >= 40.0


def test_aligner_subcommands_one_at_a_time(tmp_path, capsys, tiny):
    """preprocess-text -> preprocess-aligner -> train-aligner ->
    extract-durations --method beam on one speaker."""
    corpus = write_corpus(tmp_path / "corpus")
    out_dir = tmp_path / "aligner"
    sym = _run(capsys, "preprocess-text", "--dataset-dir", corpus,
               "--out-dir", out_dir, "--device", "cpu")
    spk = SPEAKERS[1]
    assert _run(capsys, "preprocess-aligner", "--dataset-dir", corpus,
                "--speaker", spk, "--out-dir", out_dir / spk,
                "--device", "cpu") == {"items": len(TEXTS)}
    out = _run(capsys, "train-aligner", "--data-dir", out_dir / spk,
               "--epochs", 2, "--batch-size", 4, "--device", "cpu")
    assert out["steps"] == 4 and np.isfinite(out["ctc_loss"])
    assert sym["symbols"] + 1 == json.loads(
        (out_dir / spk / "ckpt" / "config.json").read_text()
    )["model"]["num_symbols"]
    assert _run(capsys, "extract-durations", "--data-dir", out_dir / spk,
                "--ckpt-dir", out_dir / spk / "ckpt", "--method", "beam",
                "--beam-width", 4, "--device", "cpu") == {"items": len(TEXTS)}
    with open(out_dir / spk / "dataset.pkl", "rb") as f:
        for stem, n_frames, _ in pickle.load(f):
            durs = np.load(out_dir / spk / "outputs" / "durations"
                           / f"{stem}.npy")
            assert durs.sum() == n_frames


def test_extract_units_and_train_vocoder(tmp_path, capsys, monkeypatch):
    """extract-units on a tiny HuBERT checkpoint file (HF keys, read back
    by load_hubert) and a .npy codebook; train-vocoder hands its
    arguments and device to pipeline/train_vocoder.run."""
    corpus = write_corpus(tmp_path / "corpus")
    hcfg = HubertConfig(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3),
                        conv_stride=(5, 2, 2), d_model=32, n_layer=2,
                        n_head=1, ffn_dim=64, pos_conv_kernel=8,
                        pos_conv_groups=2)
    torch.save(hub.init_hubert(hcfg, torch.Generator().manual_seed(0)),
               tmp_path / "hubert.bin")
    np.save(tmp_path / "km.npy",
            np.random.default_rng(0).standard_normal((20, 32)).astype(
                np.float32))
    out = _run(capsys, "extract-units", "--ckpt", tmp_path / "hubert.bin",
               "--kmeans", tmp_path / "km.npy", "--dataset-dir", corpus,
               "--out-dir", tmp_path / "units", "--layer", 2,
               "--batch-size", 4, "--device", "cpu")
    assert out == {"wavs": len(SPEAKERS) * len(TEXTS),
                   "out": str(tmp_path / "units" / "hubert.txt")}
    entries = read_manifest(tmp_path / "units" / "hubert.txt")
    assert all(0 <= int(u) < 20 for e in entries for u in e["hubert"].split())

    calls = []
    monkeypatch.setattr("parrot_tts_tpu_torch.pipeline.train_vocoder.run",
                        lambda cfg, **kw: calls.append((cfg, kw))
                        or {"steps": kw["max_steps"], "epochs": 1})
    assert _run(capsys, "train-vocoder", "--data-dir", tmp_path / "v",
                "--max-steps", 3, "--device", "cpu") == {"steps": 3,
                                                         "epochs": 1}
    cfg, kw = calls[0]
    assert dataclasses.asdict(cfg.vocoder_model) == dataclasses.asdict(
        VocoderModelConfig())
    assert kw == {"data_dir": str(tmp_path / "v"), "run_dir": "runs/vocoder",
                  "max_steps": 3, "device": "cpu"}


def test_subcommands_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    corpus = write_corpus(tmp_path / "corpus")
    cli.main(["preprocess-text", "--dataset-dir", str(corpus), "--out-dir",
              str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["preprocess-aligner", "--dataset-dir", str(corpus),
                  "--speaker", SPEAKERS[0], "--out-dir",
                  str(tmp_path / "a" / SPEAKERS[0])])
