"""CLI: the reference's pipeline as subcommands; port of
`parrot_tts_tpu/cli.py`.

Reference workflow (README.md:29-101): preprocess-text, train-aligner,
extract-durations, extract-units (ingest), prepare-tte, train-tte,
infer-tte, prepare-vocoder, train-vocoder, synthesize. The subcommands,
their arguments, defaults and the JSON line each prints are the JAX CLI's.
Every subcommand also takes `--device` (default: the CUDA card, which is
required unless `--device cpu` is given); `main` pins cuBLAS's workspace
(CUBLAS_WORKSPACE_CONFIG=:4096:8 unless set) before any subcommand runs.
`synthesize --mesh` shards each batch over every visible CUDA device (or
over `--device` alone when one is given). Data-parallel training:
`torchrun --nproc_per_node=N -m parrot_tts_tpu_torch.cli train-tte ...`
(or `train-vocoder`).

Usage: python -m parrot_tts_tpu_torch.cli <subcommand> [args]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs on the host)")
    p = argparse.ArgumentParser(prog="parrot_tts_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name: str, help: str) -> argparse.ArgumentParser:
        return sub.add_parser(name, help=help, parents=[common])

    s = add("preprocess-text", "clean corpus text + build symbol inventory")
    s.add_argument("--dataset-dir", required=True)
    s.add_argument("--out-dir", required=True)
    s.add_argument("--transliterate", action="store_true")

    s = add("preprocess-aligner", "per-speaker mel/token npy dump")
    s.add_argument("--dataset-dir", required=True)
    s.add_argument("--speaker", required=True)
    s.add_argument("--out-dir", required=True)

    s = add("train-aligner", "CTC aligner training")
    s.add_argument("--data-dir", required=True)
    s.add_argument("--epochs", type=int, default=450)
    s.add_argument("--batch-size", type=int, default=16)

    s = add("extract-durations",
            "monotonic-path durations from aligner posteriors")
    s.add_argument("--data-dir", required=True)
    s.add_argument("--ckpt-dir", required=True)
    s.add_argument("--method", choices=("dijkstra", "beam"),
                   default="dijkstra",
                   help="path extraction: shortest-path DP (default) or "
                        "k-best beam search (reference durations.method)")
    s.add_argument("--beam-width", type=int, default=10)

    s = add("run-aligner-pipeline",
            "preprocess + train + extract for every speaker (the "
            "reference's utils/aligner/train.sh loop, without its "
            "sed-rewritten YAML)")
    s.add_argument("--dataset-dir", required=True)
    s.add_argument("--out-dir", required=True)
    s.add_argument("--epochs", type=int, default=450)
    s.add_argument("--batch-size", type=int, default=16)

    s = add("extract-units",
            "HuBERT unit extraction: walks <dataset-dir>/<speaker>/wavs/"
            "*.wav, writes hubert.txt (reference utils/hubert_extraction/"
            "extractor.py, batched here)")
    s.add_argument("--ckpt", required=True,
                   help="HuBERT weights: HF pytorch_model.bin/.safetensors "
                        "or a fairseq checkpoint .pt")
    s.add_argument("--kmeans", required=True,
                   help="k-means codebook: joblib .bin or .npy centers")
    s.add_argument("--dataset-dir", required=True)
    s.add_argument("--out-dir", required=True)
    s.add_argument("--layer", type=int, default=11)
    s.add_argument("--batch-size", type=int, default=8)
    s.add_argument("--normalize", action="store_true",
                   help="wav-level layer norm (large-style checkpoints)")

    s = add("ingest-units",
            "validate + register a precomputed hubert.txt (the reference "
            "also documents downloading units, README.md:52)")
    s.add_argument("--hubert-txt", required=True)
    s.add_argument("--out", required=True)

    s = add("prepare-tte", "join units+tokens+durations")
    s.add_argument("--hubert-txt", required=True)
    s.add_argument("--alignment-path", required=True)
    s.add_argument("--out-dir", required=True)
    s.add_argument("--val-size", type=int, default=100)
    s.add_argument("--speaker-method", default="_")

    s = add("train-tte", "TTE transformer training")
    s.add_argument("--root-path", required=True)
    s.add_argument("--alignment-path", required=True)
    s.add_argument("--max-steps", type=int, default=None)

    s = add("infer-tte", "write predictions.txt")
    s.add_argument("--root-path", required=True)
    s.add_argument("--alignment-path", required=True)
    s.add_argument("--ckpt-dir", required=True)
    s.add_argument("--out", required=True)

    s = add("prepare-vocoder", "98/2 split of hubert.txt")
    s.add_argument("--hubert-txt", required=True)
    s.add_argument("--out-dir", required=True)

    s = add("train-vocoder", "unit HiFi-GAN GAN training")
    s.add_argument("--data-dir", required=True)
    s.add_argument("--run-dir", default="runs/vocoder")
    s.add_argument("--max-steps", type=int, default=None)

    s = add("synthesize", "units manifest -> wavs (batched, optional "
                          "all-speaker --vc sweep)")
    s.add_argument("--manifest", required=True)
    s.add_argument("--ckpt-dir", required=True)
    s.add_argument("--out-dir", required=True)
    s.add_argument("--vc", action="store_true")
    s.add_argument("--copy-gt", action="store_true",
                   help="write peak-normalized <name>_gt.wav next to "
                        "generations (reference inference.py:171-175)")
    s.add_argument("--debug", action="store_true",
                   help="serial one-utterance-at-a-time synthesis "
                        "(reference inference.py:237-251)")
    s.add_argument("--mesh", action="store_true",
                   help="shard each batch over every visible CUDA device "
                        "(core/mesh.py::create_mesh)")
    s.add_argument("-n", "--limit", type=int, default=None,
                   help="stop after N utterances (reference -n)")
    s.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="serving compute dtype (default: checkpoint config)")
    s.add_argument("--quant", default=None,
                   choices=["none", "int8-tail", "int8", "int8-static"],
                   help="int8 serving path (ops/qconv.py's kernels; "
                        "int8-static adds calibrated static activation "
                        "scales, generator_staticq.py)")
    return p


def main(argv=None):
    # before any subcommand touches the card: torch reads the variable at
    # the process's first cuBLAS call (run-aligner-pipeline's mels come
    # before its training), and aligner training repeats bit for bit only
    # with the workspace pinned (pipeline/train_aligner.py)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    args = build_parser().parse_args(argv)
    return DISPATCH[args.cmd](args)


def _preprocess_text(args):
    from parrot_tts_tpu_torch.pipeline.aligner_preprocess import clean_corpus

    symbols = clean_corpus(args.dataset_dir, args.out_dir, args.transliterate)
    print(json.dumps({"symbols": len(symbols)}))


def _preprocess_aligner(args):
    from parrot_tts_tpu_torch.pipeline.aligner_preprocess import (
        compute_mels_and_tokens)
    from parrot_tts_tpu_torch.text.tokenizer import load_symbols

    out_root = Path(args.out_dir)
    symbols = load_symbols(out_root.parent / "symbols.pkl"
                           if (out_root.parent / "symbols.pkl").exists()
                           else out_root / "symbols.pkl")
    stats = compute_mels_and_tokens(Path(args.dataset_dir) / args.speaker,
                                    out_root, symbols, device=args.device)
    print(json.dumps(stats))


def _train_aligner(args):
    from parrot_tts_tpu_torch.core.config import AlignerTrainConfig
    from parrot_tts_tpu_torch.pipeline.train_aligner import train_aligner
    from parrot_tts_tpu_torch.text.tokenizer import load_symbols

    data_dir = Path(args.data_dir)
    symbols = load_symbols(data_dir.parent / "symbols.pkl")
    tcfg = AlignerTrainConfig(epochs=args.epochs, batch_size=args.batch_size)
    print(json.dumps(train_aligner(data_dir, symbols, tcfg,
                                   device=args.device)))


def _extract_durations(args):
    from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
    from parrot_tts_tpu_torch.core.config import (AlignerModelConfig,
                                                  aligner_configs_from_json)
    from parrot_tts_tpu_torch.core.device import resolve_device
    from parrot_tts_tpu_torch.models.aligner.model import Aligner
    from parrot_tts_tpu_torch.pipeline.extract_durations import (
        extract_all_durations)

    # the model config saved beside the checkpoints; a directory without
    # one takes the default config, as in the JAX package
    cfg_path = Path(args.ckpt_dir) / "config.json"
    mcfg = (aligner_configs_from_json(cfg_path.read_text())[0]
            if cfg_path.exists() else AlignerModelConfig())
    model = Aligner(mcfg)
    model.load_state_dict(CheckpointManager(args.ckpt_dir).restore()["params"],
                          strict=True)
    model.to(resolve_device(args.device)).eval()
    stats = extract_all_durations(
        args.data_dir, model, method=getattr(args, "method", "dijkstra"),
        beam_width=getattr(args, "beam_width", 10))
    print(json.dumps(stats))


def _run_aligner_pipeline(args):
    """Loop all speakers through preprocess -> CTC train -> durations
    (reference utils/aligner/train.sh:13-28)."""
    from types import SimpleNamespace

    from parrot_tts_tpu_torch.pipeline.aligner_preprocess import (
        clean_corpus, compute_mels_and_tokens)

    dataset_dir, out_dir = Path(args.dataset_dir), Path(args.out_dir)
    symbols = clean_corpus(dataset_dir, out_dir)
    results = {}
    for spk_dir in sorted(p for p in dataset_dir.iterdir() if p.is_dir()):
        spk = spk_dir.name
        spk_out = out_dir / spk
        compute_mels_and_tokens(spk_dir, spk_out, symbols,
                                device=args.device)
        _train_aligner(SimpleNamespace(
            data_dir=str(spk_out), epochs=args.epochs,
            batch_size=args.batch_size, device=args.device))
        _extract_durations(SimpleNamespace(
            data_dir=str(spk_out), ckpt_dir=str(spk_out / "ckpt"),
            device=args.device))
        results[spk] = "ok"
    print(json.dumps(results))


def _extract_units(args):
    import dataclasses

    from parrot_tts_tpu_torch.infer.unit_extractor import UnitExtractor
    from parrot_tts_tpu_torch.models.hubert.convert import (
        load_hubert, load_kmeans_centers)
    from parrot_tts_tpu_torch.pipeline.extract_units import (
        extract_units_corpus)

    model, cfg = load_hubert(args.ckpt)
    cfg = dataclasses.replace(cfg, output_layer=args.layer,
                              normalize_input=args.normalize)
    extractor = UnitExtractor(model.state_dict(), cfg,
                              load_kmeans_centers(args.kmeans),
                              batch_size=args.batch_size, device=args.device)
    entries = extract_units_corpus(extractor, args.dataset_dir, args.out_dir)
    print(json.dumps({"wavs": len(entries),
                      "out": str(Path(args.out_dir) / "hubert.txt")}))


def _ingest_units(args):
    from parrot_tts_tpu_torch.data.manifest import (read_manifest,
                                                    write_manifest)

    entries = read_manifest(args.hubert_txt)
    ok = [e for e in entries if "hubert" in e and "audio" in e]
    write_manifest(args.out, ok)
    print(json.dumps({"entries": len(ok), "dropped": len(entries) - len(ok)}))


def _prepare_tte(args):
    from parrot_tts_tpu_torch.pipeline.prepare_tte import build_tte_manifests

    stats = build_tte_manifests(
        args.hubert_txt, args.alignment_path, args.out_dir,
        speaker_method=args.speaker_method, val_size=args.val_size)
    print(json.dumps(stats))


def _train_tte(args):
    from parrot_tts_tpu_torch.core.config import PipelineConfig
    from parrot_tts_tpu_torch.pipeline.train_tte import run

    cfg = PipelineConfig(root_path=args.root_path,
                         alignment_path=args.alignment_path)
    print(json.dumps(run(cfg, max_steps=args.max_steps, device=args.device)))


def _infer_tte(args):
    import dataclasses

    from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
    from parrot_tts_tpu_torch.core.config import PipelineConfig
    from parrot_tts_tpu_torch.core.device import resolve_device
    from parrot_tts_tpu_torch.data.tte_data import TTEDataset
    from parrot_tts_tpu_torch.infer.tte_infer import write_predictions
    from parrot_tts_tpu_torch.models.tte.parrot import Parrot

    cfg = PipelineConfig(root_path=args.root_path,
                         alignment_path=args.alignment_path)
    ds = TTEDataset(cfg.root_path, cfg.alignment_path, "val",
                    cfg.tte_model.hubert_codes)
    model_cfg = dataclasses.replace(
        cfg.tte_model, vocab_size=ds.vocab_size,
        n_speaker=len(ds.speaker_map), pad_idx=ds.src_pad_idx)
    device = resolve_device(args.device)
    model = Parrot(model_cfg)
    model.load_state_dict(CheckpointManager(args.ckpt_dir).restore()["params"],
                          strict=True)
    out = write_predictions(model.to(device).eval(), ds, args.out,
                            device=device)
    print(json.dumps({"predictions": str(out), "items": len(ds)}))


def _prepare_vocoder(args):
    from parrot_tts_tpu_torch.pipeline.prepare_tte import (
        prepare_vocoder_split)

    print(json.dumps(prepare_vocoder_split(args.hubert_txt, args.out_dir)))


def _train_vocoder(args):
    from parrot_tts_tpu_torch.core.config import PipelineConfig
    from parrot_tts_tpu_torch.pipeline.train_vocoder import run

    print(json.dumps(run(PipelineConfig(), data_dir=args.data_dir,
                         run_dir=args.run_dir, max_steps=args.max_steps,
                         device=args.device)))


def _synthesize(args):
    import dataclasses

    import numpy as np

    from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
    from parrot_tts_tpu_torch.core.config import (PipelineConfig,
                                                  vocoder_config_from_json)
    from parrot_tts_tpu_torch.data.audio_io import read_wav, write_wav
    from parrot_tts_tpu_torch.data.manifest import (parse_speaker,
                                                    read_manifest)
    from parrot_tts_tpu_torch.core.mesh import create_mesh
    from parrot_tts_tpu_torch.infer.synthesize import (VocoderSynthesizer,
                                                       peak_normalize)

    saved_cfg = Path(args.ckpt_dir) / "config.json"
    vcfg = (vocoder_config_from_json(saved_cfg.read_text())
            if saved_cfg.exists() else PipelineConfig().vocoder_model)
    # --dtype / --quant override the checkpoint config's
    over = {k: getattr(args, k) for k in ("dtype", "quant")
            if getattr(args, k, None)}
    if over:
        vcfg = dataclasses.replace(vcfg, **over)
    state = CheckpointManager(args.ckpt_dir).restore()
    # a vocoder training checkpoint holds the generator under "gen"
    gen_state = state["gen"] if "gen" in state else state
    mesh = None
    if getattr(args, "mesh", False):
        mesh = create_mesh(None if args.device is None else [args.device])
    synth = VocoderSynthesizer(gen_state, vcfg, device=args.device,
                               mesh=mesh)

    entries = read_manifest(args.manifest)
    if getattr(args, "limit", None):
        entries = entries[: args.limit]
    codes = [np.asarray([int(c) for c in e["hubert"].split(" ")], np.int32)
             for e in entries]
    spk_names = sorted({parse_speaker(e["audio"], "_") for e in entries})
    spk_map = {s: i for i, s in enumerate(spk_names)}
    speakers = [spk_map.get(parse_speaker(e["audio"], "_"), 0)
                for e in entries]
    names = [Path(e["audio"]).stem for e in entries]

    f0_tracks = None
    if vcfg.f0:
        # f0-conditioned checkpoint: code-rate pitch from each utterance's
        # SOURCE audio (the reference's CodeDataset semantics)
        from parrot_tts_tpu_torch.ops.f0 import f0_for_codes

        wavs, rates = [], set()
        for e in entries:
            w, sr = read_wav(e["audio"])
            wavs.append(np.asarray(w, np.float32) / 32768.0)
            rates.add(sr)
        if len(rates) != 1:
            raise ValueError(f"mixed sample rates in manifest: {rates}")
        f0_tracks = f0_for_codes(wavs, [len(c) for c in codes],
                                 rate=rates.pop(),
                                 code_hop=vcfg.total_upsample,
                                 device=synth.device)

    if args.vc:  # all-speaker sweep (reference inference.py:157-170)
        n_spk = vcfg.num_speakers
        all_codes = [c for c in codes for _ in range(n_spk)]
        all_spk = [k for _ in codes for k in range(n_spk)]
        all_names = [f"{n}_spk{k}" for n in names for k in range(n_spk)]
        codes, speakers, out_names = all_codes, all_spk, all_names
        if f0_tracks is not None:   # the source track rides every speaker
            f0_tracks = [t for t in f0_tracks for _ in range(n_spk)]
    else:
        out_names = names

    if getattr(args, "debug", False):
        # serial path (reference --debug, inference.py:237-251): one
        # utterance per device call, no bucketed batching
        paths = []
        for i, (c, s, n) in enumerate(zip(codes, speakers, out_names)):
            paths += synth.to_wavs(
                [c], [s], args.out_dir, [n],
                f0=[f0_tracks[i]] if f0_tracks is not None else None)
    else:
        paths = synth.to_wavs(codes, speakers, args.out_dir, out_names,
                              f0=f0_tracks)

    copied = 0
    if getattr(args, "copy_gt", False):
        # ground-truth copies next to generations (inference.py:171-175)
        out_dir = Path(args.out_dir)
        for e, name in zip(entries, names):
            src = Path(e["audio"])
            if not src.exists():
                continue
            wav, sr = read_wav(src)
            wav = peak_normalize(wav.astype(np.float32) / 32768.0)
            write_wav(out_dir / f"{name}_gt.wav", wav, sr)
            copied += 1
    print(json.dumps({"wavs": len(paths), "gt": copied,
                      "rtf": synth.last_rtf}))


DISPATCH = {
    "preprocess-text": _preprocess_text,
    "run-aligner-pipeline": _run_aligner_pipeline,
    "preprocess-aligner": _preprocess_aligner,
    "train-aligner": _train_aligner,
    "extract-durations": _extract_durations,
    "extract-units": _extract_units,
    "ingest-units": _ingest_units,
    "prepare-tte": _prepare_tte,
    "train-tte": _train_tte,
    "infer-tte": _infer_tte,
    "prepare-vocoder": _prepare_vocoder,
    "train-vocoder": _train_vocoder,
    "synthesize": _synthesize,
}


if __name__ == "__main__":
    sys.exit(main())
