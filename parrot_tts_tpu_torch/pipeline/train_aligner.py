"""Aligner training: the CTC loop, logs, text artifacts and
checkpoints; port of `parrot_tts_tpu/pipeline/train_aligner.py`.

Reference: `utils/aligner/trainer.py`: per-step scalars (CTC_Loss,
Params/batch_size, Params/learning_rate, trainer.py:73-75), checkpoints
every `checkpoint_steps`, and every `plot_steps` a debug pass on the
LONGEST mel in the dataset (trainer.py:24-26, 90-116): the greedy CTC
decode against the target transcript, and the target with each symbol
repeated by its extracted duration. The step itself (IEEE float32 CTC,
the non-finite skip) is `train/aligner.py`.

On the card a step repeats bit for bit only when cuBLAS's workspace is
pinned (CUBLAS_WORKSPACE_CONFIG=:4096:8 or :16:8) for cuDNN's LSTM
backward. torch reads the variable once, when the process makes its first
cuBLAS handle, so the caller sets it before its first CUDA call, as
`cli.main` does; `train_aligner` raises on the card when it is unset.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from parrot_tts_tpu_torch.core import checkpoint as ckptlib
from parrot_tts_tpu_torch.core.config import (AlignerModelConfig,
                                              AlignerTrainConfig,
                                              aligner_configs_to_json)
from parrot_tts_tpu_torch.core.device import resolve_device
from parrot_tts_tpu_torch.core.metrics import MetricsWriter
from parrot_tts_tpu_torch.data.aligner_data import (AlignerDataset,
                                                    AlignerLoader)
from parrot_tts_tpu_torch.models.aligner.model import Aligner
from parrot_tts_tpu_torch.ops.monotonic_align import extract_durations
from parrot_tts_tpu_torch.text.tokenizer import CharTokenizer
from parrot_tts_tpu_torch.train import aligner as atrain

# cuBLAS workspace settings under which its results repeat bit for bit
DETERMINISTIC_WORKSPACES = (":4096:8", ":16:8")


def _longest_sample(ds: AlignerDataset) -> tuple[np.ndarray, np.ndarray]:
    """The dataset's longest mel and its tokens, the reference's fixed
    plot subject (trainer.py:24-26, dataset.py::get_longest_mel_id)."""
    i = max(range(len(ds.index)), key=lambda j: ds.index[j][1])
    return ds.load(i)


def log_alignment_artifacts(writer: MetricsWriter, model: Aligner,
                            tokenizer: CharTokenizer, mel: np.ndarray,
                            tokens: np.ndarray, step: int) -> dict:
    """Debug pass matching reference trainer.py:90-116: eval-mode
    posteriors on one sample -> greedy decode text, target text, and the
    target with each symbol repeated by its extracted duration."""
    device = next(model.parameters()).device
    post = atrain.posteriors(
        model, torch.from_numpy(mel[None]).to(device))[0].cpu().numpy()
    debug = atrain.alignment_debug_text(
        np.log(np.maximum(post, 1e-10)), tokens, len(tokens), tokenizer)
    durations = extract_durations(tokens.astype(np.int64), post)
    # per-token decode (the reference splits the joined string,
    # trainer.py:106-110, which breaks when a symbol IS a space)
    symbols = [tokenizer.idx_to_token.get(int(t), "") for t in tokens]
    repeated = "".join(s * int(d) for s, d in zip(symbols, durations))
    writer.text("Text/Prediction", "    " + debug["decoded"], step)
    writer.text("Text/Target", "    " + debug["target"], step)
    writer.text("Text/Target_Duration_Repeated", "    " + repeated, step)
    return debug


def train_aligner(data_dir: str | Path, symbols: list[str],
                  train_cfg: AlignerTrainConfig,
                  model_cfg: AlignerModelConfig | None = None,
                  log_dir: str | Path | None = None, seed: int = 0,
                  max_steps: int | None = None,
                  crash_at_step: int | None = None,
                  epoch_saves: bool = True, device=None) -> dict:
    """Train the CTC aligner on one speaker's mels/tokens directory.

    Resumes from `data_dir/ckpt` when a checkpoint exists (the reference
    resumes from `latest_model.pt`, trainer.py:43-53). `max_steps` caps
    the step count across epochs; `crash_at_step` is the recovery-drill
    hook: it raises WITHOUT the end-of-epoch save, as a real crash would.
    `epoch_saves=False` drops the reference's per-epoch save and keeps the
    `checkpoint_steps` cadence alone. device: default the CUDA card
    (raises without one, or without the cuBLAS workspace pin of the
    module docstring); "cpu" runs on the host. Returns
    {"steps", "ctc_loss"}."""
    device = resolve_device(device)
    if (device.type == "cuda" and os.environ.get("CUBLAS_WORKSPACE_CONFIG")
            not in DETERMINISTIC_WORKSPACES):
        raise RuntimeError(
            "aligner training on the card needs CUBLAS_WORKSPACE_CONFIG="
            ":4096:8 (or :16:8) in the environment before the process's "
            "first CUDA call, so that cuDNN's LSTM backward repeats bit for "
            "bit")
    data_dir = Path(data_dir)
    ds = AlignerDataset(data_dir)
    if model_cfg is None:
        model_cfg = AlignerModelConfig(n_mels=ds.load(0)[0].shape[1],
                                       num_symbols=len(symbols) + 1)
    loader = AlignerLoader(ds, train_cfg.batch_size,
                           train_cfg.mel_bucket_sizes,
                           train_cfg.token_bucket_sizes)
    tokenizer = CharTokenizer(symbols, for_phonemes=True)
    plot_mel, plot_tokens = _longest_sample(ds)

    state = atrain.init_state(seed, model_cfg, device)
    mgr = ckptlib.CheckpointManager(data_dir / "ckpt")
    # the config beside the checkpoints, so extract-durations can rebuild
    # the model (the reference embeds it in the checkpoint, trainer.py:77-88)
    ckptlib.save_config_json(data_dir / "ckpt",
                             aligner_configs_to_json(model_cfg, train_cfg))
    if mgr.latest_step() is not None:
        state.load_state_dict(mgr.restore())
    writer = MetricsWriter(Path(log_dir) if log_dir is not None
                           else data_dir / "logs")

    step = state.step
    last_loss = float("nan")
    done = False
    try:
        for epoch in range(train_cfg.epochs):
            for batch in loader.batches(epoch):
                metrics = atrain.train_step(
                    state, atrain.to_batch(batch, device), train_cfg)
                step += 1
                last_loss = float(metrics["ctc_loss"])
                writer.scalar("CTC_Loss", last_loss, step)
                writer.scalar("Params/batch_size", train_cfg.batch_size, step)
                writer.scalar("Params/learning_rate",
                              train_cfg.learning_rate, step)
                if step % train_cfg.checkpoint_steps == 0:
                    mgr.save(step, state.state_dict())
                if step % train_cfg.plot_steps == 0:
                    log_alignment_artifacts(writer, state.model, tokenizer,
                                            plot_mel, plot_tokens, step)
                if crash_at_step is not None and step >= crash_at_step:
                    raise RuntimeError(
                        f"simulated crash at step {step} (recovery drill)")
                if max_steps is not None and step >= max_steps:
                    done = True
                    break
            if done:
                mgr.save(step, state.state_dict(), wait=True)
                break
            if epoch_saves:
                mgr.save(step, state.state_dict(),
                         wait=epoch == train_cfg.epochs - 1)
        # final artifacts so short runs still produce inspectables
        log_alignment_artifacts(writer, state.model, tokenizer, plot_mel,
                                plot_tokens, step)
    finally:
        writer.close()
    return {"steps": step, "ctc_loss": last_loss}
