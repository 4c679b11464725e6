"""Vocoder GAN training entry point: data -> GAN steps -> validation /
checkpoints / logs.

Port of `parrot_tts_tpu/pipeline/train_vocoder.py` (the runnable
counterpart of the reference's `torch.distributed.run
utils/vocoder/train.py`, `:244-291`). Unlike the reference, startup never
wipes the checkpoint directory, and a run resumes from its latest
checkpoint by default. Batches are read in a background thread and copied
to the device one step ahead (`data/prefetch.py`).

Data parallelism: under torchrun every rank trains on its device and takes
its slice of each global batch of max(1, batch_size // N) * N rows (the
JAX package's rounding, which differs from the TTE's batch_size * N; the
reference divides its global batch across workers, train.py:279). Rank 0
alone validates and writes logs and checkpoints; the ranks meet at a
barrier after each save.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from parrot_tts_tpu_torch.core import checkpoint as ckptlib
from parrot_tts_tpu_torch.core import mesh as meshlib
from parrot_tts_tpu_torch.core.config import PipelineConfig, to_json
from parrot_tts_tpu_torch.core.metrics import MetricsWriter, Throughput
from parrot_tts_tpu_torch.data.prefetch import (device_prefetch,
                                                threaded_loader)
from parrot_tts_tpu_torch.data.vocoder_data import (VocoderDataset,
                                                    VocoderLoader,
                                                    code_rate_f0)
from parrot_tts_tpu_torch.models.vocoder import generator as gen
from parrot_tts_tpu_torch.ops import stft
from parrot_tts_tpu_torch.train import vocoder as voc_train


def run(cfg: PipelineConfig, *, data_dir: str | Path,
        run_dir: str | Path = "runs/vocoder", max_steps: int | None = None,
        resume: bool = True, crash_at_step: int | None = None,
        device=None) -> dict:
    """Train on <data_dir>/{train,val}.txt until `max_steps` steps (default
    `training_epochs` epochs); checkpoints go to <run_dir>/ckpt (generator,
    discriminators with their spectral-norm vectors, both optimizers'
    moments, the step), logs to <run_dir>/logs. resume=True carries on from
    the latest checkpoint there. device: default the CUDA card (raises
    without one unless "cpu"), under torchrun the rank's card.
    crash_at_step: recovery-drill hook; raise at that step WITHOUT the
    final checkpoint. Returns {"steps", "epochs"}."""
    mesh = meshlib.training_mesh(device, cfg.mesh)
    device = mesh.devices[0]
    main = meshlib.is_main()
    run_dir = Path(run_dir)
    mcfg, tcfg, mel_cfg = cfg.vocoder_model, cfg.vocoder_train, cfg.mel

    train_ds = VocoderDataset(
        Path(data_dir) / "train.txt", segment_size=tcfg.segment_size,
        code_hop_size=tcfg.code_hop_size, multispkr=mcfg.multispkr)
    val_ds = VocoderDataset(
        Path(data_dir) / "val.txt", segment_size=tcfg.segment_size,
        code_hop_size=tcfg.code_hop_size, multispkr=mcfg.multispkr,
        speaker_ids=train_ds.spkr_to_id)
    global_batch = max(1, tcfg.batch_size // mesh.n_data) * mesh.n_data
    loader = VocoderLoader(train_ds, global_batch, seed=tcfg.seed,
                           process_index=mesh.process_index,
                           process_count=mesh.process_count,
                           with_f0=mcfg.f0, device=device)
    steps_per_epoch = max(1, len(train_ds) // global_batch)

    state = voc_train.init_state(tcfg.seed, mcfg, device)
    for net in (state.gen, state.mpd, state.msd):
        meshlib.broadcast_state(net)
    mgr = ckptlib.CheckpointManager(run_dir / "ckpt")
    if main:
        ckptlib.save_config_json(run_dir / "ckpt", to_json(mcfg))
    if resume and mgr.latest_step() is not None:
        state.load_state_dict(mgr.restore())

    writer = MetricsWriter(run_dir / "logs") if main else None
    thr = Throughput()
    audio_s_per_batch = (global_batch * tcfg.segment_size
                         / mel_cfg.sampling_rate)

    def save() -> None:
        if main:
            mgr.save(steps, state.state_dict())
        meshlib.barrier()

    steps = state.step
    total = max_steps if max_steps is not None else (
        tcfg.training_epochs * steps_per_epoch)
    epoch = steps // steps_per_epoch
    done = False
    while not done:
        made_progress = False
        batches = threaded_loader(lambda e=epoch: loader.batches(e))
        for batch in device_prefetch(batches, dtypes=voc_train.BATCH_DTYPES,
                                     device=device):
            metrics = voc_train.train_step(state, batch, mcfg, tcfg, mel_cfg,
                                           steps_per_epoch, mesh=mesh)
            made_progress = True
            steps += 1
            thr.tick(audio_s_per_batch)

            if steps % tcfg.summary_interval == 0 and main:
                writer.scalars(steps, **{k: float(v)
                                         for k, v in metrics.items()})
                writer.scalar("train_audio_seconds_per_second",
                              thr.report()["audio_seconds_per_second"], steps)
                thr.reset()
            if steps % tcfg.validation_interval == 0 and main:
                writer.scalar("validation/mel_spec_error",
                              validate(state.gen, val_ds, mcfg, mel_cfg,
                                       writer, steps, device,
                                       f0_kwargs=loader.f0_kwargs), steps)
            if steps % tcfg.checkpoint_interval == 0:
                save()
            if crash_at_step is not None and steps >= crash_at_step:
                raise RuntimeError(
                    f"simulated crash at step {steps} (recovery drill)")
            if steps >= total:
                done = True
                break
        if not made_progress:
            raise RuntimeError("loader yielded no batches this epoch")
        epoch += 1

    save()
    if main:
        writer.close()
    return {"steps": steps, "epochs": epoch}


def validate(generator: gen.CodeGenerator, val_ds: VocoderDataset, mcfg,
             mel_cfg, writer: MetricsWriter, step: int, device,
             f0_kwargs: dict | None = None, max_items: int = 16) -> float:
    """Mean mel-L1 over the first `max_items` validation crops, with the
    first two generated clips and their banded mel logged (reference
    train.py:199-228). An f0-conditioned generator gets each crop's f0 by
    the training loader's rule (`code_rate_f0`); pass the loader's
    `f0_kwargs`, as `run` does, so both take one pitch track."""
    rng = np.random.default_rng(0)
    errs = []
    for i in range(min(max_items, len(val_ds))):
        item = val_ds.load_item(i, rng)
        batch = {"audio": item["audio"][None, :],
                 "code": item["code"][None, :],
                 "spkr": np.asarray([item["spkr"]], np.int32)}
        if mcfg.f0:
            batch["f0"] = code_rate_f0(batch["audio"], batch["code"].shape[1],
                                       val_ds.code_hop_size,
                                       f0_kwargs or {}, device)
        batch = voc_train.to_batch(batch, device)
        batch["mel"] = voc_train.loss_mel(batch["audio"], mel_cfg)
        errs.append(float(voc_train.val_step(generator, batch, mcfg,
                                             mel_cfg)))
        if i < 2:
            with torch.no_grad():
                y_hat = generator(batch["code"], batch["spkr"],
                                  voc_train.extra_feats(batch))[:, :, 0]
                # the GENERATED audio's mel (reference train.py:221-226),
                # banded with fmax, not the full-band loss mel
                y_hat_mel = stft.mel_spectrogram(
                    y_hat, n_fft=mel_cfg.n_fft, num_mels=mel_cfg.num_mels,
                    sampling_rate=mel_cfg.sampling_rate,
                    hop_size=mel_cfg.hop_size, win_size=mel_cfg.win_size,
                    fmin=mel_cfg.fmin, fmax=mel_cfg.fmax)
            writer.audio(f"generated/y_hat_{i}", y_hat[0].cpu().numpy(), step,
                         mel_cfg.sampling_rate)
            writer.figure_spectrogram(f"generated/y_hat_spec_{i}",
                                      y_hat_mel[0].cpu().numpy(), step)
    return float(np.mean(errs)) if errs else float("nan")
