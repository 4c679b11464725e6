"""TTE training entry point: data -> train steps -> eval / checkpoints / logs.

Port of `parrot_tts_tpu/pipeline/train_tte.py` (the runnable counterpart
of the reference's `python train.py --config ... --num_gpus N`,
`train.py:117-191`). Micro-batches are grouped host-side into (K, B, ...)
stacks of one bucket pair, copied to the device from pinned memory one
stack ahead (`data/prefetch.py`), and run by `train/tte.py::train_step_k`.

Data parallelism: started by `torchrun --nproc_per_node=N`, every rank
joins the process group (`core/mesh.py::training_mesh`), trains on
its device (LOCAL_RANK) and takes its contiguous slice of each global
batch of `batch_size * N` rows (the JAX package's `global_batch`); every
rank derives the same schedule from the shared seed. Rank 0 alone writes
logs, metrics.csv and checkpoints, and the ranks meet at a barrier after
each save; on resume every rank loads the latest checkpoint.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from parrot_tts_tpu_torch.core import checkpoint as ckptlib
from parrot_tts_tpu_torch.core import mesh as meshlib
from parrot_tts_tpu_torch.core.config import (PipelineConfig, TTEModelConfig,
                                              to_json)
from parrot_tts_tpu_torch.core.metrics import (CsvLogger, MetricsWriter,
                                               Throughput)
from parrot_tts_tpu_torch.data.prefetch import device_prefetch
from parrot_tts_tpu_torch.data.tte_data import BucketedLoader, TTEDataset
from parrot_tts_tpu_torch.train import tte as tte_train


def run(cfg: PipelineConfig, *, run_dir: str | Path | None = None,
        max_steps: int | None = None, crash_at_step: int | None = None,
        device=None) -> dict:
    """Train until `max_steps` (default `tte_train.total_steps`) optimizer
    steps; checkpoints go to <run_dir>/ckpt, logs to <run_dir>/logs. A run
    resumes from the latest checkpoint in <run_dir>/ckpt when there is one
    (a fresh start takes a new run_dir).
    device: default the CUDA card (raises without one unless "cpu"), under
    torchrun the rank's card. crash_at_step: recovery-drill hook; raise at
    that optimizer step WITHOUT the final checkpoint, so a resume starts
    from the last periodic one. Returns {"steps": optimizer steps,
    "epochs": epochs run}."""
    mesh = meshlib.training_mesh(device, cfg.mesh)
    device = mesh.devices[0]
    main = meshlib.is_main()
    run_dir = Path(run_dir or cfg.root_path)
    tcfg = cfg.tte_train

    train_ds = TTEDataset(cfg.root_path, cfg.alignment_path, "train",
                          cfg.tte_model.hubert_codes)
    val_ds = TTEDataset(cfg.root_path, cfg.alignment_path, "val",
                        cfg.tte_model.hubert_codes)
    model_cfg = dataclasses.replace(
        cfg.tte_model, vocab_size=train_ds.vocab_size,
        n_speaker=len(train_ds.speaker_map), pad_idx=train_ds.src_pad_idx)

    # the GLOBAL batch, each rank taking its slice; partial batches are
    # padded to static shape by repetition with loss weight 0
    global_batch = tcfg.batch_size * mesh.n_data
    part = dict(process_index=mesh.process_index,
                process_count=mesh.process_count)
    loader = BucketedLoader(train_ds, global_batch, tcfg.src_buckets,
                            tcfg.tgt_buckets, seed=tcfg.seed, **part)
    val_loader = BucketedLoader(val_ds, global_batch, tcfg.src_buckets,
                                tcfg.tgt_buckets, seed=0, shuffle=False,
                                **part)

    state = tte_train.init_state(tcfg.seed, model_cfg, device)
    meshlib.broadcast_state(state.model)
    mgr = ckptlib.CheckpointManager(run_dir / "ckpt")
    if main:
        ckptlib.save_config_json(run_dir / "ckpt", to_json(model_cfg))
    if mgr.latest_step() is not None:
        state.load_state_dict(mgr.restore())

    writer = MetricsWriter(run_dir / "logs") if main else None
    csv = CsvLogger(run_dir / "logs") if main else None
    thr = Throughput()

    def save(step: int) -> None:
        if main:
            mgr.save(step, state.state_dict(),
                     metadata={"step": step,
                               **{f"val_{k}": v for k, v in last_val.items()}})
        meshlib.barrier()
    run_seed = tcfg.seed + 1

    total = max_steps if max_steps is not None else tcfg.total_steps
    micro_steps = state.step
    epoch = 0
    done = False
    last_val: dict = {}
    acc = tcfg.grad_acc_steps
    marks = {"log": micro_steps // (tcfg.log_every * acc),
             "val": micro_steps // (tcfg.val_every * acc),
             "save": micro_steps // (tcfg.save_every * acc)}

    def crossed(kind: str, every: int) -> bool:
        mark = micro_steps // (every * acc)
        if mark > marks[kind]:
            marks[kind] = mark
            return True
        return False

    pending: dict = {}   # partial accumulation groups, carried across epochs
    idle_epochs = 0
    while not done:
        made_progress = False
        stacks = _stack_microbatches(loader.batches(epoch), acc, pending)
        for batch in device_prefetch(stacks, dtypes=tte_train.BATCH_DTYPES,
                                     device=device):
            k_here, tgt_len = batch["codes"].shape[0], batch["codes"].shape[2]
            metrics = tte_train.train_step_k(state, batch, run_seed,
                                             model_cfg, tcfg, tgt_len, mesh)
            made_progress = True
            micro_steps += k_here
            opt_steps = micro_steps // acc
            for _ in range(k_here):   # sec_per_batch stays per MICRO-batch
                thr.tick()

            if crossed("log", tcfg.log_every) and main:
                vals = {k: float(v) for k, v in metrics.items()}
                writer.scalars(opt_steps, **{f"train_{k}": v
                                             for k, v in vals.items()})
                csv.log(opt_steps, **vals, **{"sec_per_batch":
                        thr.report()["seconds_per_batch"]})
                thr.reset()
            if crossed("val", tcfg.val_every):
                last_val = evaluate(state.model, val_loader, model_cfg,
                                    device, mesh)
                if main:
                    writer.scalars(opt_steps, **{
                        f"val_{k}": v for k, v in last_val.items()})
            if crossed("save", tcfg.save_every):
                save(opt_steps)
            if crash_at_step is not None and opt_steps >= crash_at_step:
                raise RuntimeError(
                    f"simulated crash at optimizer step {opt_steps} "
                    "(recovery drill)")
            if opt_steps >= total:
                done = True
                break
        if made_progress:
            idle_epochs = 0
        else:
            # a tiny corpus can yield fewer than grad_acc_steps micro-
            # batches per epoch; the carried `pending` fills over epochs
            idle_epochs += 1
            if idle_epochs > acc:
                raise RuntimeError(
                    "loader yielded no full accumulation group in "
                    f"{idle_epochs} consecutive epochs")
        epoch += 1

    save(micro_steps // acc)
    if main:
        writer.close()
    return {"steps": micro_steps // acc, "epochs": epoch}


def _stack_microbatches(batches, k: int, pending: dict):
    """Group same-bucket micro-batches into stacked (K, B, ...) numpy
    batches. `pending` persists across epochs (the caller owns it), so an
    accumulation group always holds K micro-batches of one bucket pair; at
    most k-1 micro-batches per bucket pair stay unused when training
    stops."""

    def stack(group):
        return {key: np.stack([g[key] for g in group])
                for key in group[0] if key != "ids"}

    for b in batches:
        key = (b["phones"].shape[1], b["codes"].shape[1])
        pending.setdefault(key, []).append(b)
        if len(pending[key]) == k:
            yield stack(pending.pop(key))


def evaluate(model, val_loader: BucketedLoader, model_cfg: TTEModelConfig,
             device, mesh=None) -> dict:
    """Mean of `eval_step`'s losses over the validation batches (under a
    process group each rank evaluates its slice of every global batch,
    and every rank gets the global means)."""
    sums: dict[str, float] = {}
    n = 0
    for batch in val_loader.batches(0):
        m = tte_train.eval_step(model, tte_train.to_batch(batch, device),
                                model_cfg, batch["codes"].shape[1], mesh)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}
