"""TTE training engine: micro-steps with gradient accumulation, global-norm
clipping and AdamW under a cosine-warmup schedule.

Port of `parrot_tts_tpu/train/tte.py`, which chains optax
`clip_by_global_norm` -> `adamw` inside `MultiSteps`. The port writes that
chain out, matching optax's arithmetic:

- accumulation: the K micro-batch gradients of one optimizer step are
  averaged as MultiSteps' running mean acc + (g - acc) / (n + 1)
  (`train/tte.py:142-145`), and the update applies once every
  `grad_acc_steps` micro-steps. `train_step` and `train_step_k` share one
  micro-step, so the two give the same numbers;
- clipping: g * (max / |g|) only when |g| >= max (optax's
  `clip_by_global_norm`; `torch.nn.utils.clip_grad_norm_` divides by
  |g| + 1e-6 and so differs);
- AdamW: b1 0.9, b2 0.999, eps 1e-8 outside the square root, weight decay
  on every tensor. The config's `betas` are ignored, as the reference's
  configure_optimizers ignores them (`train.py:98-109`);
- learning rate: the schedule is read at the count of updates made so
  far, before this one (optax), so under warmup the first update has lr 0.

Dropout of micro-step n draws from (run seed, n) alone
(`models/tte/parrot.py::dropout_seed`). Steps run under
`exact_numerics(False)`: TF32 matmuls and convolutions, the counterpart of
the TPU's default-precision training; the attention kernels round their
operands to bf16 whatever the flag. The state is updated in place (the JAX
step returns a new one and donates the old): parameters, moments and the
accumulator are each held once.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from parrot_tts_tpu_torch.core.config import TTEModelConfig, TTETrainConfig
from parrot_tts_tpu_torch.core.device import batch_to_device, exact_numerics
from parrot_tts_tpu_torch.models.tte import parrot
from parrot_tts_tpu_torch.models.tte.loss import tte_loss
from parrot_tts_tpu_torch.train.schedules import cosine_warmup_schedule

B1, B2, EPS = 0.9, 0.999, 1e-8
BATCH_DTYPES = {"phones": torch.int64, "src_mask": torch.bool,
                "speaker": torch.int64, "duration": torch.int64,
                "tgt_mask": torch.bool, "codes": torch.int64,
                "sample_weight": torch.float32}


@dataclass
class TTETrainState:
    """The model (its parameters), AdamW's moments `mu` / `nu` and update
    `count`, MultiSteps' accumulated gradient `acc` and `mini_step`, and
    `step`: MICRO-batch steps, +1 per micro-batch (optimizer steps are
    step // grad_acc_steps)."""

    model: parrot.Parrot
    mu: dict
    nu: dict
    acc: dict
    count: int = 0
    mini_step: int = 0
    step: int = 0

    def state_dict(self) -> dict:
        """Everything a resumed run needs, for `core/checkpoint.py`."""
        return {"params": self.model.state_dict(), "mu": self.mu,
                "nu": self.nu, "acc": self.acc, "count": self.count,
                "mini_step": self.mini_step, "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["params"], strict=True)
        for name in ("mu", "nu", "acc"):
            mine = getattr(self, name)
            if mine.keys() != sd[name].keys():
                raise ValueError(f"checkpoint {name} names differ")
            for k, v in sd[name].items():
                mine[k].copy_(v)
        self.count, self.mini_step, self.step = (
            int(sd["count"]), int(sd["mini_step"]), int(sd["step"]))


def init_state(seed: int, model_cfg: TTEModelConfig,
               device) -> TTETrainState:
    """Seeded parameters (`parrot.init_parrot`), zero moments."""
    model = parrot.Parrot(model_cfg)
    model.load_state_dict(
        parrot.init_parrot(model_cfg, torch.Generator().manual_seed(seed)),
        strict=True)
    model = model.to(device).train()

    def zeros():
        return {n: torch.zeros_like(p) for n, p in model.named_parameters()}

    return TTETrainState(model=model, mu=zeros(), nu=zeros(), acc=zeros())


def to_batch(batch: dict, device) -> dict:
    """numpy batch (the loader's keys; `ids` dropped) -> tensors on device,
    copied from pinned memory without blocking the host."""
    return batch_to_device(batch, BATCH_DTYPES, device)


def loss_fn(model: parrot.Parrot, batch: dict, model_cfg: TTEModelConfig,
            out_len: int, dropout: tuple[int, int] | None):
    logits, _, log_dur = parrot.apply_parrot_train(
        model, batch, out_len=out_len, dropout=dropout)
    total, code, dur = tte_loss(
        logits, log_dur, batch["codes"], batch["duration"],
        batch["src_mask"], num_codes=model_cfg.hubert_codes,
        sample_weight=batch.get("sample_weight"))
    return total, {"total_loss": total.detach(), "code_loss": code.detach(),
                   "dur_loss": dur.detach()}


def _apply_update(state: TTETrainState, train_cfg: TTETrainConfig) -> None:
    """clip_by_global_norm -> AdamW on the accumulated gradient."""
    lr = cosine_warmup_schedule(train_cfg.init_lr, train_cfg.warmup_steps,
                                train_cfg.total_steps)(state.count)
    count = state.count + 1
    bc1, bc2 = 1.0 - B1**count, 1.0 - B2**count
    acc = state.acc
    norm = torch.stack([g.pow(2).sum() for g in acc.values()]).sum().sqrt()
    clip = norm >= train_cfg.grad_clip
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            g = torch.where(clip, (acc[name] / norm) * train_cfg.grad_clip,
                            acc[name])
            mu, nu = state.mu[name], state.nu[name]
            mu.copy_((1.0 - B1) * g + B1 * mu)
            nu.copy_((1.0 - B2) * g.square() + B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            u = u + train_cfg.weight_decay * p
            p.add_(-lr * u)
    state.count = count


def _micro_step(state: TTETrainState, batch: dict, run_seed: int,
                model_cfg: TTEModelConfig, train_cfg: TTETrainConfig,
                out_len: int) -> dict:
    """The one code path of a micro-batch: gradient, running mean, and the
    update on every grad_acc_steps-th call."""
    model = state.model
    names = [n for n, _ in model.named_parameters()]
    total, metrics = loss_fn(model, batch, model_cfg, out_len,
                             (run_seed, state.step))
    grads = torch.autograd.grad(total, [p for _, p in
                                        model.named_parameters()])
    n = state.mini_step
    with torch.no_grad():
        for name, g in zip(names, grads):
            a = state.acc[name]
            a.add_((g - a) / (n + 1.0))
    state.step += 1
    state.mini_step += 1
    if state.mini_step == train_cfg.grad_acc_steps:
        _apply_update(state, train_cfg)
        state.mini_step = 0
        for a in state.acc.values():
            a.zero_()
    return metrics


def train_step(state: TTETrainState, batch: dict, run_seed: int,
               model_cfg: TTEModelConfig, train_cfg: TTETrainConfig,
               out_len: int) -> dict:
    """One micro-batch step (batch: tensors on the model's device); the
    optimizer applies every grad_acc_steps calls. Returns the metrics."""
    with exact_numerics(False):
        return _micro_step(state, batch, run_seed, model_cfg, train_cfg,
                           out_len)


def train_step_k(state: TTETrainState, batches: dict, run_seed: int,
                 model_cfg: TTEModelConfig, train_cfg: TTETrainConfig,
                 out_len: int) -> dict:
    """K micro-steps over a batch dict with a leading micro-step axis
    (K, B, ...): the same numbers as K train_step calls. Returns the last
    micro-step's metrics."""
    k = next(iter(batches.values())).shape[0]
    metrics = {}
    with exact_numerics(False):
        for i in range(k):
            metrics = _micro_step(state, {key: x[i] for key, x in
                                          batches.items()},
                                  run_seed, model_cfg, train_cfg, out_len)
    return metrics


def eval_step(model: parrot.Parrot, batch: dict, model_cfg: TTEModelConfig,
              out_len: int) -> dict:
    """Losses of the deterministic training forward (no dropout; attention
    through row 1, `ops/flash_attention.py`)."""
    with torch.no_grad(), exact_numerics(False):
        return loss_fn(model, batch, model_cfg, out_len, None)[1]
