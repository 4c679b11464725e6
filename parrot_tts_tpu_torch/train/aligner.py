"""Aligner CTC training engine; port of `parrot_tts_tpu/train/aligner.py`.

Reference: `utils/aligner/trainer.py`: Adam, CTC loss over mel -> symbol
posteriors, NaN/Inf-loss step skipping, gradient clip 1.0. The JAX
package chains optax `clip_by_global_norm` -> `adam`; the port writes that
chain out with optax's arithmetic, as `train/tte.py` does for AdamW:

- clipping: g * (max / |g|) only when |g| >= max (torch's
  `clip_grad_norm_` divides by |g| + 1e-6 and so differs);
- Adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, constant lr;
- a step whose loss is not finite changes no parameter, BN running
  statistic, moment or update count, and still counts as a step (the JAX
  step's `jnp.where(isfinite(loss), new, old)`). `nn.BatchNorm1d` updates
  its statistics during the forward, so they are saved before it and put
  back.

Steps run under `exact_numerics(True)`: IEEE float32 convs, LSTM and
matmuls, deterministic cuDNN algorithms, and the CTC of `ops/ctc.py`,
whose backward has no atomics, so a step is a function of (weights, BN
statistics, batch) bit for bit on the card. cuDNN's LSTM backward repeats
only with cuBLAS's workspace pinned (CUBLAS_WORKSPACE_CONFIG=:4096:8,
set before the process's first CUDA call; `cli.main` sets it and
`pipeline/train_aligner.py` checks it). A state on the card carries a
`CTCGraphs` cache, so the CTC's recursion replays as CUDA graphs (the
same kernels as the eager loops, so the same bits).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from parrot_tts_tpu_torch.core.config import (AlignerModelConfig,
                                              AlignerTrainConfig)
from parrot_tts_tpu_torch.core.device import batch_to_device, exact_numerics
from parrot_tts_tpu_torch.models.aligner import model as amodel
from parrot_tts_tpu_torch.ops.ctc import CTCGraphs, ctc_loss_torch_mean

B1, B2, EPS = 0.9, 0.999, 1e-8
BATCH_DTYPES = {"mel": torch.float32, "mel_lengths": torch.int64,
                "tokens": torch.int64, "token_lengths": torch.int64}


@dataclass
class AlignerTrainState:
    """The model (parameters and BN statistics), Adam's moments `mu` /
    `nu` over the trained parameters, its update `count`, `step`, which
    counts skipped steps too, and the CTC's CUDA graphs (None: the eager
    loops)."""

    model: amodel.Aligner
    mu: dict
    nu: dict
    count: int = 0
    step: int = 0
    ctc_graphs: CTCGraphs | None = None

    def state_dict(self) -> dict:
        """Everything a resumed run needs, for `core/checkpoint.py`."""
        return {"params": self.model.state_dict(), "mu": self.mu,
                "nu": self.nu, "count": self.count, "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["params"], strict=True)
        with torch.no_grad():
            for name in ("mu", "nu"):
                mine = getattr(self, name)
                if mine.keys() != sd[name].keys():
                    raise ValueError(f"checkpoint {name} names differ")
                for k, v in sd[name].items():
                    mine[k].copy_(v)
        self.count, self.step = int(sd["count"]), int(sd["step"])


def trained(model: amodel.Aligner) -> dict[str, torch.nn.Parameter]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def init_state(seed: int, model_cfg: AlignerModelConfig, device
               ) -> AlignerTrainState:
    """Seeded parameters (`init_aligner`), zero moments; CTC graphs on
    the card."""
    model = amodel.Aligner(model_cfg)
    model.load_state_dict(amodel.init_aligner(
        model_cfg, torch.Generator().manual_seed(seed)), strict=True)
    model = model.to(device).train()
    return AlignerTrainState(
        model=model,
        mu={n: torch.zeros_like(p) for n, p in trained(model).items()},
        nu={n: torch.zeros_like(p) for n, p in trained(model).items()},
        ctc_graphs=CTCGraphs() if torch.device(device).type == "cuda"
        else None)


def to_batch(batch: dict, device) -> dict:
    """numpy loader batch -> tensors on device."""
    return batch_to_device(batch, BATCH_DTYPES, device)


def loss_fn(model: amodel.Aligner, batch: dict,
            ctc_graphs: CTCGraphs | None = None) -> torch.Tensor:
    """CTC loss of a training forward (BN statistics updated)."""
    logits = amodel.apply_aligner(model, batch["mel"], train=True)
    return ctc_loss_torch_mean(logits, batch["mel_lengths"], batch["tokens"],
                               batch["token_lengths"], graphs=ctc_graphs)


def _apply_update(state: AlignerTrainState, grads: dict,
                  train_cfg: AlignerTrainConfig) -> None:
    """clip_by_global_norm -> Adam."""
    count = state.count + 1
    bc1, bc2 = 1.0 - B1**count, 1.0 - B2**count
    norm = torch.stack([g.pow(2).sum() for g in grads.values()]).sum().sqrt()
    clip = norm >= train_cfg.grad_clip
    with torch.no_grad():
        for name, p in trained(state.model).items():
            g = torch.where(clip, (grads[name] / norm) * train_cfg.grad_clip,
                            grads[name])
            mu, nu = state.mu[name], state.nu[name]
            mu.copy_((1.0 - B1) * g + B1 * mu)
            nu.copy_((1.0 - B2) * g.square() + B2 * nu)
            p.add_(-train_cfg.learning_rate
                   * ((mu / bc1) / (torch.sqrt(nu / bc2) + EPS)))
    state.count = count


def train_step(state: AlignerTrainState, batch: dict,
               train_cfg: AlignerTrainConfig) -> dict:
    """One CTC step on a batch of tensors on the model's device (mel
    (B, T, M), mel_lengths, tokens (B, L), token_lengths). Returns
    {"ctc_loss": loss tensor}."""
    model = state.model
    stats = [b.clone() for b in model.buffers()]
    params = trained(model)
    with exact_numerics(True):
        loss = loss_fn(model, batch, state.ctc_graphs)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    if torch.isfinite(loss):
        _apply_update(state, grads, train_cfg)
    else:
        with torch.no_grad():
            for b, saved in zip(model.buffers(), stats):
                b.copy_(saved)
    state.step += 1
    return {"ctc_loss": loss.detach()}


@torch.no_grad()
def posteriors(model: amodel.Aligner, mel: torch.Tensor) -> torch.Tensor:
    """Eval-mode softmax posteriors (B, T, V) for duration extraction
    (reference extract_durations.py:86-95), in IEEE float32."""
    with exact_numerics(True):
        return torch.softmax(amodel.apply_aligner(model, mel, train=False),
                             dim=-1)


def alignment_debug_text(logits, tokens, token_length, tokenizer) -> dict:
    """Human-inspection artifact matching the reference's text logs
    (utils/aligner/trainer.py:90-116): the greedy CTC decode (collapsed
    repeats, blanks dropped) next to the target transcript."""
    ids = np.asarray(logits).argmax(axis=-1)
    collapsed = []
    prev = -1
    for i in ids:
        if i != prev and i != 0:
            collapsed.append(int(i))
        prev = i
    target = [int(t) for t in np.asarray(tokens)[:int(token_length)]]
    return {"decoded": tokenizer.decode(collapsed),
            "target": tokenizer.decode(target)}
