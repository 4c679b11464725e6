"""Learning-rate schedules; port of `parrot_tts_tpu/train/schedules.py`.

- cosine warmup (TTE, reference `train.py:13-52`): linear warmup to
  init_lr, then a half cosine down to 0 over the total steps;
- per-epoch exponential decay (vocoder GAN)."""

from __future__ import annotations

import math


def cosine_warmup_schedule(init_lr: float, warmup_steps: int,
                           total_steps: int, num_cycles: float = 0.5):
    """step (optimizer steps) -> learning rate, in double precision on the
    host; the JAX schedule computes in float32, so the two agree to float32
    rounding."""
    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return init_lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        return init_lr * max(
            0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return schedule


def exponential_epoch_schedule(init_lr: float, gamma: float,
                               steps_per_epoch: int):
    """Per-epoch exponential decay (the reference's ExponentialLR stepped
    once per epoch, `utils/vocoder/train.py:88-89,234-235`): the n-th
    update, counted from 0 as optax counts, has lr init_lr *
    gamma^(n // steps_per_epoch). Double precision on the host; the JAX
    schedule computes in float32."""
    def schedule(step) -> float:
        return init_lr * gamma ** (int(step) // steps_per_epoch)

    return schedule
