"""The TTE's learning-rate schedule; port of `cosine_warmup_schedule` in
`parrot_tts_tpu/train/schedules.py` (reference `train.py:13-52`): linear
warmup to init_lr, then a half cosine down to 0 over the total steps."""

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
