"""LR schedule: quartic warmup + multi-step decay (counterpart of
fastdet/train/schedule.py).

For the first 5 epochs of batches lr = base·(step/warmup)⁴, afterwards
base·0.1^(#milestone epochs passed).  Computed in f32 in the JAX
function's order of operations (x⁴ as (x·x)·(x·x), as XLA's integer
power does), so both give the same f32 value at every step.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def make_lr_schedule(base_lr: float, steps_per_epoch: int,
                     milestones: Sequence[int], gamma: float = 0.1,
                     warmup_epochs: int = 5) -> Callable[[int], float]:
    warmup_steps = warmup_epochs * steps_per_epoch
    milestones = tuple(int(m) for m in milestones)
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        epoch = np.floor(s / f32(steps_per_epoch))
        decay = f32(1.0)
        for m in milestones:
            decay = decay * (f32(gamma) if epoch >= m else f32(1.0))
        x = np.clip(s / f32(max(warmup_steps, 1)), f32(0.0), f32(1.0))
        x2 = x * x
        warm = x2 * x2
        lr = f32(base_lr) * (warm if s <= warmup_steps else f32(1.0)) * decay
        return float(lr)

    return schedule
