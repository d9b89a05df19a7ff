"""LR schedules (pure functions of the step), as in the reference's
``optim/schedule.py``.

The step is a Python int and the rate is worked out on the host, in
float32 as the reference computes it, so the schedule causes no device
sync; the result is the float32 value as a Python float.
"""
from __future__ import annotations

import numpy as np


def cosine_warmup(step: int, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> float:
    """Linear warmup then cosine decay to min_ratio * peak."""
    f32 = np.float32                  # each operation as the reference's
    step = f32(step)
    if step < warmup_steps:
        return float(f32(peak_lr) * step / f32(max(warmup_steps, 1)))
    prog = np.clip((step - f32(warmup_steps))
                   / f32(max(total_steps - warmup_steps, 1)), f32(0), f32(1))
    cos = f32(peak_lr) * (f32(min_ratio) + f32((1 - min_ratio) * 0.5)
                          * (f32(1) + np.cos(f32(np.pi) * prog)))
    return float(cos)
