"""Learning-rate schedules (pure functions of the step counter).

The port of ``repro.optim.schedule``: on a tensor step the schedule is
computed in f32 on the step's device, as the reference computes it on a
jax array; on an int or float it is plain Python arithmetic.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10000,
                  floor: float = 0.1):
    """Linear warmup then cosine decay to `floor` * peak."""
    if isinstance(step, torch.Tensor):
        s = step.float()
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return warm * cos
    s = float(step)
    warm = min(s / max(warmup, 1), 1.0)
    frac = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + math.cos(math.pi * frac))
    return warm * cos
