"""Learning-rate schedules, as the JAX package's ``optim.schedule``.

Each takes the step as an int or a 0-d tensor and returns a float32 0-d
tensor on the step's device (the CPU for an int), so a trainer that passes
its optimizer's device-side step count never waits for the device.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                         min_ratio: float = 0.1) -> torch.Tensor:
    """Warmup then cosine decay to ``min_ratio`` of peak: a scale in
    [0, 1] (0 at step 0 when there is a warmup)."""
    step = _step(step)
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos


def constant(step, *, value: float = 1.0) -> torch.Tensor:
    return torch.full_like(_step(step), value)


def exponential_decay(step, *, decay_steps: int, rate: float = 0.5,
                      staircase: bool = False) -> torch.Tensor:
    p = _step(step) / decay_steps
    if staircase:
        p = torch.floor(p)
    return torch.pow(rate, p)
