"""Learning-rate schedules as step -> lr callables (port of
``repro/optim/schedules.py``).  ``step`` is a Python int or a tensor; the
result is a float32 tensor, as the reference returns."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_step(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)

    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        s = _step(step)
        warm = lr * torch.clamp_max(s / max(warmup, 1), 1.0)
        return torch.where(s < warmup, warm, cos(s - warmup))

    return fn
