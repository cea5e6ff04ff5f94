"""LR schedules (warmup + cosine decay), pure functions of the step; port
of ``repro.optim.schedule``. A schedule takes the integer step (a tensor
or an int) and returns an fp32 tensor on the step's device."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = (floor * peak
               + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr
