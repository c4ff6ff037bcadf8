"""Learning-rate schedules (port of `repro.optim.schedule`): pure functions
of the step counter, computed in f32 as the JAX package computes them."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to base_lr, then a cosine decay to min_ratio·base_lr
    at total_steps (a 0-d f32 tensor on the step's device)."""
    step = _f32(step)
    warm = base_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1.0 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, base_lr: float, **_) -> torch.Tensor:
    return torch.full_like(_f32(step), base_lr)
