"""Learning-rate schedules (port of `repro/optim/schedules.py`): pure
functions of the step count, computed in f32 on the step's device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to `peak_lr`, then a cosine decay to
    `final_frac * peak_lr` at `total_steps`."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return sched


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)
