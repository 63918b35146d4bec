"""LR schedules: pure functions of the step (a copy of ``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(
    peak_lr: float,
    *,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    final_frac: float = 0.1,
):
    """-> lr(step): linear warm-up to ``peak_lr``, then a cosine decay to
    ``final_frac * peak_lr`` at ``total_steps``. ``step`` may be an int or a
    tensor; the result is an f32 tensor on the step's device, so a step held
    on the card costs no host sync."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr
