"""Learning-rate schedules: pure functions of the int32 step tensor.

The port of `repro.optim.schedule`; every schedule computes on the step's
device in f32 (no host sync, so a step stays capturable).
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    """lr as an f32 tensor filled on the step's device (no host copy)."""
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    """Linear warmup to peak, cosine decay to floor."""
    def fn(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak_lr - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def exponential_decay(lr: float, decay_rate: float, decay_steps: int):
    def fn(step):
        return (lr * decay_rate ** (step.to(torch.float32) / decay_steps)).to(torch.float32)
    return fn
