"""Learning-rate schedules: pure functions of the int32 step tensor."""
from __future__ import annotations

import torch


def constant(lr: float):
    """lr as an f32 tensor filled on the step's device (no host copy)."""
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)
