"""Learning-rate schedules: pure functions of the int32 step tensor."""
from __future__ import annotations

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)
