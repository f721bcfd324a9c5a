"""Optimizer and learning-rate schedules (port of `repro.optim`)."""
from .adamw import AdamW, AdamWState, clip_by_global_norm, global_norm  # noqa: F401
from . import schedule  # noqa: F401
