"""Optimizer and learning-rate schedules (port of `repro.optim`)."""
from .adamw import AdamW, AdamWState  # noqa: F401
