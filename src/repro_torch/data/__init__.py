"""Procedural scenes with analytic ground truth, the ray sampler, and the
LM substrate's synthetic token streams."""
from .lm_data import LMStreamConfig, SyntheticLMStream  # noqa: F401
