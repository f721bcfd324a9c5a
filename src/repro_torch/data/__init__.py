"""Procedural scenes with analytic ground truth and the ray sampler."""
