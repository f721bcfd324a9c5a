"""Instant-3D's decomposed hash-grid radiance field, in PyTorch (serving slice)."""
