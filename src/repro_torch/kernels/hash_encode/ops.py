"""Public hash-grid encode: device dispatch between kernel and plain version.

A CUDA tensor goes to the CUDA kernel (`kernel.hash_encode`), a CPU tensor
to the plain PyTorch version (`ref.hash_encode`); forward only.  The
training slice adds the merged (BUM) backward.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def hash_encode(points: torch.Tensor, tables: torch.Tensor, resolutions,
                dense_flags) -> torch.Tensor:
    """points (N, 3) in [0, 1)^3, tables (L, T, F) -> (N, L*F) f32."""
    if points.device.type == "cuda":
        return kernel.hash_encode(points, tables, resolutions, dense_flags)
    if points.device.type != "cpu":
        raise ValueError(f"hash_encode: no route for device {points.device}")
    return ref.hash_encode(points, tables, resolutions, dense_flags)
