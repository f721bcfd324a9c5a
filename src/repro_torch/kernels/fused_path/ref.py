"""Morton (Z-order) keys, the sort key of the pipeline's compact stage.

The port's copy of `repro.kernels.fused_path.ref.morton_key`.  The reference
works in uint32; torch lacks unsigned shifts and masks on 32 bits, so the
keys are computed in int64 -- every intermediate stays below 2^30, so the
bits are the reference's exactly.
"""
from __future__ import annotations

import torch

MORTON_BITS = 10  # 3 * 10 = 30 bits: fits uint32, finer than any grid level


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so that they occupy every third bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_key(unit_points: torch.Tensor, bits: int = MORTON_BITS) -> torch.Tensor:
    """Z-order key for points in [0, 1)^3: (N, 3) f32 -> (N,) int64 holding
    the reference's uint32 value.  Out-of-box coordinates are clamped."""
    n = 1 << bits
    q = torch.clamp(torch.floor(unit_points.to(torch.float32) * n), 0, n - 1)
    q = q.to(torch.int64)
    return (_part1by2(q[..., 0])
            | (_part1by2(q[..., 1]) << 1)
            | (_part1by2(q[..., 2]) << 2))
