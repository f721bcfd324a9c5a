"""Morton keys and the shared corner geometry of the fused compacted path.

The port of `repro.kernels.fused_path.ref`.  `morton_key` is the compact
stage's sort key.  The reference works in uint32; torch lacks unsigned
shifts and masks on 32 bits, so the keys are computed in int64 -- every
intermediate stays below 2^30, so the bits are the reference's exactly.

The geometry functions compute each level's corner coords and trilinear
weights ONCE for both grids of a decomposed field (same resolutions,
different table sizes); `fused_step` builds its plain forward and backward
from them.  Integer outputs (corner coords, indices, the address stream) are
the reference's exactly, as int64.
"""
from __future__ import annotations

import torch

from ..hash_encode import ref as he_ref

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


# --- shared corner geometry --------------------------------------------------

def corner_geometry(points: torch.Tensor, resolutions) -> tuple[list, list]:
    """Per-level corner coords and trilinear weights, computed once:
    ([(N, 8, 3) int64] * L, [(N, 8) f32] * L)."""
    corners, weights = [], []
    for res in resolutions:
        c, w = he_ref.level_corners(points, int(res))
        corners.append(c)
        weights.append(w)
    return corners, weights


def level_indices(corners: list, resolutions, table_size: int, dense_flags) -> list:
    """Per-level table indices (N, 8) int64 for one grid from shared corners."""
    return [he_ref.corner_index(c, int(res), table_size, bool(dense))
            for c, res, dense in zip(corners, resolutions, dense_flags)]


def address_stream(idx_l: list, table_size: int) -> torch.Tensor:
    """Per-level indices flattened into the canonical update-stream order,
    position l*(N*8) + n*8 + c, level l offset by l*T (hash_encode's
    `corner_updates` layout)."""
    return torch.cat([(idx + level * table_size).reshape(-1)
                      for level, idx in enumerate(idx_l)])


def encode_from_indices(tables: torch.Tensor, idx_l: list, weights: list) -> torch.Tensor:
    """Multires encoding from precomputed indices and weights, tables
    (L, T, F) -> (N, L*F) f32: the same gathers and weighted sums as
    `hash_encode.ref.hash_encode`."""
    return torch.cat([
        torch.sum(w[..., None] * tables[level][idx].to(torch.float32), dim=1)
        for level, (idx, w) in enumerate(zip(idx_l, weights))], dim=-1)
