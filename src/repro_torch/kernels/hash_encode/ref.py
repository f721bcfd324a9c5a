"""Plain PyTorch version of the multiresolution hash-grid encode (forward).

The port's counterpart of `repro.kernels.hash_encode.ref` and of the
geometry in its Pallas kernel (`corner_indices_block`); `kernel.py` launches
the CUDA kernel that computes the same function.  Conventions:

* points (N, 3) f32 in [0, 1)^3; tables (L, T, F) f32, T a power of two;
* level l's grid has (R_l + 1)^3 vertices; a level is indexed densely
  (x + y*s + z*s^2, s = R_l + 1) when that fits in T, otherwise by the
  spatial hash (x*1 ^ y*2654435761 ^ z*805459861) mod T of the paper's
  Eq. 3.  Torch has no wrapping uint32 multiply, so the hash is computed in
  int64 and each product masked to 32 bits -- the same bits as uint32;
* dense indices are clamped into [0, T-1], as JAX's gather clamps and as
  the CUDA kernel must to stay in bounds;
* sentinel rows (x < 0, the reference's padding) read row 0 with weight 0.

Level geometry (`level_resolutions`, `level_is_dense`) is numpy, copied
from the reference exactly (float64 growth factor, +1e-6 before the floor).
"""
from __future__ import annotations

import numpy as np
import torch

PI1 = 1
PI2 = 2654435761
PI3 = 805459861
_U32 = 0xFFFFFFFF


def level_resolutions(n_levels: int, base_resolution: int, max_resolution: int) -> np.ndarray:
    """Per-level grid resolutions N_l = floor(N_min * b^l) (Instant-NGP growth rule)."""
    if n_levels == 1:
        return np.array([base_resolution], dtype=np.int32)
    b = np.exp((np.log(max_resolution) - np.log(base_resolution)) / (n_levels - 1))
    return np.floor(base_resolution * b ** np.arange(n_levels) + 1e-6).astype(np.int32)


def level_is_dense(resolutions: np.ndarray, table_size: int) -> np.ndarray:
    """True where the level's full grid fits in the table (no hashing needed)."""
    r = np.asarray(resolutions, dtype=np.int64)
    return (r + 1) ** 3 <= np.int64(table_size)


def spatial_hash(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
                 table_size: int) -> torch.Tensor:
    """Eq. 3 of the paper on int64 coords -> int64 table index in [0, T)."""
    h = ((ix * PI1) & _U32) ^ ((iy * PI2) & _U32) ^ ((iz * PI3) & _U32)
    return h & (table_size - 1)


def dense_index(ix, iy, iz, resolution: int, table_size: int) -> torch.Tensor:
    """Collision-free index for levels whose full grid fits in the table,
    clamped into [0, T-1]."""
    stride = resolution + 1
    return torch.clamp(ix + iy * stride + iz * stride * stride, 0, table_size - 1)


def corner_index(coords: torch.Tensor, resolution: int, table_size: int,
                 dense: bool) -> torch.Tensor:
    """Table index for int64 grid coords (..., 3) at one level."""
    ix, iy, iz = coords[..., 0], coords[..., 1], coords[..., 2]
    if dense:
        return dense_index(ix, iy, iz, resolution, table_size)
    return spatial_hash(ix, iy, iz, table_size)


def corner_offsets(device) -> torch.Tensor:
    """The 8 corner offsets (8, 3) int64, ordered 000, 001, ..., 111: bit k
    of the corner id c = z<<2 | y<<1 | x selects dimension k's +1 offset.
    Made on `device`: a host-to-device copy would synchronise the stream."""
    cid = torch.arange(8, device=device)
    return torch.stack([cid & 1, (cid >> 1) & 1, (cid >> 2) & 1], dim=-1)


def level_corners(points: torch.Tensor, resolution: int):
    """Corner int64 coords (N, 8, 3) and trilinear weights (N, 8) f32 for one
    level; the weight of a corner is (w_x * w_y) * w_z."""
    scaled = points.to(torch.float32) * resolution
    base = torch.floor(scaled)
    frac = scaled - base
    offs = corner_offsets(points.device)
    corners = base.to(torch.int64)[:, None, :] + offs[None, :, :]
    w = torch.where(offs[None, :, :] > 0, frac[:, None, :], 1.0 - frac[:, None, :])
    return corners, (w[..., 0] * w[..., 1]) * w[..., 2]


def level_indices(points: torch.Tensor, resolution: int, table_size: int,
                  dense: bool):
    """(idx (N, 8) int64, weights (N, 8) f32) for one level, sentinel rows
    (x < 0) pinned to row 0 with weight 0."""
    corners, weights = level_corners(points, resolution)
    idx = corner_index(corners, resolution, table_size, dense)
    valid = (points[:, 0] >= 0.0)[:, None]
    return torch.where(valid, idx, 0), weights * valid.to(weights.dtype)


def hash_encode(points: torch.Tensor, tables: torch.Tensor, resolutions,
                dense_flags) -> torch.Tensor:
    """points (N, 3), tables (L, T, F) -> (N, L*F) f32."""
    table_size = tables.shape[1]
    outs = []
    for level in range(tables.shape[0]):
        idx, weights = level_indices(points, int(resolutions[level]), table_size,
                                     bool(dense_flags[level]))
        feats = tables[level][idx].to(torch.float32)        # (N, 8, F)
        outs.append(torch.sum(weights[..., None] * feats, dim=1))
    return torch.cat(outs, dim=-1)
