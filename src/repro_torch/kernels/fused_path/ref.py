"""Morton keys, the shared corner geometry and the plain fused encode.

The port of `repro.kernels.fused_path.ref` and of the function of its Pallas
kernel (`repro.kernels.fused_path.kernel`).  `morton_key` is the compact
stage's sort key.  The reference works in uint32; torch lacks unsigned
shifts and masks on 32 bits, so the keys are computed in int64 -- every
intermediate stays below 2^30, so the bits are the reference's exactly.

The geometry functions compute each level's corner coords and trilinear
weights ONCE for both grids of a decomposed field (same resolutions,
different table sizes); `fused_step` builds its plain forward and backward
from them.  Integer outputs (corner coords, indices, the address stream) are
the reference's exactly, as int64.

`fused_encode` is the plain version of kernel #8: the hash encode of
Morton-sorted points with each (block, level)'s corner addresses sorted
before the gather (duplicates adjacent, the FMU's coalesced read) and the
rows put back in point order after it.  It gathers the same rows and sums
them as `hash_encode.ref.hash_encode` does, so the two agree bit for bit.
`dedup_stats` counts the distinct reads that the sort makes possible.
"""
from __future__ import annotations

import torch

from ..hash_encode import ref as he_ref
from ...obs import metrics as _obs_metrics
from ...obs import trace as _obs_trace

DEFAULT_BLOCK_POINTS = 256
PAD_SENTINEL = -1.0     # padded rows: read row 0 at weight 0, add nothing

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


# --- the fused encode (plain version of kernel #8) ---------------------------

def fused_encode(points: torch.Tensor, tables: torch.Tensor, resolutions, dense_flags,
                 block_points: int = DEFAULT_BLOCK_POINTS) -> torch.Tensor:
    """points (N, 3), one grid's tables (L, T, F) -> (N, L*F) f32.

    N is padded to a multiple of `block_points` with sentinel rows; for each
    (block, level) the block's B*8 corner addresses are stably sorted, the
    rows gathered in that order and put back in point order, then weighted
    and summed over the 8 corners in corner order."""
    n = points.shape[0]
    n_levels, table_size, n_features = tables.shape
    pad = (-n) % block_points
    pts = points
    if pad:
        pts = torch.cat([points, torch.full((pad, 3), PAD_SENTINEL, dtype=points.dtype,
                                            device=points.device)])
    n_blocks = pts.shape[0] // block_points
    outs = []
    for level in range(n_levels):
        idx, weights = he_ref.level_indices(pts, int(resolutions[level]), table_size,
                                            bool(dense_flags[level]))
        blocks = idx.reshape(n_blocks, block_points * 8)
        order = torch.sort(blocks, dim=1, stable=True).indices
        rows = tables[level][torch.gather(blocks, 1, order)]     # sorted gather
        feats = torch.empty_like(rows).scatter_(
            1, order[..., None].expand_as(rows), rows)           # back to point order
        feats = feats.reshape(-1, 8, n_features)[:n].to(torch.float32)
        outs.append(torch.sum(weights[:n, :, None] * feats, dim=1))
    return torch.cat(outs, dim=-1)


# --- instrumentation ---------------------------------------------------------

def block_distinct_reads(idx_l: list, block_points: int = DEFAULT_BLOCK_POINTS) -> torch.Tensor:
    """Distinct table addresses read by each (point block, level): idx_l is
    one (N, 8) index tensor per level; returns (n_blocks, L) int64.  The last
    block may be short; only its N mod B rows count."""
    n = idx_l[0].shape[0]
    pad = (-n) % block_points
    n_blocks = (n + pad) // block_points
    counts = []
    for idx in idx_l:
        a = torch.cat([idx.reshape(-1), torch.full((pad * 8,), -1, dtype=idx.dtype,
                                                   device=idx.device)])
        a = torch.sort(a.reshape(n_blocks, block_points * 8), dim=1).values
        start = torch.ones_like(a, dtype=torch.bool)
        start[:, 1:] = a[:, 1:] != a[:, :-1]
        counts.append(torch.sum(start & (a >= 0), dim=1))
    return torch.stack(counts, dim=1)


def unique_ratio_block(counts: torch.Tensor, n: int,
                       block_points: int = DEFAULT_BLOCK_POINTS) -> float:
    """The mean over every (block, level) of its distinct reads (counts,
    (n_blocks, L)) over its 8 * rows corner reads, in the reference's order
    (level-major, then block); the last block of N points may be short."""
    n_blocks = counts.shape[0]
    rows = torch.clamp(n - block_points * torch.arange(n_blocks), max=block_points)
    ratios = counts.cpu().T.to(torch.float64) / (8 * rows)
    return float(ratios.reshape(-1).numpy().mean())


def dedup_stats(points, resolutions, dense_flags, table_size: int,
                block_points: int = DEFAULT_BLOCK_POINTS) -> dict:
    """Unique-corner-read accounting for one grid's forward stream.

    `unique_ratio_block` is the FMU figure of merit: within each (point
    block, level) kernel step, the fraction of corner reads that hit
    distinct addresses -- every duplicate is a read the FMU coalesces away.
    `unique_ratio_global` is the whole-batch bound.  `unique_reads_block`
    (the port's addition) is the sum of the distinct reads over every
    (block, level): what the fused encode kernel reads."""
    pts = torch.as_tensor(points)
    n = pts.shape[0]
    corners, _ = corner_geometry(pts, resolutions)
    idx_l = level_indices(corners, resolutions, table_size, dense_flags)
    total = n * 8 * len(idx_l)
    uniq_global = sum(int(torch.unique(idx).numel()) for idx in idx_l)
    counts = block_distinct_reads(idx_l, block_points)
    stats = {
        "total_reads": int(total),
        "unique_reads_global": int(uniq_global),
        "unique_ratio_global": uniq_global / total,
        "unique_ratio_block": unique_ratio_block(counts, n, block_points),
        "n_blocks": int(counts.numel()),
        "unique_reads_block": int(counts.sum()),
    }
    # folded into the port's obs registry (a no-op while tracing is off)
    if _obs_trace.enabled():
        _obs_metrics.gauge("fused_path.dedup.unique_ratio_block").set(
            stats["unique_ratio_block"])
        _obs_metrics.gauge("fused_path.dedup.unique_ratio_global").set(
            stats["unique_ratio_global"])
    return stats
