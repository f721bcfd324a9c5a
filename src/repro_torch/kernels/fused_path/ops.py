"""The fused compacted-path encode as an autograd op.

The port of `repro.kernels.fused_path.ops.make_fused_encode`, which returns
a differentiable

    encode(points, *tables) -> tuple of (N, L*F) features, one per grid

over every hash grid of a field (density and color share the level
geometry: same resolutions, different table sizes).  By device: a CUDA
tensor runs kernel #8 (`kernel.fused_encode`, in-block deduplicated corner
reads) once per grid; a CPU tensor runs the plain `ref.fused_encode`.

The backward follows the reference's default residual policy,
"recompute": only the points cross to the backward, which re-derives the
shared corner geometry and each grid's canonical address stream (level-major,
then point, then corner), builds the update values in canonical order, sorts
the stream stably by address -- the reference's `_plan` --
(`grid_update.ops.sort_stream`: the `bum_sort` kernel on a CUDA tensor,
`torch.sort` on a CPU one) and commits it through
`grid_update.ops.merged_scatter_add(presorted=True)`, the `bum_scatter`
kernel (#7) on a CUDA tensor.  The same products in the
same stable order as the hash-encode backward, so the table gradients are
`hash_encode`'s bit for bit.  A frozen table (`needs_input_grad`) gets no
commit; the points get a zero gradient.  The "stash" policy is not ported.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import kernel, ref
from ..grid_update import ops as gu_ops
from ..hash_encode import ref as he_ref

RESIDUAL_POLICIES = ("stash", "recompute")


def _forward(points, table, resolutions, dense_flags):
    if points.device.type == "cuda":
        return kernel.fused_encode(points, table, resolutions, dense_flags)[0]
    if points.device.type != "cpu":
        raise ValueError(f"fused_encode: no route for device {points.device}")
    return ref.fused_encode(points, table, resolutions, dense_flags)


def _table_gradient(points, g_out, resolutions, dense_flags, table_shape, corners, w_stack):
    """One grid's table gradient (L, T, F) f32 for the upstream gradient
    g_out (N, L*F): canonical-order updates, stably sorted by address,
    committed presorted."""
    n_levels, table_size, n_features = table_shape
    idx_l = ref.level_indices(corners, resolutions, table_size, dense_flags)
    addr = ref.address_stream(idx_l, table_size)
    gg = g_out.reshape(points.shape[0], n_levels, n_features).to(torch.float32)
    vals = (w_stack[:, :, :, None] * gg.permute(1, 0, 2)[:, :, None, :]).reshape(-1, n_features)
    # no spill row: every address lies in [0, L*T)
    addr_s, vals_s = gu_ops.sort_stream(addr, vals, (n_levels * table_size - 1).bit_length())
    flat = torch.zeros((n_levels * table_size, n_features), dtype=torch.float32,
                       device=points.device)
    flat = gu_ops.merged_scatter_add(flat, addr_s, vals_s, presorted=True)
    return flat.reshape(table_shape)


class _FusedEncode(torch.autograd.Function):
    """(geometry, points, *tables) -> one (N, L*F) tensor per table;
    geometry = (resolutions, dense flags per grid)."""

    @staticmethod
    def forward(ctx, geometry, points, *tables):
        resolutions, dense = geometry
        ctx.geometry = geometry
        ctx.tables = [(tuple(t.shape), t.dtype) for t in tables]
        ctx.save_for_backward(points)
        return tuple(_forward(points, t, resolutions, d) for t, d in zip(tables, dense))

    @staticmethod
    def backward(ctx, *g_outs):
        (points,) = ctx.saved_tensors
        resolutions, dense = ctx.geometry
        needs = ctx.needs_input_grad[2:]
        grads = [None] * len(needs)
        if any(needs):
            corners, weights = ref.corner_geometry(points, resolutions)
            w_stack = torch.stack(weights)                          # (L, N, 8)
            for g, (need, (shape, dtype)) in enumerate(zip(needs, ctx.tables)):
                if need:
                    grads[g] = _table_gradient(points, g_outs[g], resolutions, dense[g],
                                               shape, corners, w_stack).to(dtype)
        g_points = torch.zeros_like(points) if ctx.needs_input_grad[1] else None
        return (None, g_points, *grads)


def make_fused_encode(resolutions, table_sizes, n_features: int, *,
                      residual_policy: str = "recompute") -> Callable:
    """Build the fused multi-grid encoder for fixed level geometry.

    resolutions: per-level grid resolutions (shared by all grids);
    table_sizes: one table size per grid, e.g. (T_density, T_color).
    Returns encode(points (N, 3), *tables [(L, T_g, F)]) -> tuple of
    (N, L*F).  Points should be Morton-ordered unit coords, as the
    pipeline's compact stage delivers them: correctness does not depend on
    it, the kernel's dedup does."""
    if residual_policy not in RESIDUAL_POLICIES:
        raise ValueError(f"residual_policy must be one of {RESIDUAL_POLICIES}")
    if residual_policy == "stash":
        raise NotImplementedError(
            "fused_encode: the 'stash' residual policy is not ported; 'recompute' gives "
            "the same gradients")
    resolutions = tuple(int(r) for r in resolutions)
    dense = tuple(tuple(bool(x) for x in he_ref.level_is_dense(np.asarray(resolutions), int(t)))
                  for t in table_sizes)
    geometry = (resolutions, dense)

    def encode(points, *tables):
        if len(tables) != len(dense):
            raise ValueError(f"fused_encode: built for {len(dense)} grids, got {len(tables)}")
        for t, size in zip(tables, table_sizes):
            if tuple(t.shape) != (len(resolutions), int(size), n_features):
                raise ValueError(f"fused_encode: table {tuple(t.shape)} is not "
                                 f"({len(resolutions)}, {int(size)}, {n_features})")
        return _FusedEncode.apply(geometry, points, *tables)

    return encode
