"""The fused compacted-path encode as an autograd op.

The port of `repro.kernels.fused_path.ops.make_fused_encode`, which returns
a differentiable

    encode(points, *tables) -> tuple of (N, L*F) features, one per grid

over every hash grid of a field (density and color share the level
geometry: same resolutions, different table sizes).  By device: a CUDA
tensor runs kernel #8 (`kernel.fused_encode`, in-block deduplicated corner
reads) once per grid; a CPU tensor runs the plain `ref.fused_encode`.

The backward plans each grid's commit as the reference's `_plan` does:
the shared corner geometry and each grid's canonical address stream
(level-major, then point, then corner), sorted stably by address
(`grid_update.ops.sort_stream`: the `bum_sort` kernel on a CUDA tensor,
`torch.sort` on a CPU one); it builds the update values in canonical order
and commits them in that order through
`grid_update.ops.merged_scatter_add(presorted=True)`, the `bum_scatter`
kernel (#7) on a CUDA tensor.  The same products in the same stable order
as the hash-encode backward, so the table gradients are `hash_encode`'s
bit for bit.  A frozen table (`needs_input_grad`) gets no commit; the
points get a zero gradient.

residual_policy: "recompute" (default) keeps only the points and plans in
the backward; "stash" plans in the forward (`plan_streams`, shared with
the fused step) and keeps the corner weights (L, N, 8) and each grid's
(sorted addresses, order), as the reference's stash does -- on the plain
route.  On a CUDA tensor the port recomputes the plan under either policy,
where the reference's Pallas route stashes it: a departure in memory only,
since the backward's stable `bum_sort` gives the stable sort's permutation
and so the same bits.  The same deterministic ops on the same inputs:
bit-identical gradients.  merged_backward=False commits with the reference's unmerged
scatter (``flat.at[addr].add``), `index_add_` on both devices -- the
flagged atomic path on a card, whose sums are not reproducible run to run.
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


def plan_streams(idx, table_sizes, needs):
    """Each needed grid's canonical address stream (level-major, then point,
    then corner) from its level indices, stably sorted: [(sorted addresses,
    order), or (None, None) for a frozen grid] -- the "stash" plan of the
    reference's `_plan` / `_plan_streams`, on the plain route (here and in
    the fused step)."""
    streams = []
    for idx_l, size, need in zip(idx, table_sizes, needs):
        if not need:
            streams.append((None, None))
            continue
        addr = ref.address_stream(idx_l, size)
        order = torch.sort(addr, stable=True).indices
        streams.append((addr[order], order))
    return streams


def _table_gradient(points, g_out, resolutions, dense_flags, table_shape, w_stack,
                    merged: bool, corners=None, stream=None):
    """One grid's table gradient (L, T, F) f32 for the upstream gradient
    g_out (N, L*F): canonical-order updates, in the stable address order
    (sorted here from `corners`, or the planned `stream`: (sorted
    addresses, order)), committed merged, or unmerged with `index_add_`."""
    n_levels, table_size, n_features = table_shape
    gg = g_out.reshape(points.shape[0], n_levels, n_features).to(torch.float32)
    vals = (w_stack[:, :, :, None] * gg.permute(1, 0, 2)[:, :, None, :]).reshape(-1, n_features)
    if stream is None:
        idx_l = ref.level_indices(corners, resolutions, table_size, dense_flags)
        addr = ref.address_stream(idx_l, table_size)
        # no spill row: every address lies in [0, L*T)
        addr_s, vals_s = gu_ops.sort_stream(addr, vals,
                                            (n_levels * table_size - 1).bit_length())
    else:
        addr_s, vals_s = stream[0], vals[stream[1]]
    flat = torch.zeros((n_levels * table_size, n_features), dtype=torch.float32,
                       device=points.device)
    if merged:
        flat = gu_ops.merged_scatter_add(flat, addr_s, vals_s, presorted=True)
    else:
        flat.index_add_(0, addr_s, vals_s.to(torch.float32))
    return flat.reshape(table_shape)


class _FusedEncode(torch.autograd.Function):
    """(geometry, options, points, *tables) -> one (N, L*F) tensor per
    table; geometry = (resolutions, dense flags per grid), options =
    (merged_backward, stash)."""

    @staticmethod
    def forward(ctx, geometry, options, points, *tables):
        resolutions, dense = geometry
        ctx.geometry, ctx.merged = geometry, options[0]
        ctx.tables = [(tuple(t.shape), t.dtype) for t in tables]
        outs = tuple(_forward(points, t, resolutions, d) for t, d in zip(tables, dense))
        ctx.stash = None
        if options[1] and points.device.type == "cpu" and any(ctx.needs_input_grad):
            corners, weights = ref.corner_geometry(points, resolutions)
            idx = [ref.level_indices(corners, resolutions, t.shape[1], d)
                   for t, d in zip(tables, dense)]
            streams = plan_streams(idx, [t.shape[1] for t in tables], ctx.needs_input_grad[3:])
            ctx.stash = len(streams)
            ctx.save_for_backward(points, torch.stack(weights),
                                  *(t for st in streams for t in st))
        else:
            ctx.save_for_backward(points)
        return outs

    @staticmethod
    def backward(ctx, *g_outs):
        points, *stash = ctx.saved_tensors
        resolutions, dense = ctx.geometry
        needs = ctx.needs_input_grad[3:]
        grads = [None] * len(needs)
        if any(needs):
            corners = streams = None
            if ctx.stash is not None:
                w_stack = stash[0]
                streams = [tuple(stash[1 + 2 * g:3 + 2 * g]) for g in range(ctx.stash)]
            else:
                corners, weights = ref.corner_geometry(points, resolutions)
                w_stack = torch.stack(weights)                      # (L, N, 8)
            for g, (need, (shape, dtype)) in enumerate(zip(needs, ctx.tables)):
                if need:
                    grads[g] = _table_gradient(
                        points, g_outs[g], resolutions, dense[g], shape, w_stack,
                        ctx.merged, corners=corners,
                        stream=None if streams is None else streams[g]).to(dtype)
        g_points = torch.zeros_like(points) if ctx.needs_input_grad[2] else None
        return (None, None, g_points, *grads)


def make_fused_encode(resolutions, table_sizes, n_features: int, *,
                      residual_policy: str = "recompute",
                      merged_backward: bool = True) -> Callable:
    """Build the fused multi-grid encoder for fixed level geometry.

    resolutions: per-level grid resolutions (shared by all grids);
    table_sizes: one table size per grid, e.g. (T_density, T_color).
    Returns encode(points (N, 3), *tables [(L, T_g, F)]) -> tuple of
    (N, L*F).  Points should be Morton-ordered unit coords, as the
    pipeline's compact stage delivers them: correctness does not depend on
    it, the kernel's dedup does.  residual_policy / merged_backward: see
    the module docstring."""
    if residual_policy not in RESIDUAL_POLICIES:
        raise ValueError(f"residual_policy must be one of {RESIDUAL_POLICIES}")
    options = (bool(merged_backward), residual_policy == "stash")
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
        return _FusedEncode.apply(geometry, options, points, *tables)

    return encode
