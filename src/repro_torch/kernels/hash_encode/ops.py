"""Public hash-grid encode with the merged (BUM) backward.

`hash_encode` is differentiable in the tables.  Its forward goes by device:
a CUDA tensor to the CUDA kernel (`kernel.hash_encode`), a CPU tensor to the
plain PyTorch version (`ref.hash_encode`).  Its backward mirrors the
reference's `make_hash_encode` VJP (`repro.kernels.hash_encode.ops`): the
update stream of every corner of every level, level l's addresses offset by
l*T into the flat (L*T, F) table (`corner_updates`), is sorted stably by
address (`grid_update.ops.sort_stream`) and committed through
`grid_update.ops.merged_scatter_add` with one write per run -- on a CUDA
tensor the `bum_sort` and `bum_scatter` kernels.  With
``merged_backward=False`` the stream is committed unsorted with the
reference's unmerged scatter (``flat.at[idx].add``): `index_add_` on both
devices, the flagged atomic path on a card, whose sums are not reproducible
run to run.  The backward does nothing when the tables are frozen
(`needs_input_grad`), and the points get a zero gradient, as in the
reference.
"""
from __future__ import annotations

import torch

from . import kernel, ref
from ..grid_update import ops as gu_ops


def _forward(points, tables, resolutions, dense_flags):
    if points.device.type == "cuda":
        return kernel.hash_encode(points, tables, resolutions, dense_flags)
    if points.device.type != "cpu":
        raise ValueError(f"hash_encode: no route for device {points.device}")
    return ref.hash_encode(points, tables, resolutions, dense_flags)


def corner_updates(points, resolutions, dense_flags, table_size: int, grad):
    """Flattened (idx, val) update stream across all levels.

    grad (N, L, F) f32.  Returns idx (L*N*8,) int64 into the flat (L*T)
    table and vals (L*N*8, F) f32, position l*N*8 + n*8 + c -- the
    reference's `_corner_updates` order."""
    n_levels = grad.shape[1]
    all_idx, all_val = [], []
    for level in range(n_levels):
        res = int(resolutions[level])
        corners, weights = ref.level_corners(points, res)
        idx = ref.corner_index(corners, res, table_size, bool(dense_flags[level]))
        upd = weights[..., None] * grad[:, level, None, :]        # (N, 8, F)
        all_idx.append((idx + level * table_size).reshape(-1))
        all_val.append(upd.reshape(-1, grad.shape[-1]))
    return torch.cat(all_idx), torch.cat(all_val)


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, tables, resolutions, dense_flags, merged):
        ctx.save_for_backward(points)
        ctx.geometry = (resolutions, dense_flags, tuple(tables.shape), tables.dtype)
        ctx.merged = merged
        return _forward(points, tables, resolutions, dense_flags)

    @staticmethod
    def backward(ctx, g):
        (points,) = ctx.saved_tensors
        resolutions, dense_flags, (n_levels, table_size, n_features), dtype = ctx.geometry
        g_points = torch.zeros_like(points) if ctx.needs_input_grad[0] else None
        if not ctx.needs_input_grad[1]:
            return g_points, None, None, None, None
        grad = g.reshape(points.shape[0], n_levels, n_features).to(torch.float32)
        idx, vals = corner_updates(points, resolutions, dense_flags, table_size, grad)
        flat = torch.zeros((n_levels * table_size, n_features), dtype=torch.float32,
                           device=points.device)
        if ctx.merged:
            # no spill row: every address lies in [0, L*T)
            idx, vals = gu_ops.sort_stream(idx, vals, (n_levels * table_size - 1).bit_length())
            flat = gu_ops.merged_scatter_add(flat, idx, vals, presorted=True)
        else:
            flat.index_add_(0, idx, vals)
        grad_tables = flat.reshape(n_levels, table_size, n_features).to(dtype)
        return g_points, grad_tables, None, None, None


def hash_encode(points: torch.Tensor, tables: torch.Tensor, resolutions,
                dense_flags, merged_backward: bool = True) -> torch.Tensor:
    """points (N, 3) in [0, 1)^3, tables (L, T, F) -> (N, L*F) f32,
    differentiable in `tables` through the merged backward (or the
    unmerged one with ``merged_backward=False``)."""
    return _HashEncode.apply(points, tables, resolutions, dense_flags, bool(merged_backward))


def access_stream(points: torch.Tensor, resolutions, dense_flags,
                  table_size: int) -> torch.Tensor:
    """Forward-order corner address stream (the paper's Fig. 8-10
    instrumentation): (N*8*L,) int64 addresses into the flat (L*T) table,
    level by level, point by point, corner by corner."""
    grad = torch.ones((points.shape[0], len(resolutions), 1), dtype=torch.float32,
                      device=points.device)
    idx, _ = corner_updates(points, tuple(resolutions), tuple(dense_flags), table_size, grad)
    return idx
