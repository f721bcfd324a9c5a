"""Launch wrapper of the CUDA merged scatter-add (``csrc/bum_scatter.cu``).

Replaces the Pallas kernel `repro.kernels.grid_update.kernel.bum_scatter_pallas`.
Validates its inputs, launches on the current stream and counts the launch;
raises on anything the kernel does not take and on a failed launch.  The
table is updated IN PLACE (the port's callers commit into a fresh gradient
table, so a copy would be wasted) and returned.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import kernels as _k

FEATURE_COUNTS = (1, 2, 4, 8)


@functools.cache
def _entry():
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    return _k.function("bum_scatter", "bum_scatter_commit", [p, p, p, i64, i64, i, p])


def bum_scatter(table: torch.Tensor, idx_sorted: torch.Tensor,
                vals_sorted: torch.Tensor) -> torch.Tensor:
    """table (T, F) f32 += the run-merged stream: idx_sorted (M,) int64
    non-decreasing, vals_sorted (M, F) f32, all on one CUDA device.  Entries
    outside [0, T) -- the spill row T -- are dropped.  In place."""
    device = table.device
    _k.require_cuda_f32("bum_scatter", device, table=table, vals_sorted=vals_sorted)
    _k.require_cuda("bum_scatter", device, torch.int64, idx_sorted=idx_sorted)
    if table.ndim != 2 or table.shape[1] not in FEATURE_COUNTS:
        raise ValueError(f"bum_scatter: table must be (T, F) with F in {FEATURE_COUNTS}, "
                         f"got {tuple(table.shape)}")
    m = idx_sorted.shape[0]
    if idx_sorted.ndim != 1 or vals_sorted.shape != (m, table.shape[1]):
        raise ValueError(f"bum_scatter: idx {tuple(idx_sorted.shape)} and vals "
                         f"{tuple(vals_sorted.shape)} do not match table {tuple(table.shape)}")
    if m == 0:
        return table
    with torch.cuda.device(device):
        status = _entry()(_k.ptr(idx_sorted), _k.ptr(vals_sorted), _k.ptr(table), m,
                          table.shape[0], table.shape[1], _k.stream_handle(device))
    _k.check_status("bum_scatter", status, "bum_scatter")
    _k.LAUNCHES["bum_scatter"] += 1
    return table
