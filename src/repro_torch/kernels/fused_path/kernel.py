"""Launch wrapper of the CUDA fused encode (``csrc/fused_encode.cu``).

Replaces the Pallas kernel `repro.kernels.fused_path.kernel.fused_encode_pallas`:
one grid's hash encode of Morton-sorted points with each (256-point block,
level)'s corner reads sorted and read once per distinct address.  Validates
its inputs, allocates the outputs, launches on the current stream and counts
the launch; raises on anything the kernel does not take and on a failed
launch.  N need not be a multiple of the block: the kernel treats the rows
past N as the reference's sentinel padding.  The tables may be f32, bf16 or
f16 (`FieldConfig.grid_dtype`): the kernel loads their own 2-byte rows and
widens them in registers; the features are f32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import kernels as _k

BLOCK_POINTS = 256          # points per block (kBlockPoints)
MAX_LEVELS = 32
FEATURE_COUNTS = (1, 2, 4, 8)


@functools.cache
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _k.function("fused_encode", "fused_encode_fwd",
                       [p, p, p, p, p, p, i, i, i, i, i, p])


def fused_encode(points: torch.Tensor, tables: torch.Tensor, resolutions,
                 dense_flags) -> tuple[torch.Tensor, torch.Tensor]:
    """points (N, 3) f32, one grid's tables (L, T, F) f32, bf16 or f16, on
    one CUDA device -> (features (N, L*F) f32, distinct reads (ceil(N /
    256), L) int32: the number of table rows each (block, level) read)."""
    if points.dtype != torch.float32:
        raise ValueError(f"fused_encode: points is {points.dtype}, expected torch.float32")
    if tables.dtype not in _k.TABLE_TYPES:
        raise ValueError(f"fused_encode: tables is {tables.dtype}, expected one of "
                         f"{sorted(map(str, _k.TABLE_TYPES))}")
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"fused_encode: points must be (N, 3), got {tuple(points.shape)}")
    if tables.ndim != 3:
        raise ValueError(f"fused_encode: tables must be (L, T, F), got {tuple(tables.shape)}")
    n = points.shape[0]
    n_levels, table_size, n_features = tables.shape
    if not 1 <= n_levels <= MAX_LEVELS or len(resolutions) != n_levels \
            or len(dense_flags) != n_levels:
        raise ValueError(f"fused_encode: need 1..{MAX_LEVELS} levels with one "
                         f"resolution and dense flag each, got {n_levels}")
    if table_size & (table_size - 1) or table_size >= 1 << 31:
        raise ValueError(f"fused_encode: table size {table_size} is not a power of two "
                         "below 2^31")
    if n_features not in FEATURE_COUNTS:
        raise ValueError(f"fused_encode: F={n_features} not in {FEATURE_COUNTS}")
    device = points.device
    _k.require_cuda_f32("fused_encode", device, points=points)
    code = _k.table_type("fused_encode", device, tables=tables)
    if tables.data_ptr() % 16:
        raise ValueError("fused_encode: tables must be 16-byte aligned (vector row loads)")
    n_blocks = -(-n // BLOCK_POINTS)
    out = torch.empty((n, n_levels * n_features), device=device, dtype=torch.float32)
    reads = torch.empty((n_blocks, n_levels), device=device, dtype=torch.int32)
    if n == 0:
        return out, reads
    res = (ctypes.c_int * n_levels)(*(int(r) for r in resolutions))
    dense = (ctypes.c_int * n_levels)(*(int(bool(d)) for d in dense_flags))
    with torch.cuda.device(device):
        status = _entry()(_k.ptr(points), _k.ptr(tables), res, dense, _k.ptr(out),
                          _k.ptr(reads), n, n_levels, table_size, n_features, code,
                          _k.stream_handle(device))
    _k.check_status("fused_encode", status, "fused_encode")
    _k.count_launch("fused_encode")
    return out, reads
