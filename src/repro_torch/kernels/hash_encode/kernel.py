"""Launch wrapper of the CUDA hash-grid encode (``csrc/hash_encode.cu``).

Replaces the Pallas kernel `repro.kernels.hash_encode.kernel.hash_encode_pallas`.
Validates its inputs (the kernel's row loads are vector loads, so the
tables must be 16-byte aligned; its offsets are 32-bit), allocates the
output, launches on the current stream and counts the launch; raises on
anything the kernel does not take and on a failed launch.  The tables may
be f32, bf16 or f16 (`FieldConfig.grid_dtype`): the kernel loads their own
2-byte rows and widens them in registers; the output is f32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import kernels as _k

MAX_LEVELS = 32
FEATURE_COUNTS = (1, 2, 4, 8)


@functools.cache
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _k.function("hash_encode", "hash_encode_fwd",
                       [p, p, p, p, p, i, i, i, i, i, p])


def hash_encode(points: torch.Tensor, tables: torch.Tensor, resolutions,
                dense_flags) -> torch.Tensor:
    """points (N, 3) f32, tables (L, T, F) f32, bf16 or f16, on one CUDA
    device -> (N, L*F) f32."""
    device = points.device
    _k.require_cuda_f32("hash_encode", device, points=points)
    code = _k.table_type("hash_encode", device, tables=tables)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"hash_encode: points must be (N, 3), got {tuple(points.shape)}")
    if tables.ndim != 3:
        raise ValueError(f"hash_encode: tables must be (L, T, F), got {tuple(tables.shape)}")
    n = points.shape[0]
    n_levels, table_size, n_features = tables.shape
    if not 1 <= n_levels <= MAX_LEVELS or len(resolutions) != n_levels \
            or len(dense_flags) != n_levels:
        raise ValueError(f"hash_encode: need 1..{MAX_LEVELS} levels with one "
                         f"resolution and dense flag each, got {n_levels}")
    if table_size & (table_size - 1):
        raise ValueError(f"hash_encode: table size {table_size} is not a power of two")
    if n_features not in FEATURE_COUNTS:
        raise ValueError(f"hash_encode: F={n_features} not in {FEATURE_COUNTS}")
    if max(tables.numel(), n * n_levels * n_features) >= 1 << 31:
        raise ValueError("hash_encode: tables and output must hold fewer than 2^31 "
                         "elements (32-bit offsets)")
    if tables.data_ptr() % 16:
        raise ValueError("hash_encode: tables must be 16-byte aligned (vector row loads)")
    out = torch.empty((n, n_levels * n_features), device=device, dtype=torch.float32)
    if n == 0:
        return out
    res = (ctypes.c_int * n_levels)(*(int(r) for r in resolutions))
    dense = (ctypes.c_int * n_levels)(*(int(bool(d)) for d in dense_flags))
    with torch.cuda.device(device):
        status = _entry()(_k.ptr(points), _k.ptr(tables), res, dense, _k.ptr(out),
                          n, n_levels, table_size, n_features, code,
                          _k.stream_handle(device))
    _k.check_status("hash_encode", status, "hash_encode")
    _k.count_launch("hash_encode")
    return out
