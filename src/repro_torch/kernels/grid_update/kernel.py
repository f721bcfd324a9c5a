"""Launch wrappers of the BUM commit's two CUDA kernels.

`bum_scatter` (``csrc/bum_scatter.cu``) replaces the Pallas kernel
`repro.kernels.grid_update.kernel.bum_scatter_pallas`: the merged
scatter-add of an address-sorted stream.  The table is updated IN PLACE (the
port's callers commit into a fresh gradient table, so a copy would be
wasted) and returned.

`bum_sort` (``csrc/bum_sort.cu``) replaces the in-block argsort of the
commit inside `repro.kernels.fused_step.kernel.fused_step_bwd_pallas`: the
stable sort of a table-gradient stream by address, its values carried, as
a radix sort over the key's low `key_bits` bits in the digits of
`ref.radix_passes` (the plain version is `ref.stable_key_sort`): one memset
of its scratch, one histogram launch and one launch a pass, the offsets
found by decoupled look-back.

Both take value rows of any width F >= 1.  F in `FEATURE_COUNTS` (the 3D
tables' rows) runs the tiled instantiations above; any other F (the LM's
vocab-embedding rows, F = d_model) runs each source's wide route: the sort
carries each entry's int32 stream position through the passes and gathers
the value rows once through the sorted positions, and the commit spreads
a row over a block's threads and walks each run in stream order.

Each wrapper validates its inputs, launches on the current stream and counts
the launch; raises on anything its kernel does not take and on a failed
launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import kernels as _k
from . import ref

FEATURE_COUNTS = (1, 2, 4, 8)     # the tiled instantiations; any other F goes wide
# stream entries per block of the sort, by F (512 threads x items_per_thread);
# the wide route sorts positions, one 4-byte value an entry, in F = 1's tiles
SORT_TILE = {f: 512 * min(8, 16 // f) for f in FEATURE_COUNTS}
# the sort's look-back status words hold counts in 30 bits
SORT_MAX_ENTRIES = (1 << 30) - 1
# its int32 scratch: 4 x 256 digit counts, 4 tile counters, then a status
# word per (pass, tile, digit)
SORT_HEADER_WORDS = 4 * 256 + 4
SORT_DIGITS = 256


@functools.cache
def _entry():
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    return _k.function("bum_scatter", "bum_scatter_commit", [p, p, p, i64, i64, i, p])


@functools.cache
def _sort_entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _k.function("bum_sort", "bum_sort_stream", [p] * 8 + [i, i, p, i, p])


@functools.cache
def _sort_rows_entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _k.function("bum_sort", "bum_sort_rows", [p] * 10 + [i, i, p, i, p])


def bum_scatter(table: torch.Tensor, idx_sorted: torch.Tensor,
                vals_sorted: torch.Tensor) -> torch.Tensor:
    """table (T, F) f32 += the run-merged stream: idx_sorted (M,) int64
    non-decreasing, vals_sorted (M, F) f32, all on one CUDA device.  Entries
    outside [0, T) -- the spill row T -- are dropped.  In place."""
    device = table.device
    _k.require_cuda_f32("bum_scatter", device, table=table, vals_sorted=vals_sorted)
    _k.require_cuda("bum_scatter", device, torch.int64, idx_sorted=idx_sorted)
    if table.ndim != 2 or table.shape[1] < 1:
        raise ValueError(f"bum_scatter: table must be (T, F) with F >= 1, "
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
    _k.count_launch("bum_scatter")
    return table


def bum_sort(addr: torch.Tensor, vals: torch.Tensor,
             key_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The stream addr (M,) int64, every key in [0, 2**key_bits), and vals
    (M, F) f32, on one CUDA device, stably sorted by address: new tensors
    (addr[o], vals[o]) for o = torch.sort(addr, stable=True).indices.
    key_bits comes from the table geometry and is never read from the keys
    (no host sync); a key outside the range is not detected."""
    device = addr.device
    _k.require_cuda("bum_sort", device, torch.int64, addr=addr)
    _k.require_cuda_f32("bum_sort", device, vals=vals)
    if not 0 <= key_bits <= 32:
        raise ValueError(f"bum_sort: key_bits must lie in [0, 32], got {key_bits}")
    m = addr.shape[0]
    if addr.ndim != 1 or vals.ndim != 2 or vals.shape[0] != m or vals.shape[1] < 1:
        raise ValueError(f"bum_sort: addr {tuple(addr.shape)} and vals {tuple(vals.shape)} "
                         f"must be (M,) and (M, F) with F >= 1")
    if m > SORT_MAX_ENTRIES:
        raise ValueError(f"bum_sort: {m} entries, more than {SORT_MAX_ENTRIES}")
    passes = ref.radix_passes(key_bits)
    if m == 0 or not passes:            # key_bits 0: every key is 0, the order stays
        return addr.clone(), vals.clone()
    f = vals.shape[1]
    new = lambda shape, dtype: torch.empty(shape, device=device, dtype=dtype)  # noqa: E731
    addr_s, vals_s = new((m,), torch.int64), new((m, f), torch.float32)
    n_passes = len(passes)
    widths = (ctypes.c_int * len(passes))(*(width for _, width in passes))
    key_tmp0 = new((m,), torch.int32) if n_passes > 1 else addr_s
    key_tmp1 = new((m,), torch.int32) if n_passes > 2 else key_tmp0
    if f not in FEATURE_COUNTS:
        status = _sort_rows(addr, vals, addr_s, vals_s, key_tmp0, key_tmp1, widths, n_passes)
    else:
        # 32-bit keys between passes, one scratch copy of the values (the C
        # side leaves a buffer unused when there are too few passes to need it)
        vals_tmp = new((m, f), torch.float32) if n_passes > 1 else vals_s
        scratch = _sort_scratch(m, f, n_passes, device)
        with torch.cuda.device(device):
            status = _sort_entry()(
                _k.ptr(addr), _k.ptr(vals), _k.ptr(addr_s), _k.ptr(vals_s), _k.ptr(key_tmp0),
                _k.ptr(key_tmp1), _k.ptr(vals_tmp), _k.ptr(scratch), m, f, widths, n_passes,
                _k.stream_handle(device))
    _k.check_status("bum_sort", status, "bum_sort")
    _k.count_launch("bum_sort")
    return addr_s, vals_s


def _sort_scratch(m: int, f: int, n_passes: int, device) -> torch.Tensor:
    """The sort's int32 scratch for `m` entries of F = `f` values (the wide
    route's tiles are F = 1's)."""
    tile = SORT_TILE[f if f in FEATURE_COUNTS else 1]
    return torch.empty((SORT_HEADER_WORDS + n_passes * -(-m // tile) * SORT_DIGITS,),
                       device=device, dtype=torch.int32)


def _sort_rows(addr, vals, addr_s, vals_s, key_tmp0, key_tmp1, widths, n_passes: int) -> int:
    """`bum_sort`'s wide route: (key, int32 position) sorted by the F = 1
    passes, then the value rows gathered through the positions, one launch
    sequence writing addr_s and vals_s; returns the C entry's status."""
    device, m = addr.device, addr.shape[0]
    new = lambda: torch.empty((m,), device=device, dtype=torch.int32)  # noqa: E731
    pos, pos_out = new(), new()
    pos_tmp = new() if n_passes > 1 else pos_out
    scratch = _sort_scratch(m, 1, n_passes, device)
    with torch.cuda.device(device):
        status = _sort_rows_entry()(
            _k.ptr(addr), _k.ptr(vals), _k.ptr(addr_s), _k.ptr(vals_s), _k.ptr(key_tmp0),
            _k.ptr(key_tmp1), _k.ptr(pos), _k.ptr(pos_tmp), _k.ptr(pos_out), _k.ptr(scratch),
            m, vals.shape[1], widths, n_passes, _k.stream_handle(device))
    return status
