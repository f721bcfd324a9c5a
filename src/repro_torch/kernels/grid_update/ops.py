"""BUM-merged grid updates: sort, then merge runs and commit once per run.

The port of `repro.kernels.grid_update.ops`.  `merged_scatter_add` is
mathematically the naive duplicate scatter-add (`ref.scatter_add`) with the
write collisions removed: the stream is stably sorted by address (the glue
that `jnp.argsort` is in the reference) and the commit merges each run of
equal addresses into one write.  Both halves go by device.  `sort_stream`
sends a CUDA tensor to the radix-sort kernel (`kernel.bum_sort`, over the
address bits the table needs) and a CPU tensor to `torch.sort`; the commit
sends a CPU tensor to the plain `ref.segment_commit` and a CUDA tensor to
the kernel (`kernel.bum_scatter`), which sums each run in stream order on
one thread -- no float atomics, so the result is the same bits on every run.
A 2-byte table (bf16 / f16, `FieldConfig.grid_dtype`) is committed as the
reference's Pallas wrapper commits it (`bum_scatter_pallas`): into an f32
copy of the table, each row's f32 value plus its run's f32 sum, rounded to
the table's dtype once at the end.  (The reference's XLA route rounds each
run's sum to the table's dtype before a 2-byte add, a second rounding; the
two agree on a zero table, which is what every training caller commits
into.)

`windowed_scatter_add` takes both of the reference's shapes.  Stacked,
idx (W, M) and vals (W, M, F) are W per-step streams committed one after
another in step order, each exactly as `merged_scatter_add` would commit it
(the form the fused step's plain backward uses, one row per grid).  One
long stream idx (M,), vals (M, F) is cut into `window`-sized pieces, the
tail padded with spill-row (T) entries of value zero, and the pieces are
committed the same way in stream order (the LM's windowed embedding
backward, F = d_model).  Both halves of each window's commit go by device
as above: on a card the `bum_sort` and `bum_scatter` kernels, at any F.

`num_unique_addresses` is the paper's Fig. 10 statistic, the number of
distinct rows a batch of updates touches.
"""
from __future__ import annotations

import torch

from . import kernel, ref
from .. import TABLE_TYPES


def _commit(table, idx_s, vals_s):
    """Merge-and-commit of a sorted stream into a copy of `table` (a 2-byte
    table through an f32 copy, rounded once)."""
    if table.device.type == "cuda":
        if table.dtype not in TABLE_TYPES:
            raise ValueError(f"merged_scatter_add: table is {table.dtype}, expected one of "
                             f"{sorted(map(str, TABLE_TYPES))}")
        work = table.to(torch.float32, copy=True)
        kernel.bum_scatter(work, idx_s.contiguous(), vals_s.to(torch.float32).contiguous())
        return work.to(table.dtype)
    if table.device.type != "cpu":
        raise ValueError(f"merged_scatter_add: no route for device {table.device}")
    return ref.segment_commit(table, idx_s, vals_s)


def sort_stream(idx: torch.Tensor, vals: torch.Tensor, key_bits: int):
    """The update stream (idx (M,) int64, every address in [0, 2**key_bits);
    vals (M, F)) stably sorted by address: (idx[o], vals[o]) for the stable
    order o.  A CUDA tensor goes to `kernel.bum_sort` (values in f32), a CPU
    tensor to `torch.sort`."""
    if idx.device.type == "cuda":
        return kernel.bum_sort(idx.contiguous(), vals.to(torch.float32).contiguous(),
                               key_bits)
    if idx.device.type != "cpu":
        raise ValueError(f"sort_stream: no route for device {idx.device}")
    order = torch.sort(idx, stable=True).indices
    return idx[order], vals[order]


def _sort_updates(idx, vals, table_size: int, pad_to: int | None = None,
                  presorted: bool = False):
    """Sort the update stream by address (stable; the addresses lie in
    [0, T], the spill row T included), and pad it to a multiple of `pad_to`
    with spill-row (T) entries of value zero.  presorted=True promises idx
    is already non-decreasing and skips the sort: a stable sort of a sorted
    stream is the identity, so both give the same bits."""
    if presorted:
        idx_s, vals_s = idx, vals
    else:
        idx_s, vals_s = sort_stream(idx, vals, table_size.bit_length())
    if pad_to is not None and idx.shape[0] % pad_to != 0:
        pad = pad_to - idx.shape[0] % pad_to
        idx_s = torch.cat([idx_s, torch.full((pad,), table_size, dtype=idx_s.dtype,
                                             device=idx_s.device)])
        vals_s = torch.cat([vals_s, torch.zeros((pad,) + tuple(vals.shape[1:]),
                                                dtype=vals.dtype, device=vals.device)])
    return idx_s, vals_s


def merged_scatter_add(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                       *, presorted: bool = False) -> torch.Tensor:
    """table (T, F) += vals (M, F) at rows idx (M,) int64, BUM-merged; returns
    a new table.  presorted=True promises idx is non-decreasing."""
    idx_s, vals_s = _sort_updates(idx, vals, table.shape[0], presorted=presorted)
    return _commit(table, idx_s, vals_s)


def num_unique_addresses(idx: torch.Tensor) -> torch.Tensor:
    """How many distinct table rows the update stream idx (M,) touches: a
    0-d int64 tensor on idx's device."""
    if idx.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=idx.device)
    s = torch.sort(idx.reshape(-1)).values
    return (s[1:] != s[:-1]).sum() + 1


def windowed_scatter_add(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                         *, window: int = 4096, presorted: bool = False) -> torch.Tensor:
    """BUM with the paper's sliding window: merge duplicates only within each
    window of the stream and commit the windows in stream order.  idx (W, M)
    with vals (W, M, F): W stacked per-step streams (`window` is not used).
    idx (M,) with vals (M, F): one stream cut into `window`-sized pieces, the
    tail padded with spill-row entries of value zero.  presorted=True
    promises every window is already non-decreasing."""
    if idx.ndim == 1:
        t, m = table.shape[0], idx.shape[0]
        pad = (-m) % window
        if pad:
            idx = torch.cat([idx, torch.full((pad,), t, dtype=idx.dtype, device=idx.device)])
            vals = torch.cat([vals, torch.zeros((pad,) + tuple(vals.shape[1:]),
                                                dtype=vals.dtype, device=vals.device)])
        idx = idx.reshape(-1, window)
        vals = vals.reshape((idx.shape[0], window) + tuple(vals.shape[1:]))
    out = table
    for w in range(idx.shape[0]):
        out = merged_scatter_add(out, idx[w], vals[w].to(torch.float32), presorted=presorted)
    return out
