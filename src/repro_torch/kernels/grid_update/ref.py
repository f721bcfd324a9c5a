"""Plain PyTorch versions of the embedding-grid gradient commits.

The port of `repro.kernels.grid_update.ref` (the naive duplicate
scatter-add) and of the reference's merge body `_segment_commit`
(`repro.kernels.grid_update.ops`), which is the plain version of the CUDA
kernel `kernel.bum_scatter`: an address-sorted update stream is merged into
one sum per run of equal addresses -- summed in stream order, from zero --
and each run commits once.  Entries whose address lies outside [0, T) (the
spill row T of padded streams) are dropped.

On a CPU tensor `Tensor.index_add_` adds its sources one after another in
index order, so the run sums are the reference's `segment_sum` sums bit for
bit, and the commit writes each row at most once.  Like the reference,
`segment_commit` keeps M segment slots and routes the empty ones (and
out-of-range runs) to a spill row, so it never waits on the device.
"""
from __future__ import annotations

import torch


def scatter_add(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """table (T, F) + vals (M, F) at rows idx (M,), duplicates accumulated."""
    return table.index_add(0, idx, vals.to(table.dtype))


def run_starts(idx_s: torch.Tensor) -> torch.Tensor:
    """(M,) bool: True at the first entry of each run of equal addresses."""
    start = torch.ones_like(idx_s, dtype=torch.bool)
    start[1:] = idx_s[1:] != idx_s[:-1]
    return start


def segment_commit(table: torch.Tensor, idx_s: torch.Tensor,
                   vals_s: torch.Tensor) -> torch.Tensor:
    """table (T, F) plus the run-merged, address-sorted stream (idx_s (M,),
    vals_s (M, F)): one stream-order sum per run, committed once per run."""
    if idx_s.numel() == 0:
        return table.clone()
    m, t = idx_s.shape[0], table.shape[0]
    seg = torch.cumsum(run_starts(idx_s).to(torch.int64), 0) - 1
    summed = torch.zeros((m,) + tuple(vals_s.shape[1:]), dtype=torch.float32,
                         device=vals_s.device)
    summed.index_add_(0, seg, vals_s.to(torch.float32))
    # each run's address (every entry of a run writes the same one); empty
    # slots and out-of-range runs go to the spill row t
    addr = torch.full((m,), t, dtype=idx_s.dtype, device=idx_s.device).scatter(0, seg, idx_s)
    addr = torch.where((addr >= 0) & (addr < t), addr, torch.full_like(addr, t))
    spill = torch.zeros((1,) + tuple(table.shape[1:]), dtype=table.dtype, device=table.device)
    return torch.cat([table, spill]).index_add(0, addr, summed.to(table.dtype))[:t]
