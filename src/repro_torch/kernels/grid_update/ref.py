"""Plain PyTorch versions of the embedding-grid gradient commits.

The port of `repro.kernels.grid_update.ref` (the naive duplicate
scatter-add and the Fig. 10 statistic `unique_fraction`) and of the
reference's merge body `_segment_commit` (`repro.kernels.grid_update.ops`),
which is the plain version of the CUDA kernel `kernel.bum_scatter`: an
address-sorted update stream is merged into one sum per run of equal
addresses -- summed in stream order, from zero -- and each run commits
once.  Entries whose address lies outside [0, T) (the
spill row T of padded streams) are dropped.  The commit adds in f32 and
rounds to the table's dtype once, as the reference's Pallas kernel does: a
2-byte table (bf16 / f16) gets bf16(f32(row) + run sum), where the
reference's XLA route rounds the run sum to the table's dtype first.

On a CPU tensor `Tensor.index_add_` adds its sources one after another in
index order, so the run sums are the reference's `segment_sum` sums bit for
bit, and the commit writes each row at most once.  Like the reference,
`segment_commit` keeps M segment slots and routes the empty ones (and
out-of-range runs) to a spill row, so it never waits on the device.

`stable_key_sort` is the plain version of the CUDA kernel `kernel.bum_sort`:
the stable sort of an update stream by address, values carried, as a
least-significant-digit radix sort over the key's low `key_bits` bits in
the kernel's digits (`radix_passes`).  Each pass counts the digits
(`bincount`), turns the counts into each digit's first output position (an
exclusive `cumsum`) and moves every entry to that position plus its rank
among the entries of its digit that precede it in the stream.  Its output is
`addr[o], vals[o]` for the stable order `o` of `addr`: a stable sort's
permutation is unique.
"""
from __future__ import annotations

import torch

RADIX_MAX_BITS = 8          # the widest digit of one pass (256 buckets)


def scatter_add(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """table (T, F) + vals (M, F) at rows idx (M,), duplicates accumulated."""
    return table.index_add(0, idx, vals.to(table.dtype))


def unique_fraction(idx: torch.Tensor, window: int = 1000) -> torch.Tensor:
    """Mean fraction of distinct addresses per window of `window` consecutive
    updates (the paper's Fig. 10 statistic): a 0-d f32 tensor.  The stream
    is cut into max(M // window, 1) windows; a tail shorter than a window
    is dropped."""
    m = idx.shape[0]
    n_win = max(m // window, 1)
    s = torch.sort(idx[: n_win * window].reshape(n_win, window), dim=1).values
    uniq = torch.ones((n_win, window), dtype=torch.bool, device=idx.device)
    uniq[:, 1:] = s[:, 1:] != s[:, :-1]
    return torch.mean(uniq.sum(dim=1).to(torch.float32) / window)


def run_starts(idx_s: torch.Tensor) -> torch.Tensor:
    """(M,) bool: True at the first entry of each run of equal addresses."""
    start = torch.ones_like(idx_s, dtype=torch.bool)
    start[1:] = idx_s[1:] != idx_s[:-1]
    return start


def segment_commit(table: torch.Tensor, idx_s: torch.Tensor,
                   vals_s: torch.Tensor) -> torch.Tensor:
    """table (T, F) plus the run-merged, address-sorted stream (idx_s (M,),
    vals_s (M, F)): one stream-order sum per run, committed once per run,
    added to the row in f32 and rounded to the table's dtype once."""
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
    acc = torch.promote_types(table.dtype, torch.float32)
    spill = torch.zeros((1,) + tuple(table.shape[1:]), dtype=acc, device=table.device)
    work = torch.cat([table.to(acc), spill])
    return work.index_add(0, addr, summed.to(acc))[:t].to(table.dtype)


def radix_passes(key_bits: int) -> list[tuple[int, int]]:
    """(shift, width) of each least-significant-digit pass over `key_bits`
    bits: the fewest passes of at most RADIX_MAX_BITS bits, the widths as
    even as they can be (23 bits: 8, 8, 7; 21 bits: 7, 7, 7)."""
    if not 0 <= key_bits <= 32:
        raise ValueError(f"key_bits must lie in [0, 32], got {key_bits}")
    n = -(-key_bits // RADIX_MAX_BITS)
    widths = [key_bits // n + (k < key_bits % n) for k in range(n)]
    shifts = [sum(widths[:k]) for k in range(n)]
    return list(zip(shifts, widths))


def _rank_in_digit(digit: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(M,) int64: how many earlier entries of the stream share each entry's
    digit, one running count per digit that occurs (`counts` > 0)."""
    rank = torch.zeros_like(digit)
    for v in torch.nonzero(counts).flatten().tolist():
        hit = digit == v
        rank += torch.where(hit, torch.cumsum(hit, 0) - 1, 0)
    return rank


def stable_key_sort(addr: torch.Tensor, vals: torch.Tensor,
                    key_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The stream (addr (M,) int64 in [0, 2**key_bits), vals (M, ...))
    stably sorted by address: (addr[o], vals[o]) for o the stable order."""
    passes = radix_passes(key_bits)
    if not passes:                      # key_bits 0: every key is 0, the order stays
        return addr.clone(), vals.clone()
    keys, carried = addr, vals
    for shift, width in passes:
        n_digits = 1 << width
        digit = (keys >> shift) & (n_digits - 1)
        counts = torch.bincount(digit, minlength=n_digits)
        first = torch.cumsum(counts, 0) - counts            # exclusive
        dest = first[digit] + _rank_in_digit(digit, counts)
        keys = torch.empty_like(keys).index_copy_(0, dest, keys)
        carried = torch.empty_like(carried).index_copy_(0, dest, carried)
    return keys, carried
