"""Cross-step encoding-reuse cache: the port of
`repro.kernels.fused_path.reuse`.

Between training steps much of the hash tables is bit-stable: a grid frozen
by the update-frequency schedule does not change at all, and between
occupancy folds the live cell set is fixed.  For a cell whose 8 corner rows
(per level) have not changed since it was last encoded, the gathered rows
can be served from the cache instead of re-read from the table.

Host-side bookkeeping, as in the reference: per-row version stamps in numpy,
level-major flat (``l * T + idx``, the fused path's address-stream
convention), and per (grid, level) the cached cells -- sorted numpy keys,
their rows' addresses and the version they were read at, with the rows
themselves in one tensor on the tables' device.  Entries are keyed within a
fold epoch: `note_fold` drops them all.  `note_table_update` advances the
stamps of a grid's rows, all of them or only the rows given.

A hit and a miss go through the same arithmetic as the plain
`hash_encode.ref.hash_encode` (its corner weights, its gather's shape, its
sum), so a cached encode equals the plain encode bit for bit on any device
whenever the invalidation contract is kept.  Off the training step's path:
it measures and serves reuse for eager consumers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..hash_encode import ref as he_ref


def stream_reuse_mask(addrs: np.ndarray, row_stamp: np.ndarray, since: int) -> np.ndarray:
    """True where the row an address stream names has not changed since
    version `since`: reads a cache written at that version may still serve.
    `addrs` level-major flat row ids, `row_stamp` each row's last change."""
    return np.asarray(row_stamp)[np.asarray(addrs)] <= int(since)


class _Entries:
    """The cached cells of one (grid, level), sorted by cell key."""

    def __init__(self):
        self.keys = np.zeros((0,), np.int64)
        self.addrs = np.zeros((0, 8), np.int64)
        self.stamp = np.zeros((0,), np.int64)
        self.rows: torch.Tensor | None = None    # (m, 8, F) on the tables' device

    def lookup(self, cells: np.ndarray):
        """(found, pos): whether each cell has an entry, and where."""
        pos = np.searchsorted(self.keys, cells)
        found = pos < self.keys.shape[0]
        found[found] = self.keys[pos[found]] == cells[found]
        return found, pos

    def upsert(self, cells, addrs, stamp: int, rows: torch.Tensor) -> None:
        keep = ~np.isin(self.keys, cells)
        keys = np.concatenate([self.keys[keep], cells])
        order = np.argsort(keys, kind="stable")
        self.keys = keys[order]
        self.addrs = np.concatenate([self.addrs[keep], addrs])[order]
        self.stamp = np.concatenate(
            [self.stamp[keep], np.full(cells.shape, stamp, np.int64)])[order]
        old = rows[:0] if self.rows is None else self.rows[torch.from_numpy(keep).to(rows.device)]
        self.rows = torch.cat([old, rows])[torch.from_numpy(order).to(rows.device)]


class EncodingReuseCache:
    """(grid, level, cell, fold)-keyed cache of interpolation corner rows.

    ``resolutions`` (L,) per-level grid resolutions shared by all grids;
    ``table_sizes`` maps grid name -> per-level table size T."""

    def __init__(self, resolutions, table_sizes: dict):
        self.resolutions = tuple(int(r) for r in np.asarray(resolutions).reshape(-1))
        self.table_sizes = {g: int(t) for g, t in table_sizes.items()}
        self.dense_flags = {g: he_ref.level_is_dense(np.asarray(self.resolutions), t)
                            for g, t in self.table_sizes.items()}
        self.fold = 0
        self._version = 0
        n_lv = len(self.resolutions)
        self._row_stamp = {g: np.zeros(n_lv * t, np.int64) for g, t in self.table_sizes.items()}
        self._entries = {(g, lv): _Entries() for g in self.table_sizes for lv in range(n_lv)}
        self.hits = 0
        self.misses = 0

    # ---- invalidation events ----

    def note_fold(self) -> None:
        """Occupancy fold: a new epoch, every entry dropped."""
        self.fold += 1
        for key in self._entries:
            self._entries[key] = _Entries()

    def note_table_update(self, grid: str, touched_rows=None) -> None:
        """A training step updated `grid`'s tables: the stamps of
        `touched_rows` (level-major flat row ids, a superset of the rows
        that changed) advance, or of the whole grid when None."""
        self._version += 1
        if touched_rows is None:
            self._row_stamp[grid][:] = self._version
        else:
            self._row_stamp[grid][np.asarray(touched_rows).reshape(-1)] = self._version

    # ---- lookup ----

    def encode(self, grid: str, points_unit, tables: torch.Tensor) -> torch.Tensor:
        """Multires encoding (N, L*F) of `points_unit` (N, 3) in [0, 1)
        against `tables` (L, T, F), on the tables' device, reading cached
        corner rows where they are still valid.  Equal to
        `hash_encode.ref.hash_encode` bit for bit; the caller keeps the
        invalidation contract (`note_table_update` after every update of
        this grid, `note_fold` at occupancy folds)."""
        dev = tables.device
        pts = torch.as_tensor(points_unit, dtype=torch.float32).to(dev)
        t = self.table_sizes[grid]
        stamp = self._row_stamp[grid]
        offs = he_ref.corner_offsets(dev)
        valid = (pts[:, 0] >= 0.0)[:, None]
        outs = []
        for lv, res in enumerate(self.resolutions):
            ent = self._entries[(grid, lv)]
            corners, weights = he_ref.level_corners(pts, res)
            base = corners[:, 0, :]
            # a cell is its base corner, x-major: every point in it reads the
            # same 8 rows
            cell = ((base[:, 0] * res + base[:, 1]) * res + base[:, 2]).cpu().numpy()
            uniq, inverse = np.unique(cell, return_inverse=True)
            found, pos = ent.lookup(uniq)
            hit = found.copy()
            if found.any():
                p = pos[found]
                hit[found] = (stamp[ent.addrs[p]] <= ent.stamp[p][:, None]).all(axis=1)
            n_hit = int(hit.sum())
            self.hits += n_hit
            self.misses += int(uniq.shape[0]) - n_hit
            rows_u = torch.empty((uniq.shape[0], 8, tables.shape[-1]), dtype=tables.dtype,
                                 device=dev)
            hi, mi = np.nonzero(hit)[0], np.nonzero(~hit)[0]
            if hi.size:
                rows_u[torch.from_numpy(hi).to(dev)] = ent.rows[torch.from_numpy(pos[hi]).to(dev)]
            if mi.size:
                cells = uniq[mi]
                b = np.stack([cells // (res * res), (cells // res) % res, cells % res], axis=-1)
                idx = he_ref.corner_index(torch.from_numpy(b).to(dev)[:, None, :] + offs[None],
                                          res, t, bool(self.dense_flags[grid][lv]))
                fresh = tables[lv][idx]
                rows_u[torch.from_numpy(mi).to(dev)] = fresh
                ent.upsert(cells, (idx + lv * t).cpu().numpy(), self._version, fresh)
            # the plain encode's arithmetic on the (cached or fresh) rows
            feats = rows_u[torch.from_numpy(inverse.reshape(-1)).to(dev)].to(torch.float32)
            w = weights * valid.to(weights.dtype)
            outs.append(torch.sum(w[..., None] * feats, dim=1))
        return torch.cat(outs, dim=-1)

    # ---- accounting ----

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def stats(self) -> dict:
        """Reuse accounting: each hit is 8 corner-row reads (per level) the
        table never sees."""
        return {
            "lookups": int(self.lookups),
            "hits": int(self.hits),
            "misses": int(self.misses),
            "hit_rate": self.hit_rate(),
            "corner_reads_saved": int(self.hits) * 8,
            "fold": int(self.fold),
        }
