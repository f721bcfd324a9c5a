"""A block's ops on each rank's local tensors, for DTensor operands.

Where DTensor's own sharding propagation would pick a layout change that
not every torch version supports (a Shard to Partial redistribute, the
flatten of a split dim, an op with no strategy such as the `flip` in
`cumsum`'s backward), a block runs on plain local tensors instead, and
every layout change is an explicit `redistribute` among Shard, Replicate
and Partial(sum) -> Replicate, which every version supports, as
`attention._sdpa_on_shards` does.

`Ranks(x)` reads the block's input x (B, ...): its *row* dims are the mesh
dims that split the batch (Shard(0)), the others its *split* dims, over
which weights, caches and states may be split.  `Ranks(x, tokens=True)`
(`tokens(x)`: a residual stream (B, S, D) split along its sequence) counts
the dims that split the sequence (Shard(1)) as row dims too, so a block's
per-token work (projections, norms, the FFN) runs on each rank's own
(B, S) block of tokens.  Between its matmuls an activation is whole on
every rank of a split dim (each rank's rows),
so elementwise ops run as unplaced; a gradient of such an activation is
the same on those ranks.  A weight's local block enters a matmul (`mm`):
a row-parallel weight (Shard(0)) takes the activation's matching block and
its partial products are all-reduced, a column-parallel one (Shard(1))
has its output columns all-gathered (Megatron's f / g), and the gradients
follow (the activation's is all-reduced where the weight's columns were
split; a weight's is a partial sum over the row dims).  A block may also
run on each rank's block of its channels (a `layout` splitting them over
the split dims, as `ssm._mamba1_channels` does, Megatron's split of a
block): weights enter on their block (`local`, `split`) or whole
(`read`), a whole-row activation that every channel block reads gets its
gradient all-reduced (`shared`), and partial products are summed
(`partial`, `reduce`).  A token block's sequence may split unevenly
(DTensor's ceil-sized blocks): `wrap` gives each block's DTensor its
global shape.
"""
from __future__ import annotations

import torch


def as_dtensor(t, mesh):
    """t as a DTensor on `mesh`: a plain tensor counts as replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    return t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def from_local(t, mesh, placements, shape):
    """`DTensor.from_local` of a local block whose DTensor has the global
    `shape` (contiguous): a split dim that does not divide takes DTensor's
    uneven blocks (`torch.chunk`'s: ceil-sized, the last shorter), which
    `from_local` without a shape would take for even ones."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(t, mesh, list(placements), run_check=False, shape=shape,
                              stride=tuple(stride))


def chunk(size: int, mesh, placements, dim: int) -> tuple[int, int]:
    """(first index, length) of this rank's block of a dim `dim` of `size`
    laid out by `placements`: DTensor's nested `torch.chunk` blocks, in
    mesh order, ceil-sized with a shorter (or empty) last one."""
    start, n = 0, size
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            c = -(-n // mesh.size(i))
            at = min(mesh.get_local_rank(i) * c, n)
            start, n = start + at, min(c, n - at)
    return start, n


def redistributed(t, mesh, placements):
    """t laid out by `placements`; t itself when it is (a redistribute to
    the same layout would still all-reduce a partial gradient in its
    backward)."""
    if list(t.placements) == list(placements):
        return t
    return t.redistribute(mesh, list(placements))


def tokens(x) -> "Ranks | None":
    """`Ranks(x, tokens=True)` for a DTensor x (B, S, ...) split along its
    sequence; None otherwise (a plain tensor, or a DTensor whose every
    token block holds whole sequences, which DTensor's own propagation
    runs)."""
    from torch.distributed.tensor import Shard
    if getattr(x, "device_mesh", None) is None or Shard(1) not in x.placements:
        return None
    return Ranks(x, tokens=True)


class Ranks:
    """The layouts of one block's run on local tensors; see the module."""

    def __init__(self, x, tokens: bool = False):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh = x.device_mesh
        kept = (Shard(0), Shard(1)) if tokens else (Shard(0),)
        self.rows = [p if p in kept else Replicate() for p in x.placements]
        # the sequence's length (x's dim 1), which a token block's rows may
        # split unevenly
        self.seq = x.shape[1] if tokens else None

    def rows_at(self, lead: int) -> list:
        """The rows' placements of a tensor whose batch dim is `lead` (the
        (3, B, S) M-RoPE positions: 1)."""
        from torch.distributed.tensor import Shard
        return [Shard(p.dim + lead) if p.is_shard() else p for p in self.rows]

    def seq_offset(self, seq: int) -> int:
        """The first position of this rank's block of a sequence of `seq`
        split by the rows (the mesh dims that split it, in mesh order:
        DTensor's nested blocks)."""
        return self.seq_block(seq)[0]

    def seq_block(self, seq: int) -> tuple[int, int]:
        """(first position, length) of this rank's block of a sequence of
        `seq` split by the rows."""
        return self.chunk(seq, self.rows, 1)

    def chunk(self, size: int, placements, dim: int) -> tuple[int, int]:
        """`chunk` on this block's mesh."""
        return chunk(size, self.mesh, placements, dim)

    def wrap(self, t, placements):
        """A local block laid out by `placements` -> its DTensor: a dim a
        mesh dim splits is that many blocks long, but a token block's
        sequence (dim 1 split by the rows' sequence dims), which is
        `self.seq` long (uneven blocks where it does not divide)."""
        shape = list(t.shape)
        for i, p in enumerate(placements):
            if p.is_shard():
                shape[p.dim] *= self.mesh.size(i)
        if self.seq is not None and any(p.is_shard(1) for p in placements):
            if not all(r.is_shard(1) for p, r in zip(placements, self.rows) if p.is_shard(1)):
                raise ValueError("wrap: a token block's dim 1 split by a mesh dim that does "
                                 "not split its sequence")
            shape[1] = self.seq
        return from_local(t, self.mesh, placements, shape)

    def enter(self, x, placements=None):
        """x's local block laid out by `placements` (default: its rows,
        whole over the split dims)."""
        return redistributed(as_dtensor(x, self.mesh), self.mesh,
                             placements or self.rows).to_local()

    def leave(self, t, src=None, dst=None):
        """A local block laid out by `src` (default: whole rows) -> a
        DTensor laid out by `dst` (default: `src`)."""
        src = src or self.rows
        return redistributed(self.wrap(t, src), self.mesh, dst or src)

    def layout(self, t, dim: int, batch: bool = True) -> list:
        """Placements of a local block of t: Shard(0) on the row dims (for a
        batch-leading t), Shard(dim) on the split dims that split t's dim
        `dim`, Replicate elsewhere."""
        from torch.distributed.tensor import Replicate, Shard
        return [r if r.is_shard() and batch else Shard(dim) if p == Shard(dim) and not r.is_shard()
                else Replicate() for r, p in zip(self.rows, t.placements)]

    def local(self, t, placements):
        """A weight's block laid out by `placements` (Replicate on the row
        dims); its gradient a partial sum over the row dims."""
        from torch.distributed.tensor import Partial
        grad = [Partial() if r.is_shard() else p for r, p in zip(self.rows, placements)]
        return redistributed(as_dtensor(t, self.mesh), self.mesh, placements).to_local(
            grad_placements=grad)

    def param(self, t):
        """A weight whole on every rank."""
        from torch.distributed.tensor import Replicate
        return self.local(t, [Replicate()] * self.mesh.ndim)

    def read(self, t, layout):
        """A weight whole on every rank, of which each rank's block in
        `layout` reads its own part: its gradient a partial sum over the
        row dims and the mesh dims that split the block."""
        from torch.distributed.tensor import Partial, Replicate
        grad = [Partial() if r.is_shard() or p.is_shard() else Replicate()
                for r, p in zip(self.rows, layout)]
        return redistributed(as_dtensor(t, self.mesh), self.mesh,
                             [Replicate()] * self.mesh.ndim).to_local(grad_placements=grad)

    def split(self, layout, dim: int) -> list:
        """The placements of a weight's block along its dim `dim` where
        `layout` splits a block (its split dims), whole elsewhere."""
        from torch.distributed.tensor import Replicate, Shard
        return [Shard(dim) if p.is_shard() and not r.is_shard() else Replicate()
                for r, p in zip(self.rows, layout)]

    def rows_split(self, layout, dim: int) -> list:
        """The placements of an activation's block along its dim `dim`
        where `layout` splits a block: the rows', and Shard(dim) on the
        split dims."""
        return [r if r.is_shard() else p for r, p in zip(self.rows, self.split(layout, dim))]

    def partial(self, layout) -> list:
        """The rows with a block's products laid out by `layout` partial
        sums over its split dims (`reduce` sums them)."""
        from torch.distributed.tensor import Partial
        return [Partial() if p.is_shard() and not r.is_shard() else r
                for r, p in zip(self.rows, layout)]

    def relayout(self, t, src, dst):
        """A local block laid out by `src` -> its block laid out by `dst`."""
        if list(src) == list(dst):
            return t
        return redistributed(self.wrap(t, src), self.mesh, dst).to_local()

    def shared(self, t, layout):
        """t (whole rows) read whole by each rank's block in `layout`: the
        same t, its gradient a partial sum over the mesh dims that split
        the block (each rank's covers its own block), all-reduced."""
        grad = self.partial(layout)
        return t if grad == self.rows else self.wrap(t, self.rows).to_local(grad_placements=grad)

    def reduce(self, t, placements):
        """A local block laid out by `placements` (Partial: partial sums)
        -> whole rows."""
        return redistributed(self.wrap(t, placements), self.mesh, self.rows).to_local()

    def mm(self, a, w):
        """a (..., K) whole rows @ w (K, N1, ...), a DTensor split over the
        split dims by its rows (Shard(0), row-parallel) or its first output
        dim (Shard(1), column-parallel) -> (..., N1, ...) whole.  A weight
        split along another dim raises."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        w = as_dtensor(w, self.mesh)
        last = a.ndim - 1
        a_pl, a_grad, w_pl, out_pl = [], [], [], []
        for r, p in zip(self.rows, w.placements):
            if r.is_shard():                  # a row dim: w whole
                a_pl.append(r), a_grad.append(r), w_pl.append(Replicate()), out_pl.append(r)
            elif p == Shard(0):               # row-parallel
                a_pl.append(Shard(last)), a_grad.append(Shard(last))
                w_pl.append(p), out_pl.append(Partial())
            elif p == Shard(1):               # column-parallel
                a_pl.append(Replicate()), a_grad.append(Partial())
                w_pl.append(p), out_pl.append(Shard(last))
            elif p.is_shard():
                raise ValueError(f"mm: no route for a weight {tuple(w.shape)} split along "
                                 f"its dim {p.dim}")
            else:
                a_pl.append(Replicate()), a_grad.append(Replicate())
                w_pl.append(Replicate()), out_pl.append(Replicate())
        a_l = redistributed(self.wrap(a, self.rows), self.mesh, a_pl).to_local(
            grad_placements=a_grad)
        w_l = self.local(w, w_pl)
        out = self.reduce(a_l @ w_l.reshape(w_l.shape[0], -1), out_pl)
        return out.reshape(tuple(a.shape[:-1]) + tuple(w.shape[1:]))


# One body for plain tensors and for each rank's local blocks: each function
# below is `Ranks`' method of its name, and the identity (a plain matmul for
# `mm`) without `ranks`.

def enter(ranks: Ranks | None, t, placements=None):
    return t if ranks is None else ranks.enter(t, placements)


def leave(ranks: Ranks | None, t, src=None, dst=None):
    return t if ranks is None else ranks.leave(t, src, dst)


def local(ranks: Ranks | None, t, placements):
    return t if ranks is None else ranks.local(t, placements)


def param(ranks: Ranks | None, t):
    return t if ranks is None else ranks.param(t)


def relayout(ranks: Ranks | None, t, src, dst):
    return t if ranks is None else ranks.relayout(t, src, dst)


def reduce(ranks: Ranks | None, t, placements):
    return t if ranks is None else ranks.reduce(t, placements)


def mm(ranks: Ranks | None, a, w):
    return a @ w if ranks is None else ranks.mm(a, w)


def einsum(ranks: Ranks | None, eq: str, a, w):
    """`torch.einsum(eq, a, w)` for an `eq` that contracts a's last dim
    with w's first ("bsd,dhe->bshe"); with `ranks`, `Ranks.mm`."""
    return torch.einsum(eq, a, w) if ranks is None else ranks.mm(a, w)


def block(ranks: Ranks | None, t, layout, dims: dict):
    """t (whole rows) -> its block in `layout`, the placements of a state
    whose dim d is t's dim dims[d] (a state dim t lacks is whole in t, and
    read whole by each rank's block over the mesh dims that split that
    dim: `shared`).  Without `ranks` (plain tensors), t."""
    if ranks is None:
        return t
    from torch.distributed.tensor import Replicate
    unsplit = [Replicate() if p.is_shard() and p.dim in dims else p for p in layout]
    return ranks.relayout(ranks.shared(t, unsplit), _translate(ranks.rows, dims),
                          _translate(layout, dims))


def shared(ranks: Ranks | None, t, layout):
    return t if ranks is None else ranks.shared(t, layout)


def gather(ranks: Ranks | None, t, layout, dims: dict):
    """The inverse of `block`: a block in `layout` -> whole rows."""
    if ranks is None:
        return t
    return ranks.relayout(t, _translate(layout, dims), _translate(ranks.rows, dims))


def _translate(placements, dims: dict) -> list:
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in placements]
