"""Shared LM layers: norms, embeddings (with BUM-merged grads), RoPE variants.

The port of `repro.models.layers`.  The embedding's `dedup_grad` option is
the paper's technique carried over to LMs: a vocab table's backward is a
scatter-add with heavy index duplication (every repeated token), the access
pattern the BUM merges, so it can go through
`kernels.grid_update.ops.merged_scatter_add` -- on a card the `bum_sort` and
`bum_scatter` kernels, on rows of F = d_model.

Casts follow the reference: norms compute in f32 and return the input's
dtype; RoPE's angles are f32 and a bf16 input is rotated in f32 (torch
promotes a bf16 tensor times an f32 tensor to f32, as JAX does).
"""
from __future__ import annotations

import torch

from ..kernels.grid_update import ops as gu_ops
from . import shards

EMBED_MODES = ("naive", "merged", "windowed")


# --- init helpers ------------------------------------------------------------

def normal_init(generator: torch.Generator | None, shape, std=0.02, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """N(0, std^2) draws in f32 from `generator` (on its device), cast to
    `dtype`.  Without a generator, the shape alone: an uninitialised tensor
    on `device` (the meta device, for counting)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return (x * std).to(dtype)


# --- norms -------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             mean_sq=None) -> torch.Tensor:
    """The RMS norm over x's last dim.  Where x holds a block of that dim
    (`scale` the block's), `mean_sq(x32)` gives the whole dim's mean of
    squares from the block's f32 values (`ssm._mamba2_channels`)."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True) if mean_sq is None \
        else mean_sq(x32)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


# --- embedding with optional BUM-merged gradient ------------------------------

@torch.library.custom_op("repro_torch::embed_table_grad", mutates_args=())
def embed_table_grad(ids: torch.Tensor, g: torch.Tensor, vocab: int, mode: str) -> torch.Tensor:
    """The f32 (vocab, D) gradient table of a lookup at ids (...,) whose
    output gradient is g (..., D), committed as `mode` says.  An op of its
    own so that a fake tensor (a dry run's trace) takes its shape from
    `_embed_table_grad_fake` and never reaches a kernel or a ctypes call."""
    flat_ids = ids.reshape(-1).to(torch.int64)
    flat_g = g.reshape(-1, g.shape[-1]).to(torch.float32)
    zero = torch.zeros((vocab, g.shape[-1]), dtype=torch.float32, device=g.device)
    if mode == "merged":
        return gu_ops.merged_scatter_add(zero, flat_ids, flat_g)
    if mode == "windowed":
        return gu_ops.windowed_scatter_add(zero, flat_ids, flat_g)
    return zero.index_add_(0, flat_ids, flat_g)


@embed_table_grad.register_fake
def _embed_table_grad_fake(ids, g, vocab, mode):
    return g.new_empty((vocab, g.shape[-1]), dtype=torch.float32)


def _embed_table_grad_dtensor(ids, g, vocab: int, mode: str, table_placements):
    """The table gradient of DTensor operands: each rank commits its block
    of (ids, g) into a full (vocab, D) table, a partial sum over the mesh
    dims that split the tokens, then laid out as the table is (a
    reduce-scatter or an all-reduce).  A plain `ids` counts as replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = g.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    token_dims = ids.ndim
    g_pl = [p if (isinstance(p, Shard) and p.dim < token_dims) or isinstance(p, Partial)
            else Replicate() for p in g.placements]
    ids_pl = [p if isinstance(p, Shard) else Replicate() for p in g_pl]
    g, ids = g.redistribute(mesh, g_pl), ids.redistribute(mesh, ids_pl)
    out = embed_table_grad(ids.to_local(), g.to_local(), vocab, mode)
    out_pl = [Partial() if isinstance(p, (Shard, Partial)) else Replicate() for p in g_pl]
    gt = DTensor.from_local(out, mesh, out_pl, run_check=False)
    return gt.redistribute(mesh, table_placements)


def _lookup_dtensor(table, ids):
    """table[ids] of a DTensor table, the rows laid out as the ids are (a
    plain `ids` counts as replicated).  Where the mesh dims that split the
    vocab split no ids, the lookup is vocab-parallel: each rank looks its
    ids up in its own rows, zero elsewhere, and the rows are summed over
    those dims (an all-reduce of the looked-up rows).  Otherwise the table
    is gathered whole first, as FSDP gathers a param before its use."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    vocab_dims = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    shape = tuple(ids.shape) + tuple(table.shape[1:])      # the rows' global shape
    if any(isinstance(ids.placements[i], Shard) for i in vocab_dims):
        whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        return shards.from_local(whole[ids.to_local()], mesh, ids.placements, shape)
    rows = table.redistribute(mesh, [p if i in vocab_dims else Replicate()
                                     for i, p in enumerate(table.placements)]).to_local()
    lo, _ = shards.chunk(table.shape[0], mesh, table.placements, 0)     # this rank's first row
    local = ids.to_local().to(torch.int64) - lo
    mine = (local >= 0) & (local < rows.shape[0])
    out = rows[torch.where(mine, local, 0)] * mine[..., None].to(rows.dtype)
    out = shards.from_local(out, mesh, [Partial() if i in vocab_dims else p
                                        for i, p in enumerate(ids.placements)], shape)
    return out.redistribute(mesh, ids.placements)


class _EmbedLookup(torch.autograd.Function):
    """table[ids] whose table gradient is committed as `mode` says: 'naive'
    (`index_add_`, the reference's XLA scatter; float atomics on a card, so
    not reproducible run to run there), 'merged' (the global BUM sort-merge)
    or 'windowed' (the sliding-window merge, 4096 entries a window).  Each
    builds the f32 (V, D) gradient table (`embed_table_grad`) and casts it
    to the table's dtype, as the reference does.  A DTensor table (a placed
    step of `launch.steps`) gets its gradient as a DTensor of its own
    placements."""

    @staticmethod
    def forward(ctx, table, ids, mode):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.dtype, ctx.mode = table.shape[0], table.dtype, mode
        ctx.placements = getattr(table, "placements", None)
        if ctx.placements is not None:
            return _lookup_dtensor(table, ids)
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        if ctx.placements is not None:
            gt = _embed_table_grad_dtensor(ids, g, ctx.vocab, ctx.mode, ctx.placements)
        else:
            gt = embed_table_grad(ids, g, ctx.vocab, ctx.mode)
        return gt.to(ctx.dtype), None, None


def make_embed_lookup(dedup_grad: str | bool = "naive"):
    """lookup(table (V, D), ids (...,)) -> (..., D) whose backward commits
    as `dedup_grad` says: 'naive' / False, 'merged' / True or 'windowed'."""
    if dedup_grad is True:
        dedup_grad = "merged"
    if dedup_grad is False:
        dedup_grad = "naive"
    if dedup_grad not in EMBED_MODES:
        raise ValueError(f"dedup_grad must be one of {EMBED_MODES}, got {dedup_grad!r}")
    return lambda table, ids: _EmbedLookup.apply(table, ids, dedup_grad)


embed_lookup_merged = make_embed_lookup("merged")
embed_lookup_windowed = make_embed_lookup("windowed")
embed_lookup_naive = make_embed_lookup("naive")


# --- RoPE variants -------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd) rotated by the f32 angles ang (..., S, hd/2)."""
    hd = x.shape[-1]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Standard RoPE, the rotated pairs as the two halves (llama convention).
    x (..., S, H, hd); positions broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_rope_2d(x: torch.Tensor, positions: torch.Tensor,
                  theta: float = 10000.0) -> torch.Tensor:
    """ChatGLM-style 2D RoPE: rotary on the first half of head_dim only."""
    hd = x.shape[-1]
    rot, keep = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([apply_rope(rot, positions, theta), keep], dim=-1)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, sections=(16, 24, 24),
                theta: float = 1000000.0) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the hd/2 frequency slots split into (t, h, w)
    sections, each rotated by its own position stream.  x (B, S, H, hd);
    positions_3d (3, B, S); `sections` in half-dim units, summing to hd/2."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} must sum to head_dim/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)
    splits, start = [], 0
    for axis, count in enumerate(sections):
        pos = positions_3d[axis]
        splits.append(pos[..., None].to(torch.float32) * freqs[start: start + count])
        start += count
    return _rotate(x, torch.cat(splits, dim=-1))
