"""Mixture-of-Experts: the router, the shared experts and two execution paths.

The port of `repro.models.moe`.

* `moe_dense`: every expert on every token, combined by the gates; taken
  without a mesh, on a one-rank EP mesh or when the experts do not divide
  over it, and the numerical oracle for the EP path.
* `moe_ep`: expert parallelism over the EP axes' process group.  Tokens
  are routed on the rank that holds them, sent to their experts' owners by
  an `all_to_all` (`_moe_ep_local`: the reference's drop rules, a slot past
  `cap` in the send buffer and a row past `cap2` in an expert's window),
  run through a capacity-bounded grouped FFN (`_local_grouped_ffn`, the
  local experts in an unrolled loop) and sent back by a second
  `all_to_all`.  Decode (S == 1): each rank runs its local experts on all
  of its tokens and an all-reduce over the EP group combines them
  (`_moe_decode_local`).

SPMD on `torch.distributed`, where the reference runs a `shard_map`: every
rank holds the whole (replicated) x and params, as an unsharded model does;
`moe_ep` slices its rank's block of x and its experts, runs the shard body
and returns the whole (B, S, D) on every rank.  Its gradients with respect
to x and every param are the global ones on every rank (what `jax.grad`
gives the reference), decided by four autograd functions:

* `_EnterShard` (x, the router, its bias and the three expert weights, as
  the shard body reads them): forward the identity; backward an
  `all_reduce` (sum) over the whole mesh.  A rank's gradient for the
  experts it does not own, for the router and for the other ranks' blocks
  of x is partial (or zero) until it is summed over the ranks;
* `_Exchange` (the token and result exchanges): forward `all_to_all_single`;
  backward the same exchange of the cotangent;
* `_PSum` (decode's combine): forward and backward an `all_reduce` over
  the EP group, as `jax.lax.psum` transposes;
* `_GatherBlocks` (the output): forward `all_gather_into_tensor` of the
  blocks over the group of the axes that shard x; backward no collective:
  every rank's loss is the same, so its cotangent is too, and the rank
  keeps its block's, divided by the number of ranks holding that block (a
  differentiable all_gather would sum the replicated cotangents, `world`
  times too large).

The routing ids and the drop flags need no gradient and travel by plain
`all_to_all`.  `record_drops()` collects each `moe_ep` call's kept
assignments.  Without a process group (a one-rank mesh) every collective
is the identity.

Casts follow the reference: the router and its logits are f32 in any
model dtype; an expert's gate and up projections are activated in f32 and
their product goes back to the input's dtype before the down projection;
the combine weights take the experts' outputs' dtype.  The shared experts
are one SwiGLU of width n_shared * d_expert_ff (the sum of parallel
SwiGLUs is one wider SwiGLU).

Top-k: `jax.lax.top_k` returns the k largest in descending order, the
lower index first on a tie; `torch.topk` promises no order among ties.
The port takes a stable descending sort cut to k, which is that order.
`_group_pack`'s stable argsort is `torch.sort(stable=True)`.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import layers
from .config import ModelConfig, MoEConfig
from .ffn import ffn, init_ffn
from ..parallel.collectives import _all_gather, _all_to_all

# While `record_routes()` is active: one (selection scores (N, E) f32, ids
# (N, k) int32) pair per `route` call, in call order.
_ROUTES: list | None = None


@contextlib.contextmanager
def record_routes():
    """Collect every `route` call's selection scores and expert ids while
    active (a list, filled in call order): how the smoke checks count the
    routing decisions that differ between two paths."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


# While `record_drops()` is active: one (B, S, k) bool tensor per `moe_ep`
# call, in call order -- True where an assignment was kept, False where a
# capacity limit dropped it.
_DROPS: list | None = None


@contextlib.contextmanager
def record_drops():
    """Collect, for every `moe_ep` call while active, which of its (token,
    choice) assignments were kept (the whole batch's, on every rank; an
    extra exchange of int8 flags, made only while recording)."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


# --- params -------------------------------------------------------------------

def init_moe(generator, cfg: ModelConfig, dtype, device=None) -> dict:
    m: MoEConfig = cfg.moe
    d = cfg.d_model
    init = lambda shape, dt=dtype: layers.normal_init(generator, shape, dtype=dt,  # noqa: E731
                                                      device=device)
    p = {
        "router": init((d, m.n_routed), torch.float32),
        "router_bias": torch.zeros((m.n_routed,), dtype=torch.float32, device=device),
        "w_gate": init((m.n_routed, d, m.d_expert_ff)),
        "w_up": init((m.n_routed, d, m.d_expert_ff)),
        "w_down": init((m.n_routed, m.d_expert_ff, d)),
    }
    if m.n_shared:
        p["shared"] = init_ffn(generator, d, m.n_shared * m.d_expert_ff, "swiglu", dtype, device)
    return p


# --- routing ------------------------------------------------------------------

def route(params, x_flat, m: MoEConfig):
    """x_flat (N, D) -> (gates (N, k) f32, expert ids (N, k) int32).  Softmax
    or sigmoid scores; `router_bias` (deepseek-v3's balance bias) takes part
    in the selection only; the selected scores are renormalised and scaled
    by `route_scale`."""
    logits = (x_flat.to(torch.float32) @ params["router"]).to(torch.float32)
    if m.score == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + params["router_bias"]
    else:
        scores = torch.softmax(logits, dim=-1)
        sel = scores
    ids = torch.sort(sel, dim=-1, descending=True, stable=True).indices[:, : m.top_k]
    gates = torch.take_along_dim(scores, ids, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9) * m.route_scale
    ids = ids.to(torch.int32)
    if _ROUTES is not None:
        _ROUTES.append((sel.detach(), ids))
    return gates, ids


def _expert_ffn(w_gate, w_up, w_down, x):
    """SwiGLU of one expert, or of every expert at once when the weights
    carry a leading expert axis (x (N, D) -> (E, N, D))."""
    g = F.silu((x @ w_gate).to(torch.float32))
    u = (x @ w_up).to(torch.float32)
    return (g * u).to(x.dtype) @ w_down


# --- dense path -----------------------------------------------------------------

def moe_dense(params, x, cfg: ModelConfig):
    """Every routed expert on every token, combined by the gates; plus the
    shared experts (where `params` holds them).  x (B, S, D) -> (B, S, D)."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gates, ids = route(params, xf, m)
    outs = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xf)   # (E, N, D)
    onehot = F.one_hot(ids.to(torch.int64), m.n_routed).to(torch.float32)       # (N, k, E)
    combine = torch.einsum("nk,nke->ne", gates, onehot)                          # (N, E)
    y = torch.einsum("ne,end->nd", combine.to(outs.dtype), outs).reshape(b, s, d)
    if m.n_shared and "shared" in params:
        y = y + ffn(params["shared"], x, "swiglu")
    return y


# --- EP path --------------------------------------------------------------------
#
# SPMD on torch.distributed: every rank holds the whole x and all params and
# runs the reference's shard body on its own block; the autograd functions
# below decide what each backward sends.

def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _EnterShard(torch.autograd.Function):
    """Identity forward; the backward all-reduces (sums) the gradient over
    the whole mesh, so every rank holds the global gradient of what the
    shard body read from this tensor."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _Exchange(torch.autograd.Function):
    """`all_to_all_single` of (n, ...) rows; its transpose is the same
    exchange, so the backward is one more all_to_all."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group), None


class _PSum(torch.autograd.Function):
    """All-reduce (sum) forward; all-reduce of the cotangent backward (the
    transpose of `jax.lax.psum`)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _GatherBlocks(torch.autograd.Function):
    """Every rank's (b, s, d) block over the x-sharding group -> the whole
    (n_b * b, n_s * s, d), block (i, j) from group rank i * n_s + j.  The
    cotangent of the whole output is the same on every rank (each computes
    the same loss), so the backward sends nothing: it takes this rank's
    block, divided by the number of ranks holding that block (as JAX
    divides a replicated output's cotangent)."""

    @staticmethod
    def forward(ctx, blk, group, n_b, n_s, bi, si, n_rep):
        ctx.pos, ctx.n_rep = (bi, si, blk.shape[0], blk.shape[1]), n_rep
        b, s, d = blk.shape
        whole = _all_gather(blk, group).reshape(n_b, n_s, b, s, d)
        return whole.permute(0, 2, 1, 3, 4).reshape(n_b * b, n_s * s, d)

    @staticmethod
    def backward(ctx, g):
        bi, si, b, s = ctx.pos
        mine = g[bi * b:(bi + 1) * b, si * s:(si + 1) * s]
        if ctx.n_rep != 1:
            mine = mine / ctx.n_rep
        return mine, None, None, None, None, None, None


def _bincount(key, n: int):
    """How many of `key` (int64, in [0, n)) equal each of 0..n-1: a scatter
    with no host read (`torch.bincount` reads the largest key back)."""
    return torch.zeros(n, dtype=torch.int64, device=key.device).scatter_add_(
        0, key, torch.ones_like(key))


def _group_pack(sort_key, n_groups: int, capacity: int):
    """Integer group keys (A,) -> a stable grouped layout: (order (A,),
    group (A,) sorted keys, slot (A,) rank within its group, counts
    (n_groups,)).  Entries with slot >= capacity are the caller's to drop."""
    a = sort_key.shape[0]
    order = torch.sort(sort_key, stable=True).indices
    sorted_key = sort_key[order]
    counts = _bincount(sort_key, n_groups)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(a, device=sort_key.device) - starts[sorted_key]
    return order, sorted_key, slot, counts


def _local_grouped_ffn(params_local, x_sorted, e_sorted, n_local: int, capacity: int):
    """The local experts in turn, each on a capacity window of the sorted
    rows.  x_sorted (M, D) sorted by e_sorted (M,) in [0, n_local] (n_local
    the invalid sentinel, sorted last) -> y (M, D) aligned with x_sorted;
    rows past an expert's capacity window get nothing (dropped).  The buffer
    carries `capacity` rows of zero padding, so a window starting near the
    end needs no clamp (a clamp would shift it off its keep mask)."""
    m_tot, d = x_sorted.shape
    counts = _bincount(e_sorted, n_local + 1)[:n_local]
    starts = torch.cumsum(counts, 0) - counts
    x_pad = torch.cat([x_sorted, x_sorted.new_zeros((capacity, d))])
    win = torch.arange(capacity, device=x_sorted.device)
    # the expert loop unrolled, as the reference unrolls it
    idxs, outs = [], []
    for le in range(n_local):
        idx = starts[le] + win
        out = _expert_ffn(params_local["w_gate"][le], params_local["w_up"][le],
                          params_local["w_down"][le], x_pad[idx])
        idxs.append(idx)
        outs.append(torch.where((win < counts[le])[:, None], out, 0))
    # the reference adds each window into y in turn (prev + out); a row takes
    # one nonzero term (its expert's) and zeros from the windows that overlap
    # it, so one accumulation of every window is the same sum
    y = x_sorted.new_zeros((m_tot + capacity, d)).index_add(0, torch.cat(idxs), torch.cat(outs))
    return y[:m_tot]


def _moe_ep_local(params, x, m: MoEConfig, n_model: int, capacity_factor: float, group):
    """One rank's shard body: x (b_loc, s_loc, d) -> (y (b_loc, s_loc, d),
    kept (b_loc, s_loc, k) bool: the assignments that were not dropped).
    `group` is the EP group (n_model ranks, one or several mesh axes)."""
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    gates, ids = route(params, xf, m)                           # (n, k)
    k = m.top_k
    e_loc_count = m.n_routed // n_model

    a = n * k
    e_flat = ids.reshape(-1).to(torch.int64)
    tok_idx = torch.arange(n, device=x.device).repeat_interleave(k)
    owner = e_flat // e_loc_count                               # destination rank

    cap = int(math.ceil(a / n_model * capacity_factor))
    order, sorted_owner, slot, _ = _group_pack(owner, n_model, cap)
    valid = slot < cap

    # (n_model, cap) send buffers; slot >= cap drops (into a spare column,
    # cut off: no host read of how many drop)
    dst = (sorted_owner, torch.where(valid, slot, cap))
    send_x = xf.new_zeros((n_model, cap + 1, d)).index_put(dst, xf[tok_idx[order]])[:, :cap]
    send_e = torch.full((n_model, cap + 1), e_loc_count, dtype=torch.int64, device=x.device)
    send_e = send_e.index_put(dst, e_flat[order] % e_loc_count)[:, :cap].contiguous()

    # exchange: row j of recv is what rank j sent to me
    recv_x = _Exchange.apply(send_x, group)
    recv_e = _all_to_all(send_e, group)

    mt = n_model * cap
    rx = recv_x.reshape(mt, d)
    re = recv_e.reshape(mt)
    cap2 = min(int(math.ceil(mt / max(e_loc_count, 1) * capacity_factor)), mt)
    order2, sorted_e, slot2, _ = _group_pack(re, e_loc_count + 1, mt)
    y_sorted = _local_grouped_ffn(params, rx[order2], sorted_e, e_loc_count, cap2)
    # unsort back to the received layout, and send every row home
    y_flat = rx.new_zeros(rx.shape).index_copy(0, order2, y_sorted)
    y_back = _Exchange.apply(y_flat.reshape(n_model, cap, d), group)

    # each assignment's result, combined with its gate
    at = (sorted_owner, torch.clamp(slot, max=cap - 1))
    res = torch.where(valid[:, None], y_back[at], 0)
    y_assign = xf.new_zeros((a, d)).index_copy(0, order, res)
    y_tok = (y_assign.reshape(n, k, d) * gates[..., None].to(x.dtype)).sum(dim=1)

    kept = None
    if _DROPS is not None:                  # the expert windows' keep flags, sent home
        kept2 = (sorted_e < e_loc_count) & (slot2 < cap2)
        flags = torch.zeros(mt, dtype=torch.int8, device=x.device).index_copy(
            0, order2, kept2.to(torch.int8))
        back = _all_to_all(flags.reshape(n_model, cap), group)
        kept_sorted = valid & (back[at] != 0)
        kept = torch.zeros(a, dtype=torch.bool, device=x.device).index_copy(
            0, order, kept_sorted).reshape(b, s, k)
    return y_tok.reshape(b, s, d), kept


def _moe_decode_local(params, x, m: MoEConfig, n_model: int, ep_index: int, group):
    """Decode shard body: all local experts on all (few) tokens, then an
    all-reduce over the EP group."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gates, ids = route(params, xf, m)       # routing is the same on every rank of a block
    e_loc_count = m.n_routed // n_model
    lo = ep_index * e_loc_count
    outs = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xf)  # (E_loc, N, D)
    local = torch.arange(e_loc_count, device=x.device)
    onehot = ((ids.to(torch.int64) - lo)[..., None] == local).to(torch.float32)  # (N, k, E_loc)
    combine = torch.einsum("nk,nke->ne", gates, onehot)
    y = torch.einsum("ne,end->nd", combine.to(outs.dtype), outs)
    return _PSum.apply(y, group).reshape(b, s, d)


def moe_ep(params, x, cfg: ModelConfig, mesh, dp_axes=("pod", "data"),
           capacity_factor: float = 1.3, experts=None):
    """Expert-parallel MoE. x (B, S, D) -> (B, S, D), the whole of both on
    every rank.

    The EP group spans `cfg.moe.ep_axes` present in the mesh (deepseek-v3:
    ('data', 'model'), one expert a rank at 256).  This rank takes its block
    of x -- batch over the dp axes other than 'model', sequence over
    'model' after padding it to a multiple of the 'model' size (decode,
    S == 1: the whole sequence) -- and its experts, the `n_routed / n_ep`
    at its EP index; runs the shard body; and gathers every block.
    `experts` ({"w_gate", "w_up", "w_down"}: this rank's own `n_routed /
    n_ep`, each a complete gradient's leaf) replaces the slice of the whole
    ones, and the shared experts are then left to the caller
    (`_moe_layer_dtensor`)."""
    m = cfg.moe
    ep_axes = mesh.ordered(a for a in m.ep_axes if a in mesh.shape)
    n_ep = 1
    for a in ep_axes:
        n_ep *= mesh.shape[a]
    batch_ax = mesh.ordered(a for a in dp_axes if a in mesh.shape and a != "model")
    n_seq = mesh.shape.get("model", 1)
    decode = x.shape[1] == 1
    x_axes = batch_ax + (() if decode or "model" not in mesh.shape else ("model",))
    n_b = 1
    for a in batch_ax:
        n_b *= mesh.shape[a]
    n_s = 1 if decode else n_seq
    coord = mesh.coordinate()
    bi = mesh.index(batch_ax)
    si = 0 if decode else coord.get("model", 0)
    whole = mesh.group(mesh.axis_names)

    e_loc = m.n_routed // n_ep
    lo = mesh.index(ep_axes) * e_loc
    weights = ("w_gate", "w_up", "w_down")
    routed = {key: _EnterShard.apply(params[key], whole)
              for key in ("router", "router_bias") + (weights if experts is None else ())}
    if experts is None:
        experts = {key: routed[key][lo:lo + e_loc] for key in weights}
    local = {**routed, **experts}

    s = x.shape[1]
    pad = 0 if decode else (-s) % n_seq
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    xe = _EnterShard.apply(xp, whole)
    bl, sl = xp.shape[0] // n_b, xp.shape[1] // n_s
    blk = xe[bi * bl:(bi + 1) * bl, si * sl:(si + 1) * sl]
    if decode:
        y_blk, kept = _moe_decode_local(local, blk, m, n_ep, mesh.index(ep_axes),
                                        mesh.group(ep_axes)), None
    else:
        y_blk, kept = _moe_ep_local(local, blk, m, n_ep, capacity_factor, mesh.group(ep_axes))
    group_x = mesh.group(x_axes)
    n_rep = mesh.size // (n_b * n_s)
    y = _GatherBlocks.apply(y_blk, group_x, n_b, n_s, bi, si, n_rep)[:, :s]
    if _DROPS is not None:
        if kept is None:
            kept = torch.ones(tuple(blk.shape[:2]) + (m.top_k,), dtype=torch.bool,
                              device=x.device)
        flags = _all_gather(kept.to(torch.int8), group_x).reshape(
            n_b, n_s, bl, sl, m.top_k).permute(0, 2, 1, 3, 4).reshape(n_b * bl, n_s * sl, m.top_k)
        _DROPS.append(flags[:, :s] != 0)

    if m.n_shared and "shared" in params:
        y = y + ffn(params["shared"], x, "swiglu")
    return y


def _moe_layer_dtensor(params, x, cfg: ModelConfig, mesh, n_ep: int):
    """`moe_layer` of DTensor params and x (a placed step of
    `launch.steps`): the routed experts run on plain tensors, as `moe_ep`
    (each rank's own experts, gathered only over the axes that do not
    split them) or `moe_dense` (whole), and their output is laid out as x
    is (summed where x is a partial sum); the shared experts stay
    DTensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    m, dm = cfg.moe, x.device_mesh
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t  # noqa: E731
    plain = {k: whole(v) for k, v in params.items() if k in ("router", "router_bias")}
    weights = ("w_gate", "w_up", "w_down")
    if n_ep > 1:
        ep = [a in m.ep_axes for a in mesh.axis_names]
        experts = {}
        for k in weights:
            w = params[k]
            if not isinstance(w, DTensor):
                experts[k] = w
                continue
            pl = [Shard(w.ndim - 3) if on else Replicate() for on in ep]
            # a rank's expert gradient covers the tokens of its own block of
            # the axes that do not split the experts: a partial sum there
            experts[k] = w.redistribute(dm, pl).to_local(
                grad_placements=[p if on else Partial() for p, on in zip(pl, ep)])
        y = moe_ep(plain, whole(x), cfg, mesh, experts=experts)
    else:
        y = moe_dense({**plain, **{k: whole(params[k]) for k in weights}}, whole(x), cfg)
    y = DTensor.from_local(y, dm, [Replicate()] * dm.ndim, run_check=False)
    y = y.redistribute(dm, [Replicate() if p.is_partial() else p for p in x.placements])
    if m.n_shared:
        y = y + ffn(params["shared"], x, "swiglu")
    return y


def moe_layer(params, x, cfg: ModelConfig, mesh=None):
    """Entry point: the dense path without a mesh, on a one-rank EP mesh or
    when the experts do not divide over it; `moe_ep` otherwise.  `mesh`
    maps axis names to sizes in its `shape`, as a JAX mesh does
    (`launch.mesh.Mesh`)."""
    m = cfg.moe
    if m.ep_axis is None or mesh is None:
        return moe_dense(params, x, cfg)
    n_ep = 1
    for a in m.ep_axes:
        n_ep *= dict(mesh.shape).get(a, 1)
    if n_ep == 1 or m.n_routed % n_ep != 0:
        n_ep = 1
    if getattr(x, "device_mesh", None) is not None:
        return _moe_layer_dtensor(params, x, cfg, mesh, n_ep)
    if n_ep == 1:
        return moe_dense(params, x, cfg)
    return moe_ep(params, x, cfg, mesh)
