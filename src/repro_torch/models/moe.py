"""Mixture-of-Experts: the router, the shared experts and the dense path.

The port of `repro.models.moe`.  `moe_dense` runs every expert on every
token and combines them by their gates; `moe_layer` takes it, as the
reference does without a mesh or on a one-device mesh.  The expert-parallel
path (`moe_ep` and its shard bodies: `_moe_ep_local`, `_moe_decode_local`,
`_group_pack`, `_local_grouped_ffn`) runs only inside a `shard_map` over an
EP axis and is not ported yet (ROADMAP Queue 1 item 2.5, `parallel/`).

Casts follow the reference: the router and its logits are f32 in any
model dtype; an expert's gate and up projections are activated in f32 and
their product goes back to the input's dtype before the down projection;
the combine weights take the experts' outputs' dtype.  The shared experts
are one SwiGLU of width n_shared * d_expert_ff (the sum of parallel
SwiGLUs is one wider SwiGLU).

Top-k: `jax.lax.top_k` returns the k largest in descending order, the
lower index first on a tie; `torch.topk` promises no order among ties.
The port takes a stable descending sort cut to k, which is that order.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import layers
from .config import ModelConfig, MoEConfig
from .ffn import ffn, init_ffn

EP_ITEM = "ROADMAP Queue 1 item 2.5 (parallel/)"

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
    shared experts.  x (B, S, D) -> (B, S, D)."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gates, ids = route(params, xf, m)
    outs = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xf)   # (E, N, D)
    onehot = F.one_hot(ids.to(torch.int64), m.n_routed).to(torch.float32)       # (N, k, E)
    combine = torch.einsum("nk,nke->ne", gates, onehot)                          # (N, E)
    y = torch.einsum("ne,end->nd", combine.to(outs.dtype), outs).reshape(b, s, d)
    if m.n_shared:
        y = y + ffn(params["shared"], x, "swiglu")
    return y


def moe_ep(params, x, cfg: ModelConfig, mesh):
    """Expert-parallel MoE (all_to_all dispatch over the EP axes): not
    ported yet."""
    raise NotImplementedError(f"expert-parallel MoE (moe_ep): {EP_ITEM}")


def moe_layer(params, x, cfg: ModelConfig, mesh=None):
    """Entry point: the dense path without a mesh, on a one-device EP mesh or
    when the experts do not divide over it; `moe_ep` otherwise.  `mesh`
    maps axis names to sizes in its `shape`, as a JAX mesh does."""
    m = cfg.moe
    if m.ep_axis is None or mesh is None:
        return moe_dense(params, x, cfg)
    n_ep = 1
    for a in m.ep_axes:
        n_ep *= dict(mesh.shape).get(a, 1)
    if n_ep == 1 or m.n_routed % n_ep != 0:
        return moe_dense(params, x, cfg)
    return moe_ep(params, x, cfg, mesh)
