"""Partition rules: params / batches / caches -> partition-spec trees.

The port of `repro.parallel.sharding`, rule for rule.  Axes: ('pod',)
'data', 'model'.  Policy:

* TP over 'model': attention heads, FFN hidden, vocab, SSM inner channels,
  MoE experts (EP; the layout `models.moe.moe_ep` slices).
* FSDP over 'data' for large archs: the largest remaining dim of each big
  2+-D leaf is sharded over 'data'.
* DP over ('pod', 'data') for the batch; 'pod' composes with 'data' so the
  cross-pod hop is only the gradient all-reduce.

Rules match on the param path (the "/"-joined dict keys) and the leaf's
rank, so they survive nesting (stacked segments add a leading layer axis).
A tree is the port's nested dict of tensors (the reference's keys and
stacked layout); only shapes are read, so meta-device tensors
(`LM(cfg, device="meta").init(None)`, `configs.shapes.input_specs`) do.
A mesh is anything with a `shape` dict (`launch.mesh.Mesh` or
`AbstractMesh`).  A spec is a `P`, a tuple subclass: one entry a tensor
dim, None or an axis name or a tuple of names, comparing equal to JAX's
`PartitionSpec` as tuples.  `to_named` turns specs into DTensor placements,
one a mesh dim.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.config import ModelConfig
from ..optim.adamw import tree_from_paths, tree_paths


class P(tuple):
    """A partition spec: P(None, "model") is ("model" on dim 1).  An entry
    given as a sequence of axes is a tuple, and is canonicalised as JAX's
    `PartitionSpec` does: no axes is None, one axis is its name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _entry(e):
    if isinstance(e, (tuple, list)):
        return None if not e else e[0] if len(e) == 1 else tuple(e)
    return e


@dataclass(frozen=True)
class ShardingPolicy:
    """Two families:

    * TP policy (tp=True): Megatron-style -- heads / ffn / vocab over
      'model', batch over ('pod', 'data'), optional FSDP over 'data'.
      Best for decode (params and cache sharded at tiny per-step compute).
    * FSDP-pure policy (tp=False, fsdp=True): ZeRO-3 -- batch over
      ('data', 'model') [+ 'pod' as an extra param shard], every large
      param dim sharded over the widest divisible axis combination.
    """
    tp: bool = True
    fsdp: bool = False
    dp_axes: tuple = ("pod", "data")           # batch-sharding axes
    fsdp_axes: tuple = ("data",)               # param-sharding axes (widest first)
    model_axis: str = "model"


# the train / prefill policy: batch greedily over every axis, spilling to
# the sequence; params sharded over the widest divisible combination
FSDP_PURE = ShardingPolicy(
    tp=False, fsdp=True,
    dp_axes=("pod", "data", "model"),
    fsdp_axes=("pod", "data", "model"),
)


def dp(mesh, policy: ShardingPolicy) -> tuple:
    return tuple(a for a in policy.dp_axes if a in mesh.shape)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _divisible(shape, axis, n) -> bool:
    return n > 0 and shape[axis] % n == 0 and shape[axis] >= n


def _prod(mesh, axes) -> int:
    return int(np.prod([mesh.shape.get(a, 1) for a in axes])) if axes else 1


# name fragment -> the axis, counted from the right, to shard over 'model'
# (stacking prepends dims, so counting from the right is stable); None: keep
_MODEL_AXIS_RULES = [
    ("attn/wq_b", -2), ("attn/wkv_b", -2),          # MLA head dims
    ("attn/wq_a", None), ("attn/wkv_a", None),
    ("attn/q_a_norm", None), ("attn/kv_a_norm", None),
    ("attn/wq", -2), ("attn/wk", -2), ("attn/wv", -2), ("attn/wo", -3),
    ("attn/bq", -2), ("attn/bk", -2), ("attn/bv", -2),
    ("attn/q_norm", None), ("attn/k_norm", None),
    ("xattn/wq", -2), ("xattn/wk", -2), ("xattn/wv", -2), ("xattn/wo", -3),
    ("xattn/bq", -2), ("xattn/bk", -2), ("xattn/bv", -2),
    ("moe/router", None), ("moe/router_bias", None),
    ("moe/w_gate", -3), ("moe/w_up", -3), ("moe/w_down", -3),  # expert axis (EP)
    ("shared/w_gate", -1), ("shared/w_up", -1), ("shared/w_down", -2),
    ("ffn/w_gate", -1), ("ffn/w_up", -1), ("ffn/w_down", -2),
    ("ffn/b_up", -1), ("ffn/b_down", None),
    ("ssm/in_proj", -1), ("ssm/conv_w", -1), ("ssm/conv_b", -1),
    ("ssm/x_proj", -2), ("ssm/dt_proj", -1), ("ssm/dt_bias", -1),
    ("ssm/A_log", None), ("ssm/D", None), ("ssm/norm", -1),
    ("ssm/out_proj", -2),
    ("mtp/proj", -1),
    ("embed", -2), ("lm_head", -1),
]
# The SSM's per-channel leaves (A_log (di, n) / (heads,), D, dt_bias) follow
# in_proj's channel split: `param_specs` shards their channel dim (-2 for a
# 2+-D A_log, -1 otherwise) whenever it divides.


def _expert_axes(cfg: ModelConfig, mesh):
    if cfg.moe is None or cfg.moe.ep_axis is None:
        return None
    axes = tuple(a for a in cfg.moe.ep_axes if a in mesh.shape)
    return axes or None


def _one(combo):
    return combo if len(combo) > 1 else combo[0]


def param_specs(cfg: ModelConfig, abstract_params, mesh, policy: ShardingPolicy):
    """A spec tree matching the params tree."""
    n_model = mesh.shape.get(policy.model_axis, 1)
    ep_axes = _expert_axes(cfg, mesh)
    n_ep = _prod(mesh, ep_axes)

    # fsdp axis combinations, widest first: ('pod', 'data', 'model') ->
    # also ('data', 'model'), ('model',)
    fsdp_avail = tuple(a for a in policy.fsdp_axes if a in mesh.shape)
    fsdp_combos = []
    for k in range(len(fsdp_avail), 0, -1):
        if fsdp_avail[-k:] not in fsdp_combos:
            fsdp_combos.append(fsdp_avail[-k:])

    def spec_for(path, leaf):
        name = _path_str(path)
        shape = tuple(leaf.shape)
        rank = len(shape)
        spec = [None] * rank

        # MoE expert leaves: always EP-shard the expert axis (whatever the
        # tp flag), the layout moe_ep slices
        is_expert = any(f"moe/{w}" in name for w in ("w_gate", "w_up", "w_down"))
        if is_expert and ep_axes and _divisible(shape, -3, n_ep):
            spec[rank - 3] = _one(ep_axes)

        # Embedding / LM head: shard only the vocab dim (over the widest
        # dividing combination); a shard of their d_model dim would turn
        # the logits product into a (tokens x vocab) reduction
        if name.endswith("embed") or name.endswith("lm_head"):
            v_ax = -2 if name.endswith("embed") else -1
            if policy.tp:
                combos_v = [(policy.model_axis,)] + fsdp_combos
            else:
                combos_v = fsdp_combos + [(policy.model_axis,)]
            for combo in combos_v:
                if _divisible(shape, v_ax, _prod(mesh, combo)):
                    spec[rank + v_ax] = _one(combo)
                    break
            return P(*spec)

        if policy.tp and n_model > 1 and not is_expert:
            hit = None
            for frag, ax in _MODEL_AXIS_RULES:
                if frag in name:
                    hit = ax
                    break
            if name.endswith("ssm/A_log") or name.endswith("ssm/D") or "ssm/dt_bias" in name:
                hit = -2 if (name.endswith("A_log") and rank >= 2) else -1
            if hit is not None and _divisible(shape, hit, n_model):
                spec[rank + hit] = policy.model_axis

        if policy.fsdp and rank >= 2 and int(np.prod(shape)) >= 1 << 16:
            # the largest remaining dim over the widest divisible combination
            for combo in fsdp_combos:
                taken = {a for s in spec if s for a in (s if isinstance(s, tuple) else (s,))}
                if any(a in taken for a in combo):
                    continue
                n_c = _prod(mesh, combo)
                cands = [i for i in range(rank)
                         if spec[i] is None and shape[i] % n_c == 0 and shape[i] >= n_c]
                if cands:
                    spec[max(cands, key=lambda i: shape[i])] = _one(combo)
                    break
        return P(*spec)

    return tree_from_paths([(p, spec_for(p, t)) for p, t in tree_paths(abstract_params)])


def _split_batch_seq(b_size: int, s_size: int, axes: tuple, mesh):
    """Greedy (batch axes, seq axes) split: the longest prefix of `axes`
    whose product divides the batch shards the batch; the remaining axes
    shard the sequence if their product divides it."""
    for k in range(len(axes), -1, -1):
        ax_b = axes[:k]
        if b_size % _prod(mesh, ax_b) == 0:
            rest = axes[k:]
            ax_s = rest if (rest and s_size % _prod(mesh, rest) == 0) else ()
            return (ax_b or None), (ax_s or None)
    return None, None


def batch_specs(cfg: ModelConfig, batch, mesh, policy: ShardingPolicy):
    """A spec tree for a train / prefill / decode batch dict."""
    dpa = dp(mesh, policy)
    n_model = mesh.shape.get(policy.model_axis, 1)
    n_dp = _prod(mesh, dpa)

    def spec_for(path, leaf):
        name = _path_str(path)
        shape = tuple(leaf.shape)
        if "caches" in name:
            return _cache_spec(name, shape, dpa, n_model, n_dp, policy)
        if name.endswith("positions") and len(shape) == 3:  # (3, B, S) M-RoPE
            ax_b, ax_s = _split_batch_seq(shape[1], shape[2], dpa, mesh)
            return P(None, ax_b, ax_s)
        if (name.endswith("tokens") or "embeds" in name or "encoder_out" in name) \
                and len(shape) >= 2:
            ax_b, ax_s = _split_batch_seq(shape[0], shape[1], dpa, mesh)
            return P(ax_b, ax_s, *([None] * (len(shape) - 2)))
        if name.endswith("tokens") or name.endswith("pos"):
            ax_b, _ = _split_batch_seq(shape[0], 1, dpa, mesh)
            return P(ax_b, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return tree_from_paths([(p, spec_for(p, t)) for p, t in tree_paths(batch)])


def _cache_spec(name, shape, dpa, n_model, n_dp, policy: ShardingPolicy) -> P:
    """Decode-cache leaves, layer-stacked (leading dim = layer).

    kv cache  (L, B, S, K, hd): B -> dp if divisible; K -> model if
              divisible, else S -> model (sequence-sharded decode).
    mla cache (L, B, S, lora):  B -> dp, S -> model.
    ssm state (L, B, ...channels): B -> dp, biggest channel dim -> model.
    """
    rank = len(shape)
    spec = [None] * rank
    m = policy.model_axis
    if rank >= 2 and dpa and shape[1] % max(n_dp, 1) == 0:
        spec[1] = dpa
    batch_unsharded = spec[1] is None
    if rank == 5:  # (L, B, S, K, hd)
        if shape[3] % n_model == 0 and n_model > 1:
            spec[3] = m
        elif shape[2] % n_model == 0:
            spec[2] = m
        if batch_unsharded and dpa and spec[2] is None and shape[2] % max(n_dp, 1) == 0:
            spec[2] = dpa  # long-context batch 1: shard the sequence over data too
    elif rank == 4 and ("c_kv" in name or "k_rope" in name):
        if shape[2] % n_model == 0 and n_model > 1:
            spec[2] = m
    elif rank >= 3:  # ssm states / conv tails: shard the biggest trailing dim
        cands = [i for i in range(2, rank) if shape[i] % n_model == 0 and shape[i] >= n_model]
        if cands and n_model > 1:
            spec[max(cands, key=lambda i: shape[i])] = m
    return P(*spec)


def to_named(tree_specs, mesh):
    """Each spec -> its DTensor placements, one a mesh dim: `Shard(d)` on a
    mesh dim that shards tensor dim d, `Replicate()` elsewhere (what
    `torch.distributed.tensor.distribute_tensor` takes with the mesh's
    `device_mesh`).  A dim sharded over several axes is split over them in
    mesh order, JAX's row-major block order; an axis tuple out of mesh order
    raises (no rule makes one)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.shape)

    def placements(spec):
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"spec {spec}: axes {axes} are not in the mesh order {names}")
            for i in pos:
                out[i] = Shard(d)
        return tuple(out)

    return tree_from_paths([(p, placements(s)) for p, s in tree_paths(tree_specs)])


def activation_spec(mesh, policy: ShardingPolicy) -> P:
    """(B, S, D) activations: batch over dp, the rest replicated."""
    return P(dp(mesh, policy), None, None)
