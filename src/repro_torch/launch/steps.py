"""The step functions of the dry run, training and serving.

The port of `repro.launch.steps`.  Each `build_*` returns `(fn,
abstract_args)`: the abstract args are meta-device tensors
(`LM(cfg, device="meta").init(None)`, `AdamW.init` of those, and
`configs.shapes.input_specs`), shapes and dtypes only; `fn` takes concrete
or fake tensors of those shapes.

Where the reference jits with in / out shardings, `fn` places its
arguments as DTensors on the mesh's device mesh, by the partition specs of
`parallel.sharding` under the policy `policy_for` picks (`place`: a DTensor
already laid out so is kept, a plain tensor is split locally, every rank
holding the whole as the port's SPMD convention has it), runs the step on
them under `implicit_replication` (the few plain tensors the model makes,
positions and masks, count as replicated) and returns its outputs laid out
as the reference's out-shardings say; `fn.place(*args)` lays the
arguments out as `fn` does, so a caller can place them once and keep them
(`fn` keeps a DTensor already laid out).  On a mesh without a device mesh (one
rank, no process group) nothing is placed and the step runs on plain
tensors.  The counterpart of `donate_argnums` is an in-place update: the
train step writes the new params and optimizer state into its arguments'
tensors, the decode step the new caches into its batch's.

The model gets the reference's layout constraints: `tp_logits` under a TP
policy, `act_spec` (`_act_spec`, the residual stream's batch split) under
FSDP-pure; and the policy's FSDP axes, over which each block's params are
gathered before it runs (the per-layer param gathers the FSDP-pure
policy trades the activation all-reduces for).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..configs import get_config
from ..configs.shapes import SHAPES, Shape, input_specs
from ..models.config import ModelConfig
from ..models.lm import LM
from ..optim import AdamW, AdamWState, schedule
from ..optim.adamw import clip_by_global_norm, tree_from_paths, tree_paths
from ..parallel import sharding as shd
from ..parallel.sharding import P
from . import train as lm_train

# archs big enough that params+opt must shard over 'data' too (ZeRO/FSDP)
FSDP_ARCHS = {
    "qwen3-8b", "yi-9b", "chatglm3-6b", "deepseek-v2-lite-16b",
    "deepseek-v3-671b", "zamba2-7b", "falcon-mamba-7b",
}


def policy_for(cfg: ModelConfig, train: bool, variant: str = "optimized") -> shd.ShardingPolicy:
    """Sharding policy per (arch, step kind).

    baseline  -- Megatron TP over 'model' everywhere, FSDP over 'data' for
                 >=7B training.
    optimized -- train / prefill use the FSDP-pure (ZeRO-3) policy;
                 decode keeps TP (params and KV cache sharded).
    """
    if variant == "baseline" or not train:
        return shd.ShardingPolicy(tp=True, fsdp=train and cfg.name in FSDP_ARCHS)
    return shd.FSDP_PURE


def make_optimizer(cfg: ModelConfig) -> AdamW:
    return AdamW(
        lr=schedule.warmup_cosine(3e-4, 2000, 100_000),
        b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0,
    )


def opt_state_specs(param_specs_tree):
    return AdamWState(step=P(), m=param_specs_tree, v=param_specs_tree)


def _act_spec(shape: Shape, mesh, policy):
    """(B,S,D) residual-stream spec under this policy's batch split."""
    dpa = shd.dp(mesh, policy)
    ax_b, ax_s = shd._split_batch_seq(shape.global_batch, shape.seq, dpa, mesh)
    return P(ax_b, ax_s, None)


# --- placement -------------------------------------------------------------------

def _state_items(tree):
    """(key path, leaf) of a params / batch dict or an `AdamWState`."""
    if isinstance(tree, AdamWState):
        return [(("step",), tree.step)] + [(("m",) + p, t) for p, t in tree_paths(tree.m)] \
            + [(("v",) + p, t) for p, t in tree_paths(tree.v)]
    return tree_paths(tree)


def _rebuild(like, items):
    if isinstance(like, AdamWState):
        tree = tree_from_paths(items)
        return AdamWState(tree["step"], tree.get("m", {}), tree.get("v", {}))
    return tree_from_paths(items)


def place(tree, specs, mesh):
    """`tree` (a dict or an `AdamWState` of tensors) as DTensors laid out by
    `specs` (the same structure of `P`s) on the mesh's device mesh; each
    leaf moved to the mesh's device first.  Without a device mesh, the
    leaves on the device, unplaced."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    dm = mesh.device_mesh
    out = []
    spec_items = dict(_state_items(specs))
    for path, t in _state_items(tree):
        if dm is None:
            out.append((path, t.to(mesh.device)))
            continue
        pl = shd.to_named({"s": spec_items[path]}, mesh)["s"]
        if isinstance(t, DTensor):
            out.append((path, t if tuple(t.placements) == pl else t.redistribute(dm, pl)))
        else:
            out.append((path, distribute_tensor(t.to(mesh.device), dm, pl, src_data_rank=None)))
    return _rebuild(tree, out)


def _write_into(dst_tree, src_tree) -> None:
    """Copy every leaf of `src_tree` into the same leaf of `dst_tree` (the
    donated buffers' in-place update)."""
    src = dict(_state_items(src_tree))
    with torch.no_grad():
        for path, t in _state_items(dst_tree):
            t.copy_(src[path])


def _local_tree(tree):
    from torch.distributed.tensor import DTensor
    return _rebuild(tree, [(p, t.to_local() if isinstance(t, DTensor) else t)
                           for p, t in _state_items(tree)])


def _step_on_shards(model, opt: AdamW, params, opt_state, batch):
    """(loss, new params, new state): `lm_train.loss_and_grads`, then
    `opt.apply` of DTensor trees: the gradients laid out as their params
    (a reduce-scatter of a partial sum), the clip's global norm over the
    DTensors, then the elementwise update on each rank's local shards, as
    a sharded optimizer runs it; the same operations in the same order as
    `opt.apply`, so the same bits.  Each gradient tree is let go once the
    next is made (no frame holds it on), as XLA frees a buffer after its
    last use."""
    from torch.distributed.tensor import DTensor
    loss, grads = lm_train.loss_and_grads(model, params, batch)
    with torch.no_grad():
        grads = _rebuild(grads, [(p, g.redistribute(t.device_mesh, t.placements))
                                 for (p, g), (_, t) in zip(_state_items(grads),
                                                           _state_items(params))])
        if opt.clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, opt.clip_norm)
        shard_opt = AdamW(opt.lr, opt.b1, opt.b2, opt.eps, opt.weight_decay, None,
                          opt.lr_scale_fn)
        new_p, new_s = shard_opt.apply(_local_tree(params), _local_tree(grads),
                                       _local_tree(opt_state))

    def placed_as(new, like):
        return _rebuild(new, [(p, DTensor.from_local(t, o.device_mesh, o.placements,
                                                     run_check=False))
                              for (p, t), (_, o) in zip(_state_items(new), _state_items(like))])
    return loss, placed_as(new_p, params), placed_as(new_s, opt_state)


def _context(mesh):
    """The context a placed step runs in: plain tensors the model makes
    count as replicated DTensors."""
    if mesh.device_mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _model(cfg: ModelConfig, mesh, policy, shape: Shape | None):
    act = None if (policy.tp or shape is None) else _act_spec(shape, mesh, policy)
    fsdp = tuple(a for a in policy.fsdp_axes if a in mesh.shape) if policy.fsdp else ()
    return LM(cfg, mesh=mesh, device=mesh.device, tp_logits=policy.tp, act_spec=act,
              fsdp_axes=fsdp)


# --- the steps ---------------------------------------------------------------------

def build_train_step(cfg: ModelConfig, mesh, shape: Shape, variant: str = "optimized"):
    """fn(params, opt_state, batch) -> (params, opt_state, loss): one AdamW
    step, params and state updated in place; loss replicated."""
    policy = policy_for(cfg, train=True, variant=variant)
    model = _model(cfg, mesh, policy, shape)
    opt = make_optimizer(cfg)

    abstract_params = LM(cfg, device="meta").init(None)
    abstract_opt = opt.init(abstract_params)
    batch = input_specs(cfg, shape)

    pspecs = shd.param_specs(cfg, abstract_params, mesh, policy)
    ospecs = opt_state_specs(pspecs)
    bspecs = shd.batch_specs(cfg, batch, mesh, policy)

    def place_args(params, opt_state, b):
        return place(params, pspecs, mesh), place(opt_state, ospecs, mesh), place(b, bspecs, mesh)

    def train_step(params, opt_state, b):
        params, opt_state, b = place_args(params, opt_state, b)
        with _context(mesh):
            if mesh.device_mesh is None:
                new_p, new_s, loss = lm_train.train_step(model, opt, params, opt_state, b)
            else:
                loss, new_p, new_s = _step_on_shards(model, opt, params, opt_state, b)
                loss = place({"l": loss}, {"l": P()}, mesh)["l"]
            _write_into(params, new_p)
            _write_into(opt_state, new_s)
        return params, opt_state, loss

    train_step.place = place_args
    return train_step, (abstract_params, abstract_opt, batch)


def build_prefill_step(cfg: ModelConfig, mesh, shape: Shape, variant: str = "optimized"):
    """fn(params, batch) -> (last-token logits, caches)."""
    # prefill is token-heavy like training: use the train-side policy
    policy = policy_for(cfg, train=True, variant=variant)
    model = _model(cfg, mesh, policy, shape)
    abstract_params = LM(cfg, device="meta").init(None)
    batch = input_specs(cfg, shape)
    pspecs = shd.param_specs(cfg, abstract_params, mesh, policy)
    bspecs = shd.batch_specs(cfg, batch, mesh, policy)

    def place_args(params, b):
        return place(params, pspecs, mesh), place(b, bspecs, mesh)

    def prefill_step(params, b):
        params, b = place_args(params, b)
        with _context(mesh), torch.no_grad():
            logits, caches, _ = model.prefill(
                params,
                tokens=b.get("tokens"),
                embeds=b.get("embeds"),
                positions=b.get("positions"),
                encoder_embeds=b.get("encoder_embeds"),
            )
        return logits, caches

    prefill_step.place = place_args
    return prefill_step, (abstract_params, batch)


def build_decode_step(cfg: ModelConfig, mesh, shape: Shape, variant: str = "optimized"):
    """fn(params, batch) -> (logits, caches): one token; the new caches are
    written into the batch's (the donated buffers) and returned."""
    policy = policy_for(cfg, train=False, variant=variant)
    model = _model(cfg, mesh, policy, None)
    abstract_params = LM(cfg, device="meta").init(None)
    batch = input_specs(cfg, shape)
    pspecs = shd.param_specs(cfg, abstract_params, mesh, policy)
    bspecs = shd.batch_specs(cfg, batch, mesh, policy)

    dpa = shd.dp(mesh, policy)
    n_dp = int(np.prod([mesh.shape[a] for a in dpa])) if dpa else 1
    batch_ax = dpa if shape.global_batch % max(n_dp, 1) == 0 else None
    vocab_ax = policy.model_axis if cfg.vocab % mesh.shape.get(policy.model_axis, 1) == 0 \
        else None
    logits_spec = P(batch_ax, vocab_ax)

    def place_args(params, b):
        return place(params, pspecs, mesh), place(b, bspecs, mesh)

    def decode_step(params, b):
        params, b = place_args(params, b)
        with _context(mesh), torch.no_grad():
            logits, caches = model.decode_step(
                params, b["caches"], b["tokens"], b["pos"],
                encoder_out=b.get("encoder_out"),
            )
            _write_into(b["caches"], place(caches, bspecs["caches"], mesh))
            logits = place({"l": logits}, {"l": logits_spec}, mesh)["l"]
        return logits, b["caches"]

    decode_step.place = place_args
    return decode_step, (abstract_params, batch)


def build_step_cfg(cfg: ModelConfig, shape_name, mesh, variant: str = "optimized"):
    """The step of the shape's kind: ((fn, abstract args), cfg, shape).
    `shape_name` names a suite of `SHAPES` or is a `Shape` of its own."""
    shape = shape_name if isinstance(shape_name, Shape) else SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, variant), cfg, shape
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, variant), cfg, shape
    return build_decode_step(cfg, mesh, shape, variant), cfg, shape


def build_step(arch: str, shape_name: str, mesh, variant: str = "optimized"):
    return build_step_cfg(get_config(arch), shape_name, mesh, variant)


def materialize(tree, device):
    """Zeros on `device` of a tree of meta tensors' shapes and dtypes (under
    a `FakeTensorMode`, fake ones)."""
    return _rebuild(tree, [(p, torch.zeros(t.shape, dtype=t.dtype, device=device))
                           for p, t in _state_items(tree)])
