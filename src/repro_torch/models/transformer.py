"""Block definitions and the decoder stack.

The port of `repro.models.transformer`.  Architectures are *segments*,
contiguous runs of one block kind whose params are stacked along a leading
layer axis:

    dense LMs        [('attn_dense', n)]
    deepseek-v2/v3   [('mla_dense', k), ('mla_moe', n-k)]
    falcon-mamba     [('mamba1', n)]
    zamba2           [('mamba2', n)] + a weight-shared attention block
    whisper          encoder [('enc_attn', n)] / decoder [('dec_attn', n)]

`segments` gives every architecture's layout; every kind is ported.
`mesh` (a `launch.mesh.Mesh`, None by default) goes through every
`apply_block*` / `apply_segment*` down to `moe.moe_layer`, which runs the
expert-parallel path on a mesh with more than one EP rank, the dense
expert path otherwise.  The leading dense layers of an MoE config take
`moe.dense_d_ff`; an SSM block is `ln1` and `ssm` only, and its decode
cache is the SSM state itself, `{"h", "conv_tail"}`.  Whisper's `enc_attn` is non-causal self-attention;
its `dec_attn` adds `ln_x` and a cross-attention sublayer (`xattn`, no
positional rotation, no mask) over the encoder output, skipped when
`encoder_out` is None.  Its prefill projects the encoder output's keys and
values once, with their biases, into the block's cache `cross` (the
encoder's length, not padded to `max_seq`); its decode reads them there
and never the encoder output.  The reference scans a
segment with `lax.scan`; here each stacked leaf is unbound once a pass
(`torch.unbind`, whose backward stacks the layers' gradients once) and the
layers run in a Python loop, each under `torch.utils.checkpoint` when the
config asks for remat.  Indexing a stacked leaf once per layer instead
would make autograd write a zero tensor of the whole stack per layer.

zamba2's hybrid stack (`apply_hybrid_segment*`) runs its SSM layers in
groups of `hybrid_attn_every`, each group followed by one application of
the weight-shared `attn_dense` block (under remat when configured, as the
reference remats it), then the `n_layers % every` tail layers.  The
segment's decode caches stay flat (n_layers, ...); the shared block's are
stacked (n_groups, ...), one KV cache per application point.  Where the
reference reshapes the stacked leaves into (n_groups, every, ...) and
scans the groups, the port unbinds the layers once and walks them in the
same order.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from . import attention, ffn, layers, moe, shards, ssm
from .config import ModelConfig
from ..optim.adamw import tree_from_paths, tree_paths

SSM_KINDS = ("mamba1", "mamba2")


# --- segment layout -------------------------------------------------------------

def segments(cfg: ModelConfig) -> list[tuple[str, int]]:
    if cfg.enc_dec:
        return [("dec_attn", cfg.n_layers)]
    if cfg.family == "ssm":
        return [("mamba1" if cfg.ssm.kind == "mamba1" else "mamba2", cfg.n_layers)]
    if cfg.family == "hybrid":
        return [("mamba2" if cfg.ssm.kind == "mamba2" else "mamba1", cfg.n_layers)]
    if cfg.moe is not None:
        nd = cfg.moe.n_dense_layers
        segs = []
        if nd:
            segs.append(("mla_dense" if cfg.mla else "attn_dense", nd))
        segs.append(("mla_moe" if cfg.mla else "attn_moe", cfg.n_layers - nd))
        return segs
    return [("attn_dense", cfg.n_layers)]


# --- per-block params -------------------------------------------------------------

def _init_norm(cfg: ModelConfig, dtype, device=None):
    ones = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    if cfg.norm == "layernorm":
        return {"scale": ones, "bias": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}
    return {"scale": ones}


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "layernorm":
        return layers.layer_norm(x, p["scale"], p["bias"])
    return layers.rms_norm(x, p["scale"])


def init_block(generator, cfg: ModelConfig, kind: str, dtype, device=None) -> dict:
    p: dict[str, Any] = {"ln1": _init_norm(cfg, dtype, device)}
    if kind in SSM_KINDS:
        p["ssm"] = ssm.init_ssm(generator, cfg, dtype, device)
        return p
    if kind.startswith("mla"):
        p["attn"] = attention.init_mla(generator, cfg, dtype, device)
    else:
        p["attn"] = attention.init_attention(generator, cfg, dtype, device)
    p["ln2"] = _init_norm(cfg, dtype, device)
    if kind.endswith("moe"):
        p["moe"] = moe.init_moe(generator, cfg, dtype, device)
    else:
        d_ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.dense_d_ff:
            d_ff = cfg.moe.dense_d_ff            # deepseek's leading dense layers are wider
        p["ffn"] = ffn.init_ffn(generator, cfg.d_model, d_ff, cfg.act, dtype, device)
    if kind == "dec_attn":                   # whisper's decoder: the cross-attention sublayer
        p["ln_x"] = _init_norm(cfg, dtype, device)
        p["xattn"] = attention.init_attention(generator, cfg, dtype, device)
    return p


# --- per-block application ----------------------------------------------------------

def _mlp(params, cfg: ModelConfig, kind: str, h, mesh=None):
    """The block's second sublayer: the MoE layer (expert-parallel over
    `mesh`'s EP axes when it has them) or the dense FFN."""
    if kind.endswith("moe"):
        return moe.moe_layer(params["moe"], h, cfg, mesh)
    return ffn.ffn(params["ffn"], h, cfg.act)


def apply_block(params, cfg: ModelConfig, kind: str, x, positions, encoder_out=None,
                mesh=None, gather=None):
    """Full-sequence (train / prefill) block.  `gather` (a callable, `LM`'s
    under an FSDP layout) takes the block's params to the layout it runs
    on: every block function calls it first (inside the remat, so the
    backward gathers again)."""
    params = gather(params) if gather is not None else params
    h = apply_norm(cfg, params["ln1"], x)
    if kind in SSM_KINDS:
        return x + ssm.ssm_block(params["ssm"], cfg, h)[0]
    if kind.startswith("mla"):
        x = x + attention.mla_attention(params["attn"], cfg, h, positions)
    else:
        x = x + attention.attention(params["attn"], cfg, h, positions,
                                    causal=kind != "enc_attn")
    if kind == "dec_attn" and encoder_out is not None:
        h = apply_norm(cfg, params["ln_x"], x)
        x = x + _cross_attention(params["xattn"], cfg, h,
                                 *_cross_kv(params["xattn"], cfg, encoder_out))
    h = apply_norm(cfg, params["ln2"], x)
    return x + _mlp(params, cfg, kind, h, mesh)


def _cross_kv(params, cfg: ModelConfig, encoder_out):
    """The encoder output's keys and values; of a DTensor split along its
    sequence, projected on each rank's frames (`shards.tokens`) and left in
    its layout."""
    ranks = shards.tokens(encoder_out)
    e = shards.enter(ranks, encoder_out)
    k = shards.einsum(ranks, "bsd,dke->bske", e, params["wk"])
    v = shards.einsum(ranks, "bsd,dke->bske", e, params["wv"])
    if cfg.qkv_bias:
        k, v = k + shards.param(ranks, params["bk"]), v + shards.param(ranks, params["bv"])
    return shards.leave(ranks, k), shards.leave(ranks, v)


def _cross_attention(params, cfg: ModelConfig, x, k, v):
    """Decoder -> encoder attention against the encoder's keys and values:
    no positional rotation, no causal mask.  A DTensor x split along its
    sequence projects each rank's tokens, whose queries meet the keys and
    values gathered along the encoder's sequence (`_sdpa_on_shards`); a
    DTensor output projects on each rank's block (`attention._out_proj`)."""
    ranks = shards.tokens(x)
    q = shards.einsum(ranks, "bsd,dhe->bshe", shards.enter(ranks, x), params["wq"])
    if cfg.qkv_bias:
        q = q + shards.param(ranks, params["bq"])
    return attention._out_proj(attention._sdpa(shards.leave(ranks, q), k, v, causal=False),
                               params["wo"])


def apply_block_decode(params, cfg: ModelConfig, kind: str, x, cache, pos,
                       rope_positions=None, mesh=None, gather=None):
    """One-token decode: (x, the block's new cache).  pos (B, 1) is the
    cache slot; rope_positions may carry M-RoPE streams.  An SSM block's
    cache is its state; a `dec_attn` block's cross-attention reads the
    encoder's keys and values from `cache["cross"]`."""
    params = gather(params) if gather is not None else params
    h = apply_norm(cfg, params["ln1"], x)
    if kind in SSM_KINDS:
        y, state = ssm.ssm_block(params["ssm"], cfg, h, cache)
        return x + y, state
    decode = attention.mla_decode_attention if kind.startswith("mla") \
        else attention.decode_attention
    y, cache_sa = decode(params["attn"], cfg, h, cache["self"], pos, rope_positions)
    x = x + y
    if kind == "dec_attn":
        h = apply_norm(cfg, params["ln_x"], x)
        x = x + _cross_attention(params["xattn"], cfg, h, cache["cross"]["k"],
                                 cache["cross"]["v"])
    h = apply_norm(cfg, params["ln2"], x)
    return x + _mlp(params, cfg, kind, h, mesh), {**cache, "self": cache_sa}


def apply_block_prefill(params, cfg: ModelConfig, kind: str, x, positions,
                        max_seq: int | None = None, encoder_out=None, mesh=None, gather=None):
    """Full-prompt pass that also returns the block's decode cache."""
    params = gather(params) if gather is not None else params
    h = apply_norm(cfg, params["ln1"], x)
    if kind in SSM_KINDS:
        y, state = ssm.ssm_block(params["ssm"], cfg, h)
        return x + y, state
    if kind.startswith("mla"):
        y, c_kv, k_rope = attention.mla_attention_with_cache(params["attn"], cfg, h, positions)
        cache = {"self": {"c_kv": _pad_seq(c_kv, max_seq), "k_rope": _pad_seq(k_rope, max_seq)}}
    else:
        y, k, v = attention.attention_with_kv(params["attn"], cfg, h, positions,
                                              causal=kind != "enc_attn")
        cache = {"self": {"k": _pad_seq(k, max_seq), "v": _pad_seq(v, max_seq)}}
    x = x + y
    if kind == "dec_attn":
        h = apply_norm(cfg, params["ln_x"], x)
        xk, xv = _cross_kv(params["xattn"], cfg, encoder_out)
        cache["cross"] = {"k": xk, "v": xv}
        x = x + _cross_attention(params["xattn"], cfg, h, xk, xv)
    h = apply_norm(cfg, params["ln2"], x)
    return x + _mlp(params, cfg, kind, h, mesh), cache


def _pad_seq(t, max_seq):
    """Pad the sequence axis (axis 1) of a cache tensor up to max_seq."""
    if max_seq is None or t.shape[1] == max_seq:
        return t
    pad = torch.zeros((t.shape[0], max_seq - t.shape[1]) + tuple(t.shape[2:]),
                      dtype=t.dtype, device=t.device)
    return torch.cat([t, pad], dim=1)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, dtype,
                     device=None):
    if kind in SSM_KINDS:
        return ssm.init_ssm_state(cfg, batch, dtype, device)
    if kind.startswith("mla"):
        return {"self": attention.init_mla_cache(cfg, batch, max_seq, dtype, device)}
    cache = {"self": attention.init_kv_cache(cfg, batch, max_seq, dtype, device)}
    if kind == "dec_attn":                   # the encoder's keys and values, set by prefill
        cache["cross"] = attention.init_kv_cache(cfg, batch, cfg.encoder_seq, dtype, device)
    return cache


# --- stacked segments ----------------------------------------------------------------

def stack_trees(trees: list, like=None):
    """Nested dicts of equal structure -> one dict, each leaf stacked along a
    new leading axis.  An empty list needs `like`, a tree of the stacked
    structure's elements: its leaves stacked zero times."""
    if not trees:
        return tree_from_paths([(p, t.new_empty((0,) + tuple(t.shape)))
                                for p, t in tree_paths(like)])
    paths = [p for p, _ in tree_paths(trees[0])]
    flat = [dict(tree_paths(t)) for t in trees]
    return tree_from_paths([(p, torch.stack([f[p] for f in flat])) for p in paths])


def unstack_tree(tree) -> list:
    """A dict of stacked leaves -> one dict per layer, each leaf unbound once.
    A DTensor leaf split along its layer axis (an FSDP rule's pick for a
    small leaf with many layers) is gathered along it first: DTensor cannot
    unbind a split dim on every torch version."""
    items = [(p, torch.unbind(_whole_layers(t))) for p, t in tree_paths(tree)]
    n = len(items[0][1])
    return [tree_from_paths([(p, parts[i]) for p, parts in items]) for i in range(n)]


def _whole_layers(t):
    """t, whole along its dim 0 (a Shard(0) DTensor gathered over the mesh
    dims that split it)."""
    from torch.distributed.tensor import Replicate, Shard
    placements = getattr(t, "placements", None)
    if placements is None or Shard(0) not in placements:
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p == Shard(0) else p
                                          for p in placements])


def init_segment(generator, cfg: ModelConfig, kind: str, n: int, dtype, device=None):
    """n blocks' params stacked along a leading layer axis, drawn block by
    block and written into the stacked leaves as they come, so the draw
    holds one block beside the stack (without a generator, the stacked
    shapes alone: see `layers.normal_init`)."""
    stacked = None
    for i in range(n):
        block = tree_paths(init_block(generator, cfg, kind, dtype, device))
        if stacked is None:
            stacked = [(p, torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device))
                       for p, t in block]
        if generator is None:
            break
        for (_, dst), (_, t) in zip(stacked, block):
            dst[i].copy_(t)
        del block
    return tree_from_paths(stacked)


def _apply_layer(layer, cfg: ModelConfig, kind: str, x, positions, encoder_out=None,
                 mesh=None, gather=None):
    """One block, under `torch.utils.checkpoint` when the config asks for
    remat and gradients are recorded (the encoder output an input of the
    checkpoint, so the decoder's gradient reaches the encoder)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(lambda p, h, e: apply_block(p, cfg, kind, h, positions, e, mesh,
                                                      gather),
                          layer, x, encoder_out, use_reentrant=False)
    return apply_block(layer, cfg, kind, x, positions, encoder_out, mesh, gather)


def identity(h):
    return h


def apply_segment(params, cfg: ModelConfig, kind: str, x, positions, encoder_out=None,
                  mesh=None, constrain=None, gather=None):
    """Run a stacked segment layer by layer (remat per layer if configured).
    `constrain` (a callable, `LM`'s activation layout) re-lays each layer's
    output out, as the reference pins its scan's carry."""
    keep = constrain or identity
    for layer in unstack_tree(params):
        x = keep(_apply_layer(layer, cfg, kind, x, positions, encoder_out, mesh, gather))
    return x


def apply_segment_decode(params, cfg: ModelConfig, kind: str, x, caches, pos,
                         rope_positions=None, mesh=None, gather=None, constrain=None):
    """Decode through a segment; caches are stacked along the layer axis too."""
    keep = constrain or identity
    outs = []
    for layer, cache in zip(unstack_tree(params), unstack_tree(caches)):
        x, nc = apply_block_decode(layer, cfg, kind, x, cache, pos, rope_positions, mesh,
                                   gather)
        x = keep(x)
        outs.append(nc)
    return x, stack_trees(outs)


def apply_segment_prefill(params, cfg: ModelConfig, kind: str, x, positions,
                          max_seq: int | None = None, encoder_out=None, mesh=None,
                          constrain=None, gather=None):
    """Prefill through a segment: (x, stacked caches)."""
    keep = constrain or identity
    outs = []
    for layer in unstack_tree(params):
        x, cache = apply_block_prefill(layer, cfg, kind, x, positions, max_seq, encoder_out,
                                       mesh, gather)
        x = keep(x)
        outs.append(cache)
    return x, stack_trees(outs)


# --- zamba2-style hybrid: SSM stack + a weight-shared attention block ---------------
#
# The shared block's weights are read at every application point (the
# arch's parameter-saving trick; autograd sums their gradient over the
# points), but each point has its own KV cache.  Layer i is followed by the
# shared block when (i + 1) % every == 0: the reference's groups of `every`
# SSM layers, then its n_layers % every tail layers.

def _ends_group(i: int, cfg: ModelConfig) -> bool:
    return (i + 1) % cfg.hybrid_attn_every == 0


def apply_hybrid_segment(params, cfg: ModelConfig, kind: str, x, positions, shared_attn,
                         mesh=None, constrain=None, gather=None):
    keep = constrain or identity
    for i, layer in enumerate(unstack_tree(params)):
        x = keep(_apply_layer(layer, cfg, kind, x, positions, mesh=mesh, gather=gather))
        if _ends_group(i, cfg):
            x = keep(_apply_layer(shared_attn, cfg, "attn_dense", x, positions, mesh=mesh,
                                  gather=gather))
    return x


def apply_hybrid_segment_prefill(params, cfg: ModelConfig, kind: str, x, positions,
                                 shared_attn, max_seq: int | None = None, mesh=None,
                                 gather=None, constrain=None):
    """-> (x, the segment's flat (n_layers, ...) caches, the shared block's
    (n_groups, ...) caches)."""
    keep = constrain or identity
    outs, shared = [], []
    for i, layer in enumerate(unstack_tree(params)):
        x, cache = apply_block_prefill(layer, cfg, kind, x, positions, max_seq, mesh=mesh,
                                       gather=gather)
        x = keep(x)
        outs.append(cache)
        if _ends_group(i, cfg):
            x, cache = apply_block_prefill(shared_attn, cfg, "attn_dense", x, positions, max_seq,
                                           mesh=mesh, gather=gather)
            x = keep(x)
            shared.append(cache)
    like = None if shared else init_block_cache(cfg, "attn_dense", x.shape[0],
                                                max_seq or x.shape[1], x.dtype, x.device)
    return x, stack_trees(outs), stack_trees(shared, like)


def apply_hybrid_segment_decode(params, cfg: ModelConfig, kind: str, x, caches, pos,
                                shared_attn, shared_caches, mesh=None, gather=None,
                                constrain=None):
    """shared_caches: the shared block's stacked (n_groups, ...) KV caches."""
    keep = constrain or identity
    outs, shared, points = [], [], unstack_tree(shared_caches)
    for i, (layer, cache) in enumerate(zip(unstack_tree(params), unstack_tree(caches))):
        x, nc = apply_block_decode(layer, cfg, kind, x, cache, pos, mesh=mesh, gather=gather)
        x = keep(x)
        outs.append(nc)
        if _ends_group(i, cfg):
            x, nc = apply_block_decode(shared_attn, cfg, "attn_dense", x, points[len(shared)],
                                       pos, mesh=mesh, gather=gather)
            x = keep(x)
            shared.append(nc)
    return x, stack_trees(outs), stack_trees(shared) if shared else shared_caches
