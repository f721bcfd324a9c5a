"""Block definitions and the decoder stack.

The port of `repro.models.transformer`.  Architectures are *segments*,
contiguous runs of one block kind whose params are stacked along a leading
layer axis:

    dense LMs        [('attn_dense', n)]
    deepseek-v2/v3   [('mla_dense', k), ('mla_moe', n-k)]
    falcon-mamba     [('mamba1', n)]
    zamba2           [('mamba2', n)] + a weight-shared attention block
    whisper          encoder [('enc_attn', n)] / decoder [('dec_attn', n)]

`segments` gives every architecture's layout; the blocks of the
`attn_dense` kind are ported, and any other kind raises
NotImplementedError naming its ROADMAP item.  The reference scans a
segment with `lax.scan`; here each stacked leaf is unbound once a pass
(`torch.unbind`, whose backward stacks the layers' gradients once) and the
layers run in a Python loop, each under `torch.utils.checkpoint` when the
config asks for remat.  Indexing a stacked leaf once per layer instead
would make autograd write a zero tensor of the whole stack per layer.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from . import attention, ffn, layers
from .config import ModelConfig
from ..optim.adamw import tree_from_paths, tree_paths

# the ROADMAP item that ports each block kind not ported yet
NOT_PORTED = {
    "mla_dense": "ROADMAP Queue 1 item 2.1 (MLA + MoE)",
    "mla_moe": "ROADMAP Queue 1 item 2.1 (MLA + MoE)",
    "attn_moe": "ROADMAP Queue 1 item 2.1 (MLA + MoE)",
    "mamba1": "ROADMAP Queue 1 item 2.2 (SSM and hybrid)",
    "mamba2": "ROADMAP Queue 1 item 2.2 (SSM and hybrid)",
    "enc_attn": "ROADMAP Queue 1 item 2.3 (whisper's encoder-decoder)",
    "dec_attn": "ROADMAP Queue 1 item 2.3 (whisper's encoder-decoder)",
}


def require_ported(kind: str) -> None:
    if kind != "attn_dense":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: {NOT_PORTED.get(kind, 'ROADMAP Queue 1')}")


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
    require_ported(kind)
    p: dict[str, Any] = {"ln1": _init_norm(cfg, dtype, device)}
    p["attn"] = attention.init_attention(generator, cfg, dtype, device)
    p["ln2"] = _init_norm(cfg, dtype, device)
    p["ffn"] = ffn.init_ffn(generator, cfg.d_model, cfg.d_ff, cfg.act, dtype, device)
    return p


# --- per-block application ----------------------------------------------------------

def apply_block(params, cfg: ModelConfig, kind: str, x, positions):
    """Full-sequence (train / prefill) block."""
    require_ported(kind)
    h = apply_norm(cfg, params["ln1"], x)
    x = x + attention.attention(params["attn"], cfg, h, positions)
    h = apply_norm(cfg, params["ln2"], x)
    return x + ffn.ffn(params["ffn"], h, cfg.act)


def apply_block_decode(params, cfg: ModelConfig, kind: str, x, cache, pos,
                       rope_positions=None):
    """One-token decode: (x, the block's new cache).  pos (B, 1) is the
    cache slot; rope_positions may carry M-RoPE streams."""
    require_ported(kind)
    h = apply_norm(cfg, params["ln1"], x)
    y, cache_sa = attention.decode_attention(params["attn"], cfg, h, cache["self"], pos,
                                             rope_positions)
    x = x + y
    h = apply_norm(cfg, params["ln2"], x)
    return x + ffn.ffn(params["ffn"], h, cfg.act), {**cache, "self": cache_sa}


def apply_block_prefill(params, cfg: ModelConfig, kind: str, x, positions,
                        max_seq: int | None = None):
    """Full-prompt pass that also returns the block's decode cache."""
    require_ported(kind)
    h = apply_norm(cfg, params["ln1"], x)
    y, k, v = attention.attention_with_kv(params["attn"], cfg, h, positions)
    cache = {"self": {"k": _pad_seq(k, max_seq), "v": _pad_seq(v, max_seq)}}
    x = x + y
    h = apply_norm(cfg, params["ln2"], x)
    return x + ffn.ffn(params["ffn"], h, cfg.act), cache


def _pad_seq(t, max_seq):
    """Pad the sequence axis (axis 1) of a cache tensor up to max_seq."""
    if max_seq is None or t.shape[1] == max_seq:
        return t
    pad = torch.zeros((t.shape[0], max_seq - t.shape[1]) + tuple(t.shape[2:]),
                      dtype=t.dtype, device=t.device)
    return torch.cat([t, pad], dim=1)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, dtype,
                     device=None):
    require_ported(kind)
    return {"self": attention.init_kv_cache(cfg, batch, max_seq, dtype, device)}


# --- stacked segments ----------------------------------------------------------------

def stack_trees(trees: list):
    """Nested dicts of equal structure -> one dict, each leaf stacked along a
    new leading axis."""
    paths = [p for p, _ in tree_paths(trees[0])]
    flat = [dict(tree_paths(t)) for t in trees]
    return tree_from_paths([(p, torch.stack([f[p] for f in flat])) for p in paths])


def unstack_tree(tree) -> list:
    """A dict of stacked leaves -> one dict per layer, each leaf unbound once."""
    items = [(p, torch.unbind(t)) for p, t in tree_paths(tree)]
    n = len(items[0][1])
    return [tree_from_paths([(p, parts[i]) for p, parts in items]) for i in range(n)]


def init_segment(generator, cfg: ModelConfig, kind: str, n: int, dtype, device=None):
    """n blocks' params stacked along a leading layer axis (without a
    generator, the stacked shapes alone: see `layers.normal_init`)."""
    if generator is None:
        return tree_from_paths([(p, torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                                device=t.device))
                                for p, t in tree_paths(init_block(None, cfg, kind, dtype,
                                                                  device))])
    return stack_trees([init_block(generator, cfg, kind, dtype, device) for _ in range(n)])


def apply_segment(params, cfg: ModelConfig, kind: str, x, positions):
    """Run a stacked segment layer by layer (remat per layer if configured)."""
    for layer in unstack_tree(params):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(lambda p, h: apply_block(p, cfg, kind, h, positions), layer, x,
                           use_reentrant=False)
        else:
            x = apply_block(layer, cfg, kind, x, positions)
    return x


def apply_segment_decode(params, cfg: ModelConfig, kind: str, x, caches, pos,
                         rope_positions=None):
    """Decode through a segment; caches are stacked along the layer axis too."""
    outs = []
    for layer, cache in zip(unstack_tree(params), unstack_tree(caches)):
        x, nc = apply_block_decode(layer, cfg, kind, x, cache, pos, rope_positions)
        outs.append(nc)
    return x, stack_trees(outs)


def apply_segment_prefill(params, cfg: ModelConfig, kind: str, x, positions,
                          max_seq: int | None = None):
    """Prefill through a segment: (x, stacked caches)."""
    outs = []
    for layer in unstack_tree(params):
        x, cache = apply_block_prefill(layer, cfg, kind, x, positions, max_seq)
        outs.append(cache)
    return x, stack_trees(outs)
