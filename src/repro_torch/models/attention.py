"""Attention: GQA / MHA with bias, qk-norm and the RoPE variants, and
DeepSeek's MLA (multi-head latent attention).

The port of `repro.models.attention`.  Activations are
(B, S, D); projection weights keep the head axis explicit, wq (D, H, hd),
wo (H, hd, D), as in the reference.  Scores are computed in the inputs'
dtype, then taken to f32 for the scale, the mask (-1e30) and the softmax;
the probabilities go back to the values' dtype.  Sequences whose score
tile exceeds `_CHUNKED_THRESHOLD` take the chunked online softmax
(`_sdpa_chunked`), with the reference's chunk sizes and its running max,
denominator and accumulator in f32.  No library attention kernel is used.

Decode: a layer's cache is {'k': (B, S_max, K, hd), 'v': ...}; a decode
step writes its key and value into slot `pos` as the reference does,
``cache + one_hot(pos) * new``.  MLA caches the compressed latent
{'c_kv': (B, S_max, kv_lora), 'k_rope': (B, S_max, d_rope)} instead, and
its decode is absorbed: `wkv_b`'s key half goes into the query and its
value half into the output, so the scores run against the latent cache.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import layers, shards
from .config import MLAConfig, ModelConfig


def _apply_positional(cfg: ModelConfig, x, positions):
    if cfg.rope == "standard":
        return layers.apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope == "rope2d":
        return layers.apply_rope_2d(x, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        return layers.apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    return x


def init_attention(generator, cfg: ModelConfig, dtype, device=None) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    init = lambda shape: layers.normal_init(generator, shape, dtype=dtype, device=device)  # noqa: E731
    p = {"wq": init((d, h, hd)), "wk": init((d, k, hd)), "wv": init((d, k, hd)),
         "wo": init((h, hd, d))}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((k, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((k, hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _qkv(params, cfg: ModelConfig, x, positions, ranks=None):
    """q, k, v of x; with `ranks` (`shards.tokens`), of each rank's local
    tokens x at their local positions."""
    q = shards.einsum(ranks, "bsd,dhe->bshe", x, params["wq"])
    k = shards.einsum(ranks, "bsd,dke->bske", x, params["wk"])
    v = shards.einsum(ranks, "bsd,dke->bske", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = (t + shards.param(ranks, params[n]) for t, n in ((q, "bq"), (k, "bk"), (v, "bv")))
    if cfg.qk_norm:
        q = layers.rms_norm(q, shards.param(ranks, params["q_norm"]))
        k = layers.rms_norm(k, shards.param(ranks, params["k_norm"]))
    return _apply_positional(cfg, q, positions), _apply_positional(cfg, k, positions), v


def _token_positions(ranks, positions):
    """Positions (B, S) or the (3, B, S) M-RoPE streams at each rank's
    local tokens (`ranks` from `shards.tokens`); without `ranks`, as given."""
    if ranks is None:
        return positions
    return ranks.enter(positions, ranks.rows_at(positions.ndim - 2))


# above this many score elements per head group, the chunked online softmax:
# the (Sq, Sk) scores are never materialised
_CHUNKED_THRESHOLD = 2048 * 4096
_Q_CHUNK = 1024
_K_CHUNK = 1024


def _sqrt_hd(hd: int) -> float:
    """sqrt(hd) rounded to f32, as the reference's `jnp.sqrt(hd)` gives it:
    a Python float holding that f32 value (an operand of an f32 tensor op,
    so no host-to-device copy, which would wait on the device)."""
    return float(np.float32(math.sqrt(hd)))


def _heads_dividing(q, kh: int):
    """q (B, S, H, hd); a DTensor q whose heads are split in more blocks
    than there are kv heads gathered over the head dim (a block would cut
    a group of query heads)."""
    from torch.distributed.tensor import Replicate, Shard
    placements = getattr(q, "placements", None)
    if placements is None:
        return q
    split = math.prod(q.device_mesh.size(i) for i, p in enumerate(placements)
                      if isinstance(p, Shard) and p.dim == 2)
    if kh % split == 0:
        return q
    return q.redistribute(q.device_mesh, [Replicate() if isinstance(p, Shard) and p.dim == 2
                                          else p for p in placements])


def _group_heads(q, kh: int, rep: int):
    """q (B, S, H, hd) -> (B, S, K, r, hd), the query heads grouped by their
    kv head."""
    q = _heads_dividing(q, kh)
    return q.reshape(q.shape[0], q.shape[1], kh, rep, q.shape[-1])


def _sdpa_dense(q, k, v, causal: bool, q_offset=0):
    b, sq, h, hd = q.shape
    sk, kh, hd_v = v.shape[1], v.shape[2], v.shape[3]
    rep = h // kh
    q = _group_heads(q, kh, rep)
    scores = torch.einsum("bqkre,bske->bkrqs", q, k).to(torch.float32)
    scores = scores / _sqrt_hd(hd)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(ki <= qi, scores, torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bske->bqkre", probs, v)
    return out.reshape(b, sq, h, hd_v)


def _sdpa_chunked(q, k, v, causal: bool, q_offset=0):
    """Memory-efficient attention: query chunks, each running over the key
    chunks with a running (max, denominator, accumulator) online softmax in
    f32.  A query chunk's score tiles are recomputed in the backward when
    gradients are recorded (the reference's `jax.checkpoint`)."""
    b, sq0, h, hd = q.shape
    sk0, kh, hd_v = v.shape[1], v.shape[2], v.shape[3]
    rep = h // kh
    qc, kc = min(_Q_CHUNK, sq0), min(_K_CHUNK, sk0)
    pad_q, pad_k = (-sq0) % qc, (-sk0) % kc
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    sq, sk = sq0 + pad_q, sk0 + pad_k
    nq, nk = sq // qc, sk // kc
    scale = float(np.float32(1.0) / np.float32(_sqrt_hd(hd)))     # the f32 quotient
    neg = torch.full((), -1e30, device=q.device)
    qr = q.reshape(b, nq, qc, kh, rep, hd)
    kr = k.reshape(b, nk, kc, kh, hd)
    vr = v.reshape(b, nk, kc, kh, hd_v)

    def q_block(q_blk, kr, vr, qi: int):
        m = torch.full((b, kh, rep, qc), float("-inf"), dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kh, rep, qc), dtype=torch.float32, device=q.device)  # noqa: E741
        acc = torch.zeros((b, kh, rep, qc, hd_v), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            k_blk, v_blk = kr[:, ki], vr[:, ki]
            s = torch.einsum("bqkre,bske->bkrqs", q_blk, k_blk).to(torch.float32) * scale
            kpos = ki * kc + torch.arange(kc, device=q.device)[None, :]
            if causal:
                qpos = qi * qc + torch.arange(qc, device=q.device)[:, None] + q_offset
                s = torch.where(kpos <= qpos, s, neg)
            if pad_k:
                s = torch.where(kpos[0] < sk0, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)  # noqa: E741
            acc = acc * corr[..., None] + torch.einsum(
                "bkrqs,bske->bkrqe", p.to(v_blk.dtype), v_blk).to(torch.float32)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]     # (b, kh, rep, qc, hd_v)
        return out.permute(0, 3, 1, 2, 4)                    # (b, qc, kh, rep, hd_v)

    outs = []
    for qi in range(nq):
        if torch.is_grad_enabled():
            # k and v passed, not closed over: a closure would hold them as
            # long as the graph does, past an enclosing remat
            outs.append(checkpoint(q_block, qr[:, qi], kr, vr, qi, use_reentrant=False))
        else:
            outs.append(q_block(qr[:, qi], kr, vr, qi))
    out = torch.stack(outs, dim=1).reshape(b, sq, h, hd_v)
    if pad_q:
        out = out[:, :sq0]
    return out.to(v.dtype)


def _sdpa(q, k, v, causal: bool, q_offset=0, chunked: bool | None = None):
    """q, k (B, S, ., hd), v (B, Sk, K, hd_v) with GQA head repetition; long
    sequences take the chunked online softmax (`chunked` decides it for a
    block of a longer sequence).  DTensor operands run on each rank's
    block (`_sdpa_on_shards`)."""
    if getattr(q, "device_mesh", None) is not None:
        return _sdpa_on_shards(q, k, v, causal)
    sq, sk = q.shape[1], v.shape[1]
    if chunked is None:
        chunked = sq * sk > _CHUNKED_THRESHOLD and sq > 1
    if chunked:
        return _sdpa_chunked(q, k, v, causal, q_offset)
    return _sdpa_dense(q, k, v, causal, q_offset)


def _sdpa_on_shards(q, k, v, causal: bool):
    """`_sdpa` of DTensors on each rank's block: q keeps its split of the
    batch, the query positions and the heads (the heads only where the kv
    heads divide as finely); k and v (in any layout) follow its batch and
    head splits and are gathered whole along the sequence.  A rank's block
    needs no other rank's queries, so the only collectives are that gather
    and, in the backward, the reduction of k's and v's gradients, partial
    sums over the mesh dims that split the queries.  The chunked softmax is
    chosen by the whole sequence, as unplaced."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    q = _heads_dividing(q, v.shape[2])
    q_pl = [p if isinstance(p, Shard) and p.dim in (0, 1, 2) else Replicate()
            for p in q.placements]
    kv_pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate() for p in q_pl]
    kv_grad = [Partial() if isinstance(p, Shard) and p.dim == 1 else p for p in q_pl]
    q = q.redistribute(mesh, q_pl)
    k_l = shards.as_dtensor(k, mesh).redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    v_l = shards.as_dtensor(v, mesh).redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    q_l = q.to_local()
    sq, sk = q.shape[1], v.shape[1]
    # this rank's first query position: DTensor's nested blocks of the
    # sequence, ceil-sized (the last one shorter where they do not divide)
    offset = shards.Ranks(q, tokens=True).seq_offset(sq)
    out = _sdpa(q_l, k_l, v_l, causal, offset,
                chunked=sq * sk > _CHUNKED_THRESHOLD and sq > 1)
    return shards.from_local(out, mesh, q_pl, tuple(q.shape[:3]) + (v.shape[3],))


def _out_proj(out, wo):
    """einsum("bshe,hed->bsd", out, wo).  A DTensor out projects on each
    rank's block: out's local block (its batch, sequence and head splits;
    partial sums kept), wo's rows of the heads the block holds, the
    products a partial sum over the head dims (and wherever out is one),
    all-reduced (Megatron's g) -> (B, S, D) split as out's tokens, where
    DTensor's own propagation would flatten a split head dim."""
    if getattr(out, "device_mesh", None) is None:
        return torch.einsum("bshe,hed->bsd", out, wo)
    from torch.distributed.tensor import Partial, Replicate, Shard
    ranks = shards.Ranks(out, tokens=True)
    w = ranks.local(wo, [Shard(0) if p == Shard(2) else Replicate() for p in out.placements])
    y = torch.einsum("bshe,hed->bsd", out.to_local(), w)
    return ranks.leave(y, [Partial() if p == Shard(2) or p.is_partial() else r
                           for p, r in zip(out.placements, ranks.rows)], ranks.rows)


def attention(params, cfg: ModelConfig, x, positions, causal=True):
    """Full-sequence attention (training / prefill)."""
    return attention_with_kv(params, cfg, x, positions, causal)[0]


def attention_with_kv(params, cfg: ModelConfig, x, positions, causal=True):
    """Prefill variant: also returns the (k, v) tensors for the cache.

    A DTensor x split along its sequence runs on each rank's tokens
    (`shards.tokens`): the projections on the local tokens, then
    `_sdpa_on_shards` (each rank's queries at their causal offset against
    the keys and values gathered along the sequence); k and v leave in x's
    layout.  A DTensor output projects on each rank's block (`_out_proj`)."""
    ranks = shards.tokens(x)
    q, k, v = _qkv(params, cfg, shards.enter(ranks, x), _token_positions(ranks, positions),
                   ranks)
    q, k, v = (shards.leave(ranks, t) for t in (q, k, v))
    return _out_proj(_sdpa(q, k, v, causal), params["wo"]), k, v


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device=None) -> dict:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params, cfg: ModelConfig, x, cache: dict, pos: torch.Tensor,
                     rope_positions=None):
    """One-token decode.  x (B, 1, D); pos (B, 1) the absolute position (the
    cache slot); rope_positions defaults to pos but may carry the (3, B, 1)
    M-RoPE streams.  Returns (out (B, 1, D), new cache)."""
    q, k_new, v_new = _qkv(params, cfg, x, pos if rope_positions is None else rope_positions)
    b = x.shape[0]
    sk = cache["k"].shape[1]
    oh = F.one_hot(pos[:, 0].to(torch.int64), sk).to(cache["k"].dtype)     # (B, S_max)
    k_cache = cache["k"] + oh[:, :, None, None] * k_new
    v_cache = cache["v"] + oh[:, :, None, None] * v_new
    valid = torch.arange(sk, device=x.device)[None, :] <= pos               # (B, S_max)
    kh = cfg.n_kv_heads
    rep = cfg.n_heads // kh
    qr = _group_heads(q, kh, rep)
    new_cache = {"k": k_cache, "v": v_cache}
    if _sharded_cache(k_cache):
        return _decode_on_shards(qr, k_cache, v_cache, valid, params["wo"]), new_cache
    out = _decode_core(qr, k_cache, v_cache, valid, cfg.hd).reshape(b, 1, cfg.n_heads, cfg.hd)
    return _out_proj(out, params["wo"]), new_cache


def _decode_core(qr, k_cache, v_cache, valid, hd: int, whole=None):
    """qr (B, 1, K, r, hd) against the caches (B, S, K, hd) where `valid`
    (B, S) -> (B, 1, K, r, hd).  `whole` (a function of the scores and
    their inverse, or None) takes a block of the scores along the sequence
    to the whole sequence for the softmax and back."""
    scores = torch.einsum("bqkre,bske->bkrqs", qr, k_cache).to(torch.float32)
    scores = scores / _sqrt_hd(hd)
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.full((), -1e30, device=qr.device))
    if whole is None:
        probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    else:
        probs = whole[1](torch.softmax(whole[0](scores), dim=-1).to(v_cache.dtype))
    return torch.einsum("bkrqs,bske->bqkre", probs, v_cache)


def _sharded_cache(cache) -> bool:
    """A DTensor cache (B, S, K, hd) split over nothing but its batch,
    sequence and kv-head dims (a placed decode step's,
    `parallel.sharding._cache_spec`)."""
    from torch.distributed.tensor import Replicate, Shard
    placements = getattr(cache, "placements", None)
    return placements is not None and all(
        isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim in (0, 1, 2))
        for p in placements)


def _decode_on_shards(qr, k_cache, v_cache, valid, wo):
    """`_decode_core` and the output projection of a batch / sequence /
    head split cache, run on each rank's block: no score or output term
    crosses a batch row or a kv head; a block of the sequence scores its
    own positions, the scores are gathered along the sequence for the
    softmax and each block's share of the output is a partial sum; the
    projection's sum over the heads and those partial sums are one
    all-reduce (Megatron's), where DTensor's own propagation would flatten
    the split dims into one and search its layouts.  -> (B, 1, D), split
    as the batch rows are."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = k_cache.device_mesh

    def block(t, placements):
        return shards.redistributed(shards.as_dtensor(t, mesh), mesh, placements).to_local()
    cache = list(k_cache.placements)
    rows = [p if p == Shard(0) else Replicate() for p in cache]
    heads = [Replicate() if p == Shard(1) else p for p in cache]      # qr's batch and heads
    whole = None
    if Shard(1) in cache:     # (B, K, r, 1, S) scores: a block of the positions <-> all
        on_seq = [Shard(4) if p == Shard(1) else Shard(1) if p == Shard(2) else p
                  for p in cache]
        gathered = [Replicate() if p == Shard(4) else p for p in on_seq]
        whole = (lambda t: block(DTensor.from_local(t, mesh, on_seq, run_check=False), gathered),
                 lambda t: block(DTensor.from_local(t, mesh, gathered, run_check=False), on_seq))
    out = _decode_core(block(qr, heads), k_cache.to_local(), block(v_cache, cache),
                       block(valid, [p if p in (Shard(0), Shard(1)) else Replicate()
                                     for p in cache]), qr.shape[-1], whole)
    b, _, kh, rep, hd = out.shape
    w = block(wo, [Shard(0) if p == Shard(2) else Replicate() for p in cache])
    y = torch.einsum("bshe,hed->bsd", out.reshape(b, 1, kh * rep, hd), w)
    y = DTensor.from_local(y, mesh, [Partial() if p in (Shard(1), Shard(2)) else p
                                     for p in cache], run_check=False)
    return y.redistribute(mesh, rows)


# --- DeepSeek MLA (multi-head latent attention) --------------------------------

def init_mla(generator, cfg: ModelConfig, dtype, device=None) -> dict:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    init = lambda shape: layers.normal_init(generator, shape, dtype=dtype, device=device)  # noqa: E731
    ones = lambda n: torch.ones((n,), dtype=dtype, device=device)  # noqa: E731
    p = {}
    if m.q_lora:
        p["wq_a"] = init((d, m.q_lora))
        p["q_a_norm"] = ones(m.q_lora)
        p["wq_b"] = init((m.q_lora, h, m.d_nope + m.d_rope))
    else:
        p["wq"] = init((d, h, m.d_nope + m.d_rope))
    p["wkv_a"] = init((d, m.kv_lora + m.d_rope))
    p["kv_a_norm"] = ones(m.kv_lora)
    p["wkv_b"] = init((m.kv_lora, h, m.d_nope + m.d_v))
    p["wo"] = init((h, m.d_v, d))
    return p


def _mla_q(params, cfg: ModelConfig, x, positions, ranks=None):
    """(q_nope (B, S, H, d_nope), q_rope (B, S, H, d_rope) rotated): a direct
    projection, or the low-rank wq_a -> rms_norm -> wq_b when q_lora; with
    `ranks`, of each rank's local tokens."""
    m = cfg.mla
    if m.q_lora:
        qa = layers.rms_norm(shards.mm(ranks, x, params["wq_a"]),
                             shards.param(ranks, params["q_a_norm"]))
        q = shards.einsum(ranks, "bsl,lhe->bshe", qa, params["wq_b"])
    else:
        q = shards.einsum(ranks, "bsd,dhe->bshe", x, params["wq"])
    q_nope, q_rope = q[..., : m.d_nope], q[..., m.d_nope:]
    return q_nope, layers.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_kv_latent(params, cfg: ModelConfig, x, positions, ranks=None):
    """The compressed latent (B, S, kv_lora) and the shared rotary key
    (B, S, d_rope); with `ranks`, of each rank's local tokens."""
    m = cfg.mla
    kv = shards.mm(ranks, x, params["wkv_a"])                  # (B, S, kv_lora + d_rope)
    c_kv = layers.rms_norm(kv[..., : m.kv_lora], shards.param(ranks, params["kv_a_norm"]))
    k_rope = layers.apply_rope(kv[..., m.kv_lora:][:, :, None, :], positions,
                               cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_attention_with_cache(params, cfg: ModelConfig, x, positions, causal=True):
    """Training / prefill MLA: the latent expanded to per-head keys and
    values, then `_sdpa` (q and k d_nope + d_rope wide, v d_v wide; the
    rotary key is one head, broadcast to all).  Returns (out (B, S, D),
    c_kv, k_rope): the latents for the cache.  A DTensor x split along its
    sequence runs on each rank's tokens, as `attention_with_kv` does."""
    m = cfg.mla
    ranks = shards.tokens(x)
    x, positions = shards.enter(ranks, x), _token_positions(ranks, positions)
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(params, cfg, x, positions, ranks)
    c_kv, k_rope = _mla_kv_latent(params, cfg, x, positions, ranks)
    kv = shards.einsum(ranks, "bsl,lhe->bshe", c_kv, params["wkv_b"])  # (B, S, H, nope + v)
    k_nope, v = kv[..., : m.d_nope], kv[..., m.d_nope:]
    k_rope_h = k_rope[:, :, None, :].expand(b, s, cfg.n_heads, m.d_rope)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    out = _sdpa(*(shards.leave(ranks, t) for t in (q, k, v)), causal)
    return (_out_proj(out, params["wo"]),) + tuple(shards.leave(ranks, t) for t in (c_kv, k_rope))


def mla_attention(params, cfg: ModelConfig, x, positions, causal=True):
    """Training / prefill MLA (`mla_attention_with_cache` without the latents)."""
    return mla_attention_with_cache(params, cfg, x, positions, causal)[0]


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device=None) -> dict:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_seq, m.kv_lora), dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_seq, m.d_rope), dtype=dtype, device=device)}


def mla_decode_attention(params, cfg: ModelConfig, x, cache: dict, pos: torch.Tensor,
                         rope_positions=None):
    """Absorbed MLA decode: attention runs in the kv_lora-wide latent space
    (a token's cache is kv_lora + d_rope values); `wkv_b`'s key half is
    absorbed into the query, its value half into the output.  Returns
    (out (B, 1, D), new cache).

    A DTensor cache runs on each rank's local rows (`shards.Ranks`; a
    decode step, so no gradient): the heads on the block `wkv_b` splits
    them in, the latent cache on the block of the sequence it holds.  The
    query's latent and rotary parts are gathered over the heads, each
    sequence block's scores gathered for the softmax, each block's share
    of the output latent all-reduced, and the output projection's sum over
    the heads all-reduced (Megatron's), where DTensor's own propagation
    would flatten a split head dim.  The new cache keeps the cache's
    layout.  On plain tensors every `shards` call is the identity."""
    m = cfg.mla
    ranks = shards.Ranks(x) if getattr(cache["c_kv"], "device_mesh", None) is not None else None
    lay = _mla_decode_layouts(ranks, params, cache)
    p = {k: shards.local(ranks, params[k], lay["heads"]) for k in ("wq", "wq_b", "wkv_b")
         if k in params}
    p.update({k: shards.param(ranks, params[k]) for k in ("wq_a", "q_a_norm", "wkv_a", "kv_a_norm")
              if k in params})
    x, pos = shards.enter(ranks, x), shards.enter(ranks, pos)
    rp = pos if rope_positions is None else shards.enter(ranks, rope_positions)
    q_nope, q_rope = _mla_q(p, cfg, x, rp)                     # (B, 1, H, .)
    c_new, r_new = _mla_kv_latent(p, cfg, x, rp)               # (B, 1, L), (B, 1, R)
    c_kv, k_rope = (shards.enter(ranks, cache[k], lay["seq"]) for k in ("c_kv", "k_rope"))
    sk = cache["c_kv"].shape[1]
    oh = shards.relayout(ranks, F.one_hot(pos[:, 0].to(torch.int64), sk).to(c_kv.dtype),
                         lay["rows"], lay["seq"])              # (B, S_max)
    c_cache = c_kv + oh[:, :, None] * c_new
    r_cache = k_rope + oh[:, :, None] * r_new
    wk_b, wv_b = p["wkv_b"][..., : m.d_nope], p["wkv_b"][..., m.d_nope:]
    q_lat = shards.relayout(ranks, torch.einsum("bqhe,lhe->bqhl", q_nope, wk_b),
                            lay["on_heads"], lay["rows"])      # (B, 1, H, L)
    q_rope = shards.relayout(ranks, q_rope, lay["on_heads"], lay["rows"])
    scores = (torch.einsum("bqhl,bsl->bhqs", q_lat, c_cache)
              + torch.einsum("bqhe,bse->bhqs", q_rope, r_cache)).to(torch.float32)
    scores = shards.relayout(ranks, scores, lay["on_seq"], lay["rows"]) \
        / _sqrt_hd(m.d_nope + m.d_rope)
    valid = torch.arange(sk, device=x.device)[None, :] <= pos  # (B, S_max)
    scores = torch.where(valid[:, None, None, :], scores, torch.full((), -1e30, device=x.device))
    probs = shards.relayout(ranks, torch.softmax(scores, dim=-1).to(c_cache.dtype),
                            lay["rows"], lay["on_seq"])
    o_lat = shards.reduce(ranks, torch.einsum("bhqs,bsl->bqhl", probs, c_cache),
                          lay["o_lat"])                        # (B, 1, H, L)
    o = torch.einsum("bqhl,lhe->bqhe", shards.relayout(ranks, o_lat, lay["rows"], lay["on_heads"]),
                     wv_b)                                     # (B, 1, H, d_v)
    y = shards.reduce(ranks, torch.einsum("bshe,hed->bsd", o,
                                          shards.local(ranks, params["wo"], lay["wo"])), lay["y"])
    return shards.leave(ranks, y), {k: shards.leave(ranks, t, lay["seq"], lay[k])
                                    for k, t in (("c_kv", c_cache), ("k_rope", r_cache))}


def _mla_decode_layouts(ranks, params, cache: dict) -> dict:
    """The placements of `mla_decode_attention`'s local blocks (None each
    on plain tensors): the batch rows; the heads as `wkv_b` splits them;
    the cache's sequence split; (B, 1, H, .) on the heads and (B, H, 1, S)
    on the sequence; `wo` on its heads; the partial sums of the output
    latent and of the output; the caches' own layouts."""
    names = ("rows", "heads", "seq", "on_heads", "on_seq", "wo", "o_lat", "y", "c_kv", "k_rope")
    if ranks is None:
        return dict.fromkeys(names)
    from torch.distributed.tensor import Partial, Shard
    rows = ranks.rows
    heads = ranks.layout(params["wkv_b"], 1, batch=False)      # (L, H, e) split by heads
    seq = ranks.layout(cache["c_kv"], 1)                       # (B, S, L) split by positions
    on_heads = [Shard(2) if h == Shard(1) else r for r, h in zip(rows, heads)]
    on_seq = [Shard(3) if p == Shard(1) and r != Shard(0) else r for r, p in zip(rows, seq)]
    return dict(zip(names, (
        rows, heads, seq, on_heads, on_seq,
        [Shard(0) if h == Shard(1) else h for h in heads],
        [Partial() if p == Shard(3) else p for p in on_seq],
        [Partial() if p == Shard(2) else p for p in on_heads],
        shards.as_dtensor(cache["c_kv"], ranks.mesh).placements,
        shards.as_dtensor(cache["k_rope"], ranks.mesh).placements)))
