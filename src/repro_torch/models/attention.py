"""Attention: GQA / MHA with bias, qk-norm and the RoPE variants.

The port of `repro.models.attention` up to MLA (DeepSeek's latent
attention is not ported yet: ROADMAP Queue 1 item 2.1).  Activations are
(B, S, D); projection weights keep the head axis explicit, wq (D, H, hd),
wo (H, hd, D), as in the reference.  Scores are computed in the inputs'
dtype, then taken to f32 for the scale, the mask (-1e30) and the softmax;
the probabilities go back to the values' dtype.  Sequences whose score
tile exceeds `_CHUNKED_THRESHOLD` take the chunked online softmax
(`_sdpa_chunked`), with the reference's chunk sizes and its running max,
denominator and accumulator in f32.  No library attention kernel is used.

Decode: a layer's cache is {'k': (B, S_max, K, hd), 'v': ...}; a decode
step writes its key and value into slot `pos` as the reference does,
``cache + one_hot(pos) * new``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import layers
from .config import ModelConfig


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


def _qkv(params, cfg: ModelConfig, x, positions):
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    k = torch.einsum("bsd,dke->bske", x, params["wk"])
    v = torch.einsum("bsd,dke->bske", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"])
        k = layers.rms_norm(k, params["k_norm"])
    return _apply_positional(cfg, q, positions), _apply_positional(cfg, k, positions), v


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


def _sdpa_dense(q, k, v, causal: bool, q_offset=0):
    b, sq, h, hd = q.shape
    sk, kh, hd_v = v.shape[1], v.shape[2], v.shape[3]
    rep = h // kh
    q = q.reshape(b, sq, kh, rep, hd)
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

    def q_block(q_blk, qi: int):
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
            outs.append(checkpoint(q_block, qr[:, qi], qi, use_reentrant=False))
        else:
            outs.append(q_block(qr[:, qi], qi))
    out = torch.stack(outs, dim=1).reshape(b, sq, h, hd_v)
    if pad_q:
        out = out[:, :sq0]
    return out.to(v.dtype)


def _sdpa(q, k, v, causal: bool, q_offset=0):
    """q, k (B, S, ., hd), v (B, Sk, K, hd_v) with GQA head repetition; long
    sequences take the chunked online softmax."""
    sq, sk = q.shape[1], v.shape[1]
    if sq * sk > _CHUNKED_THRESHOLD and sq > 1:
        return _sdpa_chunked(q, k, v, causal, q_offset)
    return _sdpa_dense(q, k, v, causal, q_offset)


def attention(params, cfg: ModelConfig, x, positions, causal=True):
    """Full-sequence attention (training / prefill)."""
    q, k, v = _qkv(params, cfg, x, positions)
    return torch.einsum("bshe,hed->bsd", _sdpa(q, k, v, causal), params["wo"])


def attention_with_kv(params, cfg: ModelConfig, x, positions, causal=True):
    """Prefill variant: also returns the (k, v) tensors for the cache."""
    q, k, v = _qkv(params, cfg, x, positions)
    return torch.einsum("bshe,hed->bsd", _sdpa(q, k, v, causal), params["wo"]), k, v


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
    qr = q.reshape(b, 1, kh, rep, cfg.hd)
    scores = torch.einsum("bqkre,bske->bkrqs", qr, k_cache).to(torch.float32)
    scores = scores / _sqrt_hd(cfg.hd)
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.full((), -1e30, device=x.device))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkrqs,bske->bqkre", probs, v_cache).reshape(b, 1, cfg.n_heads, cfg.hd)
    return torch.einsum("bshe,hed->bsd", out, params["wo"]), {"k": k_cache, "v": v_cache}
