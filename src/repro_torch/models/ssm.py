"""State-space blocks: Mamba-1 (falcon-mamba) and Mamba-2/SSD (zamba2).

The port of `repro.models.ssm`.  Both variants keep the reference's
*chunked* forms, in its order of operations:

* mamba1: a Python loop over chunks of `SSMConfig.chunk` tokens (the
  reference's `lax.scan`), and within a chunk `associative_scan`, the
  odd/even recursion of `jax.lax.associative_scan` in torch ops over the
  chunk axis (about log2(Q) levels, the same combination tree); a
  remainder chunk when the sequence is not a multiple of the chunk.  A
  chunk's scan does not read the carried state, so the scans of
  `SCAN_GROUP` whole chunks run as one batch of ops (the same elementwise
  ops on the same values: the same bits), and only the carry's
  combination and the output product walk the chunks one at a time; a
  long sequence dispatches a fraction of the ops (what a dry run's trace
  pays by the op).
* mamba2: the SSD block form -- intra-chunk decay products, the carried
  state's contribution and the state update -- with each three-operand
  einsum taken as the pairwise products JAX's contraction path picks (an
  elementwise product, then a batched matmul keeping the reference's sum
  axes), so no (B, Q, Q, P, hd) or (B, Q, P, hd, n) tensor is formed.

Casts follow the reference: the causal conv sums in the input's dtype and
activates in f32; `dt` is `logaddexp(x, 0)` (JAX's softplus) in f32; the
scan, `D` and the gate run in f32; Mamba-2 casts to the model dtype before
its gated RMS norm.  `A_log`, `D` and `dt_bias` are f32 leaves in any
model dtype.  No library conv or scan kernel is used.

A placed block (DTensor x, `_ssm_on_shards`) runs on each rank's local
rows.  A block without a state runs in `_mamba1_channels` /
`_mamba2_channels`, with the same scan (`_mamba1_scan`, `_ssd_scan`):
under a 'model' split of the channel params (the TP policy) on each
rank's block of the channels throughout, Megatron's split of the block,
and on whole rows where nothing splits them.  A decode, and Mamba-2's
block of head dims, run `mamba1` / `mamba2` on the state's block.

The decode state is a dict ``{"h": f32 (B, di, n) | (B, P, hd, n),
"conv_tail": (B, K-1, C) in the model dtype}`` -- the reference's
`SSMState` NamedTuple as the dict its `_asdict()` gives, so the port's
tree helpers (`tree_paths`, `stack_trees`, `_reset_slot`), which walk
nested dicts, carry it like any cache.  A decode step is a call with S = 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers, shards
from .config import ModelConfig


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or max(cfg.d_model // 16, 1)


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


# --- params -------------------------------------------------------------------

def init_ssm(generator, cfg: ModelConfig, dtype, device=None) -> dict:
    s = cfg.ssm
    d, di, n = cfg.d_model, d_inner(cfg), s.d_state
    init = lambda shape, std=0.02: layers.normal_init(generator, shape, std=std,  # noqa: E731
                                                      dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    if s.kind == "mamba1":
        r = _dt_rank(cfg)
        return {
            "in_proj": init((d, 2 * di)),
            "conv_w": init((s.d_conv, di), 0.2),
            "conv_b": torch.zeros((di,), dtype=dtype, device=device),
            "x_proj": init((di, r + 2 * n)),
            "dt_proj": init((r, di), r ** -0.5),
            "dt_bias": torch.log(torch.expm1(torch.full((di,), 0.01, **f32))),
            "A_log": torch.log(torch.arange(1, n + 1, **f32).tile((di, 1))),
            "D": torch.ones((di,), **f32),
            "out_proj": init((di, d)),
        }
    # mamba2: heads of size headdim, a scalar A per head, B / C shared (1 group)
    p_heads = di // s.headdim
    conv_ch = di + 2 * n    # the conv runs over x, B and C
    return {
        "in_proj": init((d, 2 * di + 2 * n + p_heads)),
        "conv_w": init((s.d_conv, conv_ch), 0.2),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(torch.full((p_heads,), 0.01, **f32))),
        "A_log": torch.log(torch.linspace(1.0, 16.0, p_heads, **f32)),
        "D": torch.ones((p_heads,), **f32),
        "norm": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": init((di, d)),
    }


# --- causal depthwise conv ------------------------------------------------------

def causal_conv(x, w, b, tail=None):
    """x (B, S, C), w (K, C), b (C,); tail (B, K-1, C): the previous tokens'
    inputs.  The shifted sum ``sum_i xp[:, i:i+S] * w[i] + b`` in x's dtype,
    then SiLU in f32.  Returns (y (B, S, C), new tail)."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)                      # (B, S+K-1, C)
    s = x.shape[1]
    y = sum(xp[:, i: i + s, :] * w[i] for i in range(k)) + b
    new_tail = xp[:, -(k - 1):, :] if k > 1 else tail
    return F.silu(y.to(torch.float32)).to(x.dtype), new_tail


def softplus(x):
    """`jax.nn.softplus`: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# --- state --------------------------------------------------------------------

def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    s = cfg.ssm
    di = d_inner(cfg)
    if s.kind == "mamba1":
        h_shape, ch = (batch, di, s.d_state), di
    else:
        h_shape, ch = (batch, di // s.headdim, s.headdim, s.d_state), di + 2 * s.d_state
    return {"h": torch.zeros(h_shape, dtype=torch.float32, device=device),
            "conv_tail": torch.zeros((batch, s.d_conv - 1, ch), dtype=dtype, device=device)}


# --- mamba1 ---------------------------------------------------------------------

def _combine(left, right):
    """The selective scan's operator: (a_l, b_l) then (a_r, b_r)."""
    return left[0] * right[0], right[0] * left[1] + right[1]


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along axis 1 (len(even) is len(odd)
    or one more)."""
    n_odd = odd.shape[1]
    pairs = torch.stack([even[:, :n_odd], odd], dim=2).flatten(1, 2)
    if even.shape[1] == n_odd:
        return pairs
    return torch.cat([pairs, even[:, n_odd:]], dim=1)


def associative_scan(a, bx):
    """The inclusive scan of `_combine` over axis 1 of (a, bx), in
    `jax.lax.associative_scan`'s recursion: adjacent pairs combined, the
    half-length scan, then the even positions from the odd results."""
    n = a.shape[1]
    if n < 2:
        return a, bx
    odd = associative_scan(*_combine((a[:, 0:-1:2], bx[:, 0:-1:2]), (a[:, 1::2], bx[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]), (a[:, 2::2], bx[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], bx[:, 2::2]))
    even = [torch.cat([t[:, :1], e], dim=1) for t, e in zip((a, bx), even)]
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


# whole chunks whose scans run as one batch of ops
SCAN_GROUP = 4


def _mamba1_scan_chunks(h0, a, bx, q: int):
    """The selective scan of the g chunks of q tokens in a, bx (B, g*q, d,
    n) from the state h0 (B, d, n): each chunk's `associative_scan` (all g
    as one batch (B*g, q, d, n)), then its states from the carried one.
    Returns the chunks' states [(B, q, d, n)] and the last one's end."""
    b, gq = a.shape[0], a.shape[1]
    g = gq // q
    aa, bb = (t.reshape((b, g, q) + tuple(t.shape[2:]))
              for t in associative_scan(*(t.reshape((b * g, q) + tuple(t.shape[2:]))
                                          for t in (a, bx))))
    hs = []
    for j in range(g):
        h = bb[:, j] + aa[:, j] * h0[:, None]
        h0 = h[:, -1]
        hs.append(h)
    return hs, h0


def mamba1(params, cfg: ModelConfig, x, state: dict | None = None, ranks=None, layout=None):
    """x (B, S, D) -> (y (B, S, D), new state).  Chunked selective scan.
    With `ranks` (`_ssm_on_shards`: a decode, and Mamba-2's head-dim block
    without a state), x is a rank's local rows and the state its block in
    `layout`, over which the scan runs."""
    s = cfg.ssm
    b, seq, _ = x.shape
    di, n, r = d_inner(cfg), s.d_state, _dt_rank(cfg)
    xz = shards.mm(ranks, x, params["in_proj"])
    xs, z = xz[..., :di], xz[..., di:]
    tail = state["conv_tail"] if state is not None else None
    xs, new_tail = causal_conv(xs, shards.param(ranks, params["conv_w"]),
                               shards.param(ranks, params["conv_b"]), tail)

    dbc = shards.mm(ranks, xs, params["x_proj"])                    # (B, S, r+2n)
    dt = softplus(shards.mm(ranks, dbc[..., :r], params["dt_proj"]).to(torch.float32)
                  + shards.param(ranks, params["dt_bias"]))         # (B, S, di)
    bmat = dbc[..., r: r + n].to(torch.float32)                     # (B, S, n)
    cmat = dbc[..., r + n:].to(torch.float32)                       # (B, S, n)
    a_cont = -torch.exp(shards.param(ranks, params["A_log"]))       # (di, n)

    q = min(s.chunk, seq)
    xf32 = xs.to(torch.float32)
    dims = {0: 0, 1: 2}         # the state (B, di, n)'s dims in (B, S, di)
    dt_h, x_h = shards.block(ranks, dt, layout, dims), shards.block(ranks, xf32, layout, dims)
    a_h = shards.block(ranks, a_cont, layout, {1: 0})
    bmat, cmat = (shards.shared(ranks, t, layout) for t in (bmat, cmat))
    h = state["h"] if state is not None else torch.zeros((b, x_h.shape[2], n),
                                                          dtype=torch.float32, device=x.device)
    ys, h = _mamba1_scan(h, dt_h, x_h, a_h, bmat, cmat, q)
    # D and the gate on the block (elementwise: the same bits as on whole
    # rows), gathered in the model dtype
    d_h = shards.block(ranks, shards.param(ranks, params["D"]), layout, {1: 0})
    z_h = shards.block(ranks, z, layout, dims).to(torch.float32)
    y = ((ys + d_h * x_h) * F.silu(z_h)).to(x.dtype)
    y = shards.gather(ranks, y, layout, dims)
    return shards.mm(ranks, y, params["out_proj"]), {"h": h, "conv_tail": new_tail}


def _mamba1_scan(h, dt, xf, a_cont, bmat, cmat, q: int):
    """The chunked selective scan of dt, x (B, S, d) f32 against A (d, n)
    and B, C (B, S, n) from the state h (B, d, n): the chunks `SCAN_GROUP`
    at a time, then the remainder chunk.  -> (y (B, S, d), the last
    state)."""
    seq = dt.shape[1]
    ys = []
    whole, step = seq - seq % q, q * SCAN_GROUP
    for start in list(range(0, whole, step)) + ([whole] if whole < seq else []):
        stop = min(start + step, whole) if start < whole else seq
        part = slice(start, stop)
        dt_q, x_q = dt[:, part], xf[:, part]
        a = torch.exp(dt_q[..., None] * a_cont)                     # (B, g*Q, d, n)
        bx = (dt_q * x_q)[..., None] * bmat[:, part, None, :]       # (B, g*Q, d, n)
        hs, h = _mamba1_scan_chunks(h, a, bx, min(q, stop - start))
        for j, hs_q in enumerate(hs):
            ys.append(torch.einsum("bqdn,bqn->bqd", hs_q,
                                   cmat[:, start + j * q: start + (j + 1) * q]))
    return torch.cat(ys, dim=1), h


def _columns(t, spans):
    """t's last-dim entries [a, a + n) for each (a, n) of `spans`, in
    order: one slice (a view) where they are adjacent, as on whole rows."""
    runs = []
    for a, n in spans:
        if runs and sum(runs[-1]) == a:
            runs[-1] = (runs[-1][0], runs[-1][1] + n)
        else:
            runs.append((a, n))
    parts = [t[..., a:a + n] for a, n in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _mamba1_channels(params, cfg: ModelConfig, x, ranks, layout):
    """`mamba1` of a rank's whole rows x (B, S, D), without a state, on its
    block of di in `layout` throughout (whole rows where `layout` splits
    nothing), as Megatron splits a block: x @
    in_proj's columns of its xs and z channels (in_proj gathered, a
    (D, 2 di) weight, where its output would be (B, S, 2 di)); the conv,
    dt_proj's columns, dt_bias, A, D and the gate on the block; x_proj and
    out_proj row-parallel (their partial products all-reduced).  A
    whole-row activation every block reads (x, x_proj's output) gets its
    gradient all-reduced (`shards.Ranks.shared`).  -> (y (B, S, D) whole
    rows, {"h": (B, di_l, n), "conv_tail": (B, K-1, di_l)} on the block)."""
    s = cfg.ssm
    seq = x.shape[1]
    di, n, r = d_inner(cfg), s.d_state, _dt_rank(cfg)
    c0, cl = ranks.chunk(di, layout, 1)
    xz = ranks.shared(x, layout) @ _columns(ranks.read(params["in_proj"], layout),
                                           ((c0, cl), (di + c0, cl)))
    xs, z = xz[..., :cl], xz[..., cl:]
    on = ranks.split(layout, 0)
    xs, new_tail = causal_conv(xs, ranks.local(params["conv_w"], ranks.split(layout, 1)),
                               ranks.local(params["conv_b"], on))
    dbc = ranks.shared(ranks.reduce(xs @ ranks.local(params["x_proj"], on),
                                    ranks.partial(layout)), layout)         # (B, S, r+2n)
    dt = softplus((dbc[..., :r] @ ranks.local(params["dt_proj"], ranks.split(layout, 1)))
                  .to(torch.float32) + ranks.local(params["dt_bias"], on))  # (B, S, di_l)
    bmat, cmat = dbc[..., r: r + n].to(torch.float32), dbc[..., r + n:].to(torch.float32)
    xf32 = xs.to(torch.float32)
    h = torch.zeros((x.shape[0], cl, n), dtype=torch.float32, device=x.device)
    ys, h = _mamba1_scan(h, dt, xf32, -torch.exp(ranks.local(params["A_log"], on)), bmat,
                         cmat, min(s.chunk, seq))
    y = ((ys + ranks.local(params["D"], on) * xf32) * F.silu(z.to(torch.float32))).to(x.dtype)
    out = ranks.reduce(y @ ranks.local(params["out_proj"], on), ranks.partial(layout))
    return out, {"h": h, "conv_tail": new_tail}


def mamba1_decode(params, cfg: ModelConfig, x, state: dict):
    """Single-token recurrent step. x (B, 1, D)."""
    return mamba1(params, cfg, x, state)


# --- mamba2 (SSD) ---------------------------------------------------------------

def _ssd_chunk(h, dt_q, dta_q, b_q, c_q, x_q):
    """One SSD chunk.  h (B, P, hd, n); dt_q, dta_q (B, Q, P); b_q, c_q
    (B, Q, n); x_q (B, Q, P, hd).  Returns (h', y (B, Q, P, hd))."""
    qq = dt_q.shape[1]
    cum = torch.cumsum(dta_q, dim=1)                                # (B, Q, P)
    # intra-chunk: Y_ij = C_i.B_j * exp(cum_i - cum_j) * dt_j  (i >= j); the
    # exponent is formed before the mask, as in the reference
    decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])      # (B, Q, Q, P)
    tri = torch.tril(torch.ones((qq, qq), dtype=torch.bool, device=h.device))
    cb = torch.einsum("bin,bjn->bij", c_q, b_q)                     # (B, Q, Q)
    w = torch.where(tri[None, :, :, None], cb[..., None] * decay,
                    torch.zeros((), dtype=decay.dtype, device=h.device))
    # "bijp,bjp,bjpe->bipe": (x * dt) first, then the sum over j as a
    # matmul batched over (b, p)
    xdt = x_q * dt_q[..., None]                                     # (B, Q, P, hd)
    y_intra = torch.matmul(w.permute(0, 3, 1, 2), xdt.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
    # inter-chunk, "bin,bpen,bip->bipe": h . C over n first, then exp(cum)
    b, p, e, n = h.shape
    hc = torch.matmul(h.reshape(b, p * e, n), c_q.transpose(1, 2)).reshape(b, p, e, qq)
    y_inter = hc.permute(0, 3, 1, 2) * torch.exp(cum)[..., None]
    # state update: h' = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) dt_j B_j x_j;
    # "bjp,bjn,bjpe->bpen": the (j, n, p) outer product first, then the sum
    # over j as a matmul batched over (b, p)
    end = cum[:, -1:, :]                                            # (B, 1, P)
    dec_j = torch.exp(end - cum)                                    # (B, Q, P)
    bdt = b_q[..., :, None] * (dec_j * dt_q)[..., None, :]          # (B, Q, n, P)
    upd = torch.matmul(bdt.permute(0, 3, 2, 1), x_q.permute(0, 2, 1, 3))   # (B, P, n, hd)
    h_new = torch.exp(end[:, 0, :])[:, :, None, None] * h + upd.transpose(2, 3)
    return h_new, y_intra + y_inter


def mamba2(params, cfg: ModelConfig, x, state: dict | None = None, ranks=None, layout=None):
    """Chunked SSD. x (B, S, D) -> (y, new state); `ranks` and `layout`
    as in `mamba1`."""
    s = cfg.ssm
    b, seq, _ = x.shape
    di, n, hd = d_inner(cfg), s.d_state, s.headdim
    p = di // hd
    proj = shards.mm(ranks, x, params["in_proj"])                   # (B, S, 2di+2n+P)
    z, xbc, dt_raw = proj[..., :di], proj[..., di: 2 * di + 2 * n], proj[..., -p:]
    tail = state["conv_tail"] if state is not None else None
    xbc, new_tail = causal_conv(xbc, shards.param(ranks, params["conv_w"]),
                                shards.param(ranks, params["conv_b"]), tail)
    xs = xbc[..., :di]
    bmat = xbc[..., di: di + n].to(torch.float32)                   # (B, S, n)
    cmat = xbc[..., di + n:].to(torch.float32)                      # (B, S, n)
    dt = softplus(dt_raw.to(torch.float32) + shards.param(ranks, params["dt_bias"]))  # (B, S, P)
    a_head = -torch.exp(shards.param(ranks, params["A_log"]))       # (P,)
    dta = dt * a_head                                               # (B, S, P)

    q = min(s.chunk, seq)
    xh = xs.to(torch.float32).reshape(b, seq, p, hd)
    heads, chans = {0: 0, 1: 2}, {0: 0, 1: 2, 2: 3}   # the state (B, P, hd, n)'s dims
    dt_h, dta_h = (shards.block(ranks, t, layout, heads) for t in (dt, dta))
    xh_h = shards.block(ranks, xh, layout, chans)
    bmat, cmat = (shards.shared(ranks, t, layout) for t in (bmat, cmat))
    h = state["h"] if state is not None else torch.zeros(
        (b,) + tuple(xh_h.shape[2:]) + (n,), dtype=torch.float32, device=x.device)
    ys, h = _ssd_scan(h, dt_h, dta_h, bmat, cmat, xh_h, q)
    # D and the f32 gate on the block (elementwise: the same bits as on
    # whole rows), gathered in the model dtype for the norm over di
    d_h = shards.block(ranks, shards.param(ranks, params["D"]), layout, {1: 0})
    z_h = shards.block(ranks, z.reshape(b, seq, p, hd), layout, chans).to(torch.float32)
    y = ((ys + d_h[:, None] * xh_h) * F.silu(z_h)).to(x.dtype)
    y = shards.gather(ranks, y, layout, chans).reshape(b, seq, di)
    y = layers.rms_norm(y, shards.param(ranks, params["norm"]))
    return shards.mm(ranks, y, params["out_proj"]), {"h": h, "conv_tail": new_tail}


def _ssd_scan(h, dt, dta, bmat, cmat, xh, q: int):
    """SSD's chunks (`_ssd_chunk`), then the remainder chunk, of dt, dta
    (B, S, P), B, C (B, S, n) and x (B, S, P, hd) from the state h (B, P,
    hd, n).  -> (y (B, S, P, hd), the last state)."""
    ys = []
    for start in range(0, dt.shape[1], q):
        part = slice(start, start + q)
        h, y_q = _ssd_chunk(h, dt[:, part], dta[:, part], bmat[:, part], cmat[:, part],
                            xh[:, part])
        ys.append(y_q)
    return torch.cat(ys, dim=1), h


def _mamba2_channels(params, cfg: ModelConfig, x, ranks, layout):
    """`mamba2` of a rank's whole rows x (B, S, D), without a state, on its
    block of heads in `layout` throughout (whole rows where `layout` splits
    nothing), as `_mamba1_channels`: x @
    in_proj's columns of its z, x and dt channels and of B and C (whole,
    which every block reads: their conv runs on every rank); D, the f32
    gate and the gated RMS norm on the block, the norm's sum of squares
    over di all-reduced (f32, as the reference's mean); out_proj
    row-parallel.  -> (y (B, S, D) whole rows, {"h": (B, P_l, hd, n),
    "conv_tail": (B, K-1, di + 2n) whole rows})."""
    s = cfg.ssm
    b, seq, _ = x.shape
    di, n, hd = d_inner(cfg), s.d_state, s.headdim
    h0, hl = ranks.chunk(di // hd, layout, 1)
    c0, cl = h0 * hd, hl * hd
    # in_proj (D, 2di+2n+P): z | x B C | dt
    cols = ((c0, cl), (di + c0, cl), (2 * di, 2 * n), (2 * di + 2 * n + h0, hl))
    proj = ranks.shared(x, layout) @ _columns(ranks.read(params["in_proj"], layout), cols)
    z, xbc, dt_raw = proj[..., :cl], proj[..., cl:2 * cl + 2 * n], proj[..., -hl:]
    conv = ((c0, cl), (di, 2 * n))                        # conv (K, di+2n): x B C
    xbc, tail = causal_conv(xbc, *(_columns(ranks.read(params[k], layout), conv)
                                   for k in ("conv_w", "conv_b")))
    xs = xbc[..., :cl]
    bmat = xbc[..., cl: cl + n].to(torch.float32)
    cmat = xbc[..., cl + n:].to(torch.float32)
    on = ranks.split(layout, 0)
    dt = softplus(dt_raw.to(torch.float32) + ranks.local(params["dt_bias"], on))   # (B, S, P_l)
    dta = dt * -torch.exp(ranks.local(params["A_log"], on))
    xh = xs.to(torch.float32).reshape(b, seq, hl, hd)
    h = torch.zeros((b, hl, hd, n), dtype=torch.float32, device=x.device)
    ys, h = _ssd_scan(h, dt, dta, bmat, cmat, xh, min(s.chunk, seq))
    y = ((ys + ranks.local(params["D"], on)[:, None] * xh)
         * F.silu(z.reshape(b, seq, hl, hd).to(torch.float32))).to(x.dtype).reshape(b, seq, cl)
    # the gated RMS norm over di, its sum of squares summed over the blocks
    # (each block reads the sum: `shared`)
    y = layers.rms_norm(y, ranks.local(params["norm"], on), mean_sq=lambda x32: ranks.shared(
        ranks.reduce(torch.sum(torch.square(x32), dim=-1, keepdim=True),
                     ranks.partial(layout)), layout) / di)
    out = ranks.reduce(y @ ranks.local(params["out_proj"], on), ranks.partial(layout))
    # the tail's x channels gathered beside B's and C's
    whole = ranks.relayout(tail[..., :cl], ranks.rows_split(layout, 2), ranks.rows)
    return out, {"h": h, "conv_tail": torch.cat([whole, tail[..., cl:]], dim=-1)}


def ssm_block(params, cfg: ModelConfig, x, state: dict | None = None):
    if getattr(x, "device_mesh", None) is not None:
        return _ssm_on_shards(params, cfg, x, state)
    fn = mamba1 if cfg.ssm.kind == "mamba1" else mamba2
    return fn(params, cfg, x, state)


def _scan_layout(ranks, cfg: ModelConfig) -> list:
    """The layout a scan without a given state (training, prefill) runs
    in, the state's (B, di, n) / (B, P, hd, n) block: the rows' batch
    split, and 'model', where it splits no rows, on the channels the TP
    policy splits the SSM's channel params along (`parallel.sharding`:
    Mamba-1's `dt_proj` / `dt_bias` / `A_log` di, Mamba-2's `dt_bias` / `D`
    heads), where they divide over it.  Mamba-2's heads that do not divide
    leave those params whole; the scan then takes the state's other
    channel dim, its head dims, where they divide (the dim the state rule,
    `parallel.sharding._cache_spec`, splits in such a state), and runs
    whole where neither does.  d_state is never split."""
    from torch.distributed.tensor import Replicate, Shard
    layout = [r if r == Shard(0) else Replicate() for r in ranks.rows]
    names = ranks.mesh.mesh_dim_names or ()
    if "model" not in names or ranks.rows[names.index("model")].is_shard():
        return layout
    m = names.index("model")
    n = ranks.mesh.size(m)
    s, di = cfg.ssm, d_inner(cfg)
    chans = [(1, di)] if s.kind == "mamba1" else [(1, di // s.headdim), (2, s.headdim)]
    dims = [d for d, size in chans if size % n == 0 and size >= n]
    if n > 1 and dims:
        layout[m] = Shard(dims[0])
    return layout


def _ssm_on_shards(params, cfg: ModelConfig, x, state: dict | None):
    """`ssm_block` of a DTensor x on each rank's local rows
    (`shards.Ranks`).  Without a state (training, prefill), on the block of
    channels `_scan_layout` gives: a block of di / heads (or whole rows)
    throughout (`_mamba1_channels`, `_mamba2_channels`), in which the new
    state is returned; Mamba-2's block of head dims (no weight splits di
    so) only in the scan and the gate (`mamba2`), the projections, conv
    and norm on whole rows.  With a state (decode), the scan and the gate
    on the state's block of channels (Mamba-1's di, Mamba-2's heads or
    head dims; a state split over another dim is gathered for it), so a
    state never moves whole (`mamba1`, `mamba2`); the new state keeps the
    state's layout."""
    from torch.distributed.tensor import Replicate, Shard
    ranks = shards.Ranks(x)
    mesh = ranks.mesh
    if state is None:
        layout = _scan_layout(ranks, cfg)
        tail = ranks.rows
        if Shard(2) in layout:
            y, new = mamba2(params, cfg, ranks.enter(x), None, ranks, layout)
        elif cfg.ssm.kind == "mamba1":
            y, new = _mamba1_channels(params, cfg, ranks.enter(x), ranks, layout)
            tail = ranks.rows_split(layout, 2)
        else:
            y, new = _mamba2_channels(params, cfg, ranks.enter(x), ranks, layout)
        return ranks.leave(y), {"h": ranks.leave(new["h"], layout),
                                "conv_tail": ranks.leave(new["conv_tail"], tail)}
    h, tail = (shards.as_dtensor(state[k], mesh) for k in ("h", "conv_tail"))
    chans = (1,) if cfg.ssm.kind == "mamba1" else (1, 2)
    layout = [r if r == Shard(0) else p if isinstance(p, Shard) and p.dim in chans
              else Replicate() for r, p in zip(ranks.rows, h.placements)]
    local = {"h": ranks.enter(h, layout), "conv_tail": ranks.enter(tail)}
    fn = mamba1 if cfg.ssm.kind == "mamba1" else mamba2
    y, new = fn(params, cfg, ranks.enter(x), local, ranks, layout)
    return ranks.leave(y), {"h": ranks.leave(new["h"], layout, h.placements),
                            "conv_tail": ranks.leave(new["conv_tail"], dst=tail.placements)}
