"""Plain PyTorch version of the one-op training step (encode -> MLP heads).

The port of `repro.kernels.fused_step.ref`: ONE function of

    points, SH(dirs)  ->  hash-encode(density), hash-encode(color)
                      ->  density MLP (2-layer), color MLP (3-layer)
                      ->  (density head out (N, 1+geo), raw rgb (N, 3))

composed from the fused path's shared corner geometry and the plain MLPs,
with no new math.  `dedup_weight_matrix` / `encode_block_dedup` are the
reference's oracle for the TPU kernel's segment-sum dedup (out = W @ T[uniq]
per block and level); the CUDA kernel gathers each corner directly instead,
which computes the same function, so they serve the tests only.

`bwd_table_stream` lays out one grid's table-gradient stream exactly as the
backward kernel writes it; sorted stably and merged, it gives the plain
backward's table gradient bit for bit.  `backward_f64` is the same backward
in float64 arithmetic: the yardstick against which both the kernel and the
f32 plain version are measured where a pre-activation lies so close to 0
that f32 rounding decides which side of the ReLU it falls on.
`residual_bytes` counts what each residual policy keeps between forward
and backward.
"""
from __future__ import annotations

import torch

from ..fused_mlp import ref as mlp_ref
from ..fused_path import ref as fp_ref
from ..hash_encode import ref as he_ref

# segment_min's identity for an empty run, as the reference's int32
_INT32_MAX = 2 ** 31 - 1


def mlp_heads(hd, hc, sh, mlp_d: dict, mlp_c: dict):
    """(density feats, color feats, SH feats) -> (density out, raw rgb):
    mlp2 on hd, mlp3 on concat([hc, sh]).  Activations stay outside."""
    out_d = mlp_ref.mlp2(hd, mlp_d["w1"], mlp_d["b1"], mlp_d["w2"], mlp_d["b2"])
    cin = torch.cat([hc, sh], dim=-1)
    raw_c = mlp_ref.mlp3(cin, mlp_c["w1"], mlp_c["b1"], mlp_c["w2"], mlp_c["b2"],
                         mlp_c["w3"], mlp_c["b3"])
    return out_d, raw_c


def encode_both(points, t_density, t_color, resolutions, dense_d, dense_c):
    """Both grids' features from one pass of corner geometry -> (hd, hc, idx
    per grid (lists of (N, 8) per level), weights (list of (N, 8)))."""
    corners, weights = fp_ref.corner_geometry(points, resolutions)
    idx_d = fp_ref.level_indices(corners, resolutions, t_density.shape[1], dense_d)
    idx_c = fp_ref.level_indices(corners, resolutions, t_color.shape[1], dense_c)
    hd = fp_ref.encode_from_indices(t_density, idx_d, weights)
    hc = fp_ref.encode_from_indices(t_color, idx_c, weights)
    return hd, hc, (idx_d, idx_c), weights


def fused_step_ref(points, sh, t_density, t_color, mlp_d: dict, mlp_c: dict,
                   resolutions, dense_d, dense_c):
    """Whole-step plain version: points (N, 3) Morton-ordered unit coords, sh
    (N, sh_dim) -> (out_d (N, 1+geo), raw_c (N, 3))."""
    hd, hc, _, _ = encode_both(points, t_density, t_color, resolutions, dense_d, dense_c)
    return mlp_heads(hd, hc, sh, mlp_d, mlp_c)


def bwd_table_stream(points, g_feat, resolutions, table_size: int, dense_flags,
                     n_pad: int | None = None):
    """One grid's table-gradient stream in the backward kernel's layout:
    entry (l * n_pad + i) * 8 + c holds corner c of point i at level l --
    address l*T + index and value w_c * g_feat[i, l*F:(l+1)*F], one f32
    product as the kernel rounds it.  Sentinel rows (x < 0) carry row 0 at
    weight 0; rows i >= N up to n_pad (the kernel's last block) carry the
    spill address L*T with value 0.  points (N, 3), g_feat (N, L*F) ->
    (addr (L*n_pad*8,) int64, vals (L*n_pad*8, F) f32)."""
    n, levels = points.shape[0], len(resolutions)
    n_pad = n if n_pad is None else n_pad
    f = g_feat.shape[1] // levels
    spill = torch.full((n_pad - n, 8), levels * table_size, dtype=torch.int64,
                       device=points.device)
    zeros = torch.zeros((n_pad - n, 8, f), dtype=torch.float32, device=points.device)
    addr, vals = [], []
    for level, (res, dense) in enumerate(zip(resolutions, dense_flags)):
        idx, w = he_ref.level_indices(points, int(res), table_size, bool(dense))
        g = g_feat[:, level * f:(level + 1) * f].to(torch.float32)
        addr.append(torch.cat([idx + level * table_size, spill]).reshape(-1))
        vals.append(torch.cat([w[:, :, None] * g[:, None, :], zeros]).reshape(-1, f))
    return torch.cat(addr), torch.cat(vals)


def layers_f64(x, *params):
    """The plain MLPs' function in float64: x @ w + b per (w, b) pair, the
    reference's ReLU (maximum(z, 0)) between layers, none after the last."""
    for k in range(0, len(params), 2):
        x = x.to(torch.float64) @ params[k].to(torch.float64) + params[k + 1].to(torch.float64)
        if k + 2 < len(params):
            x = torch.maximum(x, x.new_zeros(()))
    return x


def backward_f64(geometry, points, sh, t_density, t_color, mlp_d: dict, mlp_c: dict,
                 g_d, g_c, needs=(True, True)):
    """The backward of `fused_step_ref` (the plain backward's function) in
    float64 arithmetic, from the same f32 corner weights: (d_t_density or
    None, d_t_color or None, d_mlp_d, d_mlp_c, d_sh), all float64."""
    resolutions, dense_d, dense_c = geometry
    f64 = torch.float64
    corners, weights = fp_ref.corner_geometry(points, resolutions)
    tables = (t_density, t_color)
    idx = [fp_ref.level_indices(corners, resolutions, t.shape[1], dense)
           for t, dense in zip(tables, (dense_d, dense_c))]

    def encode(table, idx_l):
        return torch.cat([torch.sum(w.to(f64)[..., None] * table[level].to(f64)[i], dim=1)
                          for level, (i, w) in enumerate(zip(idx_l, weights))], dim=-1)

    keys_d, keys_c = ("w1", "b1", "w2", "b2"), ("w1", "b1", "w2", "b2", "w3", "b3")
    leaves = [encode(tables[0], idx[0]), encode(tables[1], idx[1]), sh.to(f64)]
    leaves += [mlp_d[k].to(f64) for k in keys_d] + [mlp_c[k].to(f64) for k in keys_c]
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        outs = (layers_f64(leaves[0], *leaves[3:7]),
                layers_f64(torch.cat([leaves[1], leaves[2]], dim=-1), *leaves[7:]))
        grads = torch.autograd.grad(outs, leaves, (g_d.to(f64), g_c.to(f64)))
    table_grads = []
    for g_feat, table, idx_l, need in zip(grads[:2], tables, idx, needs):
        if not need:
            table_grads.append(None)
            continue
        levels, size, f = table.shape
        flat = torch.zeros((levels * size, f), dtype=f64, device=points.device)
        for level, (i, w) in enumerate(zip(idx_l, weights)):
            vals = w.to(f64)[..., None] * g_feat[:, None, level * f:(level + 1) * f]
            flat.index_add_(0, (i + level * size).reshape(-1), vals.reshape(-1, f))
        table_grads.append(flat.reshape(levels, size, f))
    return (table_grads[0], table_grads[1], dict(zip(keys_d, grads[3:7])),
            dict(zip(keys_c, grads[7:])), grads[2])


def dedup_weight_matrix(idx: torch.Tensor, weights: torch.Tensor):
    """Segment-sum dedup plan for one (block, level, grid): (B, 8) indices and
    trilinear weights -> (W (B, B*8) f32, uniq (B*8,) int64 addresses).

    The block's flat corner-address stream is sorted (stable); run r's
    address is uniq[r] and W[p, r] is the sum of point p's weights over its
    corners in run r.  Empty trailing runs are clamped to the largest
    address with an all-zero W column, as in the reference."""
    b = idx.shape[0]
    m = b * 8
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    sa = flat[order]
    start = torch.ones_like(sa, dtype=torch.bool)
    start[1:] = sa[1:] != sa[:-1]
    seg = torch.cumsum(start.to(torch.int64), 0) - 1
    uniq = torch.full((m,), _INT32_MAX, dtype=torch.int64, device=idx.device)
    uniq = uniq.scatter_reduce(0, seg, sa, reduce="amin")
    uniq = torch.minimum(torch.clamp(uniq, min=0), flat.max())
    w_mat = torch.zeros((b, m), dtype=torch.float32, device=idx.device)
    w_mat.index_put_((order // 8, seg), weights.reshape(-1)[order].to(torch.float32),
                     accumulate=True)
    return w_mat, uniq


def encode_block_dedup(points, tables, resolutions, table_size: int, dense_flags,
                       block_points: int = 256):
    """Segment-sum-dedup encode, out = W @ T[uniq] per (block, level): the
    same function as `fused_path.ref.encode_from_indices`, to rounding (the
    weight pre-sum reassociates).  N must divide into blocks."""
    n = points.shape[0]
    if n % block_points:
        raise ValueError(f"encode_block_dedup: N={n} is not a multiple of {block_points}")
    corners, weights = fp_ref.corner_geometry(points, resolutions)
    idx_l = fp_ref.level_indices(corners, resolutions, table_size, dense_flags)
    outs = []
    for level in range(tables.shape[0]):
        per_block = []
        for s in range(0, n, block_points):
            w_mat, uniq = dedup_weight_matrix(idx_l[level][s:s + block_points],
                                              weights[level][s:s + block_points])
            per_block.append(w_mat @ tables[level][uniq].to(torch.float32))
        outs.append(torch.cat(per_block, dim=0))
    return torch.cat(outs, dim=-1)


def residual_bytes(policy: str, n_points: int, n_levels: int, n_features: int,
                   table_sizes, sh_dim: int, mlp_d_params: int, mlp_c_params: int,
                   itemsize: int = 4) -> int:
    """Bytes held between forward and backward for one fused step, the
    reference's count (`repro.kernels.fused_step.ref.residual_bytes`):
    every tensor the backward keeps reachable, kept inputs included.

    * "stash": weights (L, N, 8) + two (L*N*8,) streams per grid + both
      feature blocks (N, L*F) + SH + MLP params; no tables, no points.
    * "recompute": points + SH + tables + MLP params, nothing else.

    Static arithmetic, so a production-scale footprint needs no memory."""
    n, levels, f = int(n_points), int(n_levels), int(n_features)
    grids = len(tuple(table_sizes))
    mlp = (int(mlp_d_params) + int(mlp_c_params)) * itemsize
    sh = n * int(sh_dim) * itemsize
    if policy == "stash":
        w_stack = levels * n * 8 * itemsize
        streams = grids * 2 * (levels * n * 8) * itemsize
        feats = grids * n * levels * f * itemsize
        return w_stack + streams + feats + sh + mlp
    if policy == "recompute":
        points = n * 3 * itemsize
        tables = sum(levels * int(t) * f for t in table_sizes) * itemsize
        return points + sh + tables + mlp
    raise ValueError(f"unknown residual_policy {policy!r}")
