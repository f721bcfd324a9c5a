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
"""
from __future__ import annotations

import torch

from ..fused_mlp import ref as mlp_ref
from ..fused_path import ref as fp_ref

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
