"""The one-op training step as an autograd op.

The port of `repro.kernels.fused_step.ops.make_fused_step`, which returns a
differentiable

    step(points, sh, t_density, t_color, mlp_d, mlp_c)
        -> (density head out (N, 1+geo), raw rgb (N, 3))

covering the whole shade stage of a decomposed field.  Under the reference's
default residual policy, "recompute", only the inputs cross to the backward.
By device: a CUDA tensor runs the forward kernel (`kernel.fused_step_fwd`)
and the backward kernel (`kernel.fused_step_bwd`); a CPU tensor runs the
plain versions -- the forward `ref.fused_step_ref`, the backward the
reference's own: recompute geometry and features, the autograd of the plain
MLP heads, and each grid's table gradient committed as a one-row stacked
`windowed_scatter_add` of its stably sorted address stream.  A frozen table
(`needs_input_grad`) gets no commit.  The "stash" policy is not ported.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import kernel, ref
from ..fused_path import ref as fp_ref
from ..grid_update import ops as gu_ops
from ..hash_encode import ref as he_ref

RESIDUAL_POLICIES = ("stash", "recompute")
_MLP_D_KEYS, _MLP_C_KEYS = kernel.MLP_D_KEYS, kernel.MLP_C_KEYS


def _plain_backward(geometry, points, sh, t_density, t_color, mlp_d, mlp_c, g_d, g_c,
                    needs):
    """The reference's ref-backend backward under "recompute"."""
    resolutions, dense_d, dense_c = geometry
    hd, hc, idx, weights = ref.encode_both(points, t_density, t_color, resolutions,
                                           dense_d, dense_c)
    leaves = [hd, hc, sh] + [mlp_d[k] for k in _MLP_D_KEYS] + [mlp_c[k] for k in _MLP_C_KEYS]
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        md = dict(zip(_MLP_D_KEYS, leaves[3:7]))
        mc = dict(zip(_MLP_C_KEYS, leaves[7:]))
        outs = ref.mlp_heads(leaves[0], leaves[1], leaves[2], md, mc)
        grads = torch.autograd.grad(outs, leaves, (g_d, g_c), allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(leaves, grads)]
    g_hd, g_hc, g_sh = grads[:3]
    w_stack = torch.stack(weights)                                  # (L, N, 8)
    n, levels = points.shape[0], len(resolutions)
    table_grads = []
    for g_feat, table, idx_l, need in ((g_hd, t_density, idx[0], needs[0]),
                                       (g_hc, t_color, idx[1], needs[1])):
        if not need:
            table_grads.append(None)
            continue
        f, size = table.shape[2], table.shape[1]
        gg = g_feat.reshape(n, levels, f).to(torch.float32)
        vals = (w_stack[:, :, :, None] * gg.permute(1, 0, 2)[:, :, None, :]).reshape(-1, f)
        addr = fp_ref.address_stream(idx_l, size)
        order = torch.sort(addr, stable=True).indices
        flat = torch.zeros((levels * size, f), dtype=torch.float32, device=points.device)
        flat = gu_ops.windowed_scatter_add(flat, addr[order][None], vals[order][None],
                                           presorted=True)
        table_grads.append(flat.reshape(levels, size, f).to(table.dtype))
    return (table_grads[0], table_grads[1], dict(zip(_MLP_D_KEYS, grads[3:7])),
            dict(zip(_MLP_C_KEYS, grads[7:])), g_sh)


class _FusedStep(torch.autograd.Function):
    """(geometry, points, sh, t_density, t_color, *10 MLP tensors) ->
    (out_d, raw_c); geometry = (resolutions, dense_d, dense_c)."""

    @staticmethod
    def forward(ctx, geometry, points, sh, t_density, t_color, *mlps):
        ctx.geometry = geometry
        ctx.save_for_backward(points, sh, t_density, t_color, *mlps)
        mlp_d, mlp_c = dict(zip(_MLP_D_KEYS, mlps[:4])), dict(zip(_MLP_C_KEYS, mlps[4:]))
        if points.device.type == "cuda":
            return kernel.fused_step_fwd(points, sh, t_density, t_color, mlp_d, mlp_c,
                                         *geometry)
        if points.device.type != "cpu":
            raise ValueError(f"fused_step: no route for device {points.device}")
        return ref.fused_step_ref(points, sh, t_density, t_color, mlp_d, mlp_c, *geometry)

    @staticmethod
    def backward(ctx, g_d, g_c):
        points, sh, t_density, t_color, *mlps = ctx.saved_tensors
        mlp_d, mlp_c = dict(zip(_MLP_D_KEYS, mlps[:4])), dict(zip(_MLP_C_KEYS, mlps[4:]))
        needs = (ctx.needs_input_grad[3], ctx.needs_input_grad[4])
        g_d, g_c = g_d.contiguous(), g_c.contiguous()
        if points.device.type == "cuda":
            d_td, d_tc, d_md, d_mc, d_sh = kernel.fused_step_bwd(
                points, sh, g_d, g_c, t_density, t_color, mlp_d, mlp_c, *ctx.geometry,
                need_density=needs[0], need_color=needs[1])
        else:
            d_td, d_tc, d_md, d_mc, d_sh = _plain_backward(
                ctx.geometry, points, sh, t_density, t_color, mlp_d, mlp_c, g_d, g_c, needs)
        d_mlps = [d_md[k] for k in _MLP_D_KEYS] + [d_mc[k] for k in _MLP_C_KEYS]
        d_points = torch.zeros_like(points) if ctx.needs_input_grad[1] else None
        return (None, d_points, d_sh if ctx.needs_input_grad[2] else None, d_td, d_tc,
                *(g if need else None for g, need in zip(d_mlps, ctx.needs_input_grad[5:])))


def make_fused_step(resolutions, table_sizes, n_features: int, *,
                    residual_policy: str = "recompute") -> Callable:
    """Build the one-op step for fixed level geometry (shared by both grids).

    table_sizes: (T_density, T_color).  Returns step(points (N, 3), sh (N, S),
    t_density (L, Td, F), t_color (L, Tc, F), mlp_d {w1, b1, w2, b2}, mlp_c
    {w1, b1, w2, b2, w3, b3}) -> (out_d, raw_c).  Points are Morton-ordered
    unit coords, as the pipeline's compact stage delivers them."""
    if residual_policy not in RESIDUAL_POLICIES:
        raise ValueError(f"residual_policy must be one of {RESIDUAL_POLICIES}")
    if residual_policy == "stash":
        raise NotImplementedError(
            "fused_step: the 'stash' residual policy is not ported; 'recompute' gives "
            "the same gradients")
    resolutions = tuple(int(r) for r in resolutions)
    table_sizes = tuple(int(t) for t in table_sizes)
    if len(table_sizes) != 2:
        raise ValueError("the fused step covers decomposed fields (two grids)")
    dense = tuple(tuple(bool(x) for x in he_ref.level_is_dense(np.asarray(resolutions), t))
                  for t in table_sizes)
    geometry = (resolutions, dense[0], dense[1])

    def step(points, sh, t_density, t_color, mlp_d: dict, mlp_c: dict):
        mlps = [mlp_d[k] for k in _MLP_D_KEYS] + [mlp_c[k] for k in _MLP_C_KEYS]
        return _FusedStep.apply(geometry, points, sh, t_density, t_color, *mlps)

    return step
