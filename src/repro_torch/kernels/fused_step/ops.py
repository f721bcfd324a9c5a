"""The one-op training step as an autograd op.

The port of `repro.kernels.fused_step.ops.make_fused_step`, which returns a
differentiable

    step(points, sh, t_density, t_color, mlp_d, mlp_c)
        -> (density head out (N, 1+geo), raw rgb (N, 3))

covering the whole shade stage of a decomposed field.  By device: a CUDA
tensor runs the forward kernel (`kernel.fused_step_fwd`) and the backward
kernel (`kernel.fused_step_bwd`), which recomputes in the kernel and
commits merged whatever the options, as the reference's Pallas route
does; a CPU tensor runs the plain versions -- the forward
`ref.fused_step_ref`, the backward the reference's own: geometry and
features, the autograd of the plain MLP heads, and each grid's table
gradient committed as a one-row stacked `windowed_scatter_add` of its
stably sorted address stream.  A frozen table (`needs_input_grad`) gets no
commit.

residual_policy (plain route): "recompute" (default) keeps only the
inputs and re-derives geometry, streams and features in the backward;
"stash" keeps the reference's stash set -- the corner weights (L, N, 8),
each grid's (sorted addresses, order) and both feature blocks -- and the
backward does no geometry work.  Same deterministic ops on the same
inputs, so the gradients are bit-identical.  `ref.residual_bytes` counts
both sets.  merged_backward=False (plain route) commits with the
reference's unmerged scatter (``flat.at[addr].add``), `index_add_`.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import kernel, ref
from ..fused_path import ops as fp_ops
from ..grid_update import ops as gu_ops
from ..hash_encode import ref as he_ref

RESIDUAL_POLICIES = ("stash", "recompute")
_MLP_D_KEYS, _MLP_C_KEYS = kernel.MLP_D_KEYS, kernel.MLP_C_KEYS


def _plain_backward(geometry, points, sh, t_density, t_color, mlp_d, mlp_c, g_d, g_c,
                    needs, merged: bool = True, stash=None):
    """The reference's ref-backend backward: under "recompute" from the
    inputs, under "stash" from `stash` = (w_stack, streams, hd, hc)."""
    resolutions, dense_d, dense_c = geometry
    if stash is None:
        hd, hc, idx, weights = ref.encode_both(points, t_density, t_color, resolutions,
                                               dense_d, dense_c)
        w_stack = torch.stack(weights)                              # (L, N, 8)
        streams = fp_ops.plan_streams(idx, (t_density.shape[1], t_color.shape[1]), needs)
    else:
        w_stack, streams, hd, hc = stash
    leaves = [hd, hc, sh] + [mlp_d[k] for k in _MLP_D_KEYS] + [mlp_c[k] for k in _MLP_C_KEYS]
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        md = dict(zip(_MLP_D_KEYS, leaves[3:7]))
        mc = dict(zip(_MLP_C_KEYS, leaves[7:]))
        outs = ref.mlp_heads(leaves[0], leaves[1], leaves[2], md, mc)
        grads = torch.autograd.grad(outs, leaves, (g_d, g_c), allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(leaves, grads)]
    g_hd, g_hc, g_sh = grads[:3]
    n, levels = points.shape[0], len(resolutions)
    table_grads = []
    for g_feat, table, (addr_s, order), need in ((g_hd, t_density, streams[0], needs[0]),
                                                 (g_hc, t_color, streams[1], needs[1])):
        if not need:
            table_grads.append(None)
            continue
        f, size = table.shape[2], table.shape[1]
        gg = g_feat.reshape(n, levels, f).to(torch.float32)
        vals = (w_stack[:, :, :, None] * gg.permute(1, 0, 2)[:, :, None, :]).reshape(-1, f)
        flat = torch.zeros((levels * size, f), dtype=torch.float32, device=points.device)
        if merged:
            flat = gu_ops.windowed_scatter_add(flat, addr_s[None], vals[order][None],
                                               presorted=True)
        else:
            flat.index_add_(0, addr_s, vals[order])
        table_grads.append(flat.reshape(levels, size, f).to(table.dtype))
    return (table_grads[0], table_grads[1], dict(zip(_MLP_D_KEYS, grads[3:7])),
            dict(zip(_MLP_C_KEYS, grads[7:])), g_sh)


class _FusedStep(torch.autograd.Function):
    """(geometry, options, points, sh, t_density, t_color, *10 MLP tensors)
    -> (out_d, raw_c); geometry = (resolutions, dense_d, dense_c), options =
    (merged_backward, stash)."""

    @staticmethod
    def forward(ctx, geometry, options, points, sh, t_density, t_color, *mlps):
        ctx.geometry, ctx.merged = geometry, options[0]
        ctx.stashed = False
        mlp_d, mlp_c = dict(zip(_MLP_D_KEYS, mlps[:4])), dict(zip(_MLP_C_KEYS, mlps[4:]))
        if points.device.type == "cuda":
            ctx.save_for_backward(points, sh, t_density, t_color, *mlps)
            return kernel.fused_step_fwd(points, sh, t_density, t_color, mlp_d, mlp_c,
                                         *geometry)
        if points.device.type != "cpu":
            raise ValueError(f"fused_step: no route for device {points.device}")
        if not (options[1] and any(ctx.needs_input_grad)):
            ctx.save_for_backward(points, sh, t_density, t_color, *mlps)
            return ref.fused_step_ref(points, sh, t_density, t_color, mlp_d, mlp_c,
                                      *geometry)
        # "stash": the forward's geometry, streams and features cross over
        hd, hc, idx, weights = ref.encode_both(points, t_density, t_color, *geometry)
        streams = fp_ops.plan_streams(idx, (t_density.shape[1], t_color.shape[1]),
                                      ctx.needs_input_grad[4:6])
        ctx.stashed = True
        ctx.save_for_backward(points, sh, t_density, t_color, *mlps, torch.stack(weights),
                              *streams[0], *streams[1], hd, hc)
        return ref.mlp_heads(hd, hc, sh, mlp_d, mlp_c)

    @staticmethod
    def backward(ctx, g_d, g_c):
        points, sh, t_density, t_color, *rest = ctx.saved_tensors
        mlps, stash = rest[:10], None
        if ctx.stashed:
            w_stack, a_d, o_d, a_c, o_c, hd, hc = rest[10:]
            stash = (w_stack, ((a_d, o_d), (a_c, o_c)), hd, hc)
        mlp_d, mlp_c = dict(zip(_MLP_D_KEYS, mlps[:4])), dict(zip(_MLP_C_KEYS, mlps[4:]))
        needs = (ctx.needs_input_grad[4], ctx.needs_input_grad[5])
        g_d, g_c = g_d.contiguous(), g_c.contiguous()
        if points.device.type == "cuda":
            d_td, d_tc, d_md, d_mc, d_sh = kernel.fused_step_bwd(
                points, sh, g_d, g_c, t_density, t_color, mlp_d, mlp_c, *ctx.geometry,
                need_density=needs[0], need_color=needs[1])
        else:
            d_td, d_tc, d_md, d_mc, d_sh = _plain_backward(
                ctx.geometry, points, sh, t_density, t_color, mlp_d, mlp_c, g_d, g_c, needs,
                merged=ctx.merged, stash=stash)
        d_mlps = [d_md[k] for k in _MLP_D_KEYS] + [d_mc[k] for k in _MLP_C_KEYS]
        d_points = torch.zeros_like(points) if ctx.needs_input_grad[2] else None
        return (None, None, d_points, d_sh if ctx.needs_input_grad[3] else None, d_td, d_tc,
                *(g if need else None for g, need in zip(d_mlps, ctx.needs_input_grad[6:])))


def make_fused_step(resolutions, table_sizes, n_features: int, *,
                    residual_policy: str = "recompute",
                    merged_backward: bool = True) -> Callable:
    """Build the one-op step for fixed level geometry (shared by both grids).

    table_sizes: (T_density, T_color).  Returns step(points (N, 3), sh (N, S),
    t_density (L, Td, F), t_color (L, Tc, F), mlp_d {w1, b1, w2, b2}, mlp_c
    {w1, b1, w2, b2, w3, b3}) -> (out_d, raw_c).  Points are Morton-ordered
    unit coords, as the pipeline's compact stage delivers them.
    residual_policy / merged_backward: see the module docstring."""
    if residual_policy not in RESIDUAL_POLICIES:
        raise ValueError(f"residual_policy must be one of {RESIDUAL_POLICIES}")
    options = (bool(merged_backward), residual_policy == "stash")
    resolutions = tuple(int(r) for r in resolutions)
    table_sizes = tuple(int(t) for t in table_sizes)
    if len(table_sizes) != 2:
        raise ValueError("the fused step covers decomposed fields (two grids)")
    dense = tuple(tuple(bool(x) for x in he_ref.level_is_dense(np.asarray(resolutions), t))
                  for t in table_sizes)
    geometry = (resolutions, dense[0], dense[1])

    def step(points, sh, t_density, t_color, mlp_d: dict, mlp_c: dict):
        mlps = [mlp_d[k] for k in _MLP_D_KEYS] + [mlp_c[k] for k in _MLP_C_KEYS]
        return _FusedStep.apply(geometry, options, points, sh, t_density, t_color, *mlps)

    return step
