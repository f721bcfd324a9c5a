"""Public volume-rendering composite: device dispatch.

A CUDA tensor goes to the CUDA kernel through `Composite`, an autograd op
whose backward is the CUDA backward kernel (`kernel.composite_backward`,
the closed form of the reference's `_composite_bwd` in
`repro.kernels.volume_render.ops`, which is the autodiff of the plain
version).  It returns `RenderOut` with ``weights=None`` (the kernel never
materialises them, as the Pallas kernel did not).  A CPU tensor goes to the
plain version, differentiable as it is, which returns the weights too;
`Composite` on CPU tensors runs the plain version and its autograd.
"""
from __future__ import annotations

import torch

from . import kernel, ref


class Composite(torch.autograd.Function):
    """(sigma, rgb, deltas, ts) -> (color, depth, opacity); forward and
    backward run the kernels on CUDA tensors and the plain version (and its
    autograd) on CPU tensors."""

    @staticmethod
    def forward(ctx, sigma, rgb, deltas, ts):
        ctx.save_for_backward(sigma, rgb, deltas, ts)
        if sigma.device.type == "cuda":
            return kernel.composite(sigma, rgb, deltas, ts)
        return ref.composite(sigma, rgb, deltas, ts)[:3]

    @staticmethod
    def backward(ctx, g_color, g_depth, g_opacity):
        if ctx.saved_tensors[0].device.type == "cuda":
            return kernel.composite_backward(
                *ctx.saved_tensors, g_color.contiguous(), g_depth.contiguous(),
                g_opacity.contiguous(), needs=ctx.needs_input_grad)
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        if not wanted:
            return None, None, None, None
        with torch.enable_grad():
            # outputs that depend on no wanted input (depth and opacity when
            # only rgb is wanted) have no graph
            out = [(o, g) for o, g in zip(ref.composite(*inputs)[:3],
                                          (g_color, g_depth, g_opacity)) if o.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in out], wanted, [g for _, g in out],
                                             allow_unused=True))
        got = [next(grads) if t.requires_grad else None for t in inputs]
        return tuple(torch.zeros_like(t) if t.requires_grad and gr is None else gr
                     for t, gr in zip(inputs, got))


def composite(sigma, rgb, deltas, ts) -> ref.RenderOut:
    if sigma.device.type == "cuda":
        color, depth, opacity = Composite.apply(sigma, rgb, deltas, ts)
        return ref.RenderOut(color, depth, opacity, None)
    if sigma.device.type != "cpu":
        raise ValueError(f"composite: no route for device {sigma.device}")
    return ref.composite(sigma, rgb, deltas, ts)
