"""Public fused MLPs, differentiable: kernel forward, recomputed backward.

The forward goes by device: a CUDA tensor to the CUDA kernel, a CPU tensor
to the plain PyTorch version.  The backward is the reference's
`_make_mlp_op` backward under its default "recompute" policy
(`repro.kernels.fused_mlp.ops`): only the inputs are kept, and the gradient
is the autograd of the plain version re-run on them -- in the reference too
that backward runs outside any Pallas kernel, so its matmuls stay torch
matmuls here.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def _route(x, what: str) -> bool:
    """True for the kernel, False for the plain version."""
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{what}: no route for device {x.device}")
    return False


class _MLP(torch.autograd.Function):
    """op(n_layers, x, w1, b1, ..., wN, bN) -> out, N in {2, 3}."""

    @staticmethod
    def forward(ctx, n_layers, x, *params):
        ctx.save_for_backward(x, *params)
        if n_layers == 2:
            fn = kernel.fused_mlp2 if _route(x, "mlp2") else ref.mlp2
        else:
            fn = kernel.fused_mlp3 if _route(x, "mlp3") else ref.mlp3
        ctx.plain = ref.mlp2 if n_layers == 2 else ref.mlp3
        return fn(x, *params)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ctx.plain(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        return (None,) + tuple(next(grads) if t.requires_grad else None for t in inputs)


def mlp2(x, w1, b1, w2, b2):
    """x (N, Din) -> relu(x @ w1 + b1) @ w2 + b2."""
    return _MLP.apply(2, x, w1, b1, w2, b2)


def mlp3(x, w1, b1, w2, b2, w3, b3):
    """Two hidden ReLU layers, then a linear head."""
    return _MLP.apply(3, x, w1, b1, w2, b2, w3, b3)
