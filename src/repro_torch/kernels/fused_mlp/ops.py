"""Public fused MLPs, differentiable: kernel forward, plain backward.

The forward goes by device: a CUDA tensor to the CUDA kernel, a CPU tensor
to the plain PyTorch version.  The backward is the reference's
`_make_mlp_op` backward (`repro.kernels.fused_mlp.ops`); in the reference
too it runs outside any Pallas kernel, so its matmuls stay torch matmuls
here.  What it keeps follows `residual_policy`:

* "recompute" (default): only the inputs; the gradient is the autograd of
  the plain version re-run on them;
* "stash" (plain route): also each hidden layer's pre-activation, and the
  backward chains the autograd of the plain chain's pieces (`_lin`, then
  `_relu_lin` per hidden layer) at them, skipping the hidden layers'
  forward matmuls.  The pieces compose to the whole chain op for op, so
  the gradients equal "recompute"'s bit for bit.  On a CUDA tensor the
  kernel keeps nothing and the backward recomputes, as for the fused ops.
"""
from __future__ import annotations

import torch

from . import kernel, ref

RESIDUAL_POLICIES = ("stash", "recompute")


def _route(x, what: str) -> bool:
    """True for the kernel, False for the plain version."""
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{what}: no route for device {x.device}")
    return False


# the plain chain split at its pre-activations: mlp2 == _relu_lin(_lin(x,
# w1, b1), w2, b2) op for op (mlp3 adds one more _relu_lin)

def _lin(x, w, b):
    return x.to(torch.float32) @ w.to(torch.float32) + b


def _relu_lin(z, w, b):
    return _lin(ref._relu(z), w, b)


class _MLP(torch.autograd.Function):
    """op(n_layers, stash, x, w1, b1, ..., wN, bN) -> out, N in {2, 3}."""

    @staticmethod
    def forward(ctx, n_layers, stash, x, *params):
        ctx.plain = ref.mlp2 if n_layers == 2 else ref.mlp3
        ctx.n_z = 0
        if _route(x, f"mlp{n_layers}"):
            ctx.save_for_backward(x, *params)
            fn = kernel.fused_mlp2 if n_layers == 2 else kernel.fused_mlp3
            return fn(x, *params)
        if not (stash and any(ctx.needs_input_grad)):
            ctx.save_for_backward(x, *params)
            return ctx.plain(x, *params)
        zs = [_lin(x, params[0], params[1])]
        for i in range(1, n_layers - 1):
            zs.append(_relu_lin(zs[-1], params[2 * i], params[2 * i + 1]))
        ctx.n_z = len(zs)
        ctx.save_for_backward(x, *params, *zs)
        return _relu_lin(zs[-1], params[-2], params[-1])

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        if ctx.n_z == 0:
            inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
            wanted = [t for t in inputs if t.requires_grad]
            with torch.enable_grad():
                out = ctx.plain(*inputs)
                grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
            return (None, None) + tuple(next(grads) if t.requires_grad else None
                                        for t in inputs)
        x, params, zs = saved[0], saved[1:-ctx.n_z], saved[-ctx.n_z:]
        grads = [None] * (1 + len(params))
        for i in reversed(range(1, len(params) // 2)):
            g, grads[1 + 2 * i], grads[2 + 2 * i] = _pullback(
                _relu_lin, (zs[i - 1], params[2 * i], params[2 * i + 1]),
                (True, needs[1 + 2 * i], needs[2 + 2 * i]), g)
        grads[0], grads[1], grads[2] = _pullback(_lin, (x, params[0], params[1]), needs[:3], g)
        return (None, None) + tuple(grads)


def _pullback(fn, args, needs, g) -> list:
    """The autograd of `fn(*args)` against `g`, for the args in `needs`
    (None for the others)."""
    leaves = [t.detach().requires_grad_(need) for t, need in zip(args, needs)]
    wanted = [t for t in leaves if t.requires_grad]
    with torch.enable_grad():
        out = fn(*leaves)
        got = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
    return [next(got) if t.requires_grad else None for t in leaves]


def mlp2(x, w1, b1, w2, b2, *, residual_policy: str = "recompute"):
    """x (N, Din) -> relu(x @ w1 + b1) @ w2 + b2."""
    return _MLP.apply(2, _stash(residual_policy), x, w1, b1, w2, b2)


def mlp3(x, w1, b1, w2, b2, w3, b3, *, residual_policy: str = "recompute"):
    """Two hidden ReLU layers, then a linear head."""
    return _MLP.apply(3, _stash(residual_policy), x, w1, b1, w2, b2, w3, b3)


def _stash(residual_policy: str) -> bool:
    if residual_policy not in RESIDUAL_POLICIES:
        raise ValueError(f"residual_policy must be one of {RESIDUAL_POLICIES}")
    return residual_policy == "stash"
