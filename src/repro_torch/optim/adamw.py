"""AdamW with per-leaf update masks and lr scales.

The port of `repro.optim.adamw` as the trainer uses it (no weight decay,
no gradient clipping -- the reference's trainer sets neither):

    opt = AdamW(lr=1e-2, b2=0.99, eps=1e-15, lr_scale_fn=...)
    state = opt.init(params)
    params, state = opt.apply(params, grads, state, mask=mask)

Params are nested dicts of tensors.  The `mask` tree (True = update) is how
Instant-3D's different update frequencies reach the optimizer: a masked
leaf keeps its params AND its moments, as the accelerator skips that
branch's back-propagation.  `lr_scale_fn` maps a leaf's key path to an lr
factor.  The step is an int32 tensor on the params' device and the bias
corrections are f32 powers of it, so a step makes no host sync and no
host-to-device copy (it can be captured as a CUDA graph).  The
arithmetic is the reference's, operation for operation.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from . import schedule


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any              # tree like params, f32
    v: Any              # tree like params, f32


def tree_paths(tree, prefix=()) -> list:
    """[(key path, leaf)] of a nested dict, keys sorted at every level (the
    order jax.tree_util flattens a dict in)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_paths(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def tree_get(tree, path):
    for k in path:
        if tree is None:
            return None
        tree = tree.get(k) if isinstance(tree, dict) else None
    return tree


def tree_from_paths(items) -> dict:
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


class AdamW:
    def __init__(self, lr: float | Callable, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, lr_scale_fn: Callable[[tuple], float] | None = None):
        """lr: a float or a step -> lr schedule; lr_scale_fn maps a leaf's key
        path to an lr factor (grids 1.0, MLPs 0.1 in the trainer)."""
        self.lr = lr if callable(lr) else schedule.constant(lr)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.lr_scale_fn = lr_scale_fn

    def init(self, params) -> AdamWState:
        leaves = tree_paths(params)
        device = leaves[0][1].device
        zeros = lambda: tree_from_paths(  # noqa: E731
            [(p, torch.zeros(x.shape, dtype=torch.float32, device=x.device)) for p, x in leaves])
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros())

    def apply(self, params, grads, state: AdamWState, mask=None):
        """Returns (new params, new state); new tensors, the inputs untouched.
        grads may hold None for a leaf whose mask is False."""
        step = state.step + 1
        lr_t = self.lr(step)
        b1, b2 = self.b1, self.b2
        step_f = step.to(torch.float32)
        # the constants are filled on the device: a host-to-device copy would
        # make the step uncapturable as a CUDA graph
        bias1 = 1.0 - torch.pow(torch.full((), b1, dtype=torch.float32, device=step.device), step_f)
        bias2 = 1.0 - torch.pow(torch.full((), b2, dtype=torch.float32, device=step.device), step_f)

        new_p, new_m, new_v = [], [], []
        for path, p in tree_paths(params):
            m, v = tree_get(state.m, path), tree_get(state.v, path)
            upd = True if mask is None else bool(tree_get(mask, path))
            if not upd:
                # a masked leaf keeps params AND moments (branch skipped)
                new_p.append((path, p))
                new_m.append((path, m))
                new_v.append((path, v))
                continue
            g32 = tree_get(grads, path).to(torch.float32)
            m1 = b1 * m + (1 - b1) * g32
            v1 = b2 * v + (1 - b2) * torch.square(g32)
            scale = self.lr_scale_fn(path) if self.lr_scale_fn is not None else 1.0
            update = lr_t * scale * (m1 / bias1) / (torch.sqrt(v1 / bias2) + self.eps)
            new_p.append((path, (p.to(torch.float32) - update).to(p.dtype)))
            new_m.append((path, m1))
            new_v.append((path, v1))
        return (tree_from_paths(new_p),
                AdamWState(step, tree_from_paths(new_m), tree_from_paths(new_v)))
