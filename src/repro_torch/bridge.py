"""Bit-exact conversion between the JAX package's params and the port's.

The JAX `Field.init` pytree is a dict with ``density_grid`` (L, T, F),
``density_mlp`` {w1, b1, w2, b2}, ``color_grid`` and ``color_mlp``
{w1, b1, w2, b2, w3, b3}; the port keeps the same keys, shapes, dtypes and
(d_in, d_out) layout, so conversion is a copy of every leaf through numpy.
A snapshot's occupancy pair (density EMA (R^3,), fold count) and the AdamW
state (step, m, v) convert the same way.  Inputs are anything
`numpy.asarray` accepts (numpy arrays, or JAX arrays handed over by the
caller); this module imports no JAX.  The converters to torch put the
tensors on `device`, by default the card, as every entry point of the port
does.
"""
from __future__ import annotations

import numpy as np
import torch


def params_to_torch(tree, device="cuda"):
    """Nested dict of arrays -> the same dict of torch tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(tree):
    """Nested dict of torch tensors -> the same dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def occ_to_torch(occ, device="cuda") -> tuple[torch.Tensor, int]:
    """(density_ema (R^3,), step) -> (tensor on `device`, int)."""
    ema, step = occ
    return torch.from_numpy(np.array(ema, copy=True)).to(device), int(np.asarray(step))


def occ_to_numpy(occ) -> tuple[np.ndarray, int]:
    """(density_ema tensor, step) -> (numpy array, int)."""
    ema, step = occ
    return ema.detach().cpu().numpy().copy(), int(step)


def opt_to_torch(opt, device="cuda"):
    """The reference's AdamWState (step, m, v) -> the port's AdamWState: an
    int32 step tensor and the moments' dicts, on `device`."""
    from .optim import AdamWState
    step, m, v = opt
    return AdamWState(torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
                      params_to_torch(m, device), params_to_torch(v, device))


def opt_to_numpy(opt):
    """The port's AdamWState -> (int32 numpy step, m dict, v dict)."""
    step, m, v = opt
    return (np.asarray(int(step), np.int32), params_to_numpy(m), params_to_numpy(v))
