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

bf16 leaves (`FieldConfig(grid_dtype="bfloat16")`'s tables) cross as raw
bits: numpy has no bfloat16 of its own.  An array whose dtype is named
``bfloat16`` (what `numpy.asarray` gives for a JAX bf16 array) or is the
2-byte void ``|V2`` (what `np.savez` writes for it, and a checkpoint
restores) becomes a ``torch.bfloat16`` tensor of the same bits, and a bf16
tensor leaves as a ``|V2`` array of its bits.  float16 is native to both.
"""
from __future__ import annotations

import numpy as np
import torch


BF16_BITS = np.dtype("V2")      # a bf16 array's bytes, as np.savez stores them


def is_bf16_bits(dtype: np.dtype) -> bool:
    """Whether a numpy dtype holds bf16 values: named bfloat16 (ml_dtypes'),
    or the raw 2-byte void of a saved one."""
    return dtype.name == "bfloat16" or dtype == BF16_BITS


def array_to_tensor(x) -> torch.Tensor:
    """A host tensor holding a copy of `x`: bf16 bits as torch.bfloat16."""
    a = np.array(x, copy=True)
    if is_bf16_bits(a.dtype):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor: a bf16 tensor as its bits, dtype ``|V2``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_BITS).copy()
    return t.numpy().copy()


def params_to_torch(tree, device="cuda"):
    """Nested dict of arrays -> the same dict of torch tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device) for k, v in tree.items()}
    return array_to_tensor(tree).to(device)


def params_to_numpy(tree):
    """Nested dict of torch tensors -> the same dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tensor_to_array(tree)


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
