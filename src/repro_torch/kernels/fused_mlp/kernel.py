"""Launch wrappers of the CUDA fused MLPs (``csrc/fused_mlp.cu``).

Replace the Pallas kernels `repro.kernels.fused_mlp.kernel.fused_mlp2` and
`fused_mlp3`.  Each validates its inputs, allocates the output, launches on
the current stream and counts the launch; raises on anything the kernel
does not take (widths: d_in <= 64, hidden <= 64, d_out <= 16) and on a
failed launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import kernels as _k

MAX_IN = 64
MAX_HIDDEN = 64
MAX_OUT = 16


@functools.cache
def _entry(n_layers: int):
    p, i = ctypes.c_void_p, ctypes.c_int
    if n_layers == 2:
        return _k.function("fused_mlp", "fused_mlp2_fwd",
                           [p, p, p, p, p, p, i, i, i, i, p])
    return _k.function("fused_mlp", "fused_mlp3_fwd",
                       [p, p, p, p, p, p, p, p, i, i, i, i, i, p])


def _check(what: str, x: torch.Tensor, weights, biases) -> list[int]:
    """Validate x and the layer chain; returns the widths [d_in, ..., d_out]."""
    device = x.device
    named = {"x": x}
    named.update({f"w{k + 1}": w for k, w in enumerate(weights)})
    named.update({f"b{k + 1}": b for k, b in enumerate(biases)})
    _k.require_cuda_f32(what, device, **named)
    if x.ndim != 2:
        raise ValueError(f"{what}: x must be (N, d_in), got {tuple(x.shape)}")
    dims = [x.shape[1]]
    for k, (w, b) in enumerate(zip(weights, biases)):
        if w.ndim != 2 or w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(f"{what}: layer {k + 1} shapes {tuple(w.shape)}, "
                             f"{tuple(b.shape)} do not chain from width {dims[-1]}")
        dims.append(w.shape[1])
    if dims[0] > MAX_IN or max(dims[1:-1]) > MAX_HIDDEN or dims[-1] > MAX_OUT:
        raise ValueError(f"{what}: widths {dims} exceed the kernel's limits "
                         f"(in {MAX_IN}, hidden {MAX_HIDDEN}, out {MAX_OUT})")
    return dims


def _launch(name: str, n_layers: int, x, weights, biases) -> torch.Tensor:
    dims = _check(name, x, weights, biases)
    device = x.device
    n = x.shape[0]
    out = torch.empty((n, dims[-1]), device=device, dtype=torch.float32)
    if n == 0:
        return out
    tensors = [x]
    for w, b in zip(weights, biases):
        tensors += [w, b]
    with torch.cuda.device(device):
        status = _entry(n_layers)(*(_k.ptr(t) for t in tensors), _k.ptr(out), n,
                                  *dims, _k.stream_handle(device))
    _k.check_status("fused_mlp", status, name)
    _k.count_launch(name)
    return out


def fused_mlp2(x, w1, b1, w2, b2) -> torch.Tensor:
    """relu(x @ w1 + b1) @ w2 + b2 on CUDA f32 tensors."""
    return _launch("fused_mlp2", 2, x, (w1, w2), (b1, b2))


def fused_mlp3(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The 3-layer ReLU MLP on CUDA f32 tensors."""
    return _launch("fused_mlp3", 3, x, (w1, w2, w3), (b1, b2, b3))
