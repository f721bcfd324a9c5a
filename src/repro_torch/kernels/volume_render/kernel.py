"""Launch wrapper of the CUDA composite (``csrc/composite.cu``).

Replaces the Pallas kernel `repro.kernels.volume_render.kernel.composite_pallas`.
Validates its inputs, allocates the outputs, launches on the current stream
and counts the launch; raises on anything the kernel does not take and on a
failed launch.  Like the Pallas kernel it does not materialise the
per-sample weights.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import kernels as _k


@functools.cache
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _k.function("composite", "composite_fwd", [p, p, p, p, p, p, p, i, i, p])


def composite(sigma, rgb, deltas, ts):
    """sigma, deltas, ts (R, S), rgb (R, S, 3) f32 on one CUDA device ->
    (color (R, 3), depth (R,), opacity (R,))."""
    device = sigma.device
    _k.require_cuda_f32("composite", device, sigma=sigma, rgb=rgb,
                        deltas=deltas, ts=ts)
    if sigma.ndim != 2:
        raise ValueError(f"composite: sigma must be (R, S), got {tuple(sigma.shape)}")
    r, s = sigma.shape
    if deltas.shape != (r, s) or ts.shape != (r, s) or rgb.shape != (r, s, 3):
        raise ValueError(
            f"composite: shapes sigma {tuple(sigma.shape)}, rgb {tuple(rgb.shape)}, "
            f"deltas {tuple(deltas.shape)}, ts {tuple(ts.shape)} do not agree")
    if s < 1:
        raise ValueError("composite: need at least one sample per ray")
    color = torch.empty((r, 3), device=device, dtype=torch.float32)
    depth = torch.empty((r,), device=device, dtype=torch.float32)
    opacity = torch.empty((r,), device=device, dtype=torch.float32)
    if r == 0:
        return color, depth, opacity
    with torch.cuda.device(device):
        status = _entry()(_k.ptr(sigma), _k.ptr(rgb), _k.ptr(deltas), _k.ptr(ts),
                          _k.ptr(color), _k.ptr(depth), _k.ptr(opacity), r, s,
                          _k.stream_handle(device))
    _k.check_status("composite", status, "composite")
    _k.LAUNCHES["composite"] += 1
    return color, depth, opacity
