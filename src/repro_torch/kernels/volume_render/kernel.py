"""Launch wrappers of the CUDA composite (``csrc/composite.cu``).

`composite` replaces the Pallas kernel
`repro.kernels.volume_render.kernel.composite_pallas`; `composite_backward`
replaces its backward, the autodiff of the reference's plain composite
(`repro.kernels.volume_render.ops._composite_bwd`), with the closed form of
`ref.composite_backward`.  Each validates its inputs, allocates the
outputs, launches on the current stream and counts the launch; raises on
anything the kernel does not take and on a failed launch.  Like the Pallas
kernel neither materialises the per-sample weights.
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


@functools.cache
def _bwd_entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _k.function("composite", "composite_bwd", [p] * 11 + [i, i, p])


def _check_inputs(what, sigma, rgb, deltas, ts):
    """(R, S) of four composite inputs on one CUDA device."""
    _k.require_cuda_f32(what, sigma.device, sigma=sigma, rgb=rgb, deltas=deltas, ts=ts)
    if sigma.ndim != 2:
        raise ValueError(f"{what}: sigma must be (R, S), got {tuple(sigma.shape)}")
    r, s = sigma.shape
    if deltas.shape != (r, s) or ts.shape != (r, s) or rgb.shape != (r, s, 3):
        raise ValueError(
            f"{what}: shapes sigma {tuple(sigma.shape)}, rgb {tuple(rgb.shape)}, "
            f"deltas {tuple(deltas.shape)}, ts {tuple(ts.shape)} do not agree")
    if s < 1:
        raise ValueError(f"{what}: need at least one sample per ray")
    return r, s


def composite(sigma, rgb, deltas, ts):
    """sigma, deltas, ts (R, S), rgb (R, S, 3) f32 on one CUDA device ->
    (color (R, 3), depth (R,), opacity (R,))."""
    device = sigma.device
    r, s = _check_inputs("composite", sigma, rgb, deltas, ts)
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
    _k.count_launch("composite")
    return color, depth, opacity


def composite_backward(sigma, rgb, deltas, ts, g_color, g_depth, g_opacity,
                       needs=(True, True, True, True)):
    """The composite's inputs and the upstream gradients g_color (R, 3),
    g_depth and g_opacity (R,), f32 on one CUDA device -> (d_sigma, d_rgb,
    d_deltas, d_ts), each None where `needs` does not ask for it."""
    device = sigma.device
    r, s = _check_inputs("composite_bwd", sigma, rgb, deltas, ts)
    _k.require_cuda_f32("composite_bwd", device, g_color=g_color, g_depth=g_depth,
                        g_opacity=g_opacity)
    if g_color.shape != (r, 3) or g_depth.shape != (r,) or g_opacity.shape != (r,):
        raise ValueError(
            f"composite_bwd: upstream gradients {tuple(g_color.shape)}, "
            f"{tuple(g_depth.shape)}, {tuple(g_opacity.shape)} do not match R={r}")
    shapes = ((r, s), (r, s, 3), (r, s), (r, s))
    grads = [torch.empty(shape, device=device, dtype=torch.float32) if need else None
             for shape, need in zip(shapes, needs)]
    if r == 0 or not any(needs):
        return tuple(grads)
    out = [_k.ptr(t) if t is not None else None for t in grads]
    with torch.cuda.device(device):
        status = _bwd_entry()(_k.ptr(sigma), _k.ptr(rgb), _k.ptr(deltas), _k.ptr(ts),
                              _k.ptr(g_color), _k.ptr(g_depth), _k.ptr(g_opacity), *out,
                              r, s, _k.stream_handle(device))
    _k.check_status("composite", status, "composite_bwd")
    _k.count_launch("composite_bwd")
    return tuple(grads)
