"""Launch wrappers of the CUDA one-op step (``csrc/fused_step.cu``).

`fused_step_fwd` replaces `repro.kernels.fused_step.kernel.fused_step_pallas`
and `fused_step_bwd` replaces `fused_step_bwd_pallas`.  Each validates its
inputs, allocates outputs and scratch, launches on the current stream and
counts the launch; raises on anything the kernels do not take and on a
failed launch.  The backward kernel writes each grid's table-gradient
stream in the plain version's order (level, point, corner; `ref.bwd_table_stream`
lays it out the same way); its second pass orders the stream stably by
address with the `bum_sort` kernel and commits it with the `bum_scatter`
kernel (each counts its own launches), so each table row is summed in the
plain version's order.  Both grids' tables share one element type, f32,
bf16 or f16 (`FieldConfig.grid_dtype`): the kernels load their own 2-byte
rows and widen them in registers; the streams and the commit stay f32, and
each committed table gradient is cast to its table's dtype after the commit,
as the reference's backward casts it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import kernels as _k
from ..grid_update import kernel as gu_kernel

MLP_D_KEYS = ("w1", "b1", "w2", "b2")
MLP_C_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")
MAX_LEVELS = 32
FEATURE_COUNTS = (1, 2, 4, 8)
BWD_POINTS = 32             # points per backward block (kTilePoints)
MAX_SMEM = 232448           # bytes of shared memory a block may use
MAX_OUT_D, MAX_OUT_C = 16, 4


@functools.cache
def _entry(name: str):
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "fused_step_forward":
        return _k.function("fused_step", name, [p] * 9 + [i] + [p] * 3)
    if name == "fused_step_backward":
        return _k.function("fused_step", name, [p] * 11 + [i] + [p] * 8)
    fn = _k.function("fused_step", "fused_step_smem_bytes", [p, i])
    fn.restype = ctypes.c_longlong
    return fn


def _mlp_list(mlp_d: dict, mlp_c: dict) -> list:
    return [mlp_d[k] for k in MLP_D_KEYS] + [mlp_c[k] for k in MLP_C_KEYS]


def _check(what, points, sh, t_density, t_color, mlp_d, mlp_c, resolutions,
           dense_d, dense_c) -> tuple[list[int], int]:
    """Validate the inputs; returns the 11 dims the C side takes and the
    tables' element type code."""
    device = points.device
    mlps = _mlp_list(mlp_d, mlp_c)
    named = {"points": points, "sh": sh}
    named.update({f"mlp{k}": t for k, t in enumerate(mlps)})
    _k.require_cuda_f32(what, device, **named)
    code = _k.table_type(what, device, t_density=t_density, t_color=t_color)
    n = points.shape[0]
    if points.ndim != 2 or points.shape[1] != 3 or sh.ndim != 2 or sh.shape[0] != n:
        raise ValueError(f"{what}: points {tuple(points.shape)} / sh {tuple(sh.shape)} "
                         "must be (N, 3) / (N, S)")
    if t_density.ndim != 3 or t_color.ndim != 3 or \
            t_density.shape[0] != t_color.shape[0] or t_density.shape[2] != t_color.shape[2]:
        raise ValueError(f"{what}: tables {tuple(t_density.shape)}, {tuple(t_color.shape)} "
                         "must be (L, T, F) with one L and F")
    levels, table_d, f = t_density.shape
    table_c = t_color.shape[1]
    if not 1 <= levels <= MAX_LEVELS or len(resolutions) != levels or \
            len(dense_d) != levels or len(dense_c) != levels:
        raise ValueError(f"{what}: need 1..{MAX_LEVELS} levels with one resolution and "
                         f"dense flag per grid each, got {levels}")
    if f not in FEATURE_COUNTS:
        raise ValueError(f"{what}: F={f} not in {FEATURE_COUNTS}")
    for t in (table_d, table_c):
        if t & (t - 1):
            raise ValueError(f"{what}: table size {t} is not a power of two")
    feat, s_dim = levels * f, sh.shape[1]
    w1d, b1d, w2d, b2d, w1c, b1c, w2c, b2c, w3c, b3c = mlps
    chain = [(w1d, b1d, feat), (w2d, b2d, w1d.shape[1]),
             (w1c, b1c, feat + s_dim), (w2c, b2c, w1c.shape[1]), (w3c, b3c, w2c.shape[1])]
    for w, b, d_in in chain:
        if w.ndim != 2 or w.shape[0] != d_in or b.shape != (w.shape[1],):
            raise ValueError(f"{what}: MLP layer {tuple(w.shape)}, {tuple(b.shape)} does "
                             f"not chain from width {d_in}")
    if w2d.shape[1] > MAX_OUT_D or w3c.shape[1] > MAX_OUT_C:
        raise ValueError(f"{what}: head widths {w2d.shape[1]}, {w3c.shape[1]} exceed "
                         f"{MAX_OUT_D}, {MAX_OUT_C}")
    return [n, levels, f, s_dim, table_d, table_c, w1d.shape[1], w2d.shape[1],
            w1c.shape[1], w2c.shape[1], w3c.shape[1]], code


def _c_args(dims, resolutions, dense_d, dense_c, mlps):
    levels = dims[1]
    as_ints = lambda xs: (ctypes.c_int * levels)(*(int(x) for x in xs))  # noqa: E731
    return ((ctypes.c_int * 11)(*dims), as_ints(resolutions), as_ints(dense_d),
            as_ints(dense_c), (ctypes.c_void_p * 10)(*(t.data_ptr() for t in mlps)))


def _check_smem(what: str, c_dims, backward: bool) -> None:
    need = _entry("fused_step_smem_bytes")(c_dims, int(backward))
    if need > MAX_SMEM:
        raise ValueError(f"{what}: these widths need {need} bytes of shared memory per "
                         f"block, more than the card's {MAX_SMEM}")


def fused_step_fwd(points, sh, t_density, t_color, mlp_d: dict, mlp_c: dict,
                   resolutions, dense_d, dense_c):
    """points (N, 3), sh (N, S), MLP dicts f32, tables (L, T, F) f32, bf16 or
    f16, on one CUDA device -> (out_d (N, 1+geo), raw_c (N, 3)) f32."""
    dims, code = _check("fused_step_fwd", points, sh, t_density, t_color, mlp_d, mlp_c,
                        resolutions, dense_d, dense_c)
    device, n = points.device, dims[0]
    out_d = torch.empty((n, dims[7]), device=device, dtype=torch.float32)
    out_c = torch.empty((n, dims[10]), device=device, dtype=torch.float32)
    if n == 0:
        return out_d, out_c
    mlps = _mlp_list(mlp_d, mlp_c)
    c_dims, c_res, c_dd, c_dc, c_mlp = _c_args(dims, resolutions, dense_d, dense_c, mlps)
    _check_smem("fused_step_fwd", c_dims, backward=False)
    with torch.cuda.device(device):
        status = _entry("fused_step_forward")(
            _k.ptr(points), _k.ptr(sh), _k.ptr(t_density), _k.ptr(t_color), c_mlp, c_res,
            c_dd, c_dc, c_dims, code, _k.ptr(out_d), _k.ptr(out_c), _k.stream_handle(device))
    _k.check_status("fused_step", status, "fused_step_fwd")
    _k.count_launch("fused_step_fwd")
    return out_d, out_c


def _commit(addr, vals, levels: int, table_size: int, f: int):
    """Pass 2 of one grid: order its stream by address (stable, so equal
    addresses keep stream order; the keys span [0, L*T], the spill row L*T
    included) and commit it into a fresh (L, T, F) gradient table."""
    addr_s, vals_s = gu_kernel.bum_sort(addr, vals, (levels * table_size).bit_length())
    flat = torch.zeros((levels * table_size, f), dtype=torch.float32, device=addr.device)
    gu_kernel.bum_scatter(flat, addr_s, vals_s)
    return flat.reshape(levels, table_size, f)


def fused_step_bwd_launch(points, sh, g_d, g_c, t_density, t_color, mlp_d: dict,
                          mlp_c: dict, resolutions, dense_d, dense_c, *,
                          need_density: bool = True, need_color: bool = True):
    """Pass 1 of the backward, the kernel launch alone, on CUDA tensors (the
    tables f32, bf16 or f16, the rest f32).  Returns (streams, grad_mlp,
    d_sh): streams maps "density" / "color" to that grid's (addr (M,) int64,
    vals (M, F) f32) update stream, or None for a grid not needed; grad_mlp
    (P,) holds the MLP gradients in `_mlp_list` order."""
    dims, code = _check("fused_step_bwd", points, sh, t_density, t_color, mlp_d, mlp_c,
                        resolutions, dense_d, dense_c)
    _k.require_cuda_f32("fused_step_bwd", points.device, g_d=g_d, g_c=g_c)
    n, levels, f = dims[0], dims[1], dims[2]
    if g_d.shape != (n, dims[7]) or g_c.shape != (n, dims[10]):
        raise ValueError(f"fused_step_bwd: cotangents {tuple(g_d.shape)}, "
                         f"{tuple(g_c.shape)} do not match the heads")
    device = points.device
    mlps = _mlp_list(mlp_d, mlp_c)
    n_params = sum(t.numel() for t in mlps)
    n_blocks = (n + BWD_POINTS - 1) // BWD_POINTS
    stream_len = n_blocks * levels * BWD_POINTS * 8
    new = lambda shape, dtype=torch.float32: torch.empty(shape, device=device, dtype=dtype)  # noqa: E731
    partials, grad_mlp, d_sh = new((max(n_blocks, 1), n_params)), new((n_params,)), new(sh.shape)
    streams = {}
    for name, need in (("density", need_density), ("color", need_color)):
        streams[name] = ((new((stream_len,), torch.int64), new((stream_len, f)))
                         if need and n else None)
    if n == 0:
        grad_mlp.zero_()
        return streams, grad_mlp, d_sh
    c_dims, c_res, c_dd, c_dc, c_mlp = _c_args(dims, resolutions, dense_d, dense_c, mlps)
    _check_smem("fused_step_bwd", c_dims, backward=True)
    null = ctypes.c_void_p(None)
    sd, sc = streams["density"], streams["color"]
    with torch.cuda.device(device):
        status = _entry("fused_step_backward")(
            _k.ptr(points), _k.ptr(sh), _k.ptr(g_d), _k.ptr(g_c), _k.ptr(t_density),
            _k.ptr(t_color), c_mlp, c_res, c_dd, c_dc, c_dims, code, _k.ptr(partials),
            _k.ptr(d_sh),
            _k.ptr(sd[0]) if sd else null, _k.ptr(sd[1]) if sd else null,
            _k.ptr(sc[0]) if sc else null, _k.ptr(sc[1]) if sc else null,
            _k.ptr(grad_mlp), _k.stream_handle(device))
    _k.check_status("fused_step", status, "fused_step_bwd")
    _k.count_launch("fused_step_bwd")
    return streams, grad_mlp, d_sh


def fused_step_bwd(points, sh, g_d, g_c, t_density, t_color, mlp_d: dict, mlp_c: dict,
                   resolutions, dense_d, dense_c, *, need_density: bool = True,
                   need_color: bool = True):
    """The backward on CUDA tensors (the tables f32, bf16 or f16, the rest
    f32); g_d (N, 1+geo) and g_c (N, 3) are the cotangents.  Returns
    (d_t_density or None, d_t_color or None, d_mlp_d, d_mlp_c, d_sh); each
    table gradient is committed in f32 and leaves in its table's dtype; a
    grid not needed gets no update stream."""
    streams, grad_mlp, d_sh = fused_step_bwd_launch(
        points, sh, g_d, g_c, t_density, t_color, mlp_d, mlp_c, resolutions, dense_d,
        dense_c, need_density=need_density, need_color=need_color)
    levels, f = t_density.shape[0], t_density.shape[2]
    grads = []
    for (name, need), t in zip((("density", need_density), ("color", need_color)),
                               (t_density, t_color)):
        if not need:
            grads.append(None)
        elif streams[name] is None:
            grads.append(torch.zeros_like(t))
        else:
            grads.append(_commit(*streams[name], levels, t.shape[1], f).to(t.dtype))
    mlps = _mlp_list(mlp_d, mlp_c)
    pieces = list(torch.split(grad_mlp, [t.numel() for t in mlps]))
    shaped = [piece.reshape(t.shape) for piece, t in zip(pieces, mlps)]
    g_mlp_d = dict(zip(MLP_D_KEYS, shaped[:4]))
    g_mlp_c = dict(zip(MLP_C_KEYS, shaped[4:]))
    return grads[0], grads[1], g_mlp_d, g_mlp_c, d_sh
