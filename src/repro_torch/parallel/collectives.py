"""Explicit collectives: the int8 error-feedback compressed gradient sync.

The port of `repro.parallel.collectives`, step for step, on
`torch.distributed`.  The cross-pod gradient all-reduce is the only hop
between pods in the production mesh; `compressed_psum_mean` is a quantized
exchange over one process group:

    1. residual-corrected gradient  g' = g + e         (error feedback)
    2. per-leaf symmetric int8 quantization            (scale = max|g'|/127)
    3. reduce-scatter via an int8 `all_to_all_single`  (wire: S/4 vs f32)
    4. local dequant-sum of the owned chunk, in rank order
    5. int8 `all_gather_into_tensor` of the reduced chunks (wire: S/4)
    6. new residual e = g' - dequant(quant(g'))

The scales travel by `all_gather_into_tensor` too.  Wire bytes: 2(n-1)/n
S_int8, ~4x less than an f32 ring all-reduce; error feedback keeps the bias
bounded.  Rounding is half to even (`torch.round`, as `jnp.round`) and
every division is rounded once (`_div`), so the int8 payloads are the
reference's bit for bit, on the CPU and on a card alike.  Without a process group
(a one-rank mesh, or no initialised world) the exchange is a world of one
and no collective runs.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..optim.adamw import tree_from_paths, tree_paths


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d rounded once, on any device: CUDA divides by a Python number
    as a product with its reciprocal (an ulp off at times), by a tensor
    exactly."""
    return a / a.new_full((), d)


def _quantize(g: torch.Tensor):
    scale = _div(torch.max(torch.abs(g)), 127.0) + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(...) -> (n, ...): every rank's `t`, in rank order."""
    if group is None:
        return t[None]
    n = _world(group)
    # stacked along dim 0: gloo wants an input of at least one dim and the
    # output as (n * its first dim, ...)
    src = t.reshape(1) if t.dim() == 0 else t.contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view((n,) + tuple(t.shape))


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) -> (n, ...): row j of the result is row `rank` of rank j's `t`."""
    if group is None:
        return t.clone()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def compressed_psum_mean(g: torch.Tensor, err: torch.Tensor, group=None):
    """The mean of g over `group`'s ranks with an int8 wire format and
    error feedback: (mean_g f32, new_err f32), both g's shape."""
    n = _world(group)
    orig_shape = g.shape
    g = g.to(torch.float32) + err.to(torch.float32)

    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % n
    flat_p = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat

    q, scale = _quantize(flat_p)
    new_err = (flat_p - _dequantize(q, scale))[: flat.shape[0]].reshape(orig_shape)

    # reduce-scatter: chunk j goes to rank j; each rank sums the chunks it owns
    recv = _all_to_all(q.reshape(n, -1), group)            # (n, S/n) int8
    scales = _all_gather(scale, group)                      # (n,) f32
    parts = recv.to(torch.float32) * scales[:, None]
    local_sum = parts[0]
    for j in range(1, n):
        local_sum = local_sum + parts[j]                    # (S/n,), in rank order

    # re-quantize the reduced chunk, all-gather int8
    q2, scale2 = _quantize(local_sum)
    gq = _all_gather(q2, group)                             # (n, S/n) int8
    gs = _all_gather(scale2, group)                         # (n,)
    summed = (gq.to(torch.float32) * gs[:, None]).reshape(-1)[: flat.shape[0]]
    return _div(summed, n).reshape(orig_shape), new_err


def compressed_grad_sync(grads, err_state, mesh, axis_name: str = "pod"):
    """Leaf by leaf compressed mean over one mesh axis (the cross-pod hop):
    (new grads, new error state).  The grads must already agree within the
    other axes; this is only the cross-pod mean."""
    group = mesh.group((axis_name,))
    errs = dict(tree_paths(err_state))
    outs = [(p, compressed_psum_mean(g, errs[p], group)) for p, g in tree_paths(grads)]
    return (tree_from_paths([(p, o[0]) for p, o in outs]),
            tree_from_paths([(p, o[1]) for p, o in outs]))


def init_error_state(params):
    """f32 zeros shaped like every param, on its device."""
    return tree_from_paths([(p, torch.zeros(tuple(t.shape), dtype=torch.float32,
                                            device=t.device)) for p, t in tree_paths(params)])
