"""The composite's backward in closed form (`volume_render.ref.
composite_backward`, the plain version of the CUDA kernel `composite_bwd`)
on the CPU.

The same numpy inputs, made from a seed, with random upstream gradients, go
through `jax.vjp` of the JAX package's `ref.composite` (the function of its
`_composite_bwd`), through the autograd of the port's `ref.composite` and
through the closed form, at (R, S) in {(40, 12), (7, 1), (16, 33), (64,
48)}: one sample, a ray longer than one 32-lane group, and the training
shape's S.  Tolerance: 1e-5 of the largest |value| of each gradient (the
tolerance of tests/test_torch_grad_kernels.py's `_close_grad`), against
the autograd of the port's plain composite run in f64 (the exact function).
The JAX reference computes in f32 whatever it is given, and its autodiff
forms dL/dtau_k as v_k T_k alpha_k - sum_{j>=k} w_j v_j + v_k T_k
exp(-tau_k): where the last term is small beside the first two (one sample
of optical depth ~15: every gradient ~1e-6) it is lost in their rounding.
Against JAX the scale of d_sigma (d_deltas) is therefore the larger of its
largest |value| and the largest delta_k (sigma_k) sum_{j>=k} |w_j v_j|,
the terms that autodiff cancels; d_rgb and d_ts cancel nothing.

Then an emulation of the kernel's order of operations in f32 (lane groups
of G = the power of two >= min(S, 32), a Hillis-Steele scan in each chunk
of G samples, the chunks' carries, butterfly sums, the reversed scan for
S_{>k}) is held to the plain forward and backward within the same
tolerances, so the kernel's scheme is checked where no card is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.volume_render import ref as j_vr_ref
from repro_torch import kernels as t_kernels
from repro_torch.kernels.volume_render import ops as t_vr_ops
from repro_torch.kernels.volume_render import ref as t_vr_ref

SHAPES = [(40, 12), (7, 1), (16, 33), (64, 48)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(r, s):
    rng = np.random.default_rng(1000 * r + s)
    sigma = rng.uniform(0, 20, size=(r, s)).astype(np.float32)
    rgb = rng.uniform(0, 1, size=(r, s, 3)).astype(np.float32)
    ts = np.sort(rng.uniform(2, 6, size=(r, s)).astype(np.float32), axis=-1)
    deltas = np.diff(ts, axis=-1, append=ts[:, -1:] + 4.0 / s).astype(np.float32)
    grads = tuple(rng.normal(size=sh).astype(np.float32) for sh in [(r, 3), (r,), (r,)])
    return (sigma, rgb, deltas, ts), grads


def _close_grad(got, want, what, scale=0.0):
    """got within 1e-5 of the largest |want| (or of `scale` if larger)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), scale, 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, f"{what}: max err {err:.3e} vs 1e-5 x {scale:.3e}"


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


NAMES = ("sigma", "rgb", "deltas", "ts")


@pytest.mark.parametrize("r,s", SHAPES)
def test_closed_form_is_jax_vjp_of_the_reference(r, s):
    inputs, grads = _inputs(r, s)

    def j_out(*a):
        o = j_vr_ref.composite(*a)
        return o.color, o.depth, o.opacity

    _, vjp = jax.vjp(j_out, *(jnp.asarray(x) for x in inputs))
    want = vjp(tuple(jnp.asarray(g) for g in grads))
    got = t_vr_ref.composite_backward(*(_t(x) for x in inputs), *(_t(g) for g in grads))
    cancelled = _cancelled_terms(inputs, grads)
    sigma, _, deltas, _ = inputs
    scales = (float((deltas * cancelled).max()), 0.0, float((sigma * cancelled).max()), 0.0)
    for name, g, w, scale in zip(NAMES, got, want, scales):
        assert g.shape == tuple(w.shape), name
        _close_grad(g.numpy(), np.asarray(w), f"d_{name}", scale)


def _cancelled_terms(inputs, grads):
    """(R, S): sum_{j>=k} |w_j v_j|, in f64."""
    sigma, rgb, deltas, ts = (np.asarray(x, np.float64) for x in inputs)
    g_color, g_depth, g_opacity = (np.asarray(g, np.float64) for g in grads)
    tau = sigma * deltas
    w = np.exp(-(np.cumsum(tau, axis=-1) - tau)) * (1.0 - np.exp(-tau))
    v = (rgb * g_color[:, None, :]).sum(-1) + ts * g_depth[:, None] + g_opacity[:, None]
    return np.flip(np.cumsum(np.flip(np.abs(w * v), -1), axis=-1), -1)


@pytest.mark.parametrize("r,s", SHAPES)
def test_closed_form_is_the_autograd_of_the_plain_composite(r, s):
    """In f32 against the autograd of the plain composite in f64."""
    inputs, grads = _inputs(r, s)
    leaves = [_t(x).double().requires_grad_(True) for x in inputs]
    out = t_vr_ref.composite(*leaves)[:3]
    want = torch.autograd.grad(out, leaves, tuple(_t(g).double() for g in grads))
    got = t_vr_ref.composite_backward(*(_t(x) for x in inputs), *(_t(g) for g in grads))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        _close_grad(g.numpy(), w.numpy(), f"d_{name}")


@pytest.mark.parametrize("needs", [(True, False, False, False), (False, True, False, False),
                                   (True, True, False, False), (True, True, True, True)])
def test_the_cpu_op_backward_is_the_plain_autograd_and_launches_nothing(needs):
    """`Composite` on CPU tensors differentiates through the plain version's
    autograd for any subset of inputs (the kernel route on CUDA tensors is
    the card tests' business), and no kernel is counted."""
    inputs, grads = _inputs(40, 12)
    before = dict(t_kernels.LAUNCHES)
    leaves = [_t(x).requires_grad_(need) for x, need in zip(inputs, needs)]
    out = t_vr_ops.Composite.apply(*leaves)
    sum((o * _t(g)).sum() for o, g in zip(out, grads)).backward()
    want = t_vr_ref.composite_backward(*(_t(x) for x in inputs), *(_t(g) for g in grads))
    for name, leaf, need, w in zip(NAMES, leaves, needs, want):
        if need:
            _close_grad(leaf.grad.numpy(), w.numpy(), f"d_{name}")
        else:
            assert leaf.grad is None, name
    assert t_kernels.LAUNCHES == before


# ---- the kernel's order of operations, emulated in f32 ----

def _group(s):
    g = 1
    while g < s and g < 32:
        g *= 2
    return g


def _scan(x):
    """Hillis-Steele inclusive scan along the last axis, as the lanes'
    `__shfl_up_sync` rounds take it."""
    o = 1
    while o < x.shape[-1]:
        x = torch.cat([x[..., :o], x[..., o:] + x[..., :-o]], dim=-1)
        o *= 2
    return x


def _suffix_scan(x):
    return torch.flip(_scan(torch.flip(x, (-1,))), (-1,))


def _butterfly(x):
    """The `__shfl_xor_sync` reduction over the last axis."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _chunks(x, g):
    """(R, S, ...) -> (R, C, G, ...), zero-padded to C * G samples."""
    r, s = x.shape[:2]
    c = -(-s // g)
    pad = torch.zeros((r, c * g - s) + tuple(x.shape[2:]), dtype=x.dtype)
    return torch.cat([x, pad], dim=1).reshape((r, c, g) + tuple(x.shape[2:]))


def _emulated(sigma, rgb, deltas, ts, g_color, g_depth, g_opacity):
    r, s = sigma.shape
    g = _group(s)
    sig, dl, t, c = (_chunks(x, g) for x in (sigma, deltas, ts, rgb))
    n_chunks = sig.shape[1]
    tau = sig * dl
    carry = torch.zeros(r)
    before, w_all, trans_all = [], [], []
    acc = torch.zeros((r, g, 5))
    for k in range(n_chunks):
        incl = _scan(tau[:, k])
        before.append(carry)
        trans = torch.exp(-((carry[:, None] + incl) - tau[:, k]))
        w = trans * (1.0 - torch.exp(-tau[:, k]))
        acc = acc + w[..., None] * torch.cat([c[:, k], t[:, k, :, None],
                                              torch.ones((r, g, 1))], dim=-1)
        carry = carry + incl[:, -1]
        w_all.append(w)
        trans_all.append(trans)
    out = _butterfly(acc.transpose(1, 2))                   # (R, 5)
    after = torch.zeros(r)
    d_tau = [None] * n_chunks
    for k in reversed(range(n_chunks)):
        e = torch.exp(-tau[:, k])
        v = (c[:, k] * g_color[:, None, :]).sum(-1) + t[:, k] * g_depth[:, None] \
            + g_opacity[:, None]
        suffix = _suffix_scan(w_all[k] * v)
        later = torch.cat([suffix[:, 1:], torch.zeros((r, 1))], dim=-1)
        d_tau[k] = v * trans_all[k] * e - (after[:, None] + later)
        after = after + suffix[:, 0]
    d_tau = torch.stack(d_tau, dim=1).reshape(r, -1)[:, :s]
    w = torch.stack(w_all, dim=1).reshape(r, -1)[:, :s]
    grads = (deltas * d_tau, w[..., None] * g_color[:, None, :], sigma * d_tau,
             w * g_depth[:, None])
    return (out[:, :3], out[:, 3], out[:, 4]), grads


@pytest.mark.parametrize("r,s", SHAPES + [(5, 200), (33, 64)])
def test_the_kernels_scan_order_meets_the_plain_versions(r, s):
    inputs, grads = _inputs(r, s)
    x = [_t(v) for v in inputs]
    gs = [_t(v) for v in grads]
    fwd, bwd = _emulated(*x, *gs)
    want = t_vr_ref.composite(*x)
    for name, got, w in zip(("color", "depth", "opacity"), fwd, want[:3]):
        assert float((got - w).abs().max()) <= 5e-5, name
    for name, got, w in zip(NAMES, bwd, t_vr_ref.composite_backward(*x, *gs)):
        _close_grad(got.numpy(), w.numpy(), f"d_{name}")
