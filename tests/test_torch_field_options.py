"""The field's last two options in the port, on the CPU: the unmerged
table-gradient commit (``merged_backward=False``) and the "stash" residual
policy.

* ``merged_backward=False``: the reference commits with the XLA scatter
  ``flat.at[addr].add(vals)``, the port with `index_add_`.  Both sum the
  same f32 products, in orders that may differ, so each table gradient is
  held to the JAX package's (`make_hash_encode` / `make_fused_encode` /
  `make_fused_step` on the ``ref`` backend, ``merged_backward=False``)
  within 1e-6 of its largest |value|, with the same rows nonzero.
* "stash": the port's gradients equal "recompute"'s bit for bit (the
  reference's own contract), for each op and for whole training runs.
* `residual_bytes` equals the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.field import FieldConfig as JFieldConfig
from repro.kernels.fused_path import ops as j_fp_ops
from repro.kernels.fused_path import ref as j_fp_ref
from repro.kernels.fused_step import ops as j_fs_ops
from repro.kernels.fused_step import ref as j_fs_ref
from repro.kernels.hash_encode import ops as j_he_ops
from repro.kernels.hash_encode import ref as j_he_ref
from repro_torch.core import occupancy
from repro_torch.core.encoding import HashEncoding, HashGridConfig
from repro_torch.core.field import Field, FieldConfig
from repro_torch.core.rendering import RenderConfig
from repro_torch.core.trainer import Instant3DTrainer, TrainerConfig
from repro_torch.data.rays_dataset import RaySampler
from repro_torch.data.synthetic_scene import build_dataset
from repro_torch.kernels.fused_mlp import ops as t_mlp_ops
from repro_torch.kernels.fused_path import ops as t_fp_ops
from repro_torch.kernels.fused_step import ops as t_fs_ops
from repro_torch.kernels.fused_step import ref as t_fs_ref
from repro_torch.kernels.hash_encode import ops as t_he_ops
from repro_torch.kernels.hash_encode import ref as t_he_ref
from repro_torch.optim.adamw import tree_paths

L, F = 4, 2
TD, TC = 1 << 12, 1 << 10
RES = j_he_ref.level_resolutions(L, 8, 64)
SH, HID, GEO = 16, 16, 4
UNMERGED_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x, copy=True))
    return t.requires_grad_(True) if grad else t


def _points(rng, n):
    pts = rng.uniform(0, 0.999, (n, 3)).astype(np.float32)
    key = np.asarray(j_fp_ref.morton_key(jnp.asarray(pts)))
    return pts[np.argsort(key, kind="stable")]


def _close(got, want, what, tol=UNMERGED_TOL):
    """got within `tol` of the largest |want|, the same rows nonzero."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} vs {tol:g} x {scale:.3e}"
    rows = lambda a: np.flatnonzero(np.abs(a.reshape(-1, a.shape[-1])).sum(-1))  # noqa: E731
    np.testing.assert_array_equal(rows(got), rows(want), err_msg=f"{what} rows")


def _step_inputs(rng, n):
    pts = _points(rng, n)
    sh = (rng.normal(size=(n, SH)) * 0.3).astype(np.float32)
    td = (rng.normal(size=(L, TD, F)) * 0.1).astype(np.float32)
    tc = (rng.normal(size=(L, TC, F)) * 0.1).astype(np.float32)

    def lin(d_in, d_out):
        return ((rng.normal(size=(d_in, d_out)) * (1.0 / d_in) ** 0.5).astype(np.float32),
                (rng.normal(size=(d_out,)) * 0.01).astype(np.float32))

    mlp_d = dict(zip(("w1", "b1"), lin(L * F, HID)))
    mlp_d.update(zip(("w2", "b2"), lin(HID, 1 + GEO)))
    mlp_c = dict(zip(("w1", "b1"), lin(L * F + SH, HID)))
    mlp_c.update(zip(("w2", "b2"), lin(HID, HID)))
    mlp_c.update(zip(("w3", "b3"), lin(HID, 3)))
    return pts, sh, td, tc, mlp_d, mlp_c


# ---- merged_backward=False against the JAX package ----

@pytest.mark.parametrize("seed", [0, 1])
def test_unmerged_hash_encode_gradient_matches_jax(seed):
    rng = np.random.default_rng(seed)
    t = 1 << 10
    res = j_he_ref.level_resolutions(L, 4, 64)
    n = 700
    pts = rng.uniform(0, 1 - 1e-6, size=(n, 3)).astype(np.float32)
    tables = rng.uniform(-1, 1, size=(L, t, F)).astype(np.float32)
    g = rng.normal(size=(n, L * F)).astype(np.float32)
    enc = j_he_ops.make_hash_encode(res, t, F, backend="ref", merged_backward=False)
    want = np.asarray(jax.grad(lambda tb: jnp.sum(enc(jnp.asarray(pts), tb) * g))(
        jnp.asarray(tables)))
    dense = t_he_ref.level_is_dense(res, t)
    grads = {}
    for merged in (False, True):
        tt = _t(tables, grad=True)
        (t_he_ops.hash_encode(_t(pts), tt, res, dense, merged_backward=merged)
         * _t(g)).sum().backward()
        grads[merged] = tt.grad.numpy()
    _close(grads[False], want, "unmerged hash_encode tables")
    _close(grads[False], grads[True], "unmerged vs merged")
    # through the module: HashGridConfig carries the flag
    enc_t = HashGridConfig(n_levels=L, log2_table_size=10, base_resolution=4,
                           max_resolution=64, merged_backward=False)
    tt = _t(tables, grad=True)
    (HashEncoding(enc_t)(_t(pts), tt) * _t(g)).sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(), grads[False])


@pytest.mark.parametrize("seed", [0, 1])
def test_unmerged_fused_encode_gradients_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    pts = _points(rng, n)
    td = rng.uniform(-1, 1, size=(L, TD, F)).astype(np.float32)
    tc = rng.uniform(-1, 1, size=(L, TC, F)).astype(np.float32)
    gd = rng.normal(size=(n, L * F)).astype(np.float32)
    gc = rng.normal(size=(n, L * F)).astype(np.float32)
    j_enc = j_fp_ops.make_fused_encode(RES, (TD, TC), F, backend="ref", merged_backward=False)
    want = jax.grad(lambda a, b: jnp.sum(j_enc(jnp.asarray(pts), a, b)[0] * gd)
                    + jnp.sum(j_enc(jnp.asarray(pts), a, b)[1] * gc),
                    argnums=(0, 1))(jnp.asarray(td), jnp.asarray(tc))
    for policy in ("recompute", "stash"):
        t_td, t_tc = _t(td, grad=True), _t(tc, grad=True)
        od, oc = t_fp_ops.make_fused_encode(RES, (TD, TC), F, merged_backward=False,
                                            residual_policy=policy)(_t(pts), t_td, t_tc)
        ((od * _t(gd)).sum() + (oc * _t(gc)).sum()).backward()
        _close(t_td.grad.numpy(), want[0], f"unmerged fused_encode density ({policy})")
        _close(t_tc.grad.numpy(), want[1], f"unmerged fused_encode color ({policy})")


@pytest.mark.parametrize("seed", [0, 1])
def test_unmerged_fused_step_gradients_match_jax(seed):
    """The table gradients of the plain fused step's unmerged commit; the
    reference's Pallas route ignores the flag, and so do the port's
    kernels."""
    rng = np.random.default_rng(seed)
    n = 256
    pts, sh, td, tc, mlp_d, mlp_c = _step_inputs(rng, n)
    g_d = rng.normal(size=(n, 1 + GEO)).astype(np.float32)
    g_c = rng.normal(size=(n, 3)).astype(np.float32)
    j_step = j_fs_ops.make_fused_step(RES, (TD, TC), F, backend="ref", merged_backward=False)
    jargs = (jnp.asarray(pts), jnp.asarray(sh), jnp.asarray(td), jnp.asarray(tc),
             jax.tree.map(jnp.asarray, mlp_d), jax.tree.map(jnp.asarray, mlp_c))
    _g_sh, g_td, g_tc, _g_md, _g_mc = jax.grad(
        lambda *a: jnp.sum(j_step(*a)[0] * g_d) + jnp.sum(j_step(*a)[1] * g_c),
        argnums=(1, 2, 3, 4, 5))(*jargs)
    for policy in ("recompute", "stash"):
        t_td, t_tc = _t(td, grad=True), _t(tc, grad=True)
        md = {k: _t(v, grad=True) for k, v in mlp_d.items()}
        mc = {k: _t(v, grad=True) for k, v in mlp_c.items()}
        step = t_fs_ops.make_fused_step(RES, (TD, TC), F, merged_backward=False,
                                        residual_policy=policy)
        out_d, raw_c = step(_t(pts), _t(sh), t_td, t_tc, md, mc)
        ((out_d * _t(g_d)).sum() + (raw_c * _t(g_c)).sum()).backward()
        _close(t_td.grad.numpy(), g_td, f"unmerged fused_step density ({policy})")
        _close(t_tc.grad.numpy(), g_tc, f"unmerged fused_step color ({policy})")


# ---- "stash" == "recompute", bit for bit ----

def _grads(fn, leaves, g):
    leaves = [t.detach().clone().requires_grad_(need) for t, need in leaves]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o * gi).sum() for o, gi in zip(outs, g))
    total.backward()
    return [o.detach() for o in outs], [t.grad for t in leaves]


def _equal(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n_layers", [2, 3])
@pytest.mark.parametrize("needs_x", [True, False])
def test_mlp_stash_equals_recompute(n_layers, needs_x):
    rng = np.random.default_rng(n_layers)
    dims = (L * F, HID, 1 + GEO) if n_layers == 2 else (L * F + SH, HID, HID, 3)
    x = _t(rng.normal(size=(300, dims[0])).astype(np.float32))
    x[:7] = 0.0                              # pre-activations exactly at the bias
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        params += [_t(rng.normal(size=(a, b)).astype(np.float32) * 0.3),
                   _t(np.zeros((b,), np.float32))]   # zero bias: ReLU ties at 0
    g = (_t(rng.normal(size=(300, dims[-1])).astype(np.float32)),)
    leaves = [(x, needs_x)] + [(p, True) for p in params]
    fn = t_mlp_ops.mlp2 if n_layers == 2 else t_mlp_ops.mlp3
    out_r, g_r = _grads(lambda *a: fn(*a, residual_policy="recompute"), leaves, g)
    out_s, g_s = _grads(lambda *a: fn(*a, residual_policy="stash"), leaves, g)
    assert _equal(out_r, out_s) and _equal(g_r, g_s)
    with pytest.raises(ValueError, match="residual_policy"):
        fn(x, *params, residual_policy="keep")


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("frozen_color", [False, True])
def test_fused_step_stash_equals_recompute(merged, frozen_color):
    rng = np.random.default_rng(3)
    n = 256
    pts, sh, td, tc, mlp_d, mlp_c = _step_inputs(rng, n)
    g = (_t(rng.normal(size=(n, 1 + GEO)).astype(np.float32)),
         _t(rng.normal(size=(n, 3)).astype(np.float32)))
    leaves = [(_t(pts), False), (_t(sh), True), (_t(td), True), (_t(tc), not frozen_color)]
    leaves += [(_t(v), True) for v in (*mlp_d.values(), *mlp_c.values())]
    kd, kc = list(mlp_d), list(mlp_c)

    def run(policy):
        step = t_fs_ops.make_fused_step(RES, (TD, TC), F, residual_policy=policy,
                                        merged_backward=merged)
        return _grads(lambda p, s, a, b, *m: step(p, s, a, b, dict(zip(kd, m[:4])),
                                                  dict(zip(kc, m[4:]))), leaves, g)

    (out_r, g_r), (out_s, g_s) = run("recompute"), run("stash")
    assert _equal(out_r, out_s) and _equal(g_r, g_s)
    assert (g_s[3] is None) == frozen_color


@pytest.mark.parametrize("merged", [True, False])
def test_fused_encode_stash_equals_recompute(merged):
    rng = np.random.default_rng(4)
    n = 300
    pts = _points(rng, n)
    tables = [_t(rng.uniform(-1, 1, size=(L, t, F)).astype(np.float32)) for t in (TD, TC)]
    g = tuple(_t(rng.normal(size=(n, L * F)).astype(np.float32)) for _ in range(2))
    leaves = [(_t(pts), False), (tables[0], True), (tables[1], True)]
    res = {p: _grads(t_fp_ops.make_fused_encode(RES, (TD, TC), F, residual_policy=p,
                                                merged_backward=merged), leaves, g)
           for p in ("recompute", "stash")}
    assert _equal(res["recompute"][0], res["stash"][0])
    assert _equal(res["recompute"][1], res["stash"][1])


def _small_run(field_cfg, steps=24, seed=0):
    """tests/test_torch_train.py's run: the bitfield is live from step 12,
    and the budget takes both routes."""
    rcfg = RenderConfig(n_samples=16)
    cfg = TrainerConfig(n_rays=64, render=rcfg, budget_headroom=0.7, min_budget=64,
                        occ=occupancy.OccupancyConfig(resolution=16, update_interval=4,
                                                      warmup_steps=8))
    _scene, ds = build_dataset(0, n_views=4, h=16, w=16, cfg=rcfg, gt_samples=48,
                               device="cpu")
    tr = Instant3DTrainer(Field(field_cfg), cfg, device="cpu")
    state, hist = tr.train(tr.init(torch.Generator().manual_seed(seed)),
                           RaySampler(ds, device="cpu"), iters=steps, log_every=1)
    return state, hist


def _bits(tree) -> list[bytes]:
    return [t.detach().numpy().tobytes() for _, t in tree_paths(tree)]


@pytest.mark.parametrize("decomposed", [True, False])
def test_stash_training_run_is_the_default_run(decomposed):
    """24 steps of both fields (dense steps, then compacted ones through the
    fused step or the fused encode) end on the same bytes under "stash"."""
    geom = dict(n_levels=L, max_resolution=64, log2_table_density=12,
                log2_table_color=10, hidden=HID, decomposed=decomposed)
    a, ha = _small_run(FieldConfig(**geom))
    b, hb = _small_run(FieldConfig(**geom, residual_policy="stash"))
    assert any(bud is not None for bud in ha["budget"])      # compacted steps ran
    assert ha["loss"] == hb["loss"]
    assert _bits(a.params) == _bits(b.params)
    assert _bits(a.opt_state.m) == _bits(b.opt_state.m)
    assert torch.equal(a.occ_state.density_ema, b.occ_state.density_ema)


def test_unmerged_training_run_tracks_the_merged_run():
    """merged_backward=False trains: on the CPU `index_add_` sums each row in
    another order than the merged commit, so the two runs' losses agree to
    rounding, and the run repeats its own bytes."""
    geom = dict(n_levels=L, max_resolution=64, log2_table_density=12,
                log2_table_color=10, hidden=HID)
    _a, ha = _small_run(FieldConfig(**geom))
    b, hb = _small_run(FieldConfig(**geom, merged_backward=False))
    c, _hc = _small_run(FieldConfig(**geom, merged_backward=False))
    np.testing.assert_allclose(hb["loss"], ha["loss"], rtol=1e-4)
    assert _bits(b.params) == _bits(c.params)


# ---- the configs and the residual accounting ----

def test_field_config_carries_both_options():
    cfg = FieldConfig()
    assert cfg.merged_backward is True and cfg.residual_policy == "recompute"
    j_names = {f.name for f in dataclasses.fields(JFieldConfig)}
    t_names = {f.name for f in dataclasses.fields(FieldConfig)}
    assert t_names == j_names
    off = FieldConfig(merged_backward=False)
    assert not off.grid_cfg("density").merged_backward
    assert not off.grid_cfg("color").merged_backward
    assert FieldConfig().grid_cfg("color") == dataclasses.replace(
        off.grid_cfg("color"), merged_backward=True)


@pytest.mark.parametrize("policy", ["stash", "recompute"])
@pytest.mark.parametrize("n,levels,feats,tables,itemsize", [
    (100_000, 16, 2, (1 << 18, 1 << 16), 4),
    (8192, 16, 2, (1 << 18, 1 << 16), 4),
    (513, 4, 4, (1 << 12,), 2),
])
def test_residual_bytes_match_jax(policy, n, levels, feats, tables, itemsize):
    args = (policy, n, levels, feats, tables, 16, 32 * 64 + 64 + 64 * 16 + 16,
            48 * 64 + 64 + 64 * 64 + 64 + 64 * 3 + 3)
    assert t_fs_ref.residual_bytes(*args, itemsize=itemsize) == \
        j_fs_ref.residual_bytes(*args, itemsize=itemsize)


def test_residual_bytes_stash_is_smaller_at_scale_and_unknown_raises():
    common = (100_000, 16, 2, (1 << 18, 1 << 16), 16, 3152, 7491)
    assert t_fs_ref.residual_bytes("stash", *common) > 0
    assert t_fs_ref.residual_bytes("recompute", *common) < \
        t_fs_ref.residual_bytes("stash", *common)
    with pytest.raises(ValueError, match="residual_policy"):
        t_fs_ref.residual_bytes("keep", *common)
