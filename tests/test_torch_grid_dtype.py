"""Half-width hash-grid tables (`FieldConfig.grid_dtype`) in the port, on the
CPU, against the JAX package.

The same numpy inputs, made from a seed, go to both packages; the tables
are handed to JAX as ``jnp.bfloat16`` / ``jnp.float16`` and to the port
through `repro_torch.bridge` (bf16 as raw bits).  JAX runs its ``ref``
backend, and its Pallas kernels in interpret mode where the reference's own
tests run them.  Every test runs at bf16 and at f16.  Tolerances:

* forwards (#1, #8, #5) within 1e-5 abs: both packages widen the 2-byte rows
  to f32 exactly and sum as in the f32 tests;
* table gradients in the table's dtype, each element within one ulp of it
  beyond the f32 tests' tolerance, with the same rows nonzero: both
  packages sum the gradient in f32 (within 1e-5 of the largest |value| of
  each other, as the f32 tests hold them) and round it to the table's dtype
  once, to within half an ulp (relative 2^-8 for bf16, 2^-11 for f16; f16's
  subnormals below 2^-14 are spaced 2^-24), so two values may land one ulp
  apart;
* MLP and SH gradients as the f32 tests hold them (1e-5 of the largest
  |gradient|);
* AdamW on 2-byte leaves bit for bit, masked and unmasked;
* a 24-step run of either field: budgets, overflow and live fraction equal
  to JAX's, losses within 1e-2 relative (as tests/test_torch_train.py);
* the BUM commit into a nonzero 2-byte table bit for bit against the
  reference's Pallas kernel; checkpoints and the bridge bit for bit;
* the service's four bit-identity contracts on 2-byte tables, chip_smoke's
  phase 9 rehearsed, and no import of ml_dtypes in the port.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.core import encoding as j_enc
from repro.core import field as j_field
from repro.core import losses as j_losses
from repro.core import occupancy as j_occ
from repro.core import rendering as j_rendering
from repro.core import trainer as j_trainer
from repro.core.pipeline import RenderPipeline as JPipeline
from repro.data import rays_dataset as j_rays
from repro.data import synthetic_scene as j_scene
from repro.kernels.fused_path import kernel as j_fp_kernel
from repro.kernels.fused_path import ops as j_fp_ops
from repro.kernels.fused_path import ref as j_fp_ref
from repro.kernels.fused_step import ops as j_fs_ops
from repro.kernels.grid_update import kernel as j_gu_kernel
from repro.kernels.grid_update import ops as j_gu_ops
from repro.kernels.hash_encode import ops as j_he_ops
from repro.kernels.hash_encode import ref as j_he_ref
from repro.optim import AdamW as JAdamW
from repro_torch import bridge, smoke
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import field as t_field
from repro_torch.core import occupancy as t_occ
from repro_torch.core import rendering as t_rendering
from repro_torch.core import trainer as t_trainer
from repro_torch.data import rays_dataset as t_rays
from repro_torch.kernels.fused_path import ops as t_fp_ops
from repro_torch.kernels.fused_path import ref as t_fp_ref
from repro_torch.kernels.fused_step import ops as t_fs_ops
from repro_torch.kernels.grid_update import ops as t_gu_ops
from repro_torch.kernels.hash_encode import ops as t_he_ops
from repro_torch.optim import AdamW as TAdamW
from repro_torch.optim.adamw import tree_paths

L, F = 4, 2
TD, TC = 1 << 12, 1 << 10
RES = j_he_ref.level_resolutions(L, 8, 64)
SH, HID, GEO = 16, 16, 4
DTYPES = ["bfloat16", "float16"]
# each 2-byte float's significand bits below its leading one, and its
# smallest normal value (below it the spacing is fixed: f16's 2^-24)
MANTISSA_BITS = {"bfloat16": 7, "float16": 10}
SMALLEST_NORMAL = {"bfloat16": 2.0 ** -126, "float16": 2.0 ** -14}

GEOM = dict(n_levels=L, max_resolution=64, log2_table_density=12,
            log2_table_color=10, hidden=HID)
RCFG = dict(n_samples=16)
DATA = dict(n_views=4, h=16, w=16, gt_samples=48)
TRAIN = dict(n_rays=64, iters=24, budget_headroom=0.7, min_budget=64)
OCC = dict(resolution=16, warmup_steps=8, update_interval=4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, grad=False):
    t = bridge.array_to_tensor(x)
    return t.requires_grad_(True) if grad else t


def _half(x: np.ndarray, dtype: str):
    """An f32 numpy array as the JAX 2-byte array and the port's tensor of
    the same values (through the bridge, as a JAX leaf crosses)."""
    j = jnp.asarray(x).astype(jnp.dtype(dtype))
    return j, bridge.array_to_tensor(np.asarray(j))


def _ulp(x: np.ndarray, dtype: str) -> np.ndarray:
    """The spacing of `dtype`'s values at |x| (subnormals included)."""
    _, e = np.frexp(np.maximum(np.abs(x), SMALLEST_NORMAL[dtype]))
    return np.ldexp(1.0, e - 1 - MANTISSA_BITS[dtype])


def _within_rounding(got: torch.Tensor, want, dtype: str, what: str):
    """got (a tensor of `dtype`) and want (a JAX / numpy array of it) are one
    f32 gradient, computed in two orders, each rounded once to `dtype` (to
    within half an ulp): each element within the f32 tests' tolerance (1e-5
    of the largest |value|) plus one ulp of `dtype` at that element, the
    same rows nonzero."""
    assert got.dtype == t_field.GRID_DTYPES[dtype], f"{what}: {got.dtype}"
    g, w = got.float().numpy(), np.asarray(want).astype(np.float32)
    tol = 1e-5 * np.abs(w).max() + _ulp(np.maximum(np.abs(g), np.abs(w)), dtype)
    bad = np.abs(g - w) > tol
    assert not bad.any(), f"{what}: {int(bad.sum())} values past f32 tolerance + one ulp"
    rows = lambda x: x.reshape(-1, x.shape[-1]).any(axis=-1)  # noqa: E731
    np.testing.assert_array_equal(rows(g), rows(w), err_msg=f"{what}: nonzero rows")


def _close(got, want, what, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} vs {tol:g} x {scale:.3e}"


def _points(rng, n):
    pts = rng.uniform(0, 0.999, (n, 3)).astype(np.float32)
    key = np.asarray(j_fp_ref.morton_key(jnp.asarray(pts)))
    return pts[np.argsort(key, kind="stable")]


def _tables(rng, size):
    return rng.uniform(-1, 1, size=(L, size, F)).astype(np.float32)


# ---- the option ----

@pytest.mark.parametrize("dtype", DTYPES)
def test_field_config_takes_the_reference_dtypes(dtype):
    """The three dtypes of the reference's jnp.dtype(cfg.grid_dtype) cast;
    the tables are drawn in f32 and cast (the f32 init's values, rounded),
    the MLPs stay f32; `param_bytes` counts 4 bytes a value and
    `param_counts` values, both as the reference does."""
    cfg = t_field.FieldConfig(**GEOM, grid_dtype=dtype)
    assert cfg.table_dtype == t_field.GRID_DTYPES[dtype]
    field = t_field.Field(cfg)
    params = field.init(torch.Generator().manual_seed(0), "cpu")
    full = t_field.Field(t_field.FieldConfig(**GEOM)).init(torch.Generator().manual_seed(0),
                                                           "cpu")
    for path, t in tree_paths(params):
        want = dict(tree_paths(full))[path]
        if path[0].endswith("grid"):
            assert t.dtype == cfg.table_dtype and torch.equal(t, want.to(t.dtype))
        else:
            assert t.dtype == torch.float32 and torch.equal(t, want)
    j_cfg = j_field.FieldConfig(**GEOM, grid_dtype=dtype)
    j_params = j_field.Field(j_cfg).init(jax.random.PRNGKey(0))
    assert j_params["density_grid"].dtype == jnp.dtype(dtype)
    assert field.param_counts(params) == j_field.Field(j_cfg).param_counts(j_params)
    assert field.density_enc.param_bytes == j_enc.HashEncoding(
        j_cfg.grid_cfg("density")).param_bytes == L * TD * F * 4


def test_other_grid_dtypes_raise():
    for bad in ("int8", "float64", "bf16"):
        with pytest.raises(ValueError, match="grid_dtype"):
            t_field.FieldConfig(grid_dtype=bad)
    assert t_field.FieldConfig().grid_dtype == "float32"


# ---- the forwards ----

@pytest.mark.parametrize("dtype", DTYPES)
def test_hash_encode_forward_matches_jax(dtype, rng):
    """#1's plain version on a 2-byte table against the reference's ref and
    its Pallas kernel (interpret), sentinel rows included."""
    dense = j_he_ref.level_is_dense(RES, TD)
    pts = rng.uniform(0, 0.999, size=(513, 3)).astype(np.float32)
    pts[::37] = -1.0
    jt, tt = _half(_tables(rng, TD), dtype)
    want_ref = np.asarray(j_he_ref.hash_encode(jnp.asarray(pts), jt, RES))
    want_pal = np.asarray(j_he_ops._forward(jnp.asarray(pts), jt, tuple(RES), tuple(dense),
                                            "pallas", 256))
    got = t_he_ops.hash_encode(_t(pts), tt, RES, dense)
    assert got.dtype == torch.float32
    keep = pts[:, 0] >= 0
    np.testing.assert_allclose(got.numpy()[keep], want_ref[keep], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_pal, atol=1e-5, rtol=0)
    assert not got[~torch.from_numpy(keep)].any()
    # the 2-byte table gives the bytes of its f32 copy
    assert torch.equal(got, t_he_ops.hash_encode(_t(pts), tt.float(), RES, dense))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_encode_forward_matches_jax(dtype, rng):
    """#8's plain version on 2-byte tables against `fused_encode_pallas`
    (interpret) on sentinel-padded points and the reference's op."""
    n = 300
    pts = _points(rng, n)
    tabs = {size: _half(_tables(rng, size), dtype) for size in (TD, TC)}
    for size, (jt, tt) in tabs.items():
        dense = j_he_ref.level_is_dense(RES, size)
        padded, _ = j_he_ops._pad_to(jnp.asarray(pts), 256)
        want = j_fp_kernel.fused_encode_pallas(
            padded, jt, jnp.asarray(RES, jnp.int32), jnp.asarray(dense, jnp.int32),
            block_points=256, interpret=True)[:n]
        got = t_fp_ref.fused_encode(_t(pts), tt, RES, dense)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    j_op = j_fp_ops.make_fused_encode(RES, (TD, TC), F, backend="ref")
    t_op = t_fp_ops.make_fused_encode(RES, (TD, TC), F)
    for got, want in zip(t_op(_t(pts), tabs[TD][1], tabs[TC][1]),
                         j_op(jnp.asarray(pts), tabs[TD][0], tabs[TC][0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _step_inputs(rng, n):
    pts = _points(rng, n)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    sh = rng.uniform(-0.5, 0.5, size=(n, SH)).astype(np.float32)

    def lin(d_in, d_out):
        b = (6.0 / d_in) ** 0.5
        return (rng.uniform(-b, b, size=(d_in, d_out)).astype(np.float32),
                rng.uniform(-0.1, 0.1, size=(d_out,)).astype(np.float32))

    w1, b1 = lin(L * F, HID)
    w2, b2 = lin(HID, 1 + GEO)
    mlp_d = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
    w1, b1 = lin(L * F + SH, HID)
    w2, b2 = lin(HID, HID)
    w3, b3 = lin(HID, 3)
    mlp_c = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    return pts, sh, _tables(rng, TD), _tables(rng, TC), mlp_d, mlp_c


@pytest.mark.parametrize("backend", ["ref", "pallas-interpret"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_step_values_and_gradients_match_jax(dtype, backend, rng):
    """#5 and #6's plain versions on 2-byte tables against the reference's
    fused step on its ref backend and on its Pallas kernels (interpret):
    outputs within 1e-5, table gradients in the tables' dtype within one
    ulp, MLP and SH gradients within 1e-5 of the largest."""
    n = 256
    pts, sh, td, tc, mlp_d, mlp_c = _step_inputs(rng, n)
    (j_td, t_td), (j_tc, t_tc) = _half(td, dtype), _half(tc, dtype)
    g_d = rng.normal(size=(n, 1 + GEO)).astype(np.float32)
    g_c = rng.normal(size=(n, 3)).astype(np.float32)
    j_step = j_fs_ops.make_fused_step(RES, (TD, TC), F, backend=backend, block_points=64)
    jargs = (jnp.asarray(pts), jnp.asarray(sh), j_td, j_tc,
             jax.tree.map(jnp.asarray, mlp_d), jax.tree.map(jnp.asarray, mlp_c))
    j_out = jax.jit(j_step)(*jargs)
    j_grads = jax.jit(jax.grad(
        lambda *a: jnp.sum(j_step(*a)[0] * g_d) + jnp.sum(j_step(*a)[1] * g_c),
        argnums=(1, 2, 3, 4, 5)))(*jargs)

    t_step = t_fs_ops.make_fused_step(RES, (TD, TC), F)
    t_sh = _t(sh, grad=True)
    t_td, t_tc = t_td.requires_grad_(True), t_tc.requires_grad_(True)
    t_md = {k: _t(v, grad=True) for k, v in mlp_d.items()}
    t_mc = {k: _t(v, grad=True) for k, v in mlp_c.items()}
    out_d, raw_c = t_step(_t(pts), t_sh, t_td, t_tc, t_md, t_mc)
    np.testing.assert_allclose(out_d.detach().numpy(), np.asarray(j_out[0]), atol=1e-5)
    np.testing.assert_allclose(raw_c.detach().numpy(), np.asarray(j_out[1]), atol=1e-5)
    ((out_d * _t(g_d)).sum() + (raw_c * _t(g_c)).sum()).backward()
    g_sh, g_td, g_tc, g_md, g_mc = j_grads
    _within_rounding(t_td.grad, g_td, dtype, "density table")
    _within_rounding(t_tc.grad, g_tc, dtype, "color table")
    _close(t_sh.grad.numpy(), g_sh, "d_sh")
    for k in mlp_d:
        _close(t_md[k].grad.numpy(), g_md[k], f"mlp_d {k}")
    for k in mlp_c:
        _close(t_mc[k].grad.numpy(), g_mc[k], f"mlp_c {k}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_table_gradients_match_jax(dtype, rng):
    """The dense route's hash-encode backward and the fused encode's, on
    2-byte tables: each gradient in the table's dtype, within one ulp of
    the reference's, the f32 commit cast once."""
    n = 400
    pts = _points(rng, n)
    (j_td, t_td), (j_tc, t_tc) = _half(_tables(rng, TD), dtype), _half(_tables(rng, TC), dtype)
    g = [rng.normal(size=(n, L * F)).astype(np.float32) for _ in range(2)]
    dense = [j_he_ref.level_is_dense(RES, s) for s in (TD, TC)]
    for size, jt, tt, gg, dd in ((TD, j_td, t_td, g[0], dense[0]),
                                 (TC, j_tc, t_tc, g[1], dense[1])):
        enc = j_he_ops.make_hash_encode(RES, size, F, backend="ref")
        want = jax.grad(lambda tb: jnp.sum(enc(jnp.asarray(pts), tb) * gg))(jt)
        leaf = tt.clone().requires_grad_(True)
        (t_he_ops.hash_encode(_t(pts), leaf, RES, dd) * _t(gg)).sum().backward()
        _within_rounding(leaf.grad, want, dtype, f"hash_encode T={size}")
        up = tt.float().requires_grad_(True)
        (t_he_ops.hash_encode(_t(pts), up, RES, dd) * _t(gg)).sum().backward()
        assert torch.equal(leaf.grad, up.grad.to(leaf.dtype))
    j_op = j_fp_ops.make_fused_encode(RES, (TD, TC), F, backend="ref")
    _, vjp = jax.vjp(lambda a, b: j_op(jnp.asarray(pts), a, b), j_td, j_tc)
    want = vjp(tuple(jnp.asarray(x) for x in g))
    leaves = [t_td.clone().requires_grad_(True), t_tc.clone().requires_grad_(True)]
    outs = t_fp_ops.make_fused_encode(RES, (TD, TC), F)(_t(pts), *leaves)
    sum((o * _t(x)).sum() for o, x in zip(outs, g)).backward()
    for name, leaf, w in zip(("density", "color"), leaves, want):
        _within_rounding(leaf.grad, w, dtype, f"fused_encode {name}")


# ---- the optimizer ----

@pytest.mark.parametrize("dtype", DTYPES)
def test_adamw_on_half_width_leaves_is_jax_bit_for_bit(dtype, rng):
    """Four masked AdamW steps on a tree whose grids are 2-byte (gradients
    in that dtype, as the table gradients leave), the MLP leaf f32: f32
    moments, (p.f32 - update) rounded to the leaf's dtype, every leaf and
    moment the reference's bit for bit; a masked leaf keeps its params and
    moments; the finiteness check reads 2-byte trees."""
    def lr_scale(path):
        return 1.0 if any("grid" in p for p in path) else 0.1

    kw = dict(lr=1e-2, b2=0.99, eps=1e-15, lr_scale_fn=lr_scale)
    j_opt, t_opt = JAdamW(weight_decay=0.0, **kw), TAdamW(**kw)
    jdt = jnp.dtype(dtype)
    params = {"density_grid": jnp.asarray(rng.normal(size=(2, 64, 2)), jnp.float32).astype(jdt),
              "color_grid": jnp.asarray(rng.normal(size=(2, 16, 2)), jnp.float32).astype(jdt),
              "density_mlp": {"w1": jnp.asarray(rng.normal(size=(4, 8)), jnp.float32)}}
    jp, js = params, j_opt.init(params)
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, params), "cpu")
    ts = t_opt.init(tp)
    assert all(t.dtype == torch.float32 for _, t in tree_paths(ts.m))
    for step in range(4):
        grads = jax.tree.map(
            lambda a: jnp.asarray(rng.normal(size=a.shape) * (1e-6 if step == 2 else 1.0),
                                  jnp.float32).astype(a.dtype), params)
        grads["density_grid"] = grads["density_grid"].at[0, :5].set(0)
        mask = {"density_grid": True, "color_grid": step % 2 == 0,
                "density_mlp": {"w1": True}}
        jp, js = j_opt.apply(jp, grads, js, mask=mask)
        tp, ts = t_opt.apply(tp, bridge.params_to_torch(jax.tree.map(np.asarray, grads), "cpu"),
                             ts, mask=mask)
    for (path, got), want in zip(tree_paths(tp), jax.tree_util.tree_leaves(jp)):
        want = np.asarray(want)
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, path
        assert bridge.tensor_to_array(got).tobytes() == want.tobytes(), path
    for got, want in zip([t for _, t in tree_paths(ts.m)] + [t for _, t in tree_paths(ts.v)],
                         jax.tree_util.tree_leaves((js.m, js.v))):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert t_trainer.tree_all_finite(tp)
    tp["color_grid"][0, 0, 0] = float("nan")
    assert not t_trainer.tree_all_finite(tp)


# ---- one step's gradients per route, and a short run ----

def _configs(pkg_field, pkg_rendering, pkg_occ, pkg_trainer, dtype, **field_kw):
    return (pkg_field.FieldConfig(**GEOM, grid_dtype=dtype, **field_kw),
            pkg_trainer.TrainerConfig(render=pkg_rendering.RenderConfig(**RCFG),
                                      occ=pkg_occ.OccupancyConfig(**OCC), **TRAIN))


@pytest.fixture(scope="module")
def scene():
    j_tcfg = _configs(j_field, j_rendering, j_occ, j_trainer, "float32")[1]
    _, ds = j_scene.build_dataset(0, cfg=j_tcfg.render, **DATA)
    return ds, j_rays.RaySampler(ds, views=[1, 2, 3])


def _port_sampler(ds, j_sampler):
    sampler = t_rays.RaySampler(ds, views=[1, 2, 3], device="cpu")
    sampler.origins = _t(np.asarray(j_sampler.origins))
    sampler.dirs = _t(np.asarray(j_sampler.dirs))
    return sampler


def _jax_draws(j_tcfg, i: int, n_pool: int):
    key = jax.random.fold_in(jax.random.PRNGKey(j_tcfg.seed), i)
    kb, kt, ko = jax.random.split(key, 3)
    idx = jax.random.randint(kb, (j_tcfg.n_rays,), 0, n_pool)
    u_ts = jax.random.uniform(kt, (j_tcfg.n_rays, j_tcfg.render.n_samples))
    u_occ = jax.random.uniform(ko, (j_tcfg.occ.resolution ** 3, 3))
    return tuple(_t(np.asarray(a)) for a in (idx, u_ts, u_occ))


# route -> (Instant-NGP field?, budget, fused step on?)
ROUTES = {"dense": (False, None, True), "compacted": (False, 512, True),
          "split": (False, 512, False), "compacted_ngp": (True, 512, True)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_one_step_gradients_match_jax(dtype, route, scene):
    """One training step's loss gradients on 2-byte tables, per route (the
    dense step, the compacted one-op fused step, the split route and the
    NGP baseline's compacted step through the fused encode), as
    tests/test_torch_train.py holds them at f32: the loss within 1e-5, the
    table gradients within one ulp, the MLP gradients within 1e-5 of the
    largest."""
    ds, j_sampler = scene
    ngp, budget, fused_step = ROUTES[route]
    j_fcfg, j_tcfg = _configs(j_field, j_rendering, j_occ, j_trainer, dtype, decomposed=not ngp)
    t_fcfg, t_tcfg = _configs(t_field, t_rendering, t_occ, t_trainer, dtype, decomposed=not ngp)
    t_tcfg = dataclasses.replace(t_tcfg, fused_step=fused_step)
    params = jax.tree.map(np.asarray, j_field.Field(j_fcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for k in ("density_grid", "color_grid"):
        if k in params:
            params[k] = np.asarray(jnp.asarray(rng.uniform(-1, 1, size=params[k].shape),
                                               jnp.float32).astype(jnp.dtype(dtype)))
    params["density_mlp"]["b2"] = params["density_mlp"]["b2"].copy()
    params["density_mlp"]["b2"][0] = -3.0
    j_params = jax.tree.map(jnp.asarray, params)
    ema = np.asarray(j_occ.update(j_field.Field(j_fcfg), j_params, j_occ.init_state(j_tcfg.occ),
                                  j_tcfg.occ, jax.random.PRNGKey(1)).density_ema)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(j_tcfg.seed), 5), 3)
    batch_j = j_sampler.sample(keys[0], j_tcfg.n_rays)
    ts = np.asarray(j_rendering.sample_ts(keys[1], j_tcfg.n_rays, j_tcfg.render))
    pipe = JPipeline(j_field.Field(j_fcfg), j_tcfg.render, fused_step=fused_step)
    bits = j_occ.bitfield(j_occ.OccupancyState(jnp.asarray(ema), jnp.int32(1)), j_tcfg.occ)

    def loss_fn(p):
        out = pipe(p, batch_j.origins, batch_j.dirs, jnp.asarray(ts), bitfield=bits,
                   budget=budget)
        return j_losses.mse(out["rgb"], batch_j.rgb_gt), out

    (loss_j, out_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(j_params)
    idx, _, _ = _jax_draws(j_tcfg, 5, j_sampler.n)
    trainer = t_trainer.Instant3DTrainer(t_field.Field(t_fcfg), t_tcfg, device="cpu")
    batch_t = _port_sampler(ds, j_sampler).gather(idx)
    loss_t, grads_t, aux = trainer.loss_and_grads(
        bridge.params_to_torch(params, "cpu"), batch_t, _t(ts), _t(ema), freeze_color=False,
        freeze_density=False, budget=budget, use_bits=True)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert int(aux["points_queried"]) == int(out_j["points_queried"])
    if budget is not None:
        assert int(aux["points_queried"]) == budget and int(out_j["n_live"]) > 100
    want = dict(tree_paths(grads_j))
    for path, g in tree_paths(grads_t):
        if path[0].endswith("grid"):
            _within_rounding(g, want[path], dtype, f"{route} {path}")
        else:
            _close(g.numpy(), want[path], f"{route} {path}")


@pytest.mark.parametrize("ngp", [False, True], ids=["instant3d", "ngp"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_24_step_run_matches_jax(dtype, ngp, scene):
    """24 steps of either field at a 2-byte `grid_dtype` from JAX's init, fed
    JAX's draws: the folds, every step's budget, overflow and live fraction
    JAX's, every loss within 1e-2 relative; the tables stay in their dtype
    and the moments f32."""
    ds, j_sampler = scene
    j_fcfg, j_tcfg = _configs(j_field, j_rendering, j_occ, j_trainer, dtype, decomposed=not ngp)
    t_fcfg, t_tcfg = _configs(t_field, t_rendering, t_occ, t_trainer, dtype, decomposed=not ngp)
    j_tr = j_trainer.Instant3DTrainer(j_field.Field(j_fcfg), j_tcfg)
    j_state = j_tr.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, j_state.params)
    j_state, j_hist = j_tr.train(j_state, j_sampler, log_every=1)

    t_tr = t_trainer.Instant3DTrainer(t_field.Field(t_fcfg), t_tcfg, device="cpu")
    tp = bridge.params_to_torch(params, "cpu")
    assert tp["density_grid"].dtype == t_fcfg.table_dtype
    t_state = t_trainer.TrainState(tp, t_tr.opt.init(tp), t_occ.init_state(t_tcfg.occ, "cpu"), 0)
    t_state, t_hist = t_tr.train(t_state, _port_sampler(ds, j_sampler), log_every=1,
                                 draws=lambda i: _jax_draws(j_tcfg, i, j_sampler.n))
    assert t_hist["occ_folds"] == j_hist.get("occ_folds", t_hist["occ_folds"])
    assert t_state.step == j_state.step == 24
    assert t_hist["points_queried"] == j_hist["points_queried"]
    assert t_hist["overflow"] == j_hist["overflow"]
    assert any(b is not None for b in t_hist["budget"])
    np.testing.assert_allclose(t_hist["live_fraction"], j_hist["live_fraction"], rtol=1e-6)
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-2)
    assert t_hist["loss"][-1] < t_hist["loss"][0]
    assert smoke.tables_keep_their_dtype({"state": t_state, "trainer": t_tr})
    for _, leaf in tree_paths(j_state.params):
        assert leaf.dtype in (jnp.float32, jnp.dtype(dtype))


# ---- the BUM commit into a nonzero 2-byte table ----

def _commit_all(jt, tt, idx, vals):
    """The reference's Pallas kernel (interpret) and XLA route, and the
    port, committing one sorted stream into one table: three numpy arrays
    of the table's dtype."""
    ji, jv = jnp.asarray(idx), jnp.asarray(vals)
    pallas = np.asarray(j_gu_kernel.bum_scatter_pallas(jt, ji, jv, interpret=True))
    xla = np.asarray(j_gu_ops.merged_scatter_add(jt, ji, jv, presorted=True))
    got = t_gu_ops.merged_scatter_add(tt, _t(idx).long(), _t(vals), presorted=True)
    assert got.dtype == tt.dtype
    return pallas, xla, bridge.tensor_to_array(got).view(pallas.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_merged_scatter_add_on_a_nonzero_half_width_table(dtype, rng):
    """The port commits a 2-byte table as the reference's Pallas kernel does
    (`bum_scatter_pallas`: the table widened to f32, each run's f32 sum
    added, the result rounded to the table's dtype once), bit for bit on a
    nonzero table.

    The reference's XLA route (`merged_scatter_add` on its ref backend,
    `_segment_commit`) rounds each run's f32 sum to the table's dtype first
    and then adds in that dtype -- two roundings -- so on a nonzero table it
    differs from the Pallas kernel in some rows; this asserts that it does,
    and that all three agree on a zero table, which is what every training
    caller commits table gradients into.  The values first lie on a grid of
    2^-12, so every f32 run sum is exact in any order and the rounding is
    all that can differ.  Then on normal values: the Pallas kernel walks the
    stream in blocks of 512 entries and commits a run that crosses a block
    edge in two parts, summing it in another f32 order than the port and the
    XLA route (whole runs in stream order, as the CUDA kernel); every row but
    those must still be the Pallas kernel's bit for bit, and those within one
    rounding of it."""
    t, f, m = 256, 2, 4096
    table = rng.normal(size=(t, f)).astype(np.float32)
    idx = np.sort(rng.integers(0, t, size=m)).astype(np.int32)
    grid = (rng.integers(-1024, 1025, size=(m, f)) * 2.0 ** -12).astype(np.float32)
    jt, tt = _half(table, dtype)
    pallas, xla, got = _commit_all(jt, tt, idx, grid)
    assert got.tobytes() == pallas.tobytes()
    differ = (xla.view(np.int16) != pallas.view(np.int16)).any(axis=-1)
    assert differ.any(), "the XLA route's double rounding should show on a nonzero table"
    zero_j, zero_t = _half(np.zeros_like(table), dtype)
    pallas0, xla0, got0 = _commit_all(zero_j, zero_t, idx, grid)
    assert pallas0.tobytes() == xla0.tobytes() == got0.tobytes()
    assert got0.view(np.int16).any()

    vals = (rng.normal(size=(m, f)) * 1e-2).astype(np.float32)
    pallas, _, got = _commit_all(jt, tt, idx, vals)
    edges = np.arange(512, m, 512)
    split = np.zeros(t, bool)
    split[idx[edges][idx[edges] == idx[edges - 1]]] = True
    assert split.any() and not split.all()
    np.testing.assert_array_equal(got[~split].view(np.int16), pallas[~split].view(np.int16))
    _within_rounding(bridge.array_to_tensor(got[split]), pallas[split], dtype, "split runs")
    # an f32 table keeps its bytes: the port and the XLA route agree
    f32 = t_gu_ops.merged_scatter_add(_t(table), _t(idx).long(), _t(vals), presorted=True)
    assert f32.numpy().tobytes() == np.asarray(j_gu_ops.merged_scatter_add(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals), presorted=True)).tobytes()


# ---- the bridge and checkpoints ----

def _tree(dtype, rng):
    jdt = jnp.dtype(dtype)
    return {"density_grid": jnp.asarray(rng.normal(size=(2, 8, 2)), jnp.float32).astype(jdt),
            "color_grid": jnp.asarray(rng.normal(size=(2, 4, 2)), jnp.float32).astype(jdt),
            "density_mlp": {"w1": jnp.asarray(rng.normal(size=(4, 3)), jnp.float32)}}


def _same_tree(port: dict, ref: dict):
    got = dict(tree_paths(port))
    for path, want in tree_paths(jax.tree.map(np.asarray, ref)):
        assert bridge.tensor_to_array(got[path]).tobytes() == want.tobytes(), path
        assert str(got[path].dtype).removeprefix("torch.") == want.dtype.name, path


@pytest.mark.parametrize("dtype", DTYPES)
def test_bridge_round_trips_half_width_leaves(dtype, rng):
    """A JAX 2-byte leaf (numpy dtype `bfloat16`, or float16) becomes a
    tensor of the same bits and dtype, and comes back as the same bytes
    (a bf16 tensor as `|V2`, what np.savez writes for the reference)."""
    ref = _tree(dtype, rng)
    port = bridge.params_to_torch(jax.tree.map(np.asarray, ref), "cpu")
    _same_tree(port, ref)
    back = bridge.params_to_numpy(port)
    want_dtype = np.dtype("V2") if dtype == "bfloat16" else np.dtype(np.float16)
    assert back["density_grid"].dtype == want_dtype
    assert back["density_grid"].tobytes() == np.asarray(ref["density_grid"]).tobytes()
    _same_tree(bridge.params_to_torch(back, "cpu"), ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_checkpoints_of_both_packages_restore_half_width_leaves(dtype, rng, tmp_path):
    """A reference-written checkpoint of 2-byte tables restores in the port
    bit for bit (its bf16 leaves are `|V2` on disk; the port's bf16
    template reads them as bf16), and so does a port-written one; the port
    writes the bytes the reference writes, so the reference's own restore
    gives the same numpy arrays for both files."""
    ref = _tree(dtype, rng)
    JCheckpointManager(tmp_path / "ref", async_save=False).save(3, {"params": ref})
    port_tree = bridge.params_to_torch(jax.tree.map(np.asarray, ref), "cpu")
    CheckpointManager(tmp_path / "port", async_save=False).save(3, {"params": port_tree})
    template = {"params": bridge.params_to_numpy(
        t_field.Field(t_field.FieldConfig(grid_dtype=dtype)).init(
            torch.Generator().manual_seed(0), "cpu"))}
    template = {"params": {"density_grid": template["params"]["density_grid"][:2, :8],
                           "color_grid": template["params"]["color_grid"][:2, :4],
                           "density_mlp": {"w1": np.zeros((4, 3), np.float32)}}}
    for name in ("ref", "port"):
        restored, meta = CheckpointManager(tmp_path / name).restore(template)
        assert meta["step"] == 3
        _same_tree(bridge.params_to_torch(restored["params"], "cpu"), ref)
    j_template = {"params": jax.tree.map(np.asarray, ref)}
    files = [JCheckpointManager(tmp_path / name).restore(j_template)[0]["params"]
             for name in ("ref", "port")]
    for a, b in zip(jax.tree_util.tree_leaves(files[0]), jax.tree_util.tree_leaves(files[1])):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_the_port_carries_bf16_without_ml_dtypes():
    """The card's machine has no ml_dtypes: nothing of the port imports it
    (a fresh process importing every module of the port, the bridge's bf16
    round trip included, leaves it out of sys.modules), and no source of
    the port, chip_smoke.py or tools/torch_*.py names it in an import."""
    repo = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys, numpy as np, torch\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch import bridge\n"
        "t = torch.tensor([1.5, -2.0], dtype=torch.bfloat16)\n"
        "a = bridge.tensor_to_array(t)\n"
        "assert torch.equal(bridge.array_to_tensor(a), t) and a.dtype == np.dtype('V2')\n"
        "print('ml_dtypes' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=str(repo / "src")), cwd=repo,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "False"
    files = (sorted((repo / "src" / "repro_torch").rglob("*.py"))
             + sorted((repo / "tools").glob("torch_*.py")) + [repo / "chip_smoke.py"])
    pattern = re.compile(r"^\s*(import|from)\s+ml_dtypes\b", re.MULTILINE)
    for path in files:
        assert not pattern.search(path.read_text()), path


# ---- the service on 2-byte tables ----

@pytest.mark.parametrize("dtype", DTYPES)
def test_service_contracts_hold_on_half_width_tables(dtype, tmp_path):
    """The service's four bit-identity contracts (`smoke.service_identity`)
    with 2-byte tables on the CPU: cohort == sequential, suspend / resume
    through disk (2-byte leaves in the checkpoint), the guard's rollback of
    a NaN-params fault (its finiteness check reads the 2-byte tables) and
    eval == served."""
    t_fcfg, t_tcfg = _configs(t_field, t_rendering, t_occ, t_trainer, dtype)
    t_tcfg = dataclasses.replace(t_tcfg, eval_chunk=64)
    datasets = smoke.service_datasets("cpu", DATA, n=2)
    ident = smoke.service_identity("cpu", datasets, str(tmp_path), t_fcfg, t_tcfg, iters=24,
                                   suspend_at=(8, 16), fault_at=16, slice_iters=8, held_out=1)
    assert smoke.identity_holds(ident), ident
    assert ident["guard_rollback"]["events"][0]["kind"] == "non_finite_state"


# ---- chip_smoke.py's grid_dtype phase, rehearsed ----

def test_grid_dtype_phase_rehearsed_on_the_cpu():
    """Phase 9 of chip_smoke.py at a tiny size on the CPU (its kernel cases
    need the card): both fields trained at bf16 through the phase-3 gates
    (both routes, finite losses; the tables still bf16, the moments f32),
    views served from the trained snapshot on the redistributed route with
    eval == served, and two bf16 sessions run as one cohort of the service,
    each on its sequential run's bytes."""
    t_fcfg, t_tcfg = _configs(t_field, t_rendering, t_occ, t_trainer, "bfloat16")
    t_tcfg = dataclasses.replace(t_tcfg, eval_chunk=64)
    nothing = ((), tuple(smoke.KERNELS))
    for cfg in (t_fcfg, dataclasses.replace(t_fcfg, decomposed=False)):
        run = smoke.train_main_path("cpu", cfg, t_tcfg, dataset=DATA, held_out=1)
        assert smoke.check_training(run, nothing, min_psnr=-np.inf) == []
        assert smoke.tables_keep_their_dtype(run)
    served = smoke.serve_trained("cpu", run, n_requests=2, hw=12, session_id="redist")
    assert served["eval_vs_served"] == {"rgb": True, "depth": True}
    datasets = smoke.service_datasets("cpu", DATA, n=2)
    service = smoke.cohort_service("cpu", datasets, None, t_fcfg, t_tcfg, iters=16,
                                   held_out=1, slice_iters=8, render_steps=(8,))
    assert smoke.check_service(service, must_launch=(), cohorts={2}, min_psnr=-np.inf) == []
    assert all(all(v.values()) for v in service["vs_sequential"].values())
    assert service["service"].sessions["scene-000"].state.params["color_grid"].dtype == \
        torch.bfloat16
