"""The port's training slice against the JAX package (CPU), at a small size.

L=4, T=2^12/2^10, hidden 16, 64 rays x 16 samples, occupancy R=16.  JAX
runs on its `ref` backend.  The reference draws with
``split(fold_in(PRNGKey(seed), i), 3)``; the port's `train` takes those
same draws (ray indices, stratified fractions, occupancy jitter) as numpy.
Tolerances:

* the synthetic scene's draws and the poses exactly, ground-truth images
  within 1e-5;
* one step's gradient of every leaf, on the dense and the compacted route
  (one-op fused step, and the split route: fused encode, then the MLPs),
  for the Instant-3D field and the Instant-NGP baseline, within 1e-5 of
  that leaf's largest |gradient|, with the same set of table rows carrying
  a nonzero gradient;
* a 24-step run of either field: the freeze schedule, the occupancy folds
  and every step's budget exactly, every step's loss within 1e-2 relative
  (Adam's eps of 1e-15 turns rounding-level gradient differences into steps
  of ~lr).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import field as j_field
from repro.core import losses as j_losses
from repro.core import occupancy as j_occ
from repro.core import rendering as j_rendering
from repro.core import trainer as j_trainer
from repro.core.pipeline import RenderPipeline as JPipeline
from repro.data import rays_dataset as j_rays
from repro.data import synthetic_scene as j_scene
from repro_torch import bridge
from repro_torch.core import field as t_field
from repro_torch.core import occupancy as t_occ
from repro_torch.core import rendering as t_rendering
from repro_torch.core import trainer as t_trainer
from repro_torch.data import rays_dataset as t_rays
from repro_torch.data import synthetic_scene as t_scene
from repro_torch.optim.adamw import tree_paths

GEOM = dict(n_levels=4, max_resolution=64, log2_table_density=12,
            log2_table_color=10, hidden=16)
RCFG = dict(n_samples=16)
DATA = dict(n_views=4, h=16, w=16, gt_samples=48)
# warmup 8, a fold every 4 steps: folds at 11, 15, 19, 23; the bitfield is
# live from step 12.  At a live fraction of ~0.57 the headroom 0.7 buckets
# the budget to 512 of 1024 points, which overflows, so the controller
# widens back to the dense route: both routes and both switches occur.
TRAIN = dict(n_rays=64, iters=24, budget_headroom=0.7, min_budget=64)
OCC = dict(resolution=16, warmup_steps=8, update_interval=4)


def _configs(pkg_field, pkg_rendering, pkg_occ, pkg_trainer):
    return (pkg_field.FieldConfig(**GEOM),
            pkg_trainer.TrainerConfig(render=pkg_rendering.RenderConfig(**RCFG),
                                      occ=pkg_occ.OccupancyConfig(**OCC), **TRAIN))


J_FCFG, J_TCFG = _configs(j_field, j_rendering, j_occ, j_trainer)
T_FCFG, T_TCFG = _configs(t_field, t_rendering, t_occ, t_trainer)
# the Instant-NGP baseline: one grid feeds both heads
J_NGP = dataclasses.replace(J_FCFG, decomposed=False)
T_NGP = dataclasses.replace(T_FCFG, decomposed=False)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def scene():
    """The JAX dataset (numpy), and the JAX sampler over views 1-3."""
    _, ds = j_scene.build_dataset(0, cfg=J_TCFG.render, **DATA)
    return ds, j_rays.RaySampler(ds, views=[1, 2, 3])


def _port_sampler(ds, j_sampler):
    """The port's sampler over the same views, holding the reference's
    (bit-identical) ray arrays."""
    sampler = t_rays.RaySampler(ds, views=[1, 2, 3], device="cpu")
    sampler.origins = _t(np.asarray(j_sampler.origins))
    sampler.dirs = _t(np.asarray(j_sampler.dirs))
    return sampler


def jax_draws(i: int, n_pool: int):
    """The reference trainer's draws at step i (core/trainer.py:893)."""
    key = jax.random.fold_in(jax.random.PRNGKey(J_TCFG.seed), i)
    kb, kt, ko = jax.random.split(key, 3)
    idx = jax.random.randint(kb, (J_TCFG.n_rays,), 0, n_pool)
    u_ts = jax.random.uniform(kt, (J_TCFG.n_rays, J_TCFG.render.n_samples))
    u_occ = jax.random.uniform(ko, (J_TCFG.occ.resolution ** 3, 3))
    return tuple(_t(np.asarray(a)) for a in (idx, u_ts, u_occ))


# ---- data ----

def test_scene_and_dataset_match_jax(scene):
    ds_j, j_sampler = scene
    sj, st = j_scene.make_scene(3), t_scene.make_scene(3, device="cpu")
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, ds_t = t_scene.build_dataset(0, cfg=T_TCFG.render, device="cpu", **DATA)
    np.testing.assert_array_equal(ds_t.poses, ds_j.poses)
    assert (ds_t.focal, ds_t.h, ds_t.w) == (ds_j.focal, ds_j.h, ds_j.w)
    np.testing.assert_allclose(ds_t.images, ds_j.images, atol=1e-5)
    np.testing.assert_allclose(ds_t.depths, ds_j.depths, atol=1e-4)
    assert 0.05 < (ds_t.images < 0.99).mean() < 0.95, "the scene should be in view"
    sampler = t_rays.RaySampler(ds_t, views=[1, 2, 3], device="cpu")
    assert sampler.n == j_sampler.n == 3 * 16 * 16
    np.testing.assert_allclose(sampler.origins.numpy(), np.asarray(j_sampler.origins), atol=1e-6)
    np.testing.assert_allclose(sampler.dirs.numpy(), np.asarray(j_sampler.dirs), atol=1e-6)
    idx = torch.tensor([0, 5, 767])
    batch = sampler.gather(idx)
    np.testing.assert_array_equal(batch.rgb_gt.numpy(), np.asarray(j_sampler.rgb)[[0, 5, 767]])
    u = np.random.default_rng(0).uniform(size=(5, 16)).astype(np.float32)
    ts_j = j_rendering.sample_ts(None, 5, J_TCFG.render)  # midpoints
    np.testing.assert_array_equal(
        t_rendering.sample_ts(None, 5, T_TCFG.render, "cpu").numpy(), np.asarray(ts_j))
    edges = np.asarray(jnp.linspace(2.0, 6.0, 17))
    want = edges[:-1][None] + jnp.asarray(u) * (edges[1:] - edges[:-1])[None]
    np.testing.assert_allclose(t_rendering.sample_ts(None, 5, T_TCFG.render, "cpu",
                                                     u=_t(u)).numpy(), np.asarray(want),
                               atol=1e-6)


def test_branch_update_schedule_matches_jax():
    for freq in (1.0, 0.5, 0.25, 0.3):
        assert [t_trainer._branch_update(i, freq) for i in range(100)] == \
            [j_trainer._branch_update(i, freq) for i in range(100)]


# ---- one step's gradients ----

def _snapshot(j_fcfg=J_FCFG):
    """JAX init params with the grids widened and the density bias lowered,
    so the occupancy threshold splits the cells; one JAX occupancy fold."""
    params = jax.tree.map(np.asarray, j_field.Field(j_fcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for k in ("density_grid", "color_grid"):
        if k in params:
            params[k] = rng.uniform(-1, 1, size=params[k].shape).astype(np.float32)
    params["density_mlp"]["b2"] = params["density_mlp"]["b2"].copy()
    params["density_mlp"]["b2"][0] = -3.0
    state = j_occ.update(j_field.Field(j_fcfg), jax.tree.map(jnp.asarray, params),
                         j_occ.init_state(J_TCFG.occ), J_TCFG.occ, jax.random.PRNGKey(1))
    return params, np.asarray(state.density_ema)


# route -> (Instant-NGP field?, budget, color grid frozen?, fused step on?)
ROUTES = {
    "dense": (False, None, False, True),
    "compacted": (False, 512, False, True),
    "compacted_color_frozen": (False, 512, True, True),
    "dense_ngp": (True, None, False, True),
    "compacted_ngp": (True, 512, False, True),
    "compacted_split": (False, 512, False, False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_one_step_gradients_match_jax(route, scene):
    ds, j_sampler = scene
    ngp, budget, freeze_color, fused_step = ROUTES[route]
    j_fcfg, t_fcfg = (J_NGP, T_NGP) if ngp else (J_FCFG, T_FCFG)
    t_tcfg = dataclasses.replace(T_TCFG, fused_step=fused_step)
    params, ema = _snapshot(j_fcfg)
    idx, u_ts, _ = jax_draws(5, j_sampler.n)
    batch_j = j_sampler.sample(jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(J_TCFG.seed), 5), 3)[0], J_TCFG.n_rays)
    ts = np.asarray(j_rendering.sample_ts(jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(J_TCFG.seed), 5), 3)[1], J_TCFG.n_rays, J_TCFG.render))
    pipe = JPipeline(j_field.Field(j_fcfg), J_TCFG.render, fused_step=fused_step)
    bits = j_occ.bitfield(j_occ.OccupancyState(jnp.asarray(ema), jnp.int32(1)), J_TCFG.occ)
    assert 0.1 < float(jnp.mean(bits)) < 0.9

    def loss_fn(p):
        if freeze_color:
            p = dict(p)
            p["color_grid"] = jax.lax.stop_gradient(p["color_grid"])
        out = pipe(p, batch_j.origins, batch_j.dirs, jnp.asarray(ts), bitfield=bits,
                   budget=budget)
        return j_losses.mse(out["rgb"], batch_j.rgb_gt), out

    (loss_j, out_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    if budget is not None:
        assert int(out_j["n_live"]) > 100 and int(out_j["points_queried"]) == budget

    trainer = t_trainer.Instant3DTrainer(t_field.Field(t_fcfg), t_tcfg, device="cpu")
    sampler = _port_sampler(ds, j_sampler)
    batch_t = sampler.gather(idx)
    np.testing.assert_array_equal(batch_t.origins.numpy(), np.asarray(batch_j.origins))
    ts_t = t_rendering.sample_ts(None, T_TCFG.n_rays, T_TCFG.render, "cpu", u=u_ts)
    np.testing.assert_allclose(ts_t.numpy(), ts, atol=1e-6)
    loss_t, grads_t, aux = trainer.loss_and_grads(
        bridge.params_to_torch(params, "cpu"), batch_t, _t(ts), _t(ema), freeze_color=freeze_color,
        freeze_density=False, budget=budget, use_bits=True)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert int(aux["points_queried"]) == int(out_j["points_queried"])
    assert int(aux["overflow"]) == int(out_j["overflow"])
    want = dict(tree_paths(jax.tree.map(np.asarray, grads_j)))
    for path, g in tree_paths(grads_t):
        if g is None:
            assert freeze_color and path == ("color_grid",)
            assert not want[path].any()
            continue
        scale = max(float(np.abs(want[path]).max()), 1e-30)
        err = float(np.abs(g.numpy() - want[path]).max())
        assert err <= 1e-5 * scale, f"{route} {path}: {err:.3e} vs 1e-5 x {scale:.3e}"
        if path[0].endswith("grid"):
            rows = lambda a: a.reshape(-1, a.shape[-1]).any(axis=-1)  # noqa: E731
            np.testing.assert_array_equal(rows(g.numpy()), rows(want[path]),
                                          err_msg=f"{route} {path}: nonzero rows")


# ---- a short training run ----

@pytest.mark.parametrize("ngp", [False, True], ids=["instant3d", "ngp"])
def test_24_step_run_matches_jax(ngp, scene):
    ds, j_sampler = scene
    j_fcfg, t_fcfg = (J_NGP, T_NGP) if ngp else (J_FCFG, T_FCFG)
    j_tr = j_trainer.Instant3DTrainer(j_field.Field(j_fcfg), J_TCFG)
    j_state = j_tr.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, j_state.params)
    j_state, j_hist = j_tr.train(j_state, j_sampler, log_every=1)

    t_tr = t_trainer.Instant3DTrainer(t_field.Field(t_fcfg), T_TCFG, device="cpu")
    tp = bridge.params_to_torch(params, "cpu")
    t_state = t_trainer.TrainState(tp, t_tr.opt.init(tp), t_occ.init_state(T_TCFG.occ, "cpu"), 0)
    t_state, t_hist = t_tr.train(t_state, _port_sampler(ds, j_sampler), log_every=1,
                                 draws=lambda i: jax_draws(i, j_sampler.n))

    folds = [i for i in range(24) if i >= 8 and (i + 1) % 4 == 0]
    assert t_hist["occ_folds"] == folds
    assert t_state.occ_state.step == int(j_state.occ_state.step) == len(folds)
    assert t_state.step == j_state.step == 24
    assert t_hist["step"] == j_hist["step"] == list(range(1, 25))
    # every step's budget: dense before the bitfield is live, then the
    # controller's pow2 buckets, widened after an overflow
    assert t_hist["points_queried"] == j_hist["points_queried"]
    routes = ["dense" if b is None else "compacted" for b in t_hist["budget"]]
    n_total = T_TCFG.n_rays * T_TCFG.render.n_samples
    assert routes == ["dense" if p == n_total else "compacted"
                      for p in j_hist["points_queried"]]
    if not ngp:
        assert routes == ["dense"] * 16 + ["compacted"] * 4 + ["dense"] * 4
        assert sum(t_hist["overflow"][16:20]) > 0
    assert "compacted" in routes
    assert t_hist["overflow"] == j_hist["overflow"]
    np.testing.assert_allclose(t_hist["live_fraction"], j_hist["live_fraction"], rtol=1e-6)
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-2)
    assert t_hist["loss"][-1] < t_hist["loss"][0]
    # the freeze schedule: the color grid and its moments moved only on
    # color-update steps (odd i), so after step 23 both match the reference's
    # schedule-driven step count
    assert int(t_state.opt_state.step) == int(j_state.opt_state.step) == 24
    np.testing.assert_allclose(t_state.occ_state.density_ema.numpy(),
                               np.asarray(j_state.occ_state.density_ema), rtol=1e-2, atol=1e-3)


def test_training_is_deterministic_and_time_sliceable(scene):
    """Two runs from one seed end byte-identical, and 10 + 14 steps in two
    `train` calls equal one 24-step call (draws and schedules are keyed by
    the absolute step; the overflow window carries over)."""
    ds, _ = scene
    sampler = t_rays.RaySampler(ds, views=[1, 2, 3], device="cpu")
    ends = []
    for split in (None, None, 10):
        tr = t_trainer.Instant3DTrainer(t_field.Field(T_FCFG), T_TCFG, device="cpu")
        state = tr.init()
        if split:
            state, _ = tr.train(state, sampler, iters=split)
            state, _ = tr.train(state, sampler, iters=24 - split)
        else:
            state, _ = tr.train(state, sampler)
        ends.append(state)
    for other in ends[1:]:
        for (_, a), (_, b) in zip(tree_paths(ends[0].params), tree_paths(other.params)):
            assert torch.equal(a, b)
        for (_, a), (_, b) in zip(tree_paths(ends[0].opt_state.v), tree_paths(other.opt_state.v)):
            assert torch.equal(a, b)
        assert torch.equal(ends[0].occ_state.density_ema, other.occ_state.density_ema)
    tr = t_trainer.Instant3DTrainer(t_field.Field(T_FCFG), T_TCFG, device="cpu")
    ev = tr.evaluate(ends[0].params, ds, views=[0])
    assert np.isfinite(ev["psnr_rgb"]) and np.isfinite(ev["psnr_depth"])
    # stage 2b v3 is ported: a v3 trainer builds its v3 pipeline
    v3 = t_trainer.Instant3DTrainer(t_field.Field(T_FCFG),
                                    dataclasses.replace(T_TCFG, redistribute_v3=True), "cpu")
    assert v3.pipeline.redistribute_v3_on and v3.pipeline.redistribute_on
