"""Stage 2b v3 (density-weighted, workload-balanced redistribution) of the
port against the JAX package (CPU), and its invariants.

Inputs are made from a numpy seed and fed to both packages.  Tolerances:

* the five occupancy helpers exactly (the gathers: atol 0);
* `v3_stratum_weights`, `pdf`, `cdf` and `mass` within rtol 1e-6 (the
  weights' `exp` rounds differently in torch and XLA in the last bit);
* `s_ray`, `s_cap`, `dead`, `valid` and the stratum index exactly: the
  port sums and scans in the reference's f32 order (`pipeline.ref_sum`,
  `ref_cumsum`; `torch.cumsum` on the CPU accumulates in float64 and
  rounds otherwise, which the first test below shows);
* `redistribute_v3`'s placements within atol 1e-5, its deltas rtol 1e-5;
* whole rendered rays as `test_torch_field_pipeline.py` holds v2's: rgb
  1e-4, depth 5e-4 (depth lies in [2, 6]), `n_live` exactly, overflow 0;
* a 24-step v3 training run fed JAX's draws: every step's points exactly,
  its loss within 1e-2 relative, as `test_torch_train.py` holds training.

The property tests port the invariants of `tests/test_sampling_properties.py`
to the port's functions, with `deadline=None`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import field as j_field
from repro.core import occupancy as j_occ
from repro.core import rendering as j_rendering
from repro.core import trainer as j_trainer
from repro.core.pipeline import RenderPipeline as JPipeline
from repro.data import rays_dataset as j_rays
from repro.data import synthetic_scene as j_scene
from repro_torch import bridge
from repro_torch.core import field as t_field
from repro_torch.core import occupancy as t_occ
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core import rendering as t_rendering
from repro_torch.core import trainer as t_trainer
from repro_torch.core.pipeline import RenderPipeline as TPipeline
from repro_torch.data import rays_dataset as t_rays
from repro_torch.optim.adamw import tree_paths
from repro_torch.serve3d import (DONE, ReconstructionService, RenderService,
                                 SnapshotStore)

GEOM = dict(n_levels=4, max_resolution=64, log2_table_density=12,
            log2_table_color=10, hidden=16)
J_FCFG = j_field.FieldConfig(**GEOM)
T_FCFG = t_field.FieldConfig(**GEOM)
RCFG = dict(n_samples=16)
J_RCFG = j_rendering.RenderConfig(**RCFG)
T_RCFG = t_rendering.RenderConfig(**RCFG)
OCC = dict(resolution=16)
J_OCFG = j_occ.OccupancyConfig(**OCC)
T_OCFG = t_occ.OccupancyConfig(**OCC)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _pipes(s: int, oversub: int = 4):
    return (JPipeline(None, j_rendering.RenderConfig(n_samples=s), redistribute_v3=True,
                      v3_oversub=oversub),
            TPipeline(None, t_rendering.RenderConfig(n_samples=s), redistribute_v3=True,
                      v3_oversub=oversub))


def _stage_inputs(rng, b: int, s: int, use_ema: bool):
    """Stratified candidates ts (B, S), liveness from fully dead to fully
    live per ray, and EMA values spread over orders of magnitude."""
    h = 4.0 / s
    ts = (2.0 + (np.arange(s)[None, :] + rng.random((b, s), dtype=np.float32)) * h)
    live = rng.random((b, s)) < rng.random((b, 1)) * 1.2
    ema = (rng.random((b, s), dtype=np.float32) ** 4 * 50.0) if use_ema else None
    return ts.astype(np.float32), live, ema


def _draw_case(seed: int, use_ema: bool):
    """(port pipeline, ts, live, ema, budget) from one integer seed, as the
    reference's property suite draws them."""
    rng = np.random.default_rng(seed)
    b = int(rng.integers(2, 24))
    s = int(rng.integers(4, 33))
    budget = int(rng.integers(b, 4 * b * s + 1))
    pipe = TPipeline(None, t_rendering.RenderConfig(n_samples=s), redistribute_v3=True,
                     v3_oversub=int(rng.integers(2, 7)))
    ts, live, ema = _stage_inputs(rng, b, s, use_ema)
    return pipe, _t(ts), _t(live), None if ema is None else _t(ema), budget


# ---- the reference's summation order ----

def test_ref_order_sums_match_jax_and_torch_cumsum_does_not():
    """`ref_sum` / `ref_cumsum` give XLA's f32 bits on the CPU (a tree of
    32-wide windows; 16-wide scanned blocks), at the lengths stage 2b sums
    (S strata, B rays); `torch.cumsum` does not."""
    rng = np.random.default_rng(0)
    torch_cumsum_differs = False
    for n in (5, 16, 17, 33, 48, 100, 1024, 4097):
        x = (rng.random((3, n), dtype=np.float32) ** 4 * 50.0).astype(np.float32)
        np.testing.assert_array_equal(t_pipeline.ref_sum(_t(x)).numpy(),
                                      np.asarray(jnp.sum(jnp.asarray(x), axis=-1)))
        want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
        np.testing.assert_array_equal(t_pipeline.ref_cumsum(_t(x)).numpy(), want)
        torch_cumsum_differs |= not np.array_equal(torch.cumsum(_t(x), -1).numpy(), want)
    assert torch_cumsum_differs


# ---- the occupancy helpers ----

@pytest.fixture(scope="module")
def ema_state():
    rng = np.random.default_rng(5)
    ema = (rng.random(8 ** 3, dtype=np.float32) ** 2 * 0.5).astype(np.float32)
    mids = (rng.random((6, 12, 3), dtype=np.float32) * (1 - 1e-6)).astype(np.float32)
    return ema, mids


@pytest.mark.parametrize("helper", ["ray_segment_mask", "point_density", "ray_segment_mass",
                                    "occupied_mask_fn", "occupancy_fraction"])
def test_occupancy_helpers_match_jax(helper, ema_state):
    ema, mids = ema_state
    cfg_j = j_occ.OccupancyConfig(resolution=8)
    cfg_t = t_occ.OccupancyConfig(resolution=8)
    thr = cfg_t.density_threshold
    if helper == "ray_segment_mask":
        got = t_occ.ray_segment_mask(_t(ema) > thr, _t(mids), 8)
        want = j_occ.ray_segment_mask(jnp.asarray(ema) > thr, jnp.asarray(mids), 8)
    elif helper == "point_density":
        got = t_occ.point_density(_t(ema), _t(mids), 8)
        want = j_occ.point_density(jnp.asarray(ema), jnp.asarray(mids), 8)
    elif helper == "ray_segment_mass":
        got = t_occ.ray_segment_mass(_t(ema), _t(mids), 8, thr)
        want = j_occ.ray_segment_mass(jnp.asarray(ema), jnp.asarray(mids), 8, thr)
    elif helper == "occupied_mask_fn":
        flat = mids.reshape(-1, 3)
        for step in (0, 3):       # step 0: the all-occupied warmup bitfield
            got = t_occ.occupied_mask_fn(t_occ.OccupancyState(_t(ema), step), cfg_t)(_t(flat))
            want = j_occ.occupied_mask_fn(
                j_occ.OccupancyState(jnp.asarray(ema), jnp.int32(step)), cfg_j)(
                    jnp.asarray(flat))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        got = t_occ.occupancy_fraction(t_occ.OccupancyState(_t(ema), 2), cfg_t)
        want = j_occ.occupancy_fraction(j_occ.OccupancyState(jnp.asarray(ema), 2), cfg_j)
    assert got.dtype == {"ray_segment_mask": torch.bool, "occupied_mask_fn": torch.bool}.get(
        helper, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the plan and the placement against JAX ----

def _jax_v3_stratum_index(ts, plan, near, far):
    """The stratum index inside the reference's `redistribute_v3`
    (core/pipeline.py:363-376), computed with its own jnp operations."""
    s = ts.shape[1]
    k = jnp.arange(plan["s_cap"])
    jitter = (jnp.asarray(ts)[:, k % s] - near) / (far - near) * s
    jitter = jnp.clip(jitter - jnp.floor(jitter), 0.0, 1.0 - 1e-6)
    sr = plan["s_ray"].astype(jnp.float32)[:, None]
    u = jnp.clip((k[None, :] + jitter) / sr, 0.0, 1.0 - 1e-9) * plan["cdf"][:, -1:]
    j = jax.vmap(lambda c, uu: jnp.searchsorted(c, uu, side="right"))(plan["cdf"], u)
    return np.asarray(jnp.clip(j, 0, s - 1))


# (B, S, budget, oversub): s_cap < S, s_cap > S (lane k recycles column
# k mod S), the even split, and a 1024-ray batch at the 1/12 ceiling
REGIMES = {"narrow": (16, 32, 64, 4), "wide": (16, 8, 64, 4), "even": (12, 16, 192, 2),
           "train": (1024, 48, 4096, 4)}


@pytest.mark.parametrize("use_ema", [True, False], ids=["ema", "no_ema"])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_v3_plan_and_placement_match_jax(regime, use_ema):
    b, s, budget, oversub = REGIMES[regime]
    rng = np.random.default_rng(len(regime) + 7 * use_ema)
    ts, live, ema = _stage_inputs(rng, b, s, use_ema)
    jp, tp = _pipes(s, oversub)
    ema_j = None if ema is None else jnp.asarray(ema)
    ema_t = None if ema is None else _t(ema)

    np.testing.assert_allclose(tp.v3_stratum_weights(_t(live), ema_t).numpy(),
                               np.asarray(jp.v3_stratum_weights(jnp.asarray(live), ema_j)),
                               rtol=1e-6, atol=0)
    want = jp.v3_plan(jnp.asarray(ts), jnp.asarray(live), ema_j, budget)
    got = tp.v3_plan(_t(ts), _t(live), ema_t, budget)
    assert got["s_cap"] == want["s_cap"]
    if regime == "narrow":
        assert got["s_cap"] < s
    elif regime == "wide":
        assert got["s_cap"] > s
    for key in ("s_ray", "dead"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("pdf", "cdf", "mass"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6, atol=0)
    assert int(got["s_ray"].sum()) <= budget

    j_t = t_pipeline.v3_strata(_t(ts), got, 2.0, 6.0)[0]
    np.testing.assert_array_equal(j_t.numpy(), _jax_v3_stratum_index(ts, want, 2.0, 6.0))
    ts_j, dl_j, valid_j = jp.redistribute_v3(jnp.asarray(ts), jnp.asarray(live), ema_j, budget)
    ts_t, dl_t, valid_t = tp.redistribute_v3(_t(ts), _t(live), ema_t, budget)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_allclose(ts_t.numpy(), np.asarray(ts_j), atol=1e-5)
    np.testing.assert_allclose(dl_t.numpy(), np.asarray(dl_j), rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def snapshot():
    """(numpy params, numpy occupancy pair) from the JAX field, grids widened
    to U(-1, 1) and the density bias lowered, so the threshold splits."""
    params = jax.tree.map(np.asarray, j_field.Field(J_FCFG).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for k in ("density_grid", "color_grid"):
        params[k] = rng.uniform(-1, 1, size=params[k].shape).astype(np.float32)
    params["density_mlp"]["b2"] = params["density_mlp"]["b2"].copy()
    params["density_mlp"]["b2"][0] = -3.0
    field = j_field.Field(J_FCFG)
    state = jax.jit(lambda p, k: j_occ.update(field, p, j_occ.init_state(J_OCFG), J_OCFG, k))(
        jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(1))
    return params, (np.asarray(state.density_ema), int(state.step))


def _rays(n_rays: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    pose = j_rendering.sphere_poses(1, seed=seed)[0]
    px, py = rng.integers(0, 24, size=n_rays), rng.integers(0, 24, size=n_rays)
    o, d = j_rendering.pixel_rays(jnp.asarray(pose), jnp.asarray(px), jnp.asarray(py),
                                  24, 24, 20.0)
    return np.asarray(o), np.asarray(d)


# route -> (budget, occ_ema passed, occupancy folded): the trainer's v3
# step, the served one without EMA, s_cap > S, the warmup (all-occupied
# bitfield, zero EMA: uniform-over-live weights, even split) and a budget
# below B (plain compaction)
ROUTES = {"ema": (96 * 4, True, True), "no_ema": (96 * 4, False, True),
          "wide": (96 * 8, True, True), "warmup": (96 * 4, True, False),
          "below_rays": (64, True, True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_pipeline_v3_renders_match_jax(route, snapshot):
    params, (ema, step) = snapshot
    budget, use_ema, folded = ROUTES[route]
    if not folded:
        step, ema = 0, np.zeros_like(ema)
    o, d = _rays(96, seed=2)
    ts = np.asarray(j_rendering.sample_ts(jax.random.PRNGKey(3), 96, J_RCFG))
    jbits = j_occ.bitfield(j_occ.OccupancyState(jnp.asarray(ema), jnp.int32(step)), J_OCFG)
    tbits = t_occ.bitfield(t_occ.OccupancyState(_t(ema), step), T_OCFG)
    jpipe = JPipeline(j_field.Field(J_FCFG), J_RCFG, fused_path=False, redistribute_v3=True)
    tpipe = TPipeline(t_field.Field(T_FCFG), T_RCFG, redistribute_v3=True)
    want = jax.jit(lambda p, o_, d_, t_, e_: jpipe(p, o_, d_, t_, bitfield=jbits,
                                                   budget=budget, occ_ema=e_))(
        jax.tree.map(jnp.asarray, params), *(jnp.asarray(v) for v in (o, d, ts)),
        jnp.asarray(ema) if use_ema else None)
    got = tpipe(bridge.params_to_torch(params, "cpu"), _t(o), _t(d), _t(ts), bitfield=tbits,
                budget=budget, occ_ema=_t(ema) if use_ema else None)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), atol=1e-4)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), atol=5e-4)
    np.testing.assert_allclose(got["opacity"].numpy(), np.asarray(want["opacity"]), atol=1e-4)
    assert int(got["n_live"]) == int(want["n_live"])
    assert int(got["overflow"]) == int(want["overflow"])
    assert int(got["points_queried"]) == int(want["points_queried"]) <= budget
    if route != "below_rays":
        assert int(got["overflow"]) == 0 and int(got["n_live"]) <= budget
    # a mean of bools: torch and XLA sum them in other orders
    np.testing.assert_allclose(float(got["live_fraction"]), float(want["live_fraction"]),
                               rtol=1e-6)


def test_render_rays_with_an_occupancy_mask_matches_jax(snapshot):
    params, (ema, step) = snapshot
    o, d = _rays(48, seed=4)
    ts = np.asarray(j_rendering.sample_ts(None, 48, J_RCFG))
    mask_j = j_occ.occupied_mask_fn(j_occ.OccupancyState(jnp.asarray(ema), jnp.int32(step)),
                                    J_OCFG)
    mask_t = t_occ.occupied_mask_fn(t_occ.OccupancyState(_t(ema), step), T_OCFG)
    want = j_rendering.render_rays(j_field.Field(J_FCFG), jax.tree.map(jnp.asarray, params),
                                   *(jnp.asarray(v) for v in (o, d, ts)), J_RCFG,
                                   occupancy_mask_fn=mask_j)
    got = t_rendering.render_rays(t_field.Field(T_FCFG), bridge.params_to_torch(params, "cpu"),
                                  _t(o), _t(d), _t(ts), T_RCFG, occupancy_mask_fn=mask_t)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), atol=1e-4)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), atol=5e-4)
    assert int(got["n_live"]) == int(want["n_live"]) < 48 * 16


@pytest.mark.parametrize("decomposed", [True, False], ids=["instant3d", "ngp"])
def test_autotune_max_budget_matches_jax(decomposed):
    jf = dataclasses.replace(J_FCFG, decomposed=decomposed)
    tf = dataclasses.replace(T_FCFG, decomposed=decomposed)
    cases = [{}, {"memory_bytes": 10}, {"latency_ms": 5.0}, {"latency_ms": 5.0, "us_per_point": 0}]
    for mem in (2 ** 20, 3 * 10 ** 6, 2 ** 30, 80 * 2 ** 30):
        for lat, us in ((None, None), (1.0, 0.01), (33.0, 0.004), (0.001, 1.0)):
            for mlp_width, min_budget in ((64, 512), (16, 128)):
                cases.append(dict(memory_bytes=mem, latency_ms=lat, us_per_point=us,
                                  mlp_width=mlp_width, min_budget=min_budget))
    cases += [dict(latency_ms=lat, us_per_point=0.002) for lat in (0.5, 7.0, 100.0)]
    for kw in cases:
        got = t_trainer.autotune_max_budget(tf, T_RCFG, **kw)
        assert got == j_trainer.autotune_max_budget(jf, J_RCFG, **kw), kw
        if got is not None:
            assert got & (got - 1) == 0


# ---- the invariants of tests/test_sampling_properties.py ----

@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), use_ema=st.booleans())
def test_budget_conservation_and_floor(seed, use_ema):
    """sum(S'_i) <= budget, every ray's floor of 1, S'_i <= s_cap, and the
    validity mask agrees with the allocation."""
    pipe, ts, live, ema, budget = _draw_case(seed, use_ema)
    plan = pipe.v3_plan(ts, live, ema, budget)
    _, _, valid = pipe.redistribute_v3(ts, live, ema, budget)
    s_ray = plan["s_ray"].numpy()
    assert int(s_ray.sum()) <= budget
    assert (s_ray >= 1).all()
    assert (s_ray <= plan["s_cap"]).all()
    assert (valid.numpy().sum(axis=1) == s_ray).all()


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), use_ema=st.booleans())
def test_cdf_monotone_and_normalized(seed, use_ema):
    pipe, ts, live, ema, budget = _draw_case(seed, use_ema)
    plan = pipe.v3_plan(ts, live, ema, budget)
    cdf = plan["cdf"].numpy().astype(np.float64)
    assert (plan["pdf"].numpy() >= 0.0).all()
    assert (np.diff(cdf, axis=1) >= -1e-7).all()
    np.testing.assert_allclose(cdf[:, -1], 1.0, rtol=1e-5)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), use_ema=st.booleans())
def test_deltas_sum_to_live_length(seed, use_ema):
    """Valid lanes' deltas sum per ray to its live length (dead rays: the
    full span); invalid lanes carry exactly 0."""
    pipe, ts, live, ema, budget = _draw_case(seed, use_ema)
    _, deltas, valid = pipe.redistribute_v3(ts, live, ema, budget)
    plan = pipe.v3_plan(ts, live, ema, budget)
    h = (pipe.cfg.far - pipe.cfg.near) / ts.shape[1]
    target = np.where(plan["dead"].numpy(), pipe.cfg.far - pipe.cfg.near,
                      live.numpy().sum(axis=1) * h)
    d = deltas.numpy().astype(np.float64)
    assert (d[~valid.numpy()] == 0.0).all()
    np.testing.assert_allclose(d.sum(axis=1), target, rtol=1e-5, atol=1e-6)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), use_ema=st.booleans())
def test_samples_land_in_live_strata(seed, use_ema):
    """Every valid sample of a ray with a live stratum lies in a live
    stratum; ts ascends per ray and invalid lanes are parked at far."""
    pipe, ts, live, ema, budget = _draw_case(seed, use_ema)
    ts_new, _, valid = pipe.redistribute_v3(ts, live, ema, budget)
    dead = pipe.v3_plan(ts, live, ema, budget)["dead"].numpy()
    s = ts.shape[1]
    near, far = pipe.cfg.near, pipe.cfg.far
    tsn, valid, live = ts_new.numpy(), valid.numpy(), live.numpy()
    stratum = np.clip(((tsn - near) / ((far - near) / s)).astype(np.int64), 0, s - 1)
    for i in range(tsn.shape[0]):
        assert (np.diff(tsn[i]) >= -1e-6).all()
        assert (tsn[i][~valid[i]] == np.float32(far)).all()
        if not dead[i]:
            assert live[i][stratum[i][valid[i]]].all(), f"ray {i}: sample outside live strata"


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_ray_segment_mass_degrades_to_mask(seed):
    """`ray_segment_mass > 0` is `ray_segment_mask` of bits = ema > threshold,
    and where live the mass is the cell's EMA itself."""
    rng = np.random.default_rng(seed)
    r = int(rng.choice([4, 8]))
    thr = 0.05
    ema = _t((rng.random(r ** 3, dtype=np.float32) ** 2) * 0.5)
    mids = _t(rng.random((6, 12, 3), dtype=np.float32) * (1 - 1e-6))
    mass = t_occ.ray_segment_mass(ema, mids, r, thr).numpy()
    mask = t_occ.ray_segment_mask(ema > thr, mids, r).numpy()
    np.testing.assert_array_equal(mass > 0, mask)
    d = t_occ.point_density(ema, mids, r).numpy()
    np.testing.assert_array_equal(mass, np.where(mask, d, 0.0))


def test_v3_equals_v2_under_uniform_weights():
    """With ema None and every stratum live, v3's pdf rows are 1/S,
    the allocation is v2's even split S' = budget // B, and the placements
    are v2's."""
    b, s, budget = 8, 16, 128
    _, pipe = _pipes(s)
    v2 = TPipeline(None, t_rendering.RenderConfig(n_samples=s), redistribute=True)
    ts, _, _ = _stage_inputs(np.random.default_rng(3), b, s, False)
    live = torch.ones((b, s), dtype=torch.bool)
    plan = pipe.v3_plan(_t(ts), live, None, budget)
    np.testing.assert_array_equal(plan["s_ray"].numpy(), np.full(b, budget // b))
    np.testing.assert_allclose(plan["pdf"].numpy(), 1.0 / s, rtol=1e-6)
    ts3, dl3, valid = pipe.redistribute_v3(_t(ts), live, None, budget)
    ts2, dl2 = v2.redistribute(_t(ts), live, n_out=budget // b)
    assert bool(valid[:, :budget // b].all()) and not bool(valid[:, budget // b:].any())
    np.testing.assert_allclose(ts3[:, :budget // b].numpy(), ts2.numpy(), atol=1e-6)
    np.testing.assert_allclose(dl3[:, :budget // b].numpy(), dl2.numpy(), rtol=1e-6)


# ---- training ----

TRAIN_DATA = dict(n_views=4, h=16, w=16, gt_samples=48)
TRAIN = dict(n_rays=64, iters=24, min_budget=64, max_budget=256, redistribute_v3=True)
TRAIN_OCC = dict(resolution=16, warmup_steps=8, update_interval=4)


def _train_cfgs():
    return tuple(pkg_trainer.TrainerConfig(render=pkg_rendering.RenderConfig(**RCFG),
                                           occ=pkg_occ.OccupancyConfig(**TRAIN_OCC), **TRAIN)
                 for pkg_trainer, pkg_rendering, pkg_occ in (
                     (j_trainer, j_rendering, j_occ), (t_trainer, t_rendering, t_occ)))


def _jax_draws(cfg, n_pool: int):
    def draws(i: int):
        kb, kt, ko = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(cfg.seed), i), 3)
        idx = jax.random.randint(kb, (cfg.n_rays,), 0, n_pool)
        u_ts = jax.random.uniform(kt, (cfg.n_rays, cfg.render.n_samples))
        u_occ = jax.random.uniform(ko, (cfg.occ.resolution ** 3, 3))
        return tuple(_t(np.asarray(a)) for a in (idx, u_ts, u_occ))
    return draws


def test_v3_training_run_matches_jax():
    """24 v3 steps at max_budget 256 of 1024 points, fed JAX's draws: the
    same folds, points and overflow (0) every step, the loss within 1e-2."""
    j_cfg, t_cfg = _train_cfgs()
    _, ds = j_scene.build_dataset(0, cfg=j_cfg.render, **TRAIN_DATA)
    j_sampler = j_rays.RaySampler(ds, views=[1, 2, 3])
    j_tr = j_trainer.Instant3DTrainer(j_field.Field(J_FCFG), j_cfg)
    j_state = j_tr.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, j_state.params)
    j_state, j_hist = j_tr.train(j_state, j_sampler, log_every=1)

    t_tr = t_trainer.Instant3DTrainer(t_field.Field(T_FCFG), t_cfg, device="cpu")
    tp = bridge.params_to_torch(params, "cpu")
    sampler = t_rays.RaySampler(ds, views=[1, 2, 3], device="cpu")
    sampler.origins = _t(np.asarray(j_sampler.origins))
    sampler.dirs = _t(np.asarray(j_sampler.dirs))
    t_state = t_trainer.TrainState(tp, t_tr.opt.init(tp), t_occ.init_state(t_cfg.occ, "cpu"), 0)
    t_state, t_hist = t_tr.train(t_state, sampler, log_every=1,
                                 draws=_jax_draws(j_cfg, j_sampler.n))
    assert t_hist["occ_folds"] == [i for i in range(24) if i >= 8 and (i + 1) % 4 == 0]
    assert t_state.occ_state.step == int(j_state.occ_state.step)
    assert t_hist["points_queried"] == j_hist["points_queried"]
    assert t_hist["budget"].count(256) >= 8, t_hist["budget"]
    assert max(t_hist["points_queried"][12:]) <= 256
    assert t_hist["overflow"] == j_hist["overflow"]
    assert t_hist["overflow_total"] == 0 == j_hist["overflow_total"]
    np.testing.assert_allclose(t_hist["live_fraction"], j_hist["live_fraction"], rtol=1e-6)
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-2)


def _short_run(ds, forbid=(), **cfg_kw):
    """12 steps on the small config; `forbid` names pipeline stages that
    must never run (replaced by a raiser)."""
    cfg = dataclasses.replace(_train_cfgs()[1], iters=12, redistribute_v3=False,
                              occ=t_occ.OccupancyConfig(resolution=16, warmup_steps=4,
                                                        update_interval=4), **cfg_kw)
    tr = t_trainer.Instant3DTrainer(t_field.Field(T_FCFG), cfg, device="cpu")
    for name in forbid:
        def boom(*a, _name=name, **k):
            raise AssertionError(f"{_name} ran with its knob off")
        setattr(tr.pipeline, name, boom)
    state, hist = tr.train(tr.init(), t_rays.RaySampler(ds, views=[1, 2, 3], device="cpu"),
                           log_every=4)
    return state, hist


def _states_equal(a, b) -> bool:
    leaves = lambda s: [t for _, t in tree_paths(  # noqa: E731
        {"p": s.params, "m": s.opt_state.m, "v": s.opt_state.v})] + [s.occ_state.density_ema]
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


@pytest.fixture(scope="module")
def port_scene():
    from repro_torch.data.synthetic_scene import build_dataset
    return build_dataset(0, cfg=T_RCFG, device="cpu", **TRAIN_DATA)[1]


@pytest.mark.parametrize("knob", ["off", "v2"])
def test_v3_off_never_runs_and_is_bit_identical(knob, port_scene):
    """With the v3 knob off its stage never runs (a raiser in its place
    survives a run that compacts) and the state equals, byte for byte, a run
    without the raiser; the same holds for v2's runs."""
    kw = dict(max_budget=256, redistribute=knob == "v2")
    forbid = ("redistribute_v3", "v3_plan") + (("redistribute",) if knob == "off" else ())
    a, ha = _short_run(port_scene, forbid=forbid, **kw)
    b, hb = _short_run(port_scene, **kw)
    assert any(p <= 256 for p in hb["points_queried"])
    assert _states_equal(a, b) and ha["loss"] == hb["loss"]


# ---- serving ----

def test_v3_render_service_matches_jax(snapshot):
    """A 16x16 view of a v3 session through `RenderService` against JAX's
    `batched_redistributed_render_fn(redistribute_v3=True)`."""
    params, (ema, step) = snapshot
    pose, hw, focal, chunk, spr = j_rendering.sphere_poses(1, seed=5)[0], 16, 20.0, 64, 4
    store = SnapshotStore()
    store.publish("v3", bridge.params_to_torch(params, "cpu"), step=1,
                  occ=t_occ.OccupancyState(_t(ema), step))
    svc = RenderService(store, device="cpu")
    svc.register_session("v3", T_FCFG, T_RCFG, hw, hw, focal, eval_chunk=chunk,
                         occ_cfg=T_OCFG, samples_per_ray=spr, redistribute_v3=True)
    svc.submit("v3", pose)
    (got,) = svc.drain()

    fn = j_trainer.batched_redistributed_render_fn(J_FCFG, J_RCFG, J_OCFG, chunk, 1, spr,
                                                   redistribute_v3=True)
    o, d, n, _ = j_trainer.image_rays(pose, hw, hw, focal, chunk)
    ts = j_rendering.sample_ts(None, chunk, J_RCFG)
    stacked = jax.tree.map(lambda a: jnp.asarray(a)[None], params)
    rgb, dep = [], []
    for i in range(0, o.shape[0], chunk):
        r, dd = fn(stacked, o[None, i:i + chunk], d[None, i:i + chunk], ts,
                   jnp.asarray(ema)[None], jnp.asarray([step], jnp.int32))
        rgb.append(np.asarray(r[0]))
        dep.append(np.asarray(dd[0]))
    np.testing.assert_allclose(got.rgb, np.concatenate(rgb)[:n].reshape(hw, hw, 3), atol=1e-4)
    np.testing.assert_allclose(got.depth, np.concatenate(dep)[:n].reshape(hw, hw), atol=5e-4)
    plain = svc._geom["v3"]
    assert plain.redistribute_v3 and plain.samples_per_ray == spr


def test_v3_session_trains_and_serves_through_the_service(port_scene):
    """`ReconstructionService` trains a v3 session (zero overflow under its
    ceiling) and serves it; `evaluate`'s renderer equals the served bytes."""
    cfg = dataclasses.replace(_train_cfgs()[1], eval_chunk=64,
                              occ=t_occ.OccupancyConfig(resolution=16, warmup_steps=2,
                                                        update_interval=4))
    svc = ReconstructionService(slice_iters=8, device="cpu")
    sid = svc.submit_scene(port_scene, T_FCFG, cfg, target_iters=16, seed=0)
    svc.run()
    sess, snap = svc.sessions[sid], svc.store.latest(sid)
    assert sess.status == DONE and sess.trainer.pipeline.redistribute_v3_on
    assert snap.occ[1] > 0 and sess.render_spr == 4
    rid = svc.request_render(sid, port_scene.poses[0])
    served = {r.request_id: r for r in svc.renderer.drain()}[rid]
    rgb, dep = sess.trainer.render_image(snap.params, port_scene.poses[0], port_scene,
                                         occ=snap.occ, samples_per_ray=sess.render_spr)
    assert np.array_equal(rgb, served.rgb) and np.array_equal(dep, served.depth)
    assert np.isfinite(served.rgb).all() and served.rgb.shape == (16, 16, 3)


def test_chip_smoke_v3_phase_rehearsal():
    """Phase 6 of chip_smoke.py at a tiny size on the CPU: the three runs
    under a ceiling, v3's gate (no kernel launches here, so none counted),
    its plan against the CPU, serving with eval == served, the reuse
    replay bit for bit."""
    from repro_torch import smoke
    base = t_trainer.TrainerConfig(
        n_rays=64, iters=20, min_budget=64, render=T_RCFG, eval_chunk=64,
        occ=t_occ.OccupancyConfig(resolution=16, warmup_steps=8, update_interval=4))
    runs = smoke.sampler_runs("cpu", T_FCFG, base, max_budget=256, dataset=TRAIN_DATA,
                              held_out=1)
    assert set(runs) == {"uniform", "v2", "v3"}
    nothing = ((), tuple(smoke.KERNELS))
    v3 = runs["v3"]
    assert smoke.check_v3_run(v3, 256, nothing, min_psnr=-np.inf) == []
    assert smoke.check_v3_run(v3, 128, nothing, min_psnr=-np.inf)    # over a lower ceiling
    assert v3["trainer"].pipeline.redistribute_v3_on and len(v3["compact_ms"]) > 0
    step = smoke.v3_train_step("cpu", v3, 256, held_out=1)
    assert step["overflow"] == 0 and step["points"].shape == (256, 3)
    plan = smoke.v3_plan_against_cpu(step, 256, T_RCFG)
    assert plan["s_ray_differ_from_cpu"] == 0 and plan["two_runs_same_bytes"]
    assert plan["sum_s_ray"] <= 256
    served = smoke.serve_trained("cpu", v3, n_requests=2, hw=12)
    assert served["eval_vs_served"] == {"rgb": True, "depth": True}
    assert served["samples_per_ray"] == 4 and len(served["results"]) == 2
    reuse = smoke.reuse_replay("cpu", v3, steps=6, budget=256, held_out=1)
    assert reuse["bit_identical"] and reuse["lookups"] > 0 and reuse["steps"] == 6
