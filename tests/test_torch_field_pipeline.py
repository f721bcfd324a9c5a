"""Port field, occupancy and render pipeline against the JAX package (CPU).

Params made by the JAX `Field.init` (with grids widened to U(-1, 1) so the
encodings are far from zero) are carried to the port by `repro_torch.bridge`;
stage inputs are numpy arrays fed to both packages.  Integer stage outputs
(cull masks, the compaction order, redistribute's stratum index) must match
exactly; float outputs within the stated tolerances (1e-5 for the field,
1e-4 rgb / 5e-4 depth for rendered rays, whose depth lies in [2, 6]).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import field as j_field
from repro.core import occupancy as j_occ
from repro.core import rendering as j_rendering
from repro.core import trainer as j_trainer
from repro.core.encoding import sh_encoding as j_sh_encoding
from repro.core.pipeline import RenderPipeline as JPipeline
from repro_torch import bridge
from repro_torch.core import field as t_field
from repro_torch.core import occupancy as t_occ
from repro_torch.core import rendering as t_rendering
from repro_torch.core import trainer as t_trainer
from repro_torch.core.encoding import sh_encoding as t_sh_encoding
from repro_torch.core.pipeline import RenderPipeline as TPipeline
from repro_torch.core.pipeline import inverse_cdf_strata, live_cdf

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


def jax_params(seed: int = 0) -> dict:
    """JAX `Field.init` params with the grids widened to U(-1, 1) and the
    density bias lowered, so the occupancy threshold splits the cells."""
    params = jax.tree.map(np.asarray, j_field.Field(J_FCFG).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k in ("density_grid", "color_grid"):
        params[k] = rng.uniform(-1, 1, size=params[k].shape).astype(np.float32)
    params["density_mlp"]["b2"] = params["density_mlp"]["b2"].copy()
    params["density_mlp"]["b2"][0] = -3.0
    return params


@pytest.fixture(scope="module")
def snapshot():
    """(numpy params, numpy occupancy pair) from the JAX field."""
    params = jax_params()
    field = j_field.Field(J_FCFG)
    state = jax.jit(lambda p, k: j_occ.update(field, p, j_occ.init_state(J_OCFG),
                                              J_OCFG, k))(
        jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(1))
    return params, (np.asarray(state.density_ema), int(state.step))


# ---- bridge ----

def test_bridge_round_trip_is_bit_exact():
    params = jax.tree.map(np.asarray, j_field.Field(J_FCFG).init(jax.random.PRNGKey(3)))
    back = bridge.params_to_numpy(bridge.params_to_torch(params, "cpu"))
    leaves_a, tree_a = jax.tree_util.tree_flatten(params)
    leaves_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    ema = np.random.default_rng(0).uniform(0, 3, size=16 ** 3).astype(np.float32)
    ema_b, step_b = bridge.occ_to_numpy(bridge.occ_to_torch((ema, np.int32(7)), "cpu"))
    assert ema_b.tobytes() == ema.tobytes() and step_b == 7


def test_port_init_has_the_reference_layout():
    j = jax.tree.map(np.asarray, j_field.Field(J_FCFG).init(jax.random.PRNGKey(0)))
    t = t_field.Field(T_FCFG).init(torch.Generator().manual_seed(0), device="cpu")
    jl, jt = jax.tree_util.tree_flatten(j)
    tl, tt = jax.tree_util.tree_flatten(bridge.params_to_numpy(t))
    assert jt == tt
    for a, b in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype
    # same distributions: grids U(-1e-4, 1e-4), He-uniform weights, zero biases
    assert np.abs(t["density_grid"].numpy()).max() <= 1e-4
    w1 = t["color_mlp"]["w1"].numpy()
    assert np.abs(w1).max() <= (6.0 / w1.shape[0]) ** 0.5 and w1.std() > 0
    assert not t["color_mlp"]["b1"].any()


# ---- field ----

def test_sh_encoding_matches_jax(rng):
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(t_sh_encoding(_t(d)).numpy(),
                               np.asarray(j_sh_encoding(jnp.asarray(d))),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("decomposed", [True, False])
def test_field_query_and_density_match_jax(decomposed, rng):
    jcfg = j_field.FieldConfig(**GEOM, decomposed=decomposed)
    tcfg = t_field.FieldConfig(**GEOM, decomposed=decomposed)
    params = jax.tree.map(np.asarray, j_field.Field(jcfg).init(jax.random.PRNGKey(2)))
    for k in ("density_grid", "color_grid"):
        if k in params:
            params[k] = rng.uniform(-1, 1, size=params[k].shape).astype(np.float32)
    pts = rng.uniform(0, 1 - 1e-6, size=(400, 3)).astype(np.float32)
    dirs = rng.normal(size=(400, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jf, tf = j_field.Field(jcfg), t_field.Field(tcfg)
    jp, tp = jax.tree.map(jnp.asarray, params), bridge.params_to_torch(params, "cpu")
    sig_j, rgb_j = jf.query(jp, jnp.asarray(pts), jnp.asarray(dirs))
    sig_t, rgb_t = tf.query(tp, _t(pts), _t(dirs))
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=1e-5)
    (ds_j, geo_j), (ds_t, geo_t) = jf.density(jp, jnp.asarray(pts)), tf.density(tp, _t(pts))
    np.testing.assert_allclose(ds_t.numpy(), np.asarray(ds_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(geo_t.numpy(), np.asarray(geo_j), atol=1e-5, rtol=1e-5)


# ---- occupancy ----

def test_occupancy_update_and_bitfield_match_jax(snapshot):
    params, (ema_j, step_j) = snapshot
    assert step_j == 1
    np.testing.assert_array_equal(t_occ.cell_centers(T_OCFG, "cpu").numpy(),
                                  np.asarray(j_occ.cell_centers(J_OCFG)))
    # the reference's jitter, handed to the port
    r3 = T_OCFG.resolution ** 3
    jitter = (jax.random.uniform(jax.random.PRNGKey(1), (r3, 3)) - 0.5) / T_OCFG.resolution
    state = t_occ.update(t_field.Field(T_FCFG), bridge.params_to_torch(params, "cpu"),
                         t_occ.init_state(T_OCFG, "cpu"), T_OCFG,
                         jitter=_t(np.asarray(jitter)))
    assert state.step == 1
    np.testing.assert_allclose(state.density_ema.numpy(), ema_j, atol=1e-5, rtol=1e-5)
    bits_j = np.asarray(j_occ.bitfield(j_occ.OccupancyState(jnp.asarray(ema_j),
                                                           jnp.int32(1)), J_OCFG))
    bits_t = t_occ.bitfield(t_occ.OccupancyState(_t(ema_j), 1), T_OCFG).numpy()
    np.testing.assert_array_equal(bits_t, bits_j)
    assert 0.1 < bits_t.mean() < 0.9, "the test field should split the cells"
    # before any update the field reads all-occupied
    assert t_occ.bitfield(t_occ.init_state(T_OCFG, "cpu"), T_OCFG).all()
    pts = np.random.default_rng(0).uniform(0, 1 - 1e-6, size=(2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_occ.point_liveness(_t(bits_t), _t(pts), 16).numpy(),
        np.asarray(j_occ.point_liveness(jnp.asarray(bits_j), jnp.asarray(pts), 16)))


def test_occupancy_update_from_a_generator_is_reproducible():
    field = t_field.Field(T_FCFG)
    params = field.init(torch.Generator().manual_seed(0), device="cpu")
    a, b = (t_occ.update(field, params, t_occ.init_state(T_OCFG, "cpu"), T_OCFG,
                         generator=torch.Generator().manual_seed(5)) for _ in range(2))
    assert torch.equal(a.density_ema, b.density_ema) and a.step == 1
    with pytest.raises(ValueError):
        t_occ.update(field, params, a, T_OCFG)


# ---- rays and samples ----

def test_sample_ts_and_image_rays_match_jax():
    ts_j = np.asarray(j_rendering.sample_ts(None, 7, J_RCFG))
    ts_t = t_rendering.sample_ts(None, 7, T_RCFG, device="cpu").numpy()
    np.testing.assert_array_equal(ts_t, ts_j)
    pose = j_rendering.sphere_poses(2, seed=3)[1]
    np.testing.assert_array_equal(t_rendering.sphere_poses(2, seed=3)[1], pose)
    o_j, d_j, n_j, c_j = j_trainer.image_rays(pose, 12, 10, 11.0, 64)
    o_t, d_t, n_t, c_t = t_trainer.image_rays(pose, 12, 10, 11.0, 64, device="cpu")
    assert (n_t, c_t) == (n_j, c_j) and o_t.shape == o_j.shape
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    assert t_trainer.default_samples_per_ray(48) == j_trainer.default_samples_per_ray(48) == 12


# ---- pipeline stages ----

def _rays(n_rays: int, seed: int = 0):
    """World-space rays from the sphere poses through random pixels."""
    rng = np.random.default_rng(seed)
    pose = j_rendering.sphere_poses(1, seed=seed)[0]
    px = rng.integers(0, 24, size=n_rays)
    py = rng.integers(0, 24, size=n_rays)
    o, d = j_rendering.pixel_rays(jnp.asarray(pose), jnp.asarray(px), jnp.asarray(py),
                                  24, 24, 20.0)
    return np.asarray(o), np.asarray(d)


def test_stage_outputs_match_jax(snapshot):
    params, (ema, step) = snapshot
    bits = np.asarray(j_occ.bitfield(j_occ.OccupancyState(jnp.asarray(ema), jnp.int32(step)),
                                     J_OCFG))
    jpipe = JPipeline(j_field.Field(J_FCFG), J_RCFG, fused_path=False, redistribute=True)
    tpipe = TPipeline(t_field.Field(T_FCFG), T_RCFG, redistribute=True)
    o, d = _rays(64)
    ts = np.asarray(j_rendering.sample_ts(jax.random.PRNGKey(4), 64, J_RCFG))

    # stage 1: the same arithmetic, to f32 rounding
    jp, jdirs, junit = jax.jit(jpipe.generate_samples)(*(jnp.asarray(v) for v in (o, d, ts)))
    tp, tdirs, tunit = tpipe.generate_samples(_t(o), _t(d), _t(ts))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tunit.numpy(), np.asarray(junit), atol=1e-6)
    pts, unit = np.asarray(jp), np.asarray(junit)

    # stage 2 on identical inputs: exact
    live_j = np.asarray(jax.jit(jpipe.cull)(jnp.asarray(pts), jnp.asarray(unit),
                                            jnp.asarray(bits)))
    live_t = tpipe.cull(_t(pts), _t(unit), _t(bits)).numpy()
    np.testing.assert_array_equal(live_t, live_j)
    assert 0.05 < live_t.mean() < 0.95

    # stage 2b: stratum index exactly, placements and widths to rounding
    for n_out in (16, 4):
        live2 = live_j.reshape(64, -1)
        ts_j, dl_j = jax.jit(functools.partial(jpipe.redistribute, n_out=n_out))(
            jnp.asarray(ts), jnp.asarray(live2))
        ts_t, dl_t = tpipe.redistribute(_t(ts), _t(live2), n_out=n_out)
        np.testing.assert_allclose(ts_t.numpy(), np.asarray(ts_j), atol=1e-5)
        np.testing.assert_allclose(dl_t.numpy(), np.asarray(dl_j), atol=1e-6, rtol=1e-5)
        np.testing.assert_array_equal(
            inverse_cdf_strata(_t(ts), _t(live2), n_out, 2.0, 6.0)[0].numpy(),
            _jax_stratum_index(ts, live2, n_out, 2.0, 6.0))

    # stage 3: the compaction order exactly (int64 key: dead lanes last)
    for budget in (len(live_j), 300, int(live_j.sum()) - 7):
        for u in (unit, None):
            plan_j = jax.jit(jpipe.compact, static_argnums=1)(
                jnp.asarray(live_j), budget, None if u is None else jnp.asarray(u))
            plan_t = tpipe.compact(_t(live_j), budget, None if u is None else _t(u))
            np.testing.assert_array_equal(plan_t.idx.numpy(), np.asarray(plan_j.idx))
            np.testing.assert_array_equal(plan_t.keep.numpy(), np.asarray(plan_j.keep))
            assert int(plan_t.n_live) == int(plan_j.n_live)
            assert int(plan_t.overflow) == int(plan_j.overflow)


def _jax_stratum_index(ts, live, n_out, near, far):
    """The stratum index inside the reference's `redistribute`
    (core/pipeline.py:234-247), computed with its own jnp operations."""
    s = ts.shape[1]
    w = jnp.asarray(live).astype(jnp.float32)
    total = jnp.sum(w, axis=-1, keepdims=True)
    w = jnp.where(total > 0, w, 1.0)
    cdf = jnp.cumsum(w / jnp.sum(w, axis=-1, keepdims=True), axis=-1)
    jitter = (jnp.asarray(ts)[:, :n_out] - near) / (far - near) * s - jnp.arange(n_out)
    u = (jnp.arange(n_out) + jnp.clip(jitter, 0.0, 1.0 - 1e-6)) / n_out * cdf[:, -1:]
    j = jax.vmap(lambda c, uu: jnp.searchsorted(c, uu, side="right"))(cdf, u)
    return np.asarray(jnp.clip(j, 0, s - 1))


@pytest.mark.parametrize("route", ["dense", "budgeted", "redistributed", "warmup"])
def test_pipeline_renders_match_jax(route, snapshot):
    params, (ema, step) = snapshot
    if route == "warmup":            # no update folded: all-occupied bitfield
        step = 0
    o, d = _rays(96, seed=1)
    ts = np.asarray(j_rendering.sample_ts(None, 96, J_RCFG))
    jbits = j_occ.bitfield(j_occ.OccupancyState(jnp.asarray(ema), jnp.int32(step)), J_OCFG)
    tbits = t_occ.bitfield(t_occ.OccupancyState(_t(ema), step), T_OCFG)
    redist = route in ("redistributed", "warmup")
    jpipe = JPipeline(j_field.Field(J_FCFG), J_RCFG, fused_path=False, redistribute=redist)
    tpipe = TPipeline(t_field.Field(T_FCFG), T_RCFG, redistribute=redist)
    kw_j, kw_t = {}, {}
    if route != "dense":
        budget = 96 * 4 if redist else 700
        kw_j = dict(bitfield=jbits, budget=budget)
        kw_t = dict(bitfield=tbits, budget=budget)
    want = jax.jit(lambda p, o_, d_, t_: jpipe(p, o_, d_, t_, **kw_j))(
        jax.tree.map(jnp.asarray, params), *(jnp.asarray(v) for v in (o, d, ts)))
    got = tpipe(bridge.params_to_torch(params, "cpu"), _t(o), _t(d), _t(ts), **kw_t)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), atol=1e-4)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), atol=5e-4)
    np.testing.assert_allclose(got["opacity"].numpy(), np.asarray(want["opacity"]), atol=1e-4)
    assert int(got["n_live"]) == int(want["n_live"])
    assert int(got["overflow"]) == int(want["overflow"])
    assert int(got["points_queried"]) == int(want["points_queried"])
    np.testing.assert_allclose(float(got["live_fraction"]), float(want["live_fraction"]))


# ---- stage 2b v2 in the reference's f32 order ----

# A live mask of 7 strata out of 48 (pdf 1/7 each) whose CDF XLA's blocked
# f32 scan ends at 1 + 2^-23 and torch.cumsum's float64 accumulation at 1,
# and candidates whose column 6 puts sample 6, scaled by the CDF's last
# entry, exactly on the edge 1/7 as JAX computes it, so the two CDFs send it
# to strata 7 and 6 (found by a search over masks of 3, 7 and 11 live
# strata).
EDGE_LIVE = (6, 7, 8, 13, 21, 26, 39)
EDGE_TS6 = 2.5714285373687744


def _jax_v2(ts, live, n_out):
    pipe = JPipeline(j_field.Field(J_FCFG), j_rendering.RenderConfig(n_samples=ts.shape[1]))
    return pipe.redistribute(jnp.asarray(ts), jnp.asarray(live), n_out=n_out)


def _jax_strata(ts, live, n_out, near, far):
    """The stratum index and CDF of JAX's `redistribute`, step by step."""
    s = ts.shape[1]
    w = jnp.asarray(live, jnp.float32)
    total = jnp.sum(w, axis=-1, keepdims=True)
    w = jnp.where(total > 0, w, 1.0)
    cdf = jnp.cumsum(w / jnp.sum(w, axis=-1, keepdims=True), axis=-1)
    jitter = (jnp.asarray(ts)[:, :n_out] - near) / (far - near) * s - jnp.arange(n_out)
    u = (jnp.arange(n_out) + jnp.clip(jitter, 0.0, 1.0 - 1e-6)) / n_out * cdf[:, -1:]
    j = jax.vmap(lambda c, uu: jnp.searchsorted(c, uu, side="right"))(cdf, u)
    return np.asarray(jnp.clip(j, 0, s - 1)), np.asarray(cdf)


def test_v2_sample_on_a_cdf_edge_takes_jaxs_stratum():
    s = 48
    near, far = T_RCFG.near, T_RCFG.far
    live = np.zeros((1, s), bool)
    live[0, list(EDGE_LIVE)] = True
    ts = (near + (np.arange(s) + 0.5) / s * (far - near)).astype(np.float32)[None]
    ts[0, 6] = np.float32(EDGE_TS6)
    want_j, want_cdf = _jax_strata(ts, live, s, near, far)
    pdf, cdf = live_cdf(_t(live))
    # the input is what it claims: torch.cumsum ends this CDF otherwise
    assert torch.cumsum(pdf, -1)[0, -1] != float(want_cdf[0, -1])
    np.testing.assert_array_equal(cdf.numpy(), want_cdf)
    j = inverse_cdf_strata(_t(ts), _t(live), s, near, far)[0].numpy()
    assert want_j[0, 6] == 7
    np.testing.assert_array_equal(j, want_j)
    jt, jd = _jax_v2(ts, live, s)
    pipe = TPipeline(t_field.Field(T_FCFG), t_rendering.RenderConfig(n_samples=s))
    tt, td = pipe.redistribute(_t(ts), _t(live))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("s", [12, 24, 48])
def test_v2_cdf_and_placement_are_jaxs_bit_for_bit(s):
    """Random masks (live shares 0.05-0.6, four rays dead): the CDF equals
    `jnp.cumsum`'s and the stratum index, placed ts and deltas equal JAX's,
    bit for bit."""
    rng = np.random.default_rng(s)
    near, far = T_RCFG.near, T_RCFG.far
    b = 256
    ts = (near + (np.arange(s) + rng.uniform(0, 1, (b, s))) / s * (far - near)).astype(np.float32)
    live = rng.uniform(size=(b, s)) < rng.uniform(0.05, 0.6, (b, 1))
    live[:4] = False
    pipe = TPipeline(t_field.Field(T_FCFG), t_rendering.RenderConfig(n_samples=s))
    for n_out in (s, s // 4):
        want_j, want_cdf = _jax_strata(ts, live, n_out, near, far)
        np.testing.assert_array_equal(live_cdf(_t(live))[1].numpy(), want_cdf)
        j = inverse_cdf_strata(_t(ts), _t(live), n_out, near, far)[0].numpy()
        np.testing.assert_array_equal(j, want_j)
        jt, jd = _jax_v2(ts, live, n_out)
        tt, td = pipe.redistribute(_t(ts), _t(live), n_out=n_out)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
