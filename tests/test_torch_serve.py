"""Port RenderService against the JAX package's, on the CPU.

A JAX `RenderService` and the port's serve one bridged snapshot (JAX field
params with widened grids, and the JAX occupancy EMA) on the dense and the
redistributed route, at levels 0 and 1; whole images must agree within
1e-4 on rgb and 5e-4 on depth (depth lies in [2, 6]).  The rest holds the
port's serving ladder (waiting, deadlines, retry, shedding, staleness,
levels, telemetry) to the reference's contract, and rehearses the served
main path of chip_smoke.py at a tiny size, its ray-ordered parity points,
its training phases (Instant-3D, the split route, the Instant-NGP
baseline) and its reconstruction-service phase.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import field as j_field
from repro.core import occupancy as j_occ
from repro.core import rendering as j_rendering
from repro.serve3d.render import RenderService as JService
from repro.serve3d.snapshot import SnapshotStore as JStore
from repro_torch import bridge, smoke
from repro_torch.core import field as t_field
from repro_torch.core import occupancy as t_occ
from repro_torch.core import rendering as t_rendering
from repro_torch.core import trainer as t_trainer
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace
from repro_torch.serve3d import RenderError, RenderResult, RenderService, SnapshotStore

GEOM = dict(n_levels=4, max_resolution=64, log2_table_density=12,
            log2_table_color=10, hidden=16)
J_FCFG, T_FCFG = j_field.FieldConfig(**GEOM), t_field.FieldConfig(**GEOM)
J_RCFG = j_rendering.RenderConfig(n_samples=16)
T_RCFG = t_rendering.RenderConfig(n_samples=16)
J_OCFG = j_occ.OccupancyConfig(resolution=16)
T_OCFG = t_occ.OccupancyConfig(resolution=16)
HW, FOCAL, CHUNK, SPR = 12, 14.0, 64, 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def snapshot():
    """(numpy params, numpy occupancy pair) made by the JAX package: grids
    U(-1, 1) and a lowered density bias, so the bitfield splits the cells."""
    field = j_field.Field(J_FCFG)
    params = jax.tree.map(np.asarray, field.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for k in ("density_grid", "color_grid"):
        params[k] = rng.uniform(-1, 1, size=params[k].shape).astype(np.float32)
    params["density_mlp"]["b2"] = params["density_mlp"]["b2"].copy()
    params["density_mlp"]["b2"][0] = -3.0
    state = jax.jit(lambda p, k: j_occ.update(field, p, j_occ.init_state(J_OCFG),
                                              J_OCFG, k))(
        jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(1))
    occ = (np.asarray(state.density_ema), int(state.step))
    live = (occ[0] > J_OCFG.density_threshold).mean()
    assert 0.1 < live < 0.9
    return params, occ


def _register(svc, field_cfg, render_cfg, occ_cfg):
    svc.register_session("dense", field_cfg, render_cfg, HW, HW, FOCAL, eval_chunk=CHUNK)
    svc.register_session("redist", field_cfg, render_cfg, HW, HW, FOCAL,
                         eval_chunk=CHUNK, occ_cfg=occ_cfg, samples_per_ray=SPR)


def _port_service(snapshot, **kw):
    params, occ = snapshot
    store = SnapshotStore()
    for sid in ("dense", "redist"):
        store.publish(sid, bridge.params_to_torch(params, "cpu"), step=8,
                      occ=bridge.occ_to_torch(occ, "cpu"))
    svc = RenderService(store, device="cpu", **kw)
    _register(svc, T_FCFG, T_RCFG, T_OCFG)
    return store, svc


def test_served_images_match_jax(snapshot):
    params, occ = snapshot
    jstore = JStore()
    for sid in ("dense", "redist"):
        jstore.publish(sid, params, step=8, occ=occ)
    jsvc = JService(jstore)
    _register(jsvc, J_FCFG, J_RCFG, J_OCFG)
    _store, tsvc = _port_service(snapshot)

    poses = j_rendering.sphere_poses(2, seed=5)
    for svc in (jsvc, tsvc):
        for sid in ("dense", "redist"):
            svc.submit(sid, poses[0])
            svc.submit(sid, poses[1], level=1)
    want, got = jsvc.drain(), tsvc.drain()
    assert len(want) == len(got) == 4
    for w, g in zip(want, got):
        assert isinstance(g, RenderResult)
        assert (g.request_id, g.session_id, g.level) == (w.request_id, w.session_id, w.level)
        assert (g.snapshot_version, g.snapshot_step) == (w.snapshot_version, w.snapshot_step)
        assert g.rgb.shape == w.rgb.shape and g.depth.shape == w.depth.shape
        np.testing.assert_allclose(g.rgb, w.rgb, atol=1e-4)
        np.testing.assert_allclose(g.depth, w.depth, atol=5e-4)
    assert got[1].rgb.shape == (HW // 2, HW // 2, 3)
    # the two routes really differ: redistribution changed the quadrature
    assert np.abs(got[0].depth - got[2].depth).max() > 1e-3


def test_request_waits_for_a_snapshot():
    store = SnapshotStore()
    svc = RenderService(store, device="cpu")
    _register(svc, T_FCFG, T_RCFG, T_OCFG)
    pose = t_rendering.sphere_poses(1)[0]
    svc.submit("dense", pose)
    assert svc.drain() == [] and svc.pending == 1
    params = t_field.Field(T_FCFG).init(torch.Generator().manual_seed(0), device="cpu")
    store.publish("dense", params, step=1)
    (res,) = svc.drain()
    assert isinstance(res, RenderResult) and res.snapshot_version == 1
    assert svc.pending == 0
    with pytest.raises(KeyError):
        svc.submit("unregistered", pose)
    with pytest.raises(ValueError):
        svc.register_session("x", T_FCFG, T_RCFG, HW, HW, FOCAL, samples_per_ray=4)


def test_deadline_expires_as_a_typed_error():
    svc = RenderService(SnapshotStore(), default_deadline_s=0.0, device="cpu")
    svc.register_session("s0", T_FCFG, T_RCFG, HW, HW, FOCAL)
    rid = svc.submit("s0", np.eye(4))
    (err,) = svc.drain()
    assert isinstance(err, RenderError)
    assert err.request_id == rid and err.error == "deadline_expired"
    assert svc.pending == 0 and svc.expired == 1
    assert svc.latency_stats()["degraded"]["expired"] == 1


def test_group_failure_retries_then_errors(snapshot, monkeypatch):
    _store, svc = _port_service(snapshot)
    real = svc._render_group_inner
    calls = {"n": 0}

    def fail_once(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device fault")
        return real(*a, **k)

    monkeypatch.setattr(svc, "_render_group_inner", fail_once)
    pose = t_rendering.sphere_poses(1)[0]
    svc.submit("dense", pose)
    assert svc.drain() == [] and svc.pending == 1        # attempt 1 failed
    (res,) = svc.drain()
    assert isinstance(res, RenderResult)

    def always_fail(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(svc, "_render_group_inner", always_fail)
    rid = svc.submit("dense", pose)
    assert svc.drain() == []
    (err,) = svc.drain()
    assert isinstance(err, RenderError) and err.error == "render_failed"
    assert err.request_id == rid and svc.failed == 1 and svc.pending == 0


def test_shedding_halves_the_redistributed_budget(snapshot):
    """Past the threshold a drain serves redistributed sessions at half the
    per-ray budget: the pixels equal a session registered at SPR // 2."""
    params, occ = snapshot
    _store, svc = _port_service(snapshot, shed_threshold=1)
    pose = t_rendering.sphere_poses(1, seed=2)[0]
    svc.submit("redist", pose)
    svc.submit("dense", pose)
    shed = {r.session_id: r for r in svc.drain()}
    assert svc.shed_drains == 1

    store = SnapshotStore()
    store.publish("half", bridge.params_to_torch(params, "cpu"), step=8,
                  occ=bridge.occ_to_torch(occ, "cpu"))
    ref = RenderService(store, device="cpu")
    ref.register_session("half", T_FCFG, T_RCFG, HW, HW, FOCAL, eval_chunk=CHUNK,
                         occ_cfg=T_OCFG, samples_per_ray=SPR // 2)
    ref.submit("half", pose)
    (half,) = ref.drain()
    np.testing.assert_array_equal(shed["redist"].rgb, half.rgb)
    assert svc.latency_stats()["degraded"]["shed_fraction"] == 1.0


def test_stale_marks_and_latency_stats(snapshot):
    _store, svc = _port_service(snapshot)
    pose = t_rendering.sphere_poses(1)[0]
    svc.mark_stale("dense")
    svc.submit("dense", pose)
    svc.submit("redist", pose)
    by_sid = {r.session_id: r for r in svc.drain()}
    assert by_sid["dense"].stale and not by_sid["redist"].stale
    svc.mark_stale("dense", False)
    svc.submit("dense", pose)
    (res,) = svc.drain()
    assert not res.stale
    stats = svc.latency_stats()
    assert stats["count"] == 3 and stats["per_session"] == {"dense": 2, "redist": 1}
    assert 0 < stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"] <= stats["max_ms"]
    assert set(stats["ttfuv_s"]) == {"dense", "redist"}


def test_obs_spans_and_metrics_record_a_drain(snapshot):
    """With the knob on, a drain records its spans (service, pipeline
    stages) and the served/latency metrics; off, nothing is recorded."""
    _store, svc = _port_service(snapshot)
    pose = t_rendering.sphere_poses(1)[0]
    t_trace.clear()
    t_metrics.REGISTRY.reset()
    t_trace.set_enabled(True)
    try:
        svc.submit("redist", pose)
        (res,) = svc.drain()
    finally:
        t_trace.set_enabled(False)
    names = {e.name for e in t_trace.events()}
    assert {"serve3d/render_drain", "serve3d/render_group", "pipeline/redistribute",
            "pipeline/compact", "pipeline/shade", "pipeline/composite"} <= names
    snap = t_metrics.snapshot()
    assert snap["serve3d.render.served"]["value"] == 1
    assert snap["serve3d.render.latency_ms"]["count"] == 1
    t_trace.clear()
    svc.submit("dense", pose)
    svc.drain()
    assert t_trace.events() == [] and t_trace.span("x") is t_trace.NULL
    t_metrics.REGISTRY.reset()


def test_snapshot_levels_previews_and_copies(tmp_path):
    store = SnapshotStore()
    params = {"w": torch.ones(3), "mlp": {"b": torch.zeros(2)}}
    s1 = store.publish("s", params, step=4, level=2)
    assert store.latest("s") is s1 and store.latest("s", level=0) is None
    params["w"].add_(1.0)                   # the snapshot is a copy
    assert torch.equal(s1.params["w"], torch.ones(3))
    s2 = store.publish("s", params, step=8, level=0)
    assert (s1.version, s2.version) == (1, 2)
    assert store.latest("s") is s2 and store.levels("s") == [0, 2]
    assert store.gc_previews("s") == 1 and store.levels("s") == [0]
    assert store.sessions() == ["s"] and store.latest("nobody") is None
    # persisted: full snapshots only, one checkpoint step each
    store = SnapshotStore(persist_dir=str(tmp_path))
    store.publish("s", params, step=4, level=2)
    store.publish("s", params, step=8, level=0)
    store.wait()
    assert sorted(p.name for p in (tmp_path / "s").iterdir()) == ["step_00000008"]


def test_preview_request_is_served_from_a_preview(snapshot):
    """A level-1 request takes a preview snapshot; a level-0 one waits for
    the full snapshot."""
    params, _occ = snapshot
    store = SnapshotStore()
    svc = RenderService(store, device="cpu")
    svc.register_session("s", T_FCFG, T_RCFG, HW, HW, FOCAL, eval_chunk=CHUNK)
    store.publish("s", bridge.params_to_torch(params, "cpu"), step=2, level=1)
    pose = t_rendering.sphere_poses(1)[0]
    svc.submit("s", pose)
    svc.submit("s", pose, level=1)
    (res,) = svc.drain()
    assert res.level == 1 and res.rgb.shape == (HW // 2, HW // 2, 3)
    assert svc.pending == 1


def test_chip_smoke_main_path_rehearsal():
    """Phase 3 of chip_smoke.py at a tiny size on the CPU: both routes and a
    preview served, finite, in [0, 1]; the CPU service agrees with itself."""
    store = smoke.make_snapshot_store("cpu", T_FCFG, T_OCFG)
    svc = smoke.make_service(store, "cpu", T_FCFG, T_RCFG, T_OCFG, HW, CHUNK)
    results = smoke.serve_requests(svc, HW, 4)
    assert [r.level for r in results] == [0, 0, 0, 0, 1]
    assert {r.session_id for r in results} == {"redist", "dense"}
    agree = smoke.path_parity(store, "cpu", T_FCFG, T_RCFG, T_OCFG, hw=HW, eval_chunk=CHUNK)
    assert all(v == {"rgb_max_abs_err": 0.0, "depth_max_abs_err": 0.0}
               for v in agree.values())


def test_chip_smoke_training_phases_rehearsal():
    """Phases 3 and 3b of chip_smoke.py at a tiny size on the CPU: the
    Instant-3D and the Instant-NGP runs through their gates (the PSNR gate
    is for the full size; the CPU launches no kernel, so none may be
    counted), two NGP runs byte-identical, and the split route's step
    against the one-op step.  19 steps: the bitfield is live from step 12,
    the live fraction measured at the fold after step 15, so steps 16-18
    are compacted (headroom 0.7 buckets the budget to 512 of 1024)."""
    tcfg = t_trainer.TrainerConfig(
        n_rays=64, iters=19, budget_headroom=0.7, min_budget=64, render=T_RCFG,
        occ=t_occ.OccupancyConfig(resolution=16, warmup_steps=8, update_interval=4))
    data = dict(n_views=4, h=16, w=16, gt_samples=48)
    ngp_cfg = dataclasses.replace(T_FCFG, decomposed=False)
    nothing = ((), tuple(smoke.KERNELS))
    runs = {}
    for name, fcfg in (("i3d", T_FCFG), ("ngp", ngp_cfg)):
        run = smoke.train_main_path("cpu", fcfg, tcfg, dataset=data, held_out=1)
        assert smoke.check_training(run, nothing, min_psnr=-np.inf) == [], name
        assert len(run["compact_ms"]) == 3 and len(run["dense_ms"]) == 16, name
        runs[name] = run
    # the gate refuses a path whose kernels were not all launched
    assert smoke.check_training(runs["ngp"], smoke.NGP_TRAIN_KERNELS, min_psnr=-np.inf)
    det = smoke.determinism("cpu", ngp_cfg, tcfg, steps=(12, 19), dataset=data, held_out=1)
    assert det["params_equal"] and det["moments_equal"] and det["occupancy_equal"]
    assert det["steps"] == [12, 19] and det["compacted_steps"] == 3
    split = smoke.split_route_parity("cpu", runs["i3d"], held_out=1)
    assert split["ok"] and split["budget"] == 512, split


def test_serving_points_rehearsal():
    """chip_smoke.py's ray-ordered parity points at a small size on the CPU:
    the chunk of rays through the view's centre, sampled by stage 1 (S per
    ray, ray-major) or re-spent by stage 2b (SPR per ray), in the unit
    cube."""
    hw, chunk = 32, 128
    dense = smoke.serving_points("cpu", T_RCFG, hw=hw, chunk=chunk)
    redist = smoke.serving_points("cpu", T_RCFG, samples_per_ray=SPR, hw=hw, chunk=chunk)
    assert dense.shape == (chunk * T_RCFG.n_samples, 3)
    assert redist.shape == (chunk * SPR, 3)
    for pts in (dense, redist):
        assert pts.dtype == torch.float32 and pts.is_contiguous()
        assert float(pts.min()) >= 0.0 and float(pts.max()) < 1.0
    # ray-major points of the rays through pixels [first, first + chunk),
    # the chunk that holds the centre pixel, at the stratum midpoints
    first = (hw * hw // 2) // chunk * chunk
    pix = torch.arange(first, first + chunk)
    pose = torch.as_tensor(t_rendering.sphere_poses(1, seed=0)[0], dtype=torch.float32)
    o, d = t_rendering.pixel_rays(pose, pix % hw, pix // hw, hw, hw, smoke.focal_for(hw))
    ts = t_rendering.sample_ts(None, chunk, T_RCFG, device="cpu")
    world = (o[:, None, :] + ts[..., None] * d[:, None, :]).reshape(-1, 3)
    torch.testing.assert_close(dense, t_rendering.normalize_points(world, T_RCFG),
                               rtol=0, atol=1e-6)


def test_chip_smoke_service_phase_rehearsal(tmp_path):
    """Phase 5 of chip_smoke.py at a tiny size on the CPU: the service with
    an Instant-NGP scene (alone) and three Instant-3D scenes (one cohort of
    3) through its gate (no launches counted on the CPU, no PSNR
    floor at this size), then the four bit-identity contracts over 24
    steps: folds at 11, 15, 19 and 23, compacted steps 16-19, suspended to
    disk at 8 and 16, NaN params on the slice starting at 16 rolled back to
    the last-good tree of step 16."""
    tcfg = t_trainer.TrainerConfig(
        n_rays=64, budget_headroom=0.7, min_budget=64, render=T_RCFG,
        occ=t_occ.OccupancyConfig(resolution=16, warmup_steps=8, update_interval=4))
    data = dict(n_views=4, h=16, w=16, gt_samples=48)
    ngp_cfg = dataclasses.replace(T_FCFG, decomposed=False)
    datasets = smoke.service_datasets("cpu", data)
    run = smoke.service_main_path("cpu", datasets, str(tmp_path / "snapshots"), tcfg,
                                  plan=((ngp_cfg, 20),) + ((T_FCFG, 16),) * 3,
                                  slice_iters=4, render_steps=(8, 12), held_out=1)
    assert smoke.check_service(run, must_launch=(), min_psnr=-np.inf) == []
    assert run["expected_renders"] == 12 and sorted(set(run["cohorts"])) == [1, 3]
    assert run["service"].store.wait() is None
    assert sorted(p.name for p in (tmp_path / "snapshots").iterdir()) == \
        [f"scene-{k:03d}" for k in range(4)]
    # the gate refuses kernels that never launched and a PSNR floor not met
    assert smoke.check_service(run, min_psnr=np.inf)
    ident = smoke.service_identity("cpu", datasets, str(tmp_path / "ckpt"), T_FCFG, tcfg,
                                   iters=24, suspend_at=(8, 16), fault_at=16,
                                   slice_iters=4, held_out=1)
    assert ident["folds"] == [11, 15, 19, 23] and ident["compacted_steps"] == 4
    assert ident["guard_rollback"]["events"][0]["to_step"] == 16
    assert smoke.identity_holds(ident), ident
