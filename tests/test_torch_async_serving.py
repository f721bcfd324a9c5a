"""The port's async serving plane on the CPU, and exact launch counts under
two threads.

A small field (L=4, T=2^12/2^10, hidden 16), 16x16 views, 64 rays x 8
samples, occupancy R=16 folded every 4 steps after 2 (the service tests'
configuration).  What must hold:

* the reference's `test_async_serving_completes_and_matches_sync`
  (tests/test_serve3d_mesh.py): both planes answer the in-flight request,
  post-run renders give the same bytes, and the trained params, moments and
  occupancy are the same bytes in both modes;
* the plane itself: `start_async` / `stop_async` are idempotent, a request
  without a snapshot waits and is answered after `publish` + `notify`,
  `idle` is false while a drain runs, a deadline expires from the thread,
  an injected ``render_fail`` is retried, then answered with a typed error;
* a serving thread that raises makes `ReconstructionService.run` raise;
* an async-served 16x16 view equals JAX's `Instant3DTrainer.render_image`
  of the same params (carried through `repro_torch.bridge`) and occupancy,
  rgb within 1e-4 and depth within 5e-4 (depth lies in [2, 6]);
* `kernels.count_launch` from many threads counts every call, and every
  kernel wrapper counts through it;
* chip_smoke.py's phase 7 (the service sync against async and its gate),
  rehearsed at a tiny size.
"""
import dataclasses
import re
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Field as JField, FieldConfig as JFieldConfig
from repro.core import Instant3DTrainer as JTrainer, TrainerConfig as JTrainerConfig
from repro.core import occupancy as j_occ
from repro.core.rendering import RenderConfig as JRenderConfig
from repro.core.rendering import sphere_poses
from repro_torch import bridge, kernels, smoke
from repro_torch.core import occupancy as t_occ
from repro_torch.core.field import Field, FieldConfig
from repro_torch.core.rendering import RenderConfig
from repro_torch.core.trainer import TrainerConfig
from repro_torch.data.synthetic_scene import build_dataset
from repro_torch.optim.adamw import tree_paths
from repro_torch.serve3d import (DONE, ReconstructionService, RenderError, RenderResult,
                                 RenderService, SnapshotStore)
from repro_torch.testing import faults

ROOT = Path(__file__).resolve().parents[1]
GEOM = dict(n_levels=4, max_resolution=64, log2_table_density=12, log2_table_color=10,
            hidden=16)
OCC = dict(resolution=16, update_interval=4, warmup_steps=2)
TRAIN = dict(n_rays=64, eval_chunk=256)
DATA = dict(n_views=2, h=16, w=16, gt_samples=24)
RCFG = RenderConfig(n_samples=8)
FIELD_CFG = FieldConfig(**GEOM)
TRAIN_CFG = TrainerConfig(render=RCFG, occ=t_occ.OccupancyConfig(**OCC), **TRAIN)
HW, FOCAL, CHUNK, SPR = 16, 18.0, 64, 4
WAIT_S = 30.0   # the most any test waits for the serving thread


@pytest.fixture(autouse=True)
def _one_thread_and_clean_faults():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.reset()
    faults.configure(enabled=False)
    yield
    faults.reset()
    faults.configure(enabled=False)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return build_dataset(0, cfg=RCFG, device="cpu", **DATA)[1]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_paths(a), tree_paths(b)))


def _collect(svc: RenderService, n: int) -> list:
    """Poll the plane until `n` answers came in (or WAIT_S passed)."""
    got, t_end = [], time.monotonic() + WAIT_S
    while len(got) < n and time.monotonic() < t_end:
        got += svc.poll_results()
        time.sleep(0.005)
    return got


# ---- the service, sync against async ----

def test_async_serving_completes_and_matches_sync(ds):
    finals, states = {}, {}
    for async_mode in (False, True):
        svc = ReconstructionService(slice_iters=8, async_serving=async_mode, device="cpu")
        sid = svc.submit_scene(ds, FIELD_CFG, TRAIN_CFG, target_iters=16, seed=0)
        svc.request_render(sid, ds.poses[0])
        got = []
        tel = svc.run(hook=lambda s, ev: got.extend(ev["results"]))
        assert tel["async_serving"] is async_mode
        assert not svc.renderer.async_active and not svc.renderer.async_started
        assert len(got) == 1 and isinstance(got[0], RenderResult)
        assert svc.renderer.pending == 0 and svc.sessions[sid].status == DONE
        # post-run renders use the sync drain on both services
        rid = svc.request_render(sid, ds.poses[1])
        finals[async_mode] = {r.request_id: r for r in svc.renderer.drain()}[rid]
        states[async_mode] = svc.sessions[sid].state
    assert np.array_equal(finals[False].rgb, finals[True].rgb)
    assert np.array_equal(finals[False].depth, finals[True].depth)
    a, b = states[False], states[True]
    assert _same(a.params, b.params)
    assert _same(a.opt_state.m, b.opt_state.m) and _same(a.opt_state.v, b.opt_state.v)
    assert torch.equal(a.occ_state.density_ema, b.occ_state.density_ema)


def test_a_serving_thread_that_raises_makes_run_raise(ds):
    svc = ReconstructionService(slice_iters=8, async_serving=True, device="cpu")
    sid = svc.submit_scene(ds, FIELD_CFG, TRAIN_CFG, target_iters=16, seed=0)
    svc.request_render(sid, ds.poses[0])

    def boom():
        raise RuntimeError("serving thread fault")

    svc.renderer._drain = boom
    with pytest.raises(RuntimeError, match="serving thread fault"):
        svc.run()
    assert not svc.renderer.async_active and not svc.renderer.async_started


# ---- the plane on its own ----

def _render_service(**kw):
    store = SnapshotStore()
    svc = RenderService(store, device="cpu", **kw)
    svc.register_session("s", FIELD_CFG, RCFG, HW, HW, FOCAL, eval_chunk=CHUNK)
    return store, svc


def _params():
    return Field(FIELD_CFG).init(torch.Generator().manual_seed(0), device="cpu")


def test_async_plane_waits_for_a_publish_and_is_idempotent():
    store, svc = _render_service()
    svc.start_async()
    thread = svc._async_thread
    svc.start_async()
    assert svc._async_thread is thread and svc.async_active
    rid = svc.submit("s", sphere_poses(1)[0])
    t_end = time.monotonic() + WAIT_S
    while svc.drains < 2 and time.monotonic() < t_end:   # drained twice: nothing to serve
        time.sleep(0.005)
    assert svc.drains >= 2 and svc.poll_results() == [] and svc.pending == 1
    store.publish("s", _params(), step=3)
    svc.notify()
    (res,) = _collect(svc, 1)
    assert isinstance(res, RenderResult) and res.request_id == rid
    assert (res.snapshot_version, res.snapshot_step) == (1, 3)
    assert res.rgb.shape == (HW, HW, 3) and svc.pending == 0
    svc.stop_async()
    svc.stop_async()
    assert not svc.async_active and not svc.async_started
    # a sync drain of the same snapshot gives the same bytes
    rid = svc.submit("s", sphere_poses(1)[0])
    (again,) = svc.drain()
    assert again.request_id == rid and np.array_equal(again.rgb, res.rgb)


def test_idle_is_false_while_a_drain_runs():
    store, svc = _render_service()
    store.publish("s", _params(), step=1)
    entered, release = threading.Event(), threading.Event()
    inner = svc._render_group_inner

    def held(*a, **k):
        entered.set()
        assert release.wait(WAIT_S)
        return inner(*a, **k)

    svc._render_group_inner = held
    assert svc.idle
    svc.start_async()
    try:
        svc.submit("s", sphere_poses(1)[0])
        assert entered.wait(WAIT_S)
        assert not svc.idle and svc.pending == 0
        release.set()
        t_end = time.monotonic() + WAIT_S
        while svc._draining and time.monotonic() < t_end:
            time.sleep(0.005)
        assert not svc.idle          # finished, not yet delivered
        (res,) = svc.poll_results()
        assert isinstance(res, RenderResult) and svc.idle
    finally:
        release.set()
        svc.stop_async()


def test_deadline_expires_from_the_thread():
    _store, svc = _render_service(default_deadline_s=0.05)
    svc.start_async()
    try:
        rid = svc.submit("s", sphere_poses(1)[0])
        (err,) = _collect(svc, 1)
    finally:
        svc.stop_async()
    assert isinstance(err, RenderError) and err.error == "deadline_expired"
    assert err.request_id == rid and err.latency_s > 0.05 and svc.expired == 1


@pytest.mark.parametrize("failures", [1, 2])
def test_render_fail_is_retried_then_a_typed_error(failures):
    store, svc = _render_service(max_attempts=2)
    store.publish("s", _params(), step=1)
    faults.configure(enabled=True)
    faults.inject("serve3d.render_group", "render_fail", times=failures)
    svc.start_async()
    try:
        rid = svc.submit("s", sphere_poses(1)[0])
        (res,) = _collect(svc, 1)
    finally:
        svc.stop_async()
    assert res.request_id == rid and faults.fired_count("render_fail") == failures
    if failures == 1:
        assert isinstance(res, RenderResult)
        assert svc.failed == 0
    else:
        assert isinstance(res, RenderError) and res.error == "render_failed"
        assert svc.failed == 1


# ---- an async-served view against JAX ----

def test_async_served_view_matches_jax_render_image():
    j_fcfg, j_rcfg = JFieldConfig(**GEOM), JRenderConfig(n_samples=8)
    j_ocfg = j_occ.OccupancyConfig(resolution=16)
    field = JField(j_fcfg)
    params = jax.tree.map(np.asarray, field.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for k in ("density_grid", "color_grid"):
        params[k] = rng.uniform(-1, 1, size=params[k].shape).astype(np.float32)
    params["density_mlp"]["b2"] = params["density_mlp"]["b2"].copy()
    params["density_mlp"]["b2"][0] = -3.0
    state = j_occ.update(field, jax.tree.map(jnp.asarray, params), j_occ.init_state(j_ocfg),
                         j_ocfg, jax.random.PRNGKey(1))
    occ = (np.asarray(state.density_ema), int(state.step))
    trainer = JTrainer(field, JTrainerConfig(render=j_rcfg, occ=j_ocfg, eval_chunk=CHUNK))
    view = type("View", (), {"h": HW, "w": HW, "focal": FOCAL})()
    pose = sphere_poses(1, seed=3)[0]
    want_rgb, want_depth = trainer.render_image(params, pose, view, occ=occ,
                                                samples_per_ray=SPR)

    store = SnapshotStore()
    svc = RenderService(store, device="cpu")
    svc.register_session("s", FIELD_CFG, RCFG, HW, HW, FOCAL, eval_chunk=CHUNK,
                         occ_cfg=t_occ.OccupancyConfig(resolution=16), samples_per_ray=SPR)
    svc.start_async()
    try:
        svc.submit("s", pose)
        store.publish("s", bridge.params_to_torch(params, "cpu"), step=1,
                      occ=bridge.occ_to_torch(occ, "cpu"))
        svc.notify()
        (res,) = _collect(svc, 1)
    finally:
        svc.stop_async()
    assert isinstance(res, RenderResult)
    np.testing.assert_allclose(res.rgb, np.asarray(want_rgb), atol=1e-4)
    np.testing.assert_allclose(res.depth, np.asarray(want_depth), atol=5e-4)


# ---- launch counts under two threads ----

def test_count_launch_is_exact_under_threads():
    """More threads than cores, switching every microsecond: a lost
    read-modify-write would leave a count short."""
    before = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    n, names = 5000, ("composite", "bum_sort") * 8
    start = threading.Barrier(len(names))

    def hammer(name):
        start.wait()
        for _ in range(n):
            kernels.count_launch(name)
            kernels.count_launch("hash_encode")

    threads = [threading.Thread(target=hammer, args=(name,)) for name in names]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
        assert kernels.LAUNCHES["hash_encode"] == len(names) * n
        assert kernels.LAUNCHES["composite"] == kernels.LAUNCHES["bum_sort"] == len(names) // 2 * n
    finally:
        sys.setswitchinterval(interval)
        kernels.reset_launches()
        kernels.LAUNCHES.update(before)
    # every wrapper counts through count_launch, and nothing else writes
    sites = []
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"LAUNCHES\[[^\]]+\]\s*[+-]?=", text) or path.name == "__init__.py", path
        sites += [(path.parent.name, m) for m in re.findall(r"count_launch\(([^)]+)\)", text)
                  if path.name == "kernel.py"]
    assert len(sites) == 9


# ---- chip_smoke.py's phase 7, rehearsed ----

def test_chip_smoke_async_phase_rehearsal(tmp_path):
    """Phase 7's service half at a tiny size on the CPU: the service of
    phase 5 (an Instant-NGP scene alone, three Instant-3D scenes in one
    cohort) run sync, then async; its gate (no launches counted on the
    CPU, no PSNR floor at this size) passes, every async answer is
    replayed, and the summary carries both modes."""
    tcfg = dataclasses.replace(TRAIN_CFG, budget_headroom=0.7, min_budget=64,
                               occ=t_occ.OccupancyConfig(resolution=16, warmup_steps=8,
                                                         update_interval=4))
    datasets = smoke.service_datasets("cpu", dict(n_views=4, h=16, w=16, gt_samples=48))
    modes = smoke.service_modes(
        "cpu", datasets, str(tmp_path), runs=1,
        plan=((dataclasses.replace(FIELD_CFG, decomposed=False), 20),) + ((FIELD_CFG, 16),) * 3,
        cfg=tcfg, slice_iters=4, render_steps=(8, 12), held_out=1)
    assert smoke.check_service_modes(modes, must_launch=(), min_psnr=-np.inf) == []
    assert all(len(r["replayed"]) == 12 and all(r["replayed"]) for r in modes["async"])
    summary = {m: smoke.service_mode_summary(runs) for m, runs in modes.items()}
    assert summary["async"]["render_count"] == [8] == summary["sync"]["render_count"]
    assert summary["sync"]["wall_s"]["median"] > 0
    # the gate refuses a session whose bytes differ between the modes
    sess = modes["async"][0]["service"].sessions["scene-001"]
    sess.state.params["density_mlp"]["b1"][0] += 1.0
    assert any("scene-001" in p for p in smoke.check_service_modes(
        modes, must_launch=(), min_psnr=-np.inf))
