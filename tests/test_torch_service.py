"""The port's reconstruction service on the CPU: scheduling, snapshots,
serving, previews, the trace and the launcher, and one whole run against
the JAX package's service.

A small field (L=4, T=2^12/2^10, hidden 16), 16x16 views, 64 rays x 8
samples, occupancy R=16 folded every 4 steps after 2.  Mirrors
tests/test_serve3d.py and the single-device cases of
tests/test_serve3d_mesh.py (the compile-cache test is JAX's own).

Against JAX: the same three submissions (two configs, ``max_resident=2``,
``max_cohort=2``), the same fault plan (an exception, NaN params, a NaN
loss) and the same render requests give the same per-quantum (trained,
cohort, step) sequence, the same guard verdicts, the same publish (session,
version, step, level) sequence and the same answered requests in the same
order.  The straggler watchdog reads wall time, so both runs switch it off
(sigma = inf); everything else the scheduler decides from steps, statuses
and verdicts.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import FieldConfig as JFieldConfig, TrainerConfig as JTrainerConfig
from repro.core import occupancy as j_occ
from repro.core.rendering import RenderConfig as JRenderConfig
from repro.data import build_dataset as j_build_dataset
from repro.serve3d import ReconstructionService as JService
from repro.serve3d import RenderResult as JRenderResult
from repro.testing import faults as j_faults
from repro_torch.core import occupancy as t_occ
from repro_torch.core.field import Field, FieldConfig
from repro_torch.core.rendering import RenderConfig
from repro_torch.core.trainer import Instant3DTrainer, TrainerConfig
from repro_torch.data.rays_dataset import RaySampler
from repro_torch.data.synthetic_scene import build_dataset
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adamw import tree_paths
from repro_torch.serve3d import (
    ACTIVE, DONE, PENDING, ReconstructionService, RenderResult, RenderService,
    SceneSession, SessionScheduler, SnapshotStore,
)
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


@pytest.fixture(autouse=True)
def _one_thread_and_clean_faults():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for f in (faults, j_faults):
        f.reset()
        f.configure(enabled=False)
    yield
    for f in (faults, j_faults):
        f.reset()
        f.configure(enabled=False)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def datasets():
    return [build_dataset(seed, cfg=RCFG, device="cpu", **DATA)[1] for seed in range(2)]


def _session(sid, ds, target_iters, **kw):
    return SceneSession(sid, ds, FIELD_CFG, TRAIN_CFG, target_iters=target_iters,
                        device="cpu", **kw)


def _params_equal(a, b) -> bool:
    pa, pb = tree_paths(a), tree_paths(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for (_, x), (_, y) in zip(pa, pb))


# ---- scheduling ----

def test_interleaved_matches_sequential(datasets):
    """Round-robin time-slicing (cohorts off) equals sequential training
    bit for bit at equal per-scene step counts."""
    svc = ReconstructionService(slice_iters=4, max_cohort=1, device="cpu")
    for seed, ds in enumerate(datasets):
        svc.submit_scene(ds, FIELD_CFG, TRAIN_CFG, target_iters=12, seed=seed)
    cohorts = []
    svc.run(hook=lambda _s, ev: cohorts.append(ev["cohort"]))
    assert all(len(c) == 1 for c in cohorts if c)
    for seed, ds in enumerate(datasets):
        tr = Instant3DTrainer(Field(FIELD_CFG), TRAIN_CFG, device="cpu")
        st, _ = tr.train(tr.init(torch.Generator().manual_seed(seed)),
                         RaySampler(ds, device="cpu"), iters=12, log_every=12)
        sess = svc.sessions[f"scene-{seed:03d}"]
        assert sess.status == DONE and sess.step == 12
        assert _params_equal(st.params, sess.state.params), seed


def test_scheduler_round_robin_fair(datasets):
    sched = SessionScheduler(slice_iters=4, policy="round_robin")
    for i in range(3):
        sched.add(_session(f"s{i}", datasets[i % 2], 8))
    assert [sched.step().session_id for _ in range(6)] == ["s0", "s1", "s2"] * 2
    assert sched.all_done and sched.step() is None


def test_scheduler_edf_prefers_urgent(datasets):
    sched = SessionScheduler(slice_iters=4, policy="edf")
    sched.add(_session("slack", datasets[0], 4, deadline=1e6))
    sched.add(_session("urgent", datasets[1], 4, deadline=1.0))
    assert sched.step().session_id == "urgent"
    assert sched.step().session_id == "slack"


def test_scheduler_edf_admission_order(datasets):
    sched = SessionScheduler(slice_iters=4, policy="edf", max_resident=1)
    first = _session("first", datasets[0], 4, deadline=1e6)
    lazy = _session("lazy", datasets[1], 4)
    urgent = _session("urgent", datasets[0], 4, deadline=1.0)
    for s in (first, lazy, urgent):
        sched.add(s)
    assert first.status == ACTIVE                   # residents not preempted
    assert sched.step().session_id == "first"
    assert urgent.status == ACTIVE and lazy.status == PENDING
    assert sched.step().session_id == "urgent"
    assert sched.step().session_id == "lazy"
    assert sched.all_done


def test_scheduler_slot_reset_admission(datasets):
    sched = SessionScheduler(slice_iters=4, policy="round_robin", max_resident=1)
    a, b = _session("a", datasets[0], 8), _session("b", datasets[1], 4)
    sched.add(a)
    sched.add(b)
    assert a.status == ACTIVE and b.status == PENDING
    assert sched.step().session_id == "a"
    assert b.status == PENDING
    assert sched.step().session_id == "a"
    assert a.status == DONE and b.status == ACTIVE   # slot reset -> b admitted
    assert not a.resident                            # device state released
    assert a._current_params() is not None           # but still publishable
    assert sched.step().session_id == "b"
    assert sched.all_done


# ---- snapshots ----

def test_snapshot_store_atomic_publish(datasets):
    store = SnapshotStore()
    sess = _session("s0", datasets[0], 8)
    sess.start()
    snap1 = sess.publish(store)
    assert (snap1.version, snap1.step) == (1, 0)
    sess.run_slice(4)
    snap2 = sess.publish(store)
    assert (snap2.version, snap2.step) == (2, 4)
    assert store.latest("s0") is snap2 and store.latest("missing") is None
    assert store.sessions() == ["s0"]
    assert not _params_equal(snap1.params, snap2.params)
    sess.run_slice(4)
    assert store.latest("s0") is snap2
    assert _params_equal(snap2.params, store.latest("s0").params)


def test_snapshot_persistence_restores_in_both_packages(datasets, tmp_path):
    """A persisted snapshot restores through the port's manager and through
    the reference's, bit for bit, with its version and step."""
    store = SnapshotStore(persist_dir=str(tmp_path))
    sess = _session("sceneX", datasets[0], 4)
    sess.start()
    sess.run_slice(4)
    snap = sess.publish(store)
    store.wait()
    from repro_torch.checkpoint import CheckpointManager
    template = {"params": {k: (v if not isinstance(v, dict) else dict(v))
                           for k, v in snap.params.items()},
                "occ_ema": snap.occ[0], "occ_step": np.int32(0)}
    for manager in (CheckpointManager, JCheckpointManager):
        tree, meta = manager(tmp_path / "sceneX").restore(template)
        assert meta["version"] == 1 and meta["step"] == 4
        assert _params_equal(tree["params"], snap.params)
        np.testing.assert_array_equal(tree["occ_ema"], snap.occ[0].numpy())
        assert int(tree["occ_step"]) == snap.occ[1] > 0


def test_snapshot_levels_versions_and_gc():
    store = SnapshotStore()
    params = {"w": torch.ones(3)}
    s1 = store.publish("s", params, step=4, level=2)
    assert s1.version == 1 and s1.level == 2
    assert store.latest("s").level == 2 and store.latest("s", level=0) is None
    s2 = store.publish("s", params, step=8, level=0)
    assert s2.version == 2
    assert store.latest("s").level == 0 and store.latest("s", level=2).version == 1
    assert store.levels("s") == [0, 2]
    assert store.gc_previews("s") == 1 and store.levels("s") == [0]
    assert store.latest("s").version == 2
    assert store.gc_previews("s") == 0 and store.gc_previews("ghost") == 0


# ---- serving ----

def test_batched_render_matches_render_image(datasets):
    svc = ReconstructionService(slice_iters=4, redistributed_render=False, device="cpu")
    sids = [svc.submit_scene(ds, FIELD_CFG, TRAIN_CFG, target_iters=8, seed=i)
            for i, ds in enumerate(datasets)]
    svc.run()
    for sid, ds in zip(sids, datasets):
        svc.request_render(sid, ds.poses[1])
    results = svc.renderer.drain()
    assert [r.session_id for r in results] == sids and svc.renderer.pending == 0
    for r, ds in zip(results, datasets):
        sess = svc.sessions[r.session_id]
        rgb, dep = sess.trainer.render_image(sess.state.params, ds.poses[1], ds)
        np.testing.assert_array_equal(r.rgb, rgb)
        np.testing.assert_array_equal(r.depth, dep)
        assert r.snapshot_step == 8


def test_render_waits_for_first_snapshot(datasets):
    store = SnapshotStore()
    rs = RenderService(store, device="cpu")
    rs.register_session("s0", FIELD_CFG, RCFG, 16, 16, datasets[0].focal, eval_chunk=256)
    rs.submit("s0", datasets[0].poses[0])
    assert rs.drain() == [] and rs.pending == 1
    sess = _session("s0", datasets[0], 4)
    sess.start()
    sess.publish(store)
    results = rs.drain()
    assert len(results) == 1 and rs.pending == 0 and results[0].snapshot_version == 1
    with pytest.raises(KeyError):
        rs.submit("unregistered", datasets[0].poses[0])


def test_eval_matches_served_bitwise(datasets):
    """`evaluate`'s renderer and the served path march the same
    redistributed quadrature on the same snapshot: equal bytes."""
    svc = ReconstructionService(slice_iters=8, device="cpu")
    ds = datasets[0]
    sid = svc.submit_scene(ds, FIELD_CFG, TRAIN_CFG, target_iters=16, seed=0)
    svc.run()
    rid = svc.request_render(sid, ds.poses[0])
    served = {r.request_id: r for r in svc.renderer.drain()}[rid]
    sess, snap = svc.sessions[sid], svc.store.latest(sid)
    assert sess.render_spr == 4 and snap.occ[1] > 0
    rgb, dep = sess.trainer.render_image(snap.params, ds.poses[0], ds, occ=snap.occ,
                                         samples_per_ray=sess.render_spr)
    assert np.array_equal(rgb, served.rgb) and np.array_equal(dep, served.depth)
    live_rgb, _ = sess.trainer.render_image(sess.state.params, ds.poses[0], ds,
                                            occ=sess._current_occ(),
                                            samples_per_ray=sess.render_spr)
    assert np.array_equal(live_rgb, served.rgb)
    assert np.isfinite(sess.evaluate(views=[0])["psnr_rgb"])


def test_preview_serving_resolution_and_gc(datasets):
    svc = ReconstructionService(slice_iters=4, snapshot_every=4, snapshot_levels=2,
                                device="cpu")
    ds = datasets[0]
    sid = svc.submit_scene(ds, FIELD_CFG, TRAIN_CFG, target_iters=16, seed=0)
    svc.request_render(sid, ds.poses[0], level=2)
    svc.request_render(sid, ds.poses[0], level=0)
    got, first = [], []

    def hook(_s, ev):
        got.extend(ev["results"])
        if not first and ev["results"]:
            first.extend(r.level for r in ev["results"])

    svc.run(hook=hook)
    by_level = {r.level: r for r in got}
    assert set(by_level) == {0, 2}
    assert by_level[2].rgb.shape == (ds.h >> 2, ds.w >> 2, 3)
    assert by_level[0].rgb.shape == (ds.h, ds.w, 3)
    assert first == [2]
    assert by_level[2].snapshot_step < by_level[0].snapshot_step
    assert svc.store.levels(sid) == [0]


def test_unported_options_raise(datasets):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ReconstructionService(device="cpu", devices=2)
    # the async serving plane is ported: the service builds and reports it
    svc = ReconstructionService(device="cpu", async_serving=True)
    assert svc.telemetry()["async_serving"] is True
    assert not svc.renderer.async_active
    with pytest.raises(NotImplementedError, match="not ported yet"):
        SessionScheduler(placement=object())
    # stage 2b v3 serving is ported: a v3 session registers
    rs = RenderService(SnapshotStore(), device="cpu")
    rs.register_session("x", FIELD_CFG, RCFG, 16, 16, 20.0, occ_cfg=TRAIN_CFG.occ,
                        samples_per_ray=4, redistribute_v3=True)
    assert rs._geom["x"].redistribute_v3 and rs._geom["x"].samples_per_ray == 4
    with pytest.raises(NotImplementedError, match="not ported yet"):
        _session("x", datasets[0], 4).place("cuda:1", 1)


def test_entry_points_default_to_the_card():
    import inspect
    from repro_torch.launch import serve3d as launch
    for fn in (ReconstructionService.__init__, SceneSession.__init__, RenderService.__init__,
               Instant3DTrainer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert launch.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        launch.main(["--device", "cpu", "--scenes", "1", "--devices", "2"])


# ---- the trace and the launcher ----

def test_dump_trace_passes_check_trace(datasets, tmp_path):
    was = obs_trace.enabled()
    obs_trace.set_enabled(True)
    obs_trace.clear()
    try:
        svc = ReconstructionService(slice_iters=4, device="cpu")
        sid = svc.submit_scene(datasets[0], FIELD_CFG, TRAIN_CFG, target_iters=8)
        svc.request_render(sid, datasets[0].poses[0])
        svc.run()
        path = svc.dump_trace(str(tmp_path / "trace.json"))
        metrics = svc.metrics()
    finally:
        obs_trace.set_enabled(was)
        obs_trace.clear()
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_trace.py"), path,
         "--require", "serve3d/quantum", "--require", "serve3d/slice",
         "--require", "trainer/step", "--require", "serve3d/render_group",
         "--require", "serve3d/snapshot_publish"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[ok]" in out.stdout
    assert metrics["metrics"]["serve3d.quanta"]["value"] >= 2
    assert metrics["meta"]["service"]["snapshots"] == {sid: 2}


def test_launcher_runs_to_its_end(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve3d", "--device", "cpu",
         "--scenes", "2", "--iters", "24", "--metrics-out", str(tmp_path / "m.json")],
        capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "scene-000: done step 24/24" in out.stdout
    assert "scene-001: done step 24/24" in out.stdout
    assert "guard: rollbacks 0" in out.stdout
    doc = json.loads((tmp_path / "m.json").read_text())
    assert doc["meta"]["service"]["telemetry"]["scenes_done"] == 2


# ---- one whole run against the JAX package's service ----

def _record_publishes(store, log):
    publish = store.publish

    def recorded(session_id, params, step, meta=None, occ=None, level=0):
        snap = publish(session_id, params, step, meta, occ=occ, level=level)
        log.append((snap.session_id, snap.version, snap.step, snap.level))
        return snap

    store.publish = recorded


def _arm(f):
    f.configure(enabled=True)
    f.inject("serve3d.slice", "exception", session="scene-000", at_step=4)
    f.inject("serve3d.slice", "nan_params", session="scene-001", at_step=8)
    f.inject("serve3d.slice", "nan_loss", session="scene-002", at_step=4)


def _drive(svc, pkg_datasets, field_cfg, cfgs, result_type):
    svc.scheduler.straggler_sigma = math.inf
    publishes, quanta, verdicts, answers = [], [], [], []
    _record_publishes(svc.store, publishes)
    for k, (ds, cfg) in enumerate(zip(pkg_datasets, cfgs)):
        svc.submit_scene(ds, field_cfg, cfg, target_iters=12, seed=k)
        svc.request_render(f"scene-{k:03d}", ds.poses[0])

    def hook(s, ev):
        quanta.append((ev["trained"], tuple(ev["cohort"]), ev["step"]))
        verdicts.append(sorted(ev["guard"].items()))
        for sid in ev["cohort"]:
            if s.sessions[sid].step == 8:
                s.request_render(sid, pkg_datasets[int(sid[-3:])].poses[1])
        answers.extend((r.request_id, r.session_id,
                        "ok" if isinstance(r, result_type) else r.error,
                        getattr(r, "snapshot_version", None), getattr(r, "snapshot_step", None))
                       for r in ev["results"])

    tel = svc.run(hook=hook)
    return {"quanta": quanta, "verdicts": verdicts, "publishes": publishes,
            "answers": answers, "done": [p["status"] for p in tel["sessions"]],
            "rollbacks": tel["guard"]["rollbacks"],
            "divergences": tel["guard"]["divergences"]}


def test_service_sequences_match_jax():
    small = dict(cfg=None, **DATA)
    j_cfg = JTrainerConfig(render=JRenderConfig(n_samples=8),
                           occ=j_occ.OccupancyConfig(**OCC), **TRAIN)
    j_other = JTrainerConfig(render=JRenderConfig(n_samples=8),
                             occ=j_occ.OccupancyConfig(**OCC), n_rays=32, eval_chunk=256)
    t_other = TrainerConfig(render=RCFG, occ=t_occ.OccupancyConfig(**OCC), n_rays=32,
                            eval_chunk=256)
    j_ds = [j_build_dataset(k, **dict(small, cfg=j_cfg.render))[1] for k in range(3)]
    t_ds = [build_dataset(k, device="cpu", **dict(small, cfg=RCFG))[1] for k in range(3)]

    _arm(j_faults)
    want = _drive(JService(slice_iters=4, max_resident=2, max_cohort=2), j_ds,
                  JFieldConfig(**GEOM), [j_cfg, j_cfg, j_other], JRenderResult)
    _arm(faults)
    got = _drive(ReconstructionService(slice_iters=4, max_resident=2, max_cohort=2,
                                       device="cpu"),
                 t_ds, FIELD_CFG, [TRAIN_CFG, TRAIN_CFG, t_other], RenderResult)
    assert faults.fired_count() == j_faults.fired_count() == 3
    assert got["quanta"] == want["quanta"]
    assert got["verdicts"] == want["verdicts"]
    assert got["publishes"] == want["publishes"]
    assert got["answers"] == want["answers"]
    assert got["done"] == want["done"] == ["done"] * 3
    assert got["rollbacks"] == want["rollbacks"] >= 3
    assert got["divergences"] == want["divergences"]
    assert any(len(c) == 2 for _, c, _ in got["quanta"])
    assert len(got["answers"]) == 6 and all(a[2] == "ok" for a in got["answers"])
