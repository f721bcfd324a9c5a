"""The port's fault tolerance on the CPU: guard rollback and quarantine,
publish retry and the render degradation ladder.

Mirrors the single-device chaos cases of tests/test_robustness.py at a
small field (L=4, T=2^12/2^10, hidden 16), 16x16 views, 64 rays x 8
samples, occupancy R=16 folded every 4 steps after 2: the service runs
with `repro_torch.testing.faults` armed, every session finishes, and a
recovered session's params equal the fault-free run's byte for byte,
since training streams are keyed by the absolute step.
"""
import functools

import numpy as np
import pytest
import torch

from _hypothesis_shim import given, settings, strategies as st

from repro_torch.core import occupancy as t_occ
from repro_torch.core.field import FieldConfig
from repro_torch.core.rendering import RenderConfig
from repro_torch.core.trainer import TrainerConfig, tree_all_finite
from repro_torch.data.synthetic_scene import build_dataset
from repro_torch.optim.adamw import tree_paths
from repro_torch.serve3d import (
    DONE, QUARANTINED, GuardConfig, ReconstructionService, RenderError, RenderService,
    SnapshotStore,
)
from repro_torch.testing import faults

RCFG = RenderConfig(n_samples=8)
FIELD_CFG = FieldConfig(n_levels=4, max_resolution=64, log2_table_density=12,
                        log2_table_color=10, hidden=16)
OCFG = t_occ.OccupancyConfig(resolution=16, update_interval=4, warmup_steps=2)
TRAIN_CFG = TrainerConfig(n_rays=64, render=RCFG, occ=OCFG, eval_chunk=256)


@functools.lru_cache(maxsize=None)
def _ds(seed: int = 0):
    return build_dataset(seed, n_views=2, h=16, w=16, cfg=RCFG, gt_samples=24,
                         device="cpu")[1]


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


def _params_equal(a, b) -> bool:
    pa, pb = tree_paths(a), tree_paths(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for (_, x), (_, y) in zip(pa, pb))


def _run_service(n_scenes=2, target_iters=16, slice_iters=4, guard=True, **kw):
    svc = ReconstructionService(slice_iters=slice_iters, guard=guard, device="cpu", **kw)
    for seed in range(n_scenes):
        svc.submit_scene(_ds(seed), FIELD_CFG, TRAIN_CFG, target_iters=target_iters,
                         seed=seed)
    return svc, svc.run()


@functools.lru_cache(maxsize=None)
def _clean_params(n_scenes: int, target_iters: int):
    """Final params of the fault-free run, by session id."""
    svc, tel = _run_service(n_scenes=n_scenes, target_iters=target_iters)
    assert tel["guard"]["rollbacks"] == 0
    return {sid: s._current_params() for sid, s in svc.sessions.items()}


# ---- guard: detection, rollback, quarantine ----

def test_nan_params_rollback_bit_identical():
    """NaN params in one cohort member -> rollback; both sessions finish
    with the fault-free run's params, the faulted one included."""
    faults.configure(enabled=True)
    faults.inject("serve3d.slice", "nan_params", session="scene-001", at_step=8)
    svc, tel = _run_service(target_iters=16)
    assert faults.fired_count("nan_params") == 1
    assert tel["guard"]["rollbacks"] >= 1
    assert tel["guard"]["divergences"] == {"non_finite_state": 1}
    assert all(s.status == DONE for s in svc.sessions.values())
    clean = _clean_params(2, 16)
    for sid, s in svc.sessions.items():
        assert _params_equal(s._current_params(), clean[sid]), sid


def test_nan_loss_detected_by_cheap_check():
    faults.configure(enabled=True)
    faults.inject("serve3d.slice", "nan_loss", session="scene-000", at_step=4)
    svc, tel = _run_service(n_scenes=1, target_iters=16)
    assert tel["guard"]["divergences"].get("nan_loss", 0) >= 1
    assert svc.sessions["scene-000"].status == DONE


def test_loss_spike_trips_collapse_heuristic():
    faults.configure(enabled=True)
    faults.inject("serve3d.slice", "loss_spike", session="scene-000", at_step=20,
                  factor=1e8)
    svc, tel = _run_service(n_scenes=1, target_iters=32)
    assert tel["guard"]["divergences"].get("collapse", 0) >= 1
    assert svc.sessions["scene-000"].status == DONE


def test_slice_exception_rolls_back_with_guard():
    faults.configure(enabled=True)
    faults.inject("serve3d.slice", "exception", session="scene-000", at_step=8)
    svc, tel = _run_service(n_scenes=1, target_iters=16)
    assert tel["guard"]["divergences"].get("exception", 0) == 1
    assert svc.sessions["scene-000"].status == DONE


def test_slice_exception_unwinds_without_guard():
    faults.configure(enabled=True)
    faults.inject("serve3d.slice", "exception", session="scene-000", at_step=8)
    with pytest.raises(faults.InjectedFault):
        _run_service(n_scenes=1, target_iters=16, guard=None)


def test_quarantine_after_max_retries_keeps_service_alive():
    faults.configure(enabled=True)
    faults.inject("serve3d.slice", "nan_params", session="scene-000", at_step=8,
                  times=None)
    svc, tel = _run_service(target_iters=16,
                            guard=GuardConfig(checkpoint_every=2, max_retries=2))
    sick, healthy = svc.sessions["scene-000"], svc.sessions["scene-001"]
    assert sick.status == QUARANTINED
    assert healthy.status == DONE and healthy.step == 16
    assert svc.scheduler.all_done
    assert tel["guard"]["quarantined"] == ["scene-000"]
    assert tel["guard"]["rollbacks"] == 2
    snap = svc.store.latest("scene-000")
    assert snap is not None and snap.step <= 8 and tree_all_finite(snap.params)
    svc.request_render("scene-000", _ds(0).poses[0])
    (res,) = svc.renderer.drain()
    assert res.stale and res.snapshot_step == snap.step
    assert _params_equal(healthy._current_params(), _clean_params(2, 16)["scene-001"])


def test_straggler_slice_flagged_not_blocked():
    faults.configure(enabled=True)
    faults.inject("serve3d.slice", "slow", session="scene-000", at_step=8, seconds=1.0)
    svc, tel = _run_service(target_iters=16)
    assert faults.fired_count("slow") == 1
    assert tel["stragglers_flagged"] >= 1
    assert all(s.status == DONE and s.step == 16 for s in svc.sessions.values())


def test_guard_event_log_and_step_verdicts():
    faults.configure(enabled=True)
    faults.inject("serve3d.slice", "nan_params", session="scene-000", at_step=8)
    svc = ReconstructionService(slice_iters=4, device="cpu")
    svc.submit_scene(_ds(0), FIELD_CFG, TRAIN_CFG, target_iters=16)
    verdicts = []
    svc.run(hook=lambda _svc, ev: verdicts.extend(ev["guard"].values()))
    assert verdicts.count("rolled_back") == 1
    events = svc.guard.session_events("scene-000")
    assert events and events[0]["event"] == "rollback"
    assert events[0]["to_step"] < events[0]["from_step"]


def test_guard_persists_last_good_trees(tmp_path):
    """With a checkpoint dir, each last-good tree is written through the
    session's manager, so a fresh process can roll back too."""
    svc = ReconstructionService(slice_iters=4, guard=GuardConfig(checkpoint_every=2),
                                device="cpu")
    svc.submit_scene(_ds(0), FIELD_CFG, TRAIN_CFG, target_iters=16,
                     ckpt_dir=str(tmp_path / "ckpt"))
    svc.run()
    sess = svc.sessions["scene-000"]
    sess.ckpt.wait()
    assert sess.ckpt.all_steps() == [8, 16]
    tree, meta = sess.ckpt.restore(sess.trainer.suspend(sess.state))
    assert meta["step"] == 16 and _params_equal(tree["params"], sess.state.params)


# ---- snapshot publish retry ----

def test_publish_failure_retains_last_good_and_retries():
    faults.configure(enabled=True)
    faults.inject("serve3d.snapshot_publish", "snapshot_fail", session="scene-000",
                  at_step=8)
    svc, _ = _run_service(n_scenes=1, target_iters=16, snapshot_every=1)
    assert faults.fired_count("snapshot_fail") == 1
    assert svc.publish_failures == 1
    snap = svc.store.latest("scene-000")
    assert snap is not None and snap.step == 16 and snap.version == 3
    assert svc.sessions["scene-000"].status == DONE


# ---- the render degradation ladder ----

def test_render_deadline_expires_as_typed_error():
    rs = RenderService(SnapshotStore(), default_deadline_s=0.0, device="cpu")
    rs.register_session("s0", FIELD_CFG, RCFG, 16, 16, 20.0)
    rid = rs.submit("s0", np.eye(4)[:3])
    (err,) = rs.drain()
    assert isinstance(err, RenderError)
    assert err.request_id == rid and err.error == "deadline_expired"
    assert rs.pending == 0 and rs.expired == 1


@pytest.fixture(scope="module")
def trained_service():
    """One finished single-scene service the render-ladder tests share."""
    svc, _ = _run_service(n_scenes=2, target_iters=8)
    return svc


def test_render_group_failure_retries_then_succeeds(trained_service):
    svc = trained_service
    faults.inject("serve3d.render_group", "render_fail", times=1)
    svc.request_render("scene-000", _ds(0).poses[0])
    assert svc.renderer.drain() == []          # attempt 1 fails, re-queued
    (res,) = svc.renderer.drain()
    assert not isinstance(res, RenderError) and res.rgb.shape == (16, 16, 3)


def test_render_group_failure_exhausts_to_typed_error(trained_service):
    svc = trained_service
    failed = svc.renderer.failed
    faults.inject("serve3d.render_group", "render_fail", times=None)
    rid = svc.request_render("scene-000", _ds(0).poses[0])
    svc.renderer.drain()
    (err,) = svc.renderer.drain()
    assert isinstance(err, RenderError)
    assert err.request_id == rid and err.error == "render_failed"
    assert svc.renderer.failed == failed + 1 and svc.renderer.pending == 0


def test_overload_shedding_degrades_before_dropping(trained_service):
    svc = trained_service
    svc.renderer.shed_threshold = 1
    try:
        for sid in ("scene-000", "scene-001"):
            svc.request_render(sid, _ds(0).poses[0])
        results = svc.renderer.drain()
    finally:
        svc.renderer.shed_threshold = None
    assert len(results) == 2 and all(r.rgb.shape == (16, 16, 3) for r in results)
    assert svc.renderer.shed_drains >= 1
    assert svc.renderer.latency_stats()["degraded"]["shed_fraction"] > 0


def test_stale_annotation_round_trip(trained_service):
    svc = trained_service
    svc.renderer.mark_stale("scene-000")
    svc.request_render("scene-000", _ds(0).poses[0])
    (res,) = svc.renderer.drain()
    assert res.stale
    svc.renderer.mark_stale("scene-000", False)
    svc.request_render("scene-000", _ds(0).poses[0])
    (res,) = svc.renderer.drain()
    assert not res.stale


@settings(max_examples=3, deadline=None)
@given(fault_step=st.integers(4, 12),
       kind=st.sampled_from(["nan_params", "inf_params", "exception", "nan_loss"]))
def test_recovery_bit_identity_property(fault_step, kind):
    """Any fault kind at any step: the guarded service ends on the exact
    params of a fault-free run."""
    faults.reset()
    faults.configure(enabled=True)
    faults.inject("serve3d.slice", kind, session="scene-000", at_step=fault_step)
    svc, tel = _run_service(n_scenes=1, target_iters=16)
    faults.reset()
    faults.configure(enabled=False)
    assert tel["guard"]["rollbacks"] >= 1
    assert svc.sessions["scene-000"].status == DONE
    assert _params_equal(svc.sessions["scene-000"]._current_params(),
                         _clean_params(1, 16)["scene-000"])
