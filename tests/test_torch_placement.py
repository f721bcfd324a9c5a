"""Sessions across devices in the port, on the CPU: `DevicePlacement`
against the JAX package's on the same operation sequences, the cohort key's
device axis, the per-device residency cap, the multi-device quantum's bytes
against the placement-free service, a device move, fault isolation per
slot, render groups per device and `session_devices`.

The small field of tests/test_serve3d_mesh.py (L=2, T=2^10/2^8, hidden 16),
12x12 views, 64 rays x 8 samples.  The CPU has no second device, so the
multi-device cases place their slots over an explicit list of CPU slots
(``["cpu"] * n``): every slot is a real `torch.device`, the scheduler's
slot threads run, and the bytes must equal the placement-free run's.
"""
import sys

import numpy as np
import pytest
import torch

from repro.serve3d.placement import DevicePlacement as JDevicePlacement
from repro_torch.core import occupancy
from repro_torch.core.field import FieldConfig
from repro_torch.core.rendering import RenderConfig
from repro_torch.core.trainer import TrainerConfig
from repro_torch.data.synthetic_scene import build_dataset
from repro_torch.launch.mesh import session_devices
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adamw import tree_paths
from repro_torch.serve3d import (
    DONE, DevicePlacement, ReconstructionService, RenderResult, SceneSession,
)
from repro_torch.testing import faults

RCFG = RenderConfig(n_samples=8)
FIELD_CFG = FieldConfig(n_levels=2, max_resolution=32, log2_table_density=10,
                        log2_table_color=8, hidden=16)
OCFG = occupancy.OccupancyConfig(resolution=16, update_interval=4, warmup_steps=2)
TRAIN_CFG = TrainerConfig(n_rays=64, render=RCFG, occ=OCFG, eval_chunk=144)
ITERS, SLICE = 16, 8


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
def datasets():
    return [build_dataset(seed, n_views=2, h=12, w=12, cfg=RCFG, gt_samples=24,
                          device="cpu")[1] for seed in range(4)]


def _bits(tree) -> list[bytes]:
    return [np.asarray(t).tobytes() for _, t in tree_paths(tree)]


def _run(datasets, n_scenes=2, **kw):
    """A service of `n_scenes` scenes (seed k on dataset k), run to the end."""
    svc = ReconstructionService(slice_iters=SLICE, device="cpu", **kw)
    sids = [svc.submit_scene(datasets[k], FIELD_CFG, TRAIN_CFG, target_iters=ITERS, seed=k)
            for k in range(n_scenes)]
    return svc, sids, svc.run()


def _same_final_bytes(a, b, sids_a, sids_b) -> bool:
    for x, y in zip(sids_a, sids_b):
        sa, sb = a.store.latest(x), b.store.latest(y)
        if _bits(sa.params) != _bits(sb.params) or sa.step != sb.step:
            return False
        if not torch.equal(sa.occ[0], sb.occ[0]) or sa.occ[1] != sb.occ[1]:
            return False
    return True


# ---- the placement policy against the JAX package's (bookkeeping only) ----

def _apply(p, op):
    """One operation -> its result, or the exception type it raised."""
    name, *args = op
    try:
        return getattr(p, name)(*args)
    except (KeyError, ValueError) as e:
        return type(e)


@pytest.mark.parametrize("seed", range(6))
def test_placement_policy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5))
    labels = [f"d{i}" for i in range(n)]
    if seed % 2:
        labels[-1] = labels[0]               # duplicates are allowed
    ours, theirs = DevicePlacement(list(labels)), JDevicePlacement(list(labels))
    ids = [f"s{i}" for i in range(7)]
    for _ in range(60):
        kind = rng.choice(["assign", "assign", "move", "move_to", "release"])
        sid = str(rng.choice(ids))
        op = {"assign": ("assign", sid), "move": ("move", sid),
              "move_to": ("move", sid, int(rng.integers(-1, n + 1))),
              "release": ("release", sid)}[kind]
        assert _apply(ours, op) == _apply(theirs, op), op
        assert ours.loads() == theirs.loads(), op
        assert ours.stats() == theirs.stats(), op
        assert ours.slot(sid) == theirs.slot(sid) and ours.device(sid) == theirs.device(sid)
    assert ours.n == theirs.n == n


def test_placement_least_loaded_sticky_release_and_move():
    p = DevicePlacement(["d0", "d1", "d2", "d3"])
    assert [p.assign(f"s{i}") for i in range(6)] == [0, 1, 2, 3, 0, 1]
    assert p.assign("s0") == 0 and p.loads() == [2, 2, 1, 1]
    assert p.device("s2") == "d2" and p.device_for_slot(3) == "d3"
    assert p.device("unplaced") is None and p.slot("unplaced") is None
    p.release("s0")
    p.release("s0")                          # idempotent
    assert p.loads() == [1, 2, 1, 1] and p.slot("s0") == 0
    assert p.move("s1") == 0                 # least-loaded other slot, lowest first
    assert p.loads() == [2, 1, 1, 1]
    assert p.move("s1", 2) == 2 and p.loads() == [1, 1, 2, 1]
    with pytest.raises(KeyError):
        p.move("nope")
    with pytest.raises(ValueError):
        p.move("s1", 4)
    with pytest.raises(ValueError):
        DevicePlacement([])


# ---- session_devices: the card count, loudly ----

def test_session_devices_raise_past_the_card_count():
    count = torch.cuda.device_count()
    assert session_devices() == [torch.device("cuda", i) for i in range(count)]
    with pytest.raises(ValueError, match="devices but only"):
        session_devices(count + 1)
    with pytest.raises(ValueError, match="at least one"):
        session_devices(0)
    with pytest.raises(ValueError):
        ReconstructionService(device="cpu", devices=count + 1)
    if count == 0:
        with pytest.raises(ValueError):
            DevicePlacement()                # no card, no placement
    else:
        assert DevicePlacement().n == count


# ---- sessions and the scheduler ----

def test_cohort_key_device_axis(datasets):
    a = SceneSession("a", datasets[0], FIELD_CFG, TRAIN_CFG, ITERS, seed=0, device="cpu")
    b = SceneSession("b", datasets[1], FIELD_CFG, TRAIN_CFG, ITERS, seed=1, device="cpu")
    assert a.cohort_key() == b.cohort_key()
    a.place("cpu", 0)
    b.place("cpu", 1)
    assert a.cohort_key() != b.cohort_key()  # split across slots
    b.place("cpu", 0)
    assert a.cohort_key() == b.cohort_key()  # co-located: batch again
    a.start()
    with pytest.raises(AssertionError, match="suspend before"):
        a.place("cpu", 1)


def test_per_device_residency_cap(datasets):
    svc = ReconstructionService(slice_iters=4, device="cpu", devices=["cpu", "cpu"],
                                max_resident=1)
    for k in range(4):
        svc.submit_scene(datasets[k], FIELD_CFG, TRAIN_CFG, target_iters=8, seed=k)
    high = {"all": 0, 0: 0, 1: 0}

    def hook(service, _ev):
        sched = service.scheduler
        high["all"] = max(high["all"], sched._resident_count())
        for slot in (0, 1):
            high[slot] = max(high[slot], sched._resident_count(slot))

    tel = svc.run(hook=hook)
    assert tel["scenes_done"] == 4
    assert high == {"all": 2, 0: 1, 1: 1}
    assert tel["placement"]["placed"] == {"scene-000": 0, "scene-001": 1,
                                          "scene-002": 0, "scene-003": 1}
    assert tel["placement"]["loads"] == [0, 0]


def test_one_slot_bit_identical_to_placement_free(datasets):
    free, free_ids, _ = _run(datasets, max_cohort=4)
    one, one_ids, tel = _run(datasets, max_cohort=4, devices=["cpu"])
    assert tel["devices"] == 1 and tel["placement"]["placed"] == {s: 0 for s in one_ids}
    assert _same_final_bytes(free, one, free_ids, one_ids)
    pose = datasets[0].poses[0]
    ra, rb = free.request_render(free_ids[0], pose), one.request_render(one_ids[0], pose)
    (a,), (b,) = free.renderer.drain(), one.renderer.drain()
    assert a.request_id == ra and b.request_id == rb
    assert np.array_equal(a.rgb, b.rgb) and np.array_equal(a.depth, b.depth)


def test_four_cpu_slots_bit_identical_to_placement_free(datasets):
    """Four slot threads (more than this test's one torch thread) switched
    every 10 us, the async serving thread beside them: the bytes, the
    placement and every answer hold."""
    free, free_ids, _ = _run(datasets, n_scenes=4, max_cohort=4)
    was = obs_trace.enabled()
    obs_trace.set_enabled(True)
    obs_trace.clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        svc = ReconstructionService(slice_iters=SLICE, device="cpu", devices=["cpu"] * 4,
                                    max_cohort=4, async_serving=True)
        sids = [svc.submit_scene(datasets[k], FIELD_CFG, TRAIN_CFG, target_iters=ITERS,
                                 seed=k) for k in range(4)]
        for sid in sids:
            svc.request_render(sid, datasets[0].poses[0])
        got = []
        tel = svc.run(hook=lambda _s, ev: got.extend(ev["results"]))
        slices = [e for e in obs_trace.events() if e.name == "serve3d/slice"]
    finally:
        sys.setswitchinterval(interval)
        obs_trace.set_enabled(was)
        obs_trace.clear()
    assert tel["scenes_done"] == 4 and tel["devices"] == 4
    assert set(tel["placement"]["placed"].values()) == {0, 1, 2, 3}
    assert tel["placement"]["loads"] == [0, 0, 0, 0]
    assert len(got) == 4 and all(isinstance(r, RenderResult) for r in got)
    assert _same_final_bytes(free, svc, free_ids, sids)
    # every slot's slices ran on a slot thread, and none outlived `run`
    assert {e.thread_name.rsplit("_", 1)[0] for e in slices} == {"serve3d-dev"}
    assert svc.scheduler._pool is None


def test_device_move_is_bit_identical(datasets):
    p = DevicePlacement(["cpu", "cpu"])
    slot = p.assign("m")
    moved = SceneSession("m", datasets[0], FIELD_CFG, TRAIN_CFG, ITERS, seed=0, device="cpu")
    moved.place(p.device_for_slot(slot), slot)
    moved.start()
    moved.run_slice(SLICE)
    moved.suspend()
    new = p.move("m")
    assert new == 1 and p.loads() == [0, 1]
    moved.place(p.device_for_slot(new), new)
    moved.resume()
    moved.run_slice(SLICE)
    ref = SceneSession("r", datasets[0], FIELD_CFG, TRAIN_CFG, ITERS, seed=0, device="cpu")
    ref.start()
    ref.run_slice(SLICE)
    ref.run_slice(SLICE)
    assert moved.status == ref.status == DONE and moved.device_slot == 1
    assert _bits(moved.state.params) == _bits(ref.state.params)
    assert _bits(moved.state.opt_state.m) == _bits(ref.state.opt_state.m)
    assert _bits(moved.state.opt_state.v) == _bits(ref.state.opt_state.v)
    assert torch.equal(moved.state.occ_state.density_ema, ref.state.occ_state.density_ema)


def test_fault_rolls_back_only_its_slot(datasets):
    clean, clean_ids, _ = _run(datasets, devices=["cpu", "cpu"])
    faults.configure(enabled=True)
    faults.inject("serve3d.slice", "exception", session="scene-000", at_step=SLICE)
    try:
        svc = ReconstructionService(slice_iters=SLICE, device="cpu", devices=["cpu", "cpu"])
        sids = [svc.submit_scene(datasets[k], FIELD_CFG, TRAIN_CFG, target_iters=ITERS,
                                 seed=k) for k in range(2)]
        verdicts = []
        tel = svc.run(hook=lambda _s, ev: verdicts.append(ev["guard"]))
        fired = faults.fired_count("exception")
    finally:
        faults.reset()
        faults.configure(enabled=False)
    assert fired == 1 and tel["scenes_done"] == 2
    assert tel["placement"]["placed"] == {"scene-000": 0, "scene-001": 1}
    # the quantum that faulted trained both slots; only scene-000 rolled back
    (faulted,) = [v for v in verdicts if "rolled_back" in v.values()]
    assert faulted == {"scene-000": "rolled_back", "scene-001": "ok"}
    assert [e["event"] for e in svc.guard.session_events("scene-000")] == ["rollback"]
    assert svc.guard.session_events("scene-001") == [] and tel["guard"]["rollbacks"] == 1
    # the rollback is bit-exact and the other slot never noticed
    assert _same_final_bytes(clean, svc, clean_ids, sids)


def test_render_groups_keyed_per_device(datasets):
    """Groups are keyed by the device the placement holds their sessions
    on, as in the reference: two slots on one device share its groups, two
    devices never do ("cpu" and "cpu:0" are two devices to the key and one
    memory to the tensors), and a move re-routes at the next drain."""
    services = {}
    for devices in (None, ["cpu", "cpu"], ["cpu", "cpu:0"]):
        svc, sids, _ = _run(datasets, devices=devices)
        was = obs_trace.enabled()
        obs_trace.set_enabled(True)
        obs_trace.clear()
        try:
            rids = [svc.request_render(sid, datasets[0].poses[1]) for sid in sids]
            out = {r.request_id: r for r in svc.renderer.drain()}
            groups = [e.args for e in obs_trace.events() if e.name == "serve3d/render_group"]
        finally:
            obs_trace.set_enabled(was)
            obs_trace.clear()
        services[None if devices is None else tuple(devices)] = (
            [out[r] for r in rids], sorted((g["device"], tuple(g["sessions"])) for g in groups),
            svc)
    both = ("scene-000", "scene-001")
    assert services[None][1] == [("cpu", both)]
    assert services[("cpu", "cpu")][1] == [("cpu", both)]
    assert services[("cpu", "cpu:0")][1] == [("cpu", ("scene-000",)), ("cpu:0", ("scene-001",))]
    for key in (("cpu", "cpu"), ("cpu", "cpu:0")):
        for a, b in zip(services[None][0], services[key][0]):
            assert np.array_equal(a.rgb, b.rgb) and np.array_equal(a.depth, b.depth)
    # each group on its sessions' device; a move re-routes at the next drain
    svc = services[("cpu", "cpu:0")][2]
    assert svc.renderer._placed("scene-001") == torch.device("cpu:0")
    svc.placement.move("scene-001", 0)
    assert svc.renderer._placed("scene-001") == torch.device("cpu")


# ---- the entry points' --devices ----

@pytest.mark.parametrize("entry", ["launch", "example"])
def test_entry_points_place_over_device_lists(entry, capsys):
    from repro_torch.examples import reconstruct_service
    from repro_torch.launch import serve3d as launch
    argv = ["--device", "cpu", "--scenes", "3", "--iters", "8", "--slice", "4", "--hw", "8",
            "--devices", "cpu,cpu"]
    if entry == "launch":
        tel = launch.main(argv + ["--views", "2", "--gt-samples", "16", "--rays", "32",
                                  "--samples", "8", "--renders-per-scene", "1"])
    else:
        tel = reconstruct_service.main(argv)["telemetry"]
    assert tel["devices"] == 2 and tel["scenes_done"] == 3
    assert tel["placement"] == {"devices": ["cpu", "cpu"], "loads": [0, 0],
                                "placed": {"scene-000": 0, "scene-001": 1, "scene-002": 0}}
    assert "placement loads [0, 0]" in capsys.readouterr().out
    assert launch.devices_arg("2") == 2
    assert launch.devices_arg("cuda:0, cuda:0") == ["cuda:0", "cuda:0"]


# ---- chip_smoke.py's phase 8, rehearsed ----

def test_chip_smoke_placement_phase_rehearsal():
    """Phase 8 at a tiny size on the CPU, two CPU slots in place of two
    slots of the card: the three service runs and their gate (no launches
    counted on the CPU, no PSNR floor at this size), the device move, the
    move across devices ("cpu" to "cpu:0" in place of the CPU to the card),
    the field-option runs and their gate."""
    import dataclasses
    from repro_torch import smoke
    tcfg = dataclasses.replace(TRAIN_CFG, budget_headroom=0.7, min_budget=64,
                               occ=occupancy.OccupancyConfig(resolution=16, warmup_steps=8,
                                                             update_interval=4))
    data = dict(n_views=4, h=16, w=16, gt_samples=48)
    datasets = smoke.service_datasets("cpu", data)
    runs = smoke.placement_runs(
        "cpu", datasets, slots=("cpu", "cpu"), one_slot=["cpu"],
        plan=((dataclasses.replace(FIELD_CFG, decomposed=False), 20),) + ((FIELD_CFG, 16),) * 3,
        cfg=tcfg, slice_iters=4, render_steps=(8, 12), held_out=1)
    assert smoke.check_placement(runs, must_launch=(), min_psnr=-np.inf) == []
    two = runs["two_slots"]
    assert smoke.slice_overlap(two["slice_spans"])["threads"] == ["serve3d-dev_0",
                                                                  "serve3d-dev_1"]
    assert smoke.groups_on_their_devices(two)
    # the gate refuses a session whose bytes differ from the placement-free run
    two["service"].sessions["scene-002"].state.params["density_mlp"]["b1"][0] += 1.0
    assert any("scene-002" in p for p in smoke.check_placement(
        runs, must_launch=(), min_psnr=-np.inf))
    move = smoke.device_move("cpu", datasets, FIELD_CFG, tcfg, iters=16, move_at=8,
                             slots=("cpu", "cpu"), held_out=1)
    assert move["from_slot"] == 0 and move["to_slot"] == 1
    assert all(move[k] for k in ("params", "adam_m", "adam_v", "occupancy_ema", "steps"))
    # the move across devices: "cpu:0" is another device to the placement
    cross = smoke.cross_device_move(datasets[1], FIELD_CFG, tcfg, iters=16, move_at=8,
                                    slots=("cpu", "cpu:0"))
    assert smoke.cross_move_holds(cross) and cross["render_on"] == ["cpu:0"]
    opts = smoke.option_runs("cpu", iters=24, field_cfg=FIELD_CFG, cfg=tcfg, dataset=data,
                             held_out=1)
    assert smoke.check_options(opts, ((), tuple(smoke.KERNELS)), min_psnr=-np.inf) == []
