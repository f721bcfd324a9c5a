"""The port's checkpoints and fault harness against the JAX package (CPU).

A small field (L=4, T=2^12/2^10, hidden 16), 16x16 views, 64 rays x 8
samples, occupancy R=16 folded every 4 steps after 2.  What must hold:

* a suspend tree written by either package's `CheckpointManager` restores
  in the other's bit for bit, and both write the same flat keys, shapes
  and dtypes (`tree_to_flat`);
* the reference's robustness cases: per-file checksums, a corrupt step
  falls back to the previous one, the ``checkpoint.write`` faults (corrupt,
  kill mid-write) leave the last committed step valid;
* suspend -> resume (in memory and from disk, in a fresh session) trains on
  bit for bit like an uninterrupted run;
* the fault harness matches, counts and resets as the reference's does.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import tree_to_flat as j_tree_to_flat
from repro.core import Field as JField, FieldConfig as JFieldConfig
from repro.core import Instant3DTrainer as JTrainer, TrainerConfig as JTrainerConfig
from repro.core import occupancy as j_occ
from repro.core.rendering import RenderConfig as JRenderConfig
from repro.data import RaySampler as JRaySampler, build_dataset as j_build_dataset
from repro_torch.checkpoint import CheckpointManager, flat_to_tree, tree_to_flat
from repro_torch.core import occupancy as t_occ
from repro_torch.core.field import Field, FieldConfig
from repro_torch.core.rendering import RenderConfig
from repro_torch.core.trainer import Instant3DTrainer, TrainerConfig, tree_all_finite
from repro_torch.data.rays_dataset import RaySampler
from repro_torch.data.synthetic_scene import build_dataset
from repro_torch.optim.adamw import tree_paths
from repro_torch.serve3d import ACTIVE, DONE, SUSPENDED, SceneSession
from repro_torch.testing import faults

GEOM = dict(n_levels=4, max_resolution=64, log2_table_density=12, log2_table_color=10,
            hidden=16)
OCC = dict(resolution=16, update_interval=4, warmup_steps=2)
TRAIN = dict(n_rays=64, eval_chunk=256)
DATA = dict(n_views=2, h=16, w=16, gt_samples=24)

FIELD_CFG = FieldConfig(**GEOM)
TRAIN_CFG = TrainerConfig(render=RenderConfig(n_samples=8),
                          occ=t_occ.OccupancyConfig(**OCC), **TRAIN)
J_FIELD_CFG = JFieldConfig(**GEOM)
J_TRAIN_CFG = JTrainerConfig(render=JRenderConfig(n_samples=8),
                             occ=j_occ.OccupancyConfig(**OCC), **TRAIN)


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
    return build_dataset(0, cfg=TRAIN_CFG.render, device="cpu", **DATA)[1]


def _flat_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
        for k in a)


def _trained_jax_tree(steps=8):
    _, ds_j = j_build_dataset(0, cfg=J_TRAIN_CFG.render, **DATA)
    tr = JTrainer(JField(J_FIELD_CFG), J_TRAIN_CFG)
    st, _ = tr.train(tr.init(jax.random.PRNGKey(0)), JRaySampler(ds_j), iters=steps,
                     log_every=steps)
    return tr, tr.suspend(st)


def _trained_port(ds, steps=8, seed=0):
    tr = Instant3DTrainer(Field(FIELD_CFG), TRAIN_CFG, device="cpu")
    st = tr.init(torch.Generator().manual_seed(seed))
    st, _ = tr.train(st, RaySampler(ds, device="cpu"), iters=steps, log_every=steps)
    return tr, st


# ---- the suspend tree and its flat keys ----

def test_flat_keys_shapes_and_dtypes_match_jax(ds):
    """Fresh and trained suspend trees of both packages flatten to the same
    keys, shapes and dtypes (the optimizer's NamedTuple as ``opt/.step``,
    ``opt/.m/...``; the overflow window padded to int32)."""
    jtr = JTrainer(JField(J_FIELD_CFG), J_TRAIN_CFG)
    want = j_tree_to_flat(jtr.suspend(jtr.init(jax.random.PRNGKey(0))))
    tr, st = _trained_port(ds, steps=6)
    for tree in (tr.suspend(tr.init()), tr.suspend(st)):
        got = tree_to_flat(tree)
        assert got.keys() == want.keys()
        for k in want:
            assert (got[k].shape, got[k].dtype) == (want[k].shape, want[k].dtype), k
    assert "opt/.m/density_grid" in want and want["overflow_window"].shape == (4,)
    # host copies share no storage with the live state
    tree = tr.suspend(st)
    tree["params"]["density_grid"][...] = 0.0
    assert st.params["density_grid"].abs().max() > 0


def test_jax_checkpoint_restores_in_port_bit_for_bit(ds, tmp_path):
    jtr, jtree = _trained_jax_tree()
    JCheckpointManager(tmp_path, async_save=False).save(8, jtree)
    tr = Instant3DTrainer(Field(FIELD_CFG), TRAIN_CFG, device="cpu")
    tree, meta = CheckpointManager(tmp_path).restore(tr.suspend(tr.init()))
    assert meta["step"] == 8
    assert _flat_equal(tree_to_flat(tree), j_tree_to_flat(jtree))
    state = tr.resume(tree)
    assert state.step == 8 and state.occ_state.step == int(jtree["occ_step"]) > 0
    assert int(state.opt_state.step) == int(jtree["opt"].step)
    assert tr._live_frac == float(jtree["live_frac"])
    assert tr._overflow_window == [int(v) for v in jtree["overflow_window"]]
    for path, t in tree_paths(state.params):
        want = jtree["params"]
        for k in path:
            want = want[k]
        assert np.array_equal(t.numpy(), want), path
    # and suspending the resumed state writes the reference's tree again
    assert _flat_equal(tree_to_flat(tr.suspend(state)), j_tree_to_flat(jtree))


def test_port_checkpoint_restores_in_jax_bit_for_bit(ds, tmp_path):
    tr, st = _trained_port(ds)
    tree = tr.suspend(st)
    CheckpointManager(tmp_path, async_save=False).save(st.step, tree, extra={"who": "port"})
    jtr = JTrainer(JField(J_FIELD_CFG), J_TRAIN_CFG)
    jtree, meta = JCheckpointManager(tmp_path).restore(
        jtr.suspend(jtr.init(jax.random.PRNGKey(0))))
    assert meta["step"] == 8 and meta["who"] == "port"
    assert _flat_equal(j_tree_to_flat(jtree), tree_to_flat(tree))
    jstate = jtr.resume(jtree)
    assert jstate.step == 8 and int(jstate.occ_state.step) == st.occ_state.step
    np.testing.assert_array_equal(np.asarray(jstate.params["density_grid"]),
                                  st.params["density_grid"].numpy())


def test_flat_to_tree_checks_leaves():
    tmpl = {"a": np.zeros(3, np.float32), "b": {"c": np.zeros((2, 2), np.int32)}}
    flat = tree_to_flat({"a": torch.arange(3.0), "b": {"c": np.ones((2, 2), np.int32)}})
    assert set(flat) == {"a", "b/c"}
    tree = flat_to_tree(tmpl, flat)
    np.testing.assert_array_equal(tree["b"]["c"], np.ones((2, 2), np.int32))
    with pytest.raises(KeyError, match="b/c"):
        flat_to_tree(tmpl, {"a": flat["a"]})
    with pytest.raises(ValueError, match="shape mismatch"):
        flat_to_tree(tmpl, {"a": np.zeros(4, np.float32), "b/c": flat["b/c"]})


# ---- checkpoint integrity (mirrors tests/test_robustness.py) ----

def test_checkpoint_meta_carries_per_file_checksums(tmp_path):
    ckpt = CheckpointManager(tmp_path, async_save=False)
    ckpt.save(1, {"w": np.ones(4, np.float32)})
    _tree, meta = ckpt.restore({"w": np.zeros(4, np.float32)})
    assert "files" in meta and set(meta["files"]) == {"arrays.npz"}
    assert meta["sha256"] == meta["files"]["arrays.npz"]


def test_checkpoint_rejects_corruption_falls_back(tmp_path):
    ckpt = CheckpointManager(tmp_path, async_save=False)
    ckpt.save(1, {"w": np.full(8, 1.0, np.float32)})
    ckpt.save(2, {"w": np.full(8, 2.0, np.float32)})
    faults.corrupt_file(tmp_path / "step_00000002" / "arrays.npz")
    assert not ckpt._verify(2)
    tree, meta = ckpt.restore({"w": np.zeros(8, np.float32)})
    assert meta["step"] == 1
    np.testing.assert_array_equal(tree["w"], np.full(8, 1.0, np.float32))


def test_checkpoint_corrupt_injection_detected(tmp_path):
    faults.configure(enabled=True)
    ckpt = CheckpointManager(tmp_path, async_save=False)
    ckpt.save(1, {"w": np.full(8, 1.0, np.float32)})
    faults.inject("checkpoint.write", "corrupt", at_step=2)
    ckpt.save(2, {"w": np.full(8, 2.0, np.float32)})
    assert faults.fired_count("corrupt") == 1
    assert 2 in ckpt.all_steps() and not ckpt._verify(2)
    _tree, meta = ckpt.restore({"w": np.zeros(8, np.float32)})
    assert meta["step"] == 1


def test_checkpoint_kill_mid_write_is_atomic(tmp_path):
    faults.configure(enabled=True)
    ckpt = CheckpointManager(tmp_path, async_save=False)
    ckpt.save(10, {"w": np.full(8, 10.0, np.float32)})
    faults.inject("checkpoint.write", "kill_mid_write", at_step=20)
    with pytest.raises(faults.InjectedFault):
        ckpt.save(20, {"w": np.full(8, 20.0, np.float32)})
    assert (tmp_path / "tmp_step_00000020").exists()   # the torn write is left behind
    assert ckpt.all_steps() == [10]                    # never committed
    _tree, meta = ckpt.restore({"w": np.zeros(8, np.float32)})
    assert meta["step"] == 10
    ckpt.save(20, {"w": np.full(8, 20.0, np.float32)})
    assert ckpt.all_steps() == [10, 20]
    _tree, meta = ckpt.restore({"w": np.zeros(8, np.float32)})
    assert meta["step"] == 20


def test_async_save_keep_last_and_host_copy(tmp_path):
    """An async save copies the tree before it returns (a later in-place
    change does not reach the file); keep_last bounds the steps on disk."""
    ckpt = CheckpointManager(tmp_path, keep_last=2)
    w = torch.ones(8)
    for step in (1, 2, 3):
        ckpt.save(step, {"w": w})
        w.mul_(2.0)
    ckpt.wait()
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    tree, _ = ckpt.restore({"w": np.zeros(8, np.float32)})
    np.testing.assert_array_equal(tree["w"], np.full(8, 4.0, np.float32))


# ---- suspend -> resume, bit for bit ----

def _state_bits(state):
    return ([t.numpy().tobytes() for _, t in tree_paths(state.params)]
            + [t.numpy().tobytes() for _, t in tree_paths(state.opt_state.m)]
            + [t.numpy().tobytes() for _, t in tree_paths(state.opt_state.v)]
            + [state.occ_state.density_ema.numpy().tobytes(), state.occ_state.step,
               int(state.opt_state.step)])


def test_trainer_suspend_resume_bit_identical(ds):
    """16 steps, a host round-trip through a fresh trainer, 8 more: equal
    to 24 steps in one trainer, moments and occupancy included.  With
    headroom 0.7 the live fraction measured at the fold after step 15 puts
    steps 16-19 on the compacted route, so the resumed trainer must take
    its budget from the restored bookkeeping; the overflow there widens
    steps 20-23 back to dense."""
    cfg = dataclasses.replace(TRAIN_CFG, render=RenderConfig(n_samples=16),
                              budget_headroom=0.7, min_budget=64,
                              occ=t_occ.OccupancyConfig(resolution=16, warmup_steps=8,
                                                        update_interval=4))
    sampler = RaySampler(ds, device="cpu")
    ref = Instant3DTrainer(Field(FIELD_CFG), cfg, device="cpu")
    want, hist = ref.train(ref.init(), sampler, iters=24, log_every=1)
    assert [b is None for b in hist["budget"][16:]] == [False] * 4 + [True] * 4
    tr = Instant3DTrainer(Field(FIELD_CFG), cfg, device="cpu")
    mid, _ = tr.train(tr.init(), sampler, iters=16)
    fresh = Instant3DTrainer(Field(FIELD_CFG), cfg, device="cpu")
    got, got_hist = fresh.train(fresh.resume(tr.suspend(mid)), sampler, iters=8,
                                log_every=1)
    assert got_hist["budget"] == hist["budget"][16:]
    assert _state_bits(got) == _state_bits(want)
    assert fresh._live_frac == ref._live_frac
    assert fresh._overflow_window == ref._overflow_window


def test_session_suspend_to_disk_resume_in_fresh_session(ds, tmp_path):
    sess = SceneSession("s0", ds, FIELD_CFG, TRAIN_CFG, target_iters=20,
                        ckpt_dir=str(tmp_path / "ckpt"), device="cpu")
    sess.start()
    sess.run_slice(12)
    assert sess.state.occ_state.step > 0
    img_before = sess.trainer.render_image(sess.state.params, ds.poses[0], ds)
    sess.suspend(block=True)
    assert sess.status == SUSPENDED and not sess.resident and sess.step == 12

    fresh = SceneSession("s0", ds, FIELD_CFG, TRAIN_CFG, target_iters=20,
                         ckpt_dir=str(tmp_path / "ckpt"), device="cpu")
    fresh.resume()
    assert fresh.status == ACTIVE and fresh.step == 12
    img_after = fresh.trainer.render_image(fresh.state.params, ds.poses[0], ds)
    for a, b in zip(img_before, img_after):
        np.testing.assert_array_equal(a, b)
    fresh.run_slice(8)
    ref = SceneSession("ref", ds, FIELD_CFG, TRAIN_CFG, target_iters=20, device="cpu")
    ref.start()
    ref.run_slice(12)
    ref.run_slice(8)
    assert fresh.status == ref.status == DONE
    assert _state_bits(fresh.state) == _state_bits(ref.state)


def test_crash_resume_falls_back_past_corrupt_checkpoint(ds, tmp_path):
    """A fresh session restores from the newest valid checkpoint (the
    newest is corrupt) and trains to the same bits as an uninterrupted run."""
    sess = SceneSession("s0", ds, FIELD_CFG, TRAIN_CFG, target_iters=16,
                        ckpt_dir=str(tmp_path / "ckpt"), device="cpu")
    sess.start()
    for _ in range(3):
        sess.run_slice(4)
        sess.ckpt.save(sess.step, sess.trainer.suspend(sess.state), block=True)
    faults.corrupt_file(tmp_path / "ckpt" / "step_00000012" / "arrays.npz")
    fresh = SceneSession("s0", ds, FIELD_CFG, TRAIN_CFG, target_iters=16,
                         ckpt_dir=str(tmp_path / "ckpt"), device="cpu")
    fresh.resume()
    assert fresh.step == 8
    while fresh.status != DONE:
        fresh.run_slice(4)
    ref = SceneSession("ref", ds, FIELD_CFG, TRAIN_CFG, target_iters=16, device="cpu")
    ref.start()
    while ref.status != DONE:
        ref.run_slice(4)
    assert _state_bits(fresh.state) == _state_bits(ref.state)


# ---- the fault harness (mirrors tests/test_robustness.py) ----

def test_faults_disabled_is_noop():
    assert not faults.enabled()
    assert faults.check("serve3d.slice", session="x", step=0) is None
    assert faults.fired() == []


def test_fault_matching_semantics():
    faults.configure(enabled=True)
    inj = faults.inject("serve3d.slice", "nan_params", session="a", at_step=10, skip=1,
                        times=2)
    assert faults.check("serve3d.slice", session="b", step=50) is None
    assert faults.check("serve3d.slice", session="a", step=5) is None
    assert faults.check("serve3d.slice", session="a", step=10) is None
    assert faults.check("serve3d.slice", session="a", step=12) is inj
    assert faults.check("serve3d.slice", session="a", step=14) is inj
    assert faults.check("serve3d.slice", session="a", step=16) is None
    assert faults.fired_count("nan_params") == 2
    inj2 = faults.inject("serve3d.slice", "slow", seconds=0.5)
    assert inj2.params == {"seconds": 0.5} and inj2.match == {}


def test_arming_enables_and_reset_clears():
    assert not faults.enabled()
    faults.inject("checkpoint.write", "corrupt")
    assert faults.enabled()
    assert faults.check("checkpoint.write", step=1) is not None
    faults.reset()
    assert faults.check("checkpoint.write", step=2) is None
    assert faults.fired() == []


def test_poison_tree_and_finiteness():
    tree = {"w": torch.ones((3, 2)), "n": torch.arange(4), "h": np.ones(2, np.float32)}
    bad = faults.poison_tree(tree, float("nan"))
    assert torch.isnan(bad["w"]).all() and torch.isnan(bad["h"]).all()
    assert torch.equal(bad["n"], tree["n"])              # integers kept
    assert torch.equal(tree["w"], torch.ones((3, 2)))     # the input untouched
    assert tree_all_finite(tree) and not tree_all_finite(bad)
    assert tree_all_finite(bad["n"])
    assert not tree_all_finite(tree, faults.poison_tree({"x": torch.ones(2)}, float("inf")))
