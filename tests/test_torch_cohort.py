"""The port's train cohorts: bit identity within the port, and a 2-member
cohort against the JAX package's `train_cohort` (CPU).

Within the port (mirrors tests/test_serve3d_cohort.py), at L=4,
T=2^12/2^10, hidden 16, 64 rays x 8 samples, occupancy R=16 folded every 4
steps after 2: a cohort equals sequential `train` calls byte for byte
(params, Adam moments, occupancy EMA, the trainers' live fraction and
overflow window), whatever the cohort's size and order; members whose
budgets drift apart split into groups and stay byte-identical; mismatched
members are refused; the service forms cohorts of config-matched sessions
and keeps round-robin fair.

Against JAX (the configuration of tests/test_torch_train.py: 64 rays x 16
samples, warmup 8, a fold every 4 steps, headroom 0.7 so the compacted
route, its overflow and the widening back all occur), both members fed
the reference's draws: budgets, overflow and folds equal, live fraction
within 1e-6 relative, loss within 1e-2 relative, occupancy EMA within 1e-2
relative / 1e-3 absolute -- the tolerances of `test_24_step_run_matches_jax`.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import field as j_field
from repro.core import occupancy as j_occ
from repro.core import rendering as j_rendering
from repro.core import trainer as j_trainer
from repro.data import rays_dataset as j_rays
from repro.data import synthetic_scene as j_scene
from repro_torch import bridge
from repro_torch.core import occupancy as t_occ
from repro_torch.core.field import Field, FieldConfig
from repro_torch.core.rendering import RenderConfig
from repro_torch.core.trainer import (Instant3DTrainer, TrainerConfig, TrainState,
                                      _partition_members, train_cohort)
from repro_torch.data.rays_dataset import RaySampler
from repro_torch.data.synthetic_scene import build_dataset
from repro_torch.optim.adamw import tree_paths
from repro_torch.serve3d import ReconstructionService

GEOM = dict(n_levels=4, max_resolution=64, log2_table_density=12, log2_table_color=10,
            hidden=16)
FIELD_CFG = FieldConfig(**GEOM)
RCFG = RenderConfig(n_samples=8)
OCFG = t_occ.OccupancyConfig(resolution=16, update_interval=4, warmup_steps=2)
# min_budget below n_rays * n_samples so compaction budgets engage
TRAIN_CFG = TrainerConfig(n_rays=64, render=RCFG, occ=OCFG, eval_chunk=256, min_budget=64)
OTHER_CFG = dataclasses.replace(TRAIN_CFG, n_rays=32)
M = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def datasets():
    return [build_dataset(seed, n_views=2, h=16, w=16, cfg=RCFG, gt_samples=24,
                          device="cpu")[1] for seed in range(M)]


def _fresh(datasets, k, cfg=TRAIN_CFG):
    tr = Instant3DTrainer(Field(FIELD_CFG), cfg, device="cpu")
    return tr, tr.init(torch.Generator().manual_seed(k)), RaySampler(datasets[k], device="cpu")


def _bits(state):
    return ([t.numpy().tobytes() for _, t in tree_paths(state.params)]
            + [t.numpy().tobytes() for _, t in tree_paths(state.opt_state.m)]
            + [t.numpy().tobytes() for _, t in tree_paths(state.opt_state.v)]
            + [int(state.opt_state.step), state.occ_state.density_ema.numpy().tobytes(),
               state.occ_state.step, state.step])


# ---- cohort == sequential, byte for byte ----

def test_cohort_matches_sequential_bit_identical(datasets):
    seq = [_fresh(datasets, k) for k in range(M)]
    seq_states, seq_hists = [], []
    for tr, st, sa in seq:
        st, hist = tr.train(st, sa, iters=16, log_every=16)
        seq_states.append(st)
        seq_hists.append(hist)
    trs, sts, sas = zip(*[_fresh(datasets, k) for k in range(M)])
    coh_states, hists = train_cohort(list(trs), list(sts), list(sas), iters=16, log_every=16)
    for k in range(M):
        assert _bits(seq_states[k]) == _bits(coh_states[k]), f"member {k}"
        assert trs[k]._live_frac == seq[k][0]._live_frac
        assert trs[k]._overflow_window == seq[k][0]._overflow_window
        for key in ("loss", "live_fraction", "budget", "occ_folds", "overflow_total"):
            assert hists[k][key] == seq_hists[k][key], (k, key)


def test_cohort_m_and_order_invariance(datasets):
    def run(members):
        trs, sts, sas = zip(*[_fresh(datasets, k) for k in members])
        states, _ = train_cohort(list(trs), list(sts), list(sas), iters=12, log_every=12)
        return dict(zip(members, states))

    solo = run([1])
    for out in (run([0, 1]), run([1, 0]), run([0, 1, 2])):
        assert _bits(solo[1]) == _bits(out[1])


def test_budget_split_cohort_stays_bit_identical(datasets):
    """Forced live fractions split the members into groups of different
    budgets mid-run ([0, 2] and [1]); each stays byte-identical to its
    sequential run, and keeps its own budget and window."""
    forced = [0.05, 0.3, 0.05]
    seq_states, seq_trainers = [], []
    for k in range(M):
        tr, st, sa = _fresh(datasets, k)
        st, _ = tr.train(st, sa, iters=12, log_every=12)
        tr._live_frac = forced[k]
        st, _ = tr.train(st, sa, iters=8, log_every=8)
        seq_states.append(st)
        seq_trainers.append(tr)

    trs, sts, sas = zip(*[_fresh(datasets, k) for k in range(M)])
    mids, _ = train_cohort(list(trs), list(sts), list(sas), iters=12, log_every=12)
    for k in range(M):
        trs[k]._live_frac = forced[k]
    part = _partition_members(list(trs), True, [m.occ_state.step for m in mids])
    assert [members for _, members in part] == [[0, 2], [1]]
    assert part[0][0][1] != part[1][0][1] and None not in (part[0][0][1], part[1][0][1])
    news, hists = train_cohort(list(trs), list(mids), list(sas), iters=8, log_every=1)
    for k in range(M):
        assert _bits(seq_states[k]) == _bits(news[k]), f"member {k}"
        assert trs[k]._live_frac == seq_trainers[k]._live_frac
        assert trs[k]._overflow_window == seq_trainers[k]._overflow_window
    assert hists[0]["budget"][0] != hists[1]["budget"][0]


def test_cohort_rejects_mismatched_members(datasets):
    tr0, st0, sa0 = _fresh(datasets, 0)
    tr1, st1, sa1 = _fresh(datasets, 1, cfg=OTHER_CFG)
    with pytest.raises(ValueError, match="configs"):
        train_cohort([tr0, tr1], [st0, st1], [sa0, sa1], iters=4)
    tr2, st2, sa2 = _fresh(datasets, 1)
    st2b, _ = tr2.train(st2, sa2, iters=4, log_every=4)
    with pytest.raises(ValueError, match="same training step"):
        train_cohort([tr0, tr2], [st0, st2b], [sa0, sa2], iters=4)


# ---- the service: cohorts of config-matched sessions ----

def _service(datasets, target_iters):
    svc = ReconstructionService(slice_iters=4, device="cpu")
    svc.submit_scene(datasets[0], FIELD_CFG, TRAIN_CFG, target_iters=target_iters,
                     seed=0, session_id="a0")
    svc.submit_scene(datasets[1], FIELD_CFG, TRAIN_CFG, target_iters=target_iters,
                     seed=1, session_id="a1")
    svc.submit_scene(datasets[2], FIELD_CFG, OTHER_CFG, target_iters=target_iters,
                     seed=2, session_id="solo")
    return svc


def test_service_mixed_config_scheduling_and_fairness(datasets):
    """The config-matched pair rides one cohort, the odd-config scene trains
    solo in between (slice credits), both groups take the same number of
    quanta, and every session equals its sequential run."""
    svc = _service(datasets, 12)
    cohorts = []
    svc.run(hook=lambda _svc, ev: cohorts.append(sorted(ev["cohort"])))
    assert cohorts[0] == ["a0", "a1"]
    assert cohorts.count(["a0", "a1"]) == cohorts.count(["solo"]) == 3
    for sid, k, cfg in (("a0", 0, TRAIN_CFG), ("a1", 1, TRAIN_CFG), ("solo", 2, OTHER_CFG)):
        tr, st, sa = _fresh(datasets, k, cfg)
        st, _ = tr.train(st, sa, iters=12, log_every=12)
        sess = svc.sessions[sid]
        assert sess.step == 12
        assert _bits(st) == _bits(sess.state), sid


def test_cohort_membership_survives_suspend_resume(datasets):
    def build():
        svc = ReconstructionService(slice_iters=4, device="cpu")
        for k in range(2):
            svc.submit_scene(datasets[k], FIELD_CFG, TRAIN_CFG, target_iters=12, seed=k,
                             session_id=f"s{k}")
        return svc

    plain = build()
    plain.run()
    svc = build()
    assert sorted(svc.step()["cohort"]) == ["s0", "s1"]
    for sess in svc.sessions.values():
        sess.suspend()
        assert not sess.resident
    assert sorted(svc.step()["cohort"]) == ["s0", "s1"]   # resumed, re-formed
    svc.run()
    for sid in ("s0", "s1"):
        assert _bits(plain.sessions[sid].state) == _bits(svc.sessions[sid].state), sid


# ---- a 2-member cohort against the JAX package ----

J_GEOM = dict(GEOM)
J_RCFG = dict(n_samples=16)
J_DATA = dict(n_views=4, h=16, w=16, gt_samples=48)
J_TRAIN = dict(n_rays=64, iters=24, budget_headroom=0.7, min_budget=64)
J_OCC = dict(resolution=16, warmup_steps=8, update_interval=4)
J_TCFG = j_trainer.TrainerConfig(render=j_rendering.RenderConfig(**J_RCFG),
                                 occ=j_occ.OccupancyConfig(**J_OCC), **J_TRAIN)
T_TCFG = TrainerConfig(render=RenderConfig(**J_RCFG), occ=t_occ.OccupancyConfig(**J_OCC),
                       **J_TRAIN)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def jax_draws(i: int, n_pool: int):
    """The reference cohort's draws at step i, shared by its members
    (core/trainer.py:893, `_CohortGroup.sample`)."""
    key = jax.random.fold_in(jax.random.PRNGKey(J_TCFG.seed), i)
    kb, kt, ko = jax.random.split(key, 3)
    idx = jax.random.randint(kb, (J_TCFG.n_rays,), 0, n_pool)
    u_ts = jax.random.uniform(kt, (J_TCFG.n_rays, J_TCFG.render.n_samples))
    u_occ = jax.random.uniform(ko, (J_TCFG.occ.resolution ** 3, 3))
    return tuple(_t(np.asarray(a)) for a in (idx, u_ts, u_occ))


@pytest.mark.parametrize("ngp", [False, True], ids=["instant3d", "ngp"])
def test_two_member_cohort_matches_jax(ngp):
    j_fcfg = dataclasses.replace(j_field.FieldConfig(**J_GEOM), decomposed=not ngp)
    t_fcfg = dataclasses.replace(FieldConfig(**J_GEOM), decomposed=not ngp)
    j_samplers, t_samplers, j_trs, j_states, t_trs, t_states = [], [], [], [], [], []
    for k in range(2):
        _, ds = j_scene.build_dataset(k, cfg=J_TCFG.render, **J_DATA)
        js = j_rays.RaySampler(ds, views=[1, 2, 3])
        ts_ = RaySampler(ds, views=[1, 2, 3], device="cpu")
        ts_.origins, ts_.dirs = _t(np.asarray(js.origins)), _t(np.asarray(js.dirs))
        ts_.rgb = _t(np.asarray(js.rgb))
        j_samplers.append(js)
        t_samplers.append(ts_)
        j_tr = j_trainer.Instant3DTrainer(j_field.Field(j_fcfg), J_TCFG)
        j_st = j_tr.init(jax.random.PRNGKey(k))
        j_trs.append(j_tr)
        j_states.append(j_st)
        t_tr = Instant3DTrainer(Field(t_fcfg), T_TCFG, device="cpu")
        tp = bridge.params_to_torch(jax.tree.map(np.asarray, j_st.params), "cpu")
        t_trs.append(t_tr)
        t_states.append(TrainState(tp, t_tr.opt.init(tp),
                                   t_occ.init_state(T_TCFG.occ, "cpu"), 0))
    n = j_samplers[0].n
    assert n == j_samplers[1].n
    j_out, j_hists = j_trainer.train_cohort(j_trs, j_states, j_samplers, log_every=1)
    t_out, t_hists = train_cohort(t_trs, t_states, t_samplers, log_every=1,
                                  draws=[lambda i: jax_draws(i, n)] * 2)
    folds = [i for i in range(24) if i >= 8 and (i + 1) % 4 == 0]
    n_total = T_TCFG.n_rays * T_TCFG.render.n_samples
    compacted = 0
    for k in range(2):
        jh, th = j_hists[k], t_hists[k]
        assert th["occ_folds"] == folds
        assert t_out[k].occ_state.step == int(j_out[k].occ_state.step) == len(folds)
        assert t_out[k].step == j_out[k].step == 24
        assert th["step"] == jh["step"] == list(range(1, 25))
        assert th["points_queried"] == jh["points_queried"]
        assert [b is None for b in th["budget"]] == [p == n_total for p in jh["points_queried"]]
        compacted += sum(b is not None for b in th["budget"])
        assert th["overflow"] == jh["overflow"]
        assert th["overflow_total"] == jh["overflow_total"]
        assert t_trs[k]._live_frac == pytest.approx(j_trs[k]._live_frac, rel=1e-6)
        np.testing.assert_allclose(th["live_fraction"], jh["live_fraction"], rtol=1e-6)
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-2)
        assert int(t_out[k].opt_state.step) == int(j_out[k].opt_state.step) == 24
        np.testing.assert_allclose(t_out[k].occ_state.density_ema.numpy(),
                                   np.asarray(j_out[k].occ_state.density_ema),
                                   rtol=1e-2, atol=1e-3)
    assert compacted > 0, "the run should reach the compacted route"
