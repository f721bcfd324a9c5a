"""The port's compiled-step cache against the reference's (CPU).

* Keys: the reference's `cohort_step_fn` (which builds a `jax.jit` lazily
  and compiles nothing) and the port's, called on one sequence of
  variants with tracing on, count the same ``trainer.step_cache.hit`` /
  ``.miss``, answer `step_variant_cached` alike before every call and
  leave the same `step_cache_keys()`.
* Spans: a 4-step run (L=4, small tables, 64 rays x 16 samples, no
  occupancy) in both packages names the same sequence of
  ``trainer/step_compile`` / ``trainer/step`` spans.
* The staged step (`step_graph.StagedGraph` on the CPU: static buffers,
  copy in, a replay that overwrites the static outputs, copy out):
  outputs never alias the caller's inputs or the static buffers, a masked
  leaf is the caller's input object, every step keeps its own aux, and a
  whole run staged (24 steps with folds, compacted steps that overflow and
  the widening back) ends on the bytes of the same run under
  `eager_steps()`, history, overflow window and live fraction included.
* The launch record: counts made in a recording go to its record, a
  replay adds the record, another thread's counts go to `LAUNCHES`.
* `Instant3DTrainer.step_fn` mirrors tests/test_nerf_core.py's frozen-grid
  step; `occ_update_fn` is `occupancy.update` byte for byte.

Every comparison is exact.  Autouse fixtures run each test on one thread
and with empty caches (the reference's cache is saved and restored), so no
test depends on another's.
"""
import dataclasses
import threading

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
from repro.obs import metrics as j_metrics
from repro.obs import trace as j_trace
from repro_torch import kernels
from repro_torch.core import field as t_field
from repro_torch.core import occupancy as t_occ
from repro_torch.core import rendering as t_rendering
from repro_torch.core import step_graph
from repro_torch.core import trainer as t_trainer
from repro_torch.data import rays_dataset as t_rays
from repro_torch.data import synthetic_scene as t_scene
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace
from repro_torch.optim.adamw import tree_paths

GEOM = dict(n_levels=4, max_resolution=64, log2_table_density=12, log2_table_color=10,
            hidden=16)
RCFG = dict(n_samples=16)
OCC = dict(resolution=16, warmup_steps=8, update_interval=4)
# the configuration of tests/test_torch_train.py: folds at 11, 15, 19, 23, a
# budget of 512 of 1024 points that overflows, then the widening back
TRAIN = dict(n_rays=64, iters=24, budget_headroom=0.7, min_budget=64)
DATA = dict(n_views=4, h=16, w=16, gt_samples=48)


def _configs(pkg_field, pkg_rendering, pkg_occ, pkg_trainer, **train):
    return (pkg_field.FieldConfig(**GEOM),
            pkg_trainer.TrainerConfig(render=pkg_rendering.RenderConfig(**RCFG),
                                      occ=pkg_occ.OccupancyConfig(**OCC), **{**TRAIN, **train}))


T_FCFG, T_TCFG = _configs(t_field, t_rendering, t_occ, t_trainer)
J_FCFG, J_TCFG = _configs(j_field, j_rendering, j_occ, j_trainer)


@pytest.fixture(autouse=True)
def _one_thread_and_empty_caches():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = dict(j_trainer._COHORT_STEP_CACHE)
    j_trainer._COHORT_STEP_CACHE.clear()
    t_trainer.clear_step_cache()
    kernels.reset_launches()
    yield
    t_trainer.clear_step_cache()
    kernels.reset_launches()
    j_trainer._COHORT_STEP_CACHE.clear()
    j_trainer._COHORT_STEP_CACHE.update(saved)
    torch.set_num_threads(n)


@pytest.fixture
def traced():
    """Tracing on in both packages, their buffers emptied before and after."""
    was = (j_trace.enabled(), t_trace.enabled())
    for tr in (j_trace, t_trace):
        tr.set_enabled(True)
        tr.clear()
    yield
    for tr, on in zip((j_trace, t_trace), was):
        tr.set_enabled(on)
        tr.clear()


@pytest.fixture(scope="module")
def t_data():
    _, ds = t_scene.build_dataset(0, cfg=t_rendering.RenderConfig(**RCFG), device="cpu", **DATA)
    return ds


def _counts(metrics) -> tuple:
    return tuple(metrics.counter(f"trainer.step_cache.{w}").value for w in ("hit", "miss"))


# ---- keys and spans against the reference ----

VARIANTS = [(True, False, None, False, 1), (False, False, None, False, 1),
            (True, False, None, False, 1), (False, False, 512, True, 1),
            (False, False, 512, True, 2), (False, False, 512, True, 1),
            (True, True, 256, True, 3), (False, False, None, True, 1),
            (True, True, 256, True, 3)]


def test_keys_and_counters_equal_the_reference(traced):
    j_before, t_before = _counts(j_metrics), _counts(t_metrics)
    for variant in VARIANTS:
        assert j_trainer.step_variant_cached(J_FCFG, J_TCFG, *variant) == \
            t_trainer.step_variant_cached(T_FCFG, T_TCFG, *variant), variant
        j_trainer.cohort_step_fn(J_FCFG, J_TCFG, *variant)
        t_trainer.cohort_step_fn(T_FCFG, T_TCFG, *variant)
        assert t_trainer.step_variant_cached(T_FCFG, T_TCFG, *variant)
    j_delta = np.subtract(_counts(j_metrics), j_before)
    t_delta = np.subtract(_counts(t_metrics), t_before)
    assert list(t_delta) == list(j_delta) == [3, 6]
    j_keys = j_trainer.Instant3DTrainer(j_field.Field(J_FCFG), J_TCFG).step_cache_keys()
    t_keys = t_trainer.Instant3DTrainer(t_field.Field(T_FCFG), T_TCFG,
                                        device="cpu").step_cache_keys()
    assert t_keys == j_keys == set(VARIANTS)
    # another trainer config sees none of them
    other = dataclasses.replace(T_TCFG, n_rays=32)
    assert t_trainer.Instant3DTrainer(t_field.Field(T_FCFG), other,
                                      device="cpu").step_cache_keys() == set()
    t_trainer.clear_step_cache()
    assert not t_trainer.step_variant_cached(T_FCFG, T_TCFG, *VARIANTS[0])


def test_a_run_names_the_reference_spans(traced):
    jf, jt = _configs(j_field, j_rendering, j_occ, j_trainer, use_occupancy=False, iters=4)
    tf, tt = _configs(t_field, t_rendering, t_occ, t_trainer, use_occupancy=False, iters=4)
    _, j_ds = j_scene.build_dataset(0, cfg=j_rendering.RenderConfig(**RCFG), **DATA)
    j_tr = j_trainer.Instant3DTrainer(j_field.Field(jf), jt)
    j_tr.train(j_tr.init(jax.random.PRNGKey(0)), j_rays.RaySampler(j_ds), log_every=4)
    _, t_ds = t_scene.build_dataset(0, cfg=t_rendering.RenderConfig(**RCFG), device="cpu",
                                    **DATA)
    t_tr = t_trainer.Instant3DTrainer(t_field.Field(tf), tt, device="cpu")
    t_tr.train(t_tr.init(), t_rays.RaySampler(t_ds, device="cpu"), log_every=4)

    def steps(events):
        return [(e.name, e.args) for e in events if e.name.startswith("trainer/step")]

    j_spans, t_spans = steps(j_trace.events()), steps(t_trace.events())
    assert [n for n, _ in t_spans] == [n for n, _ in j_spans] == \
        ["trainer/step_compile"] * 2 + ["trainer/step"] * 2
    assert [a for _, a in t_spans] == [a for _, a in j_spans]
    assert t_tr.step_cache_keys() == j_tr.step_cache_keys() == \
        {(True, False, None, False, 1), (False, False, None, False, 1)}


# ---- the staged step ----

def _member_inputs(tr, state, sampler, i, cfg=T_TCFG):
    ray_idx, u_ts, _ = t_trainer.default_draws(cfg, sampler.n)(i)
    ts = t_rendering.sample_ts(None, cfg.n_rays, cfg.render, "cpu", u=u_ts)
    return state.params, state.opt_state, sampler.gather(ray_idx), ts, \
        state.occ_state.density_ema


def _storages(tree) -> set:
    return {leaf.untyped_storage().data_ptr() for _, leaf in step_graph._flatten(tree)
            if isinstance(leaf, torch.Tensor)}


def _same(a, b) -> bool:
    la, lb = step_graph._flatten(a), step_graph._flatten(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) and x.dtype == y.dtype if isinstance(x, torch.Tensor) else x == y
        for (_, x), (_, y) in zip(la, lb))


def test_staged_step_copies_out_and_passes_masked_leaves_through(t_data):
    """Two members, color frozen, a budget that overflows: each replay's
    outputs are fresh tensors equal to the eager body's, the frozen grid
    and its moments are the caller's objects, and every step's aux keeps
    its own overflow count."""
    sampler = t_rays.RaySampler(t_data, device="cpu")
    trs = [t_trainer.Instant3DTrainer(t_field.Field(T_FCFG), T_TCFG, device="cpu")
           for _ in range(2)]
    states = [tr.init(torch.Generator().manual_seed(k)) for k, tr in enumerate(trs)]
    fn = t_trainer.cohort_step_fn(T_FCFG, T_TCFG, True, False, 256, True, 2)
    staged, kept, eager_overflow = None, [], []
    for i in range(5):
        members = [_member_inputs(tr, s, sampler, 7 * i + k)
                   for k, (tr, s) in enumerate(zip(trs, states))]
        args = tuple(list(col) for col in zip(*members))
        if staged is None:
            staged = step_graph.StagedGraph(fn.body, args)
        out = staged(args)
        want = fn.body(*args)
        assert _same(out, want)
        for r in range(2):
            assert out[0][r]["color_grid"] is args[0][r]["color_grid"]
            assert out[1][r].m["color_grid"] is args[1][r].m["color_grid"]
            assert out[1][r].v["color_grid"] is args[1][r].v["color_grid"]
        passed = {id(args[0][r]["color_grid"]) for r in range(2)} | \
            {id(getattr(args[1][r], w)["color_grid"]) for r in range(2) for w in "mv"}
        fresh = [leaf for _, leaf in step_graph._flatten(out)
                 if isinstance(leaf, torch.Tensor) and id(leaf) not in passed]
        taken = _storages(args) | _storages(staged.static_in) | _storages(staged.static_out)
        assert all(leaf.untyped_storage().data_ptr() not in taken for leaf in fresh)
        kept.append([a["overflow"] for a in out[3]])
        eager_overflow.append([int(a["overflow"]) for a in want[3]])
    assert [[int(v) for v in row] for row in kept] == eager_overflow
    assert len({tuple(row) for row in eager_overflow}) > 1     # the counts do vary
    assert staged.replays == 5
    with pytest.raises(ValueError, match="input"):
        bad = (args[0], args[1], args[2], [t[:, :8] for t in args[3]], args[4])
        staged(bad)


def _staged_call(self, *args):
    """`CompiledStep.__call__` staging on the CPU too (HostReplay)."""
    if step_graph.eager():
        return self.body(*args)
    graph = self.graphs.get("host")
    if graph is None:
        graph = self.graphs["host"] = step_graph.StagedGraph(self.body, args)
    return graph(args)


def _run(t_data, iters=24):
    tr = t_trainer.Instant3DTrainer(t_field.Field(T_FCFG), T_TCFG, device="cpu")
    state, hist = tr.train(tr.init(), t_rays.RaySampler(t_data, device="cpu"), iters=iters,
                           log_every=1)
    return tr, state, hist


def _state_bytes(tr, state) -> list:
    return ([t.numpy().tobytes() for _, t in tree_paths(state.params)]
            + [t.numpy().tobytes() for _, t in tree_paths(state.opt_state.m)]
            + [t.numpy().tobytes() for _, t in tree_paths(state.opt_state.v)]
            + [int(state.opt_state.step), state.occ_state.density_ema.numpy().tobytes(),
               state.occ_state.step, state.step, tr._live_frac, tr._overflow_window])


def test_a_staged_run_ends_on_the_eager_bytes(t_data, monkeypatch):
    with t_trainer.eager_steps():
        eager = _run(t_data)
    monkeypatch.setattr(step_graph.CompiledStep, "__call__", _staged_call)
    staged = _run(t_data)
    assert _state_bytes(*staged[:2]) == _state_bytes(*eager[:2])
    hist = staged[2]
    assert {k: v for k, v in hist.items() if k != "wall_s"} == \
        {k: v for k, v in eager[2].items() if k != "wall_s"}
    assert hist["overflow_steps"] > 0 and None in hist["budget"] and 512 in hist["budget"]
    # every variant of the run and every fold went through its staged graph
    entries = list(t_trainer._COHORT_STEP_CACHE.values()) + \
        list(t_trainer._OCC_UPDATE_CACHE.values())
    assert sum(e.graphs["host"].replays for e in t_trainer._COHORT_STEP_CACHE.values()) == 24
    assert sum(e.graphs["host"].replays for e in t_trainer._OCC_UPDATE_CACHE.values()) == \
        len(hist["occ_folds"]) == 4
    assert all(e.graphs["host"].replays > 0 for e in entries)


def test_cpu_calls_run_the_body(t_data):
    tr, _, hist = _run(t_data, iters=4)
    assert len(t_trainer._COHORT_STEP_CACHE) == 2
    assert all(e.graphs == {} for e in t_trainer._COHORT_STEP_CACHE.values())
    assert not step_graph.eager()
    seen = []
    with t_trainer.eager_steps():
        with t_trainer.eager_steps():
            worker = threading.Thread(target=lambda: seen.append(step_graph.eager()))
            worker.start()
            worker.join(timeout=30)
        assert step_graph.eager()
    assert not worker.is_alive() and seen == [True] and not step_graph.eager()


# ---- the launch record ----

def test_launch_record_is_per_thread_and_replays_add_it():
    def other():
        kernels.count_launch("composite")

    with kernels.record_launches() as rec:
        kernels.count_launch("hash_encode")
        kernels.count_launch("hash_encode")
        worker = threading.Thread(target=other)
        worker.start()
        worker.join(timeout=30)
        with kernels.record_launches() as inner:
            kernels.count_launch("bum_sort")
        kernels.count_launch("fused_mlp2")
    assert not worker.is_alive()
    assert rec == {"hash_encode": 2, "fused_mlp2": 1} and inner == {"bum_sort": 1}
    assert kernels.LAUNCHES["composite"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    for _ in range(3):
        kernels.add_launches(rec)
    assert kernels.LAUNCHES["hash_encode"] == 6 and kernels.LAUNCHES["fused_mlp2"] == 3
    kernels.count_launch("hash_encode")              # the recording is over
    assert kernels.LAUNCHES["hash_encode"] == 7


def test_launch_counts_stay_exact_under_threads():
    """Twelve threads, half of them recording, each counting 2000 launches
    with a short switch interval: no count is lost or misrouted."""
    import sys
    records, n = [], 2000

    def count(recording: bool):
        if recording:
            with kernels.record_launches() as rec:
                for _ in range(n):
                    kernels.count_launch("bum_scatter")
            records.append(rec)
        else:
            for _ in range(n):
                kernels.count_launch("bum_scatter")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=count, args=(k % 2 == 0,)) for k in range(12)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert kernels.LAUNCHES["bum_scatter"] == 6 * n
    assert records == [{"bum_scatter": n}] * 6


# ---- step_fn and the fold ----

def test_step_fn_keeps_the_frozen_color_grid(t_data):
    """tests/test_nerf_core.py's frozen-grid step on the port's step_fn."""
    tcfg = dataclasses.replace(T_TCFG, use_occupancy=False)
    tr = t_trainer.Instant3DTrainer(t_field.Field(T_FCFG), tcfg, device="cpu")
    state = tr.init()
    params, opt_state, batch, ts, occ = _member_inputs(
        tr, state, t_rays.RaySampler(t_data, device="cpu"), 1, tcfg)
    step = tr.step_fn(freeze_color=True)
    assert tr.step_fn(freeze_color=True) is step
    before_color = params["color_grid"].clone()
    before_density = params["density_grid"].clone()
    new, new_opt, loss, _ = step(params, opt_state, batch, ts, occ)
    assert torch.equal(new["color_grid"], before_color)
    assert not torch.equal(new["density_grid"], before_density)
    assert torch.equal(params["density_grid"], before_density)     # inputs untouched
    want = tr.step(params, opt_state, batch, ts, occ, freeze_color=True, use_bits=False)
    assert _same((new, new_opt, loss), want[:3])
    assert t_trainer._COHORT_STEP_CACHE == {}                       # per instance


def test_occ_update_fn_is_the_eager_fold():
    fcfg, ocfg = T_FCFG, T_TCFG.occ
    field = t_field.Field(fcfg)
    params = [field.init(torch.Generator().manual_seed(k), "cpu") for k in range(2)]
    emas = [torch.rand(ocfg.resolution ** 3, generator=torch.Generator().manual_seed(9 + k))
            for k in range(2)]
    jitters = [(torch.rand((ocfg.resolution ** 3, 3),
                           generator=torch.Generator().manual_seed(5 + k)) - 0.5)
               / ocfg.resolution for k in range(2)]
    fold = t_trainer.occ_update_fn(fcfg, ocfg, 2)
    assert t_trainer.occ_update_fn(fcfg, ocfg, 2) is fold
    got = fold(params, emas, jitters)
    for p, e, j, g in zip(params, emas, jitters, got):
        want = t_occ.update(field, p, t_occ.OccupancyState(e, 3), ocfg, jitter=j)
        assert torch.equal(g, want.density_ema)


def test_phase_10_helpers_on_the_cpu(t_data, monkeypatch):
    """chip_smoke's phase 10 at a tiny size, the graphs staged on the CPU:
    the built keys are the variants the run took, every step and fold a
    replay, and the staged run is the eager run's bytes."""
    from repro_torch import smoke
    sampler = t_rays.RaySampler(t_data, device="cpu")
    with t_trainer.eager_steps():
        eager = smoke.compiled_run(sampler, T_FCFG, T_TCFG, 24)
    monkeypatch.setattr(step_graph.CompiledStep, "__call__", _staged_call)
    staged = smoke.compiled_run(sampler, T_FCFG, T_TCFG, 24)
    stats = smoke.graph_stats()
    keys = staged["trainer"].step_cache_keys()
    assert keys == smoke.variants_taken(staged, T_FCFG, T_TCFG)
    assert {k[2] for k in keys} == {None, 512} and {k[3] for k in keys} == {False, True}
    assert stats["replays"] == 24 and stats["fold_replays"] == 4 and stats["fold_graphs"] == 1
    assert stats["graphs"] == stats["variants"] == len(keys)
    assert set(stats["capture_ms"]) == {str(k) for k in keys}
    assert all(smoke.same_run(staged, eager).values()), smoke.same_run(staged, eager)
    assert staged["launches"] == eager["launches"]
    smoke.print_graphs("rehearsal", "cpu")
    assert t_trainer._COHORT_STEP_CACHE == {}
