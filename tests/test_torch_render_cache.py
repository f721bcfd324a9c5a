"""The port's render caches against the reference's (CPU).

* `_pow2_bucket` is the reference's.
* Keys: the same drains through a JAX `RenderService` and the port's --
  groups of 1, 2 and 3 on the dense and redistributed routes, a shed
  drain, a preview (which keeps the chunk, so reuses a key), then
  `evaluate` dense and redistributed -- leave the same key tails (chunk,
  group, samples per ray, v3) in `_BATCH_RENDER_CACHE` and
  `_EVAL_RENDER_CACHE`; every group size shares one member render.
* The reference's cache-identity test (tests/test_serve3d.py) for the
  port's `eval_render_fn`.
* A group of 3, keyed as padded to 4, gives each member the bytes of the
  same request served alone, and the JAX served view within the slice
  tolerance (1e-4 rgb, 5e-4 depth, as tests/test_torch_serve.py).
* The bound-input staging (`step_graph.RenderGraph` on the CPU stand-in,
  `HostReplay`): one member graph staged from a snapshot with no fold
  yet, then a folded snapshot rendered through it, each the eager
  entry's bytes, alone and as two members of one group; the bitfield's
  fold-count choice reads nothing on the host.
* `clear_render_cache()` empties the caches; chip_smoke's phase 11
  (`smoke.compiled_against_eager_renders`) at a tiny size, its graphs
  staged on the CPU through `CompiledRender`'s `stage`.

Autouse fixtures run each test on one thread with empty port caches; the
reference's caches are saved and restored around the JAX drains.
"""
import dataclasses
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
from repro.serve3d import render as j_render
from repro.serve3d.snapshot import SnapshotStore as JStore
from repro_torch import bridge, smoke
from repro_torch.core import field as t_field
from repro_torch.core import occupancy as t_occ
from repro_torch.core import rendering as t_rendering
from repro_torch.core import step_graph
from repro_torch.core import trainer as t_trainer
from repro_torch.serve3d import RenderResult, RenderService, SnapshotStore
from repro_torch.serve3d import render as t_render

GEOM = dict(n_levels=4, max_resolution=64, log2_table_density=12,
            log2_table_color=10, hidden=16)
J_FCFG, T_FCFG = j_field.FieldConfig(**GEOM), t_field.FieldConfig(**GEOM)
J_RCFG = j_rendering.RenderConfig(n_samples=16)
T_RCFG = t_rendering.RenderConfig(n_samples=16)
J_OCFG = j_occ.OccupancyConfig(resolution=16)
T_OCFG = t_occ.OccupancyConfig(resolution=16)
# 16x16 views in chunks of 32 (8 a view); a level-1 preview (64 rays)
# keeps the chunk, as an 800x800 view's does at 4096
HW, FOCAL, CHUNK, SPR = 16, 18.0, 32, 4
SESSIONS = {"dense": {}, "redist": {"samples_per_ray": SPR}}
J_CACHES = ("_EVAL_RENDER_CACHE", "_REDIST_RENDER_CACHE", "_BATCH_RENDER_CACHE")


@pytest.fixture(autouse=True)
def _one_thread_and_empty_caches():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    t_trainer.clear_render_cache()
    yield
    t_trainer.clear_render_cache()
    torch.set_num_threads(n)


def _tails(cache: dict) -> set:
    """Cache keys without their configs: (chunk, group, spr, v3) and the
    like."""
    return {tuple(k for k in key if isinstance(k, (bool, int))) for key in cache}


@pytest.fixture(scope="module")
def snapshot():
    """(numpy params, numpy occupancy pair) made by the JAX package, the
    grids U(-1, 1) and a lowered density bias, so the bitfield splits."""
    field = j_field.Field(J_FCFG)
    params = jax.tree.map(np.asarray, field.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for k in ("density_grid", "color_grid"):
        params[k] = rng.uniform(-1, 1, size=params[k].shape).astype(np.float32)
    params["density_mlp"]["b2"] = params["density_mlp"]["b2"].copy()
    params["density_mlp"]["b2"][0] = -3.0
    state = jax.jit(lambda p, k: j_occ.update(field, p, j_occ.init_state(J_OCFG), J_OCFG, k))(
        jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(1))
    return params, (np.asarray(state.density_ema), int(state.step))


def _register(svc, field_cfg, render_cfg, occ_cfg):
    for sid, kw in SESSIONS.items():
        svc.register_session(sid, field_cfg, render_cfg, HW, HW, FOCAL, eval_chunk=CHUNK,
                             occ_cfg=occ_cfg if kw else None, **kw)


def _services(params, occ, port: bool, shed_threshold=None):
    if port:
        store = SnapshotStore()
        for sid in SESSIONS:
            store.publish(sid, bridge.params_to_torch(params, "cpu"), step=8,
                          occ=bridge.occ_to_torch(occ, "cpu"))
        svc = RenderService(store, device="cpu", shed_threshold=shed_threshold)
        _register(svc, T_FCFG, T_RCFG, T_OCFG)
    else:
        store = JStore()
        for sid in SESSIONS:
            store.publish(sid, params, step=8, occ=occ)
        svc = j_render.RenderService(store, shed_threshold=shed_threshold)
        _register(svc, J_FCFG, J_RCFG, J_OCFG)
    return svc


@dataclasses.dataclass
class _View:
    h: int
    w: int
    focal: float
    poses: np.ndarray
    images: np.ndarray
    depths: np.ndarray


def _drains(params, occ, port: bool) -> dict:
    """The drains of the key test in one package -> the answers of each
    drain, and the caches' key tails after them."""
    svc = _services(params, occ, port)
    poses = j_rendering.sphere_poses(4, seed=3)
    answers = []
    for group in (1, 2, 3):
        for sid in SESSIONS:
            for k in range(group):
                svc.submit(sid, poses[k])
        answers.append(svc.drain())
    svc.submit("redist", poses[0], level=1)
    answers.append(svc.drain())
    shed = _services(params, occ, port, shed_threshold=1)
    shed.submit("redist", poses[3])
    shed.submit("dense", poses[3])
    answers.append(shed.drain())
    view = _View(HW, HW, FOCAL, poses[:1], np.zeros((1, HW, HW, 3), np.float32),
                 np.full((1, HW, HW), 4.0, np.float32))
    if port:
        tcfg = t_trainer.TrainerConfig(render=T_RCFG, occ=T_OCFG, eval_chunk=CHUNK)
        tr = t_trainer.Instant3DTrainer(t_field.Field(T_FCFG), tcfg, device="cpu")
        tparams = bridge.params_to_torch(params, "cpu")
        evals = [tr.evaluate(tparams, view), tr.evaluate(tparams, view,
                                                         occ=bridge.occ_to_torch(occ, "cpu"))]
        mod = t_trainer
    else:
        jcfg = j_trainer.TrainerConfig(render=J_RCFG, occ=J_OCFG, eval_chunk=CHUNK)
        tr = j_trainer.Instant3DTrainer(j_field.Field(J_FCFG), jcfg)
        evals = [tr.evaluate(params, view), tr.evaluate(params, view, occ=occ)]
        mod = j_trainer
    return {"answers": answers, "evals": evals,
            "tails": {name: _tails(getattr(mod, name)) for name in J_CACHES},
            "members": _tails(getattr(mod, "_MEMBER_RENDERS", {}))}


@pytest.fixture(scope="module")
def both(snapshot):
    """The key test's drains in JAX (its caches saved, emptied, restored)
    and in the port (its caches emptied first)."""
    saved = {name: dict(getattr(j_trainer, name)) for name in J_CACHES}
    for name in J_CACHES:
        getattr(j_trainer, name).clear()
    try:
        want = _drains(*snapshot, port=False)
    finally:
        for name in J_CACHES:
            getattr(j_trainer, name).clear()
            getattr(j_trainer, name).update(saved[name])
    t_trainer.clear_render_cache()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = _drains(*snapshot, port=True)
    finally:
        torch.set_num_threads(n)
    return want, got


def test_pow2_bucket_is_the_references():
    for n in range(1, 65):
        assert t_render._pow2_bucket(n) == j_render._pow2_bucket(n), n


def test_keys_after_the_same_drains_equal_the_references(both):
    want, got = both
    assert got["tails"] == want["tails"]
    batch = got["tails"]["_BATCH_RENDER_CACHE"]
    # groups of 1, 2 and 3 (padded to 4) on both routes and the shed
    # drain's halved budget; the preview and the redistributed evaluate
    # reuse the group-of-1 entry
    assert batch == {(CHUNK, g) for g in (1, 2, 4)} | \
        {(CHUNK, g, SPR, False) for g in (1, 2, 4)} | {(CHUNK, 1, SPR // 2, False)}
    assert got["tails"]["_EVAL_RENDER_CACHE"] == {(CHUNK,)}
    assert got["tails"]["_REDIST_RENDER_CACHE"] == set()
    # one member render for every group size of a chunk, budget and path
    assert got["members"] == {
        (CHUNK,), (CHUNK, SPR, False), (CHUNK, SPR // 2, False)}
    for (wa, ga) in zip(want["evals"], got["evals"]):
        assert abs(wa["psnr_rgb"] - ga["psnr_rgb"]) < 1e-3


def test_eval_render_cache_keyed_per_config():
    """tests/test_serve3d.py's cache-identity test on the port."""
    a = t_trainer.eval_render_fn(T_FCFG, T_RCFG, 144)
    b = t_trainer.eval_render_fn(T_FCFG, T_RCFG, 144)
    assert a is b
    bigger = t_field.FieldConfig(n_levels=2, max_resolution=32, log2_table_density=12,
                                 log2_table_color=8, hidden=16)
    assert t_trainer.eval_render_fn(bigger, T_RCFG, 144) is not a
    assert t_trainer.eval_render_fn(T_FCFG, T_RCFG, 72) is not a
    assert len(t_trainer._EVAL_RENDER_CACHE) == 3


def test_padded_group_members_are_the_lone_requests_bytes(both, snapshot):
    """The third drain's group of 3 (keyed as padded to 4, the reference
    rendering the padding): each member is the bytes of its pose served
    alone, and the JAX answer within tolerance."""
    want, got = both
    three, jthree = got["answers"][2], want["answers"][2]
    assert len(three) == len(jthree) == 6
    svc = _services(*snapshot, port=True)
    poses = j_rendering.sphere_poses(4, seed=3)
    for r, w in zip(three, jthree):
        assert isinstance(r, RenderResult) and (r.session_id, r.level) == (w.session_id, 0)
        np.testing.assert_allclose(r.rgb, w.rgb, atol=1e-4)
        np.testing.assert_allclose(r.depth, w.depth, atol=5e-4)
    for sid in ("dense", "redist"):
        members = [r for r in three if r.session_id == sid]
        assert len(members) == 3
        for k, r in enumerate(members):
            svc.submit(sid, poses[k])
            (alone,) = svc.drain()
            assert np.array_equal(alone.rgb, r.rgb) and np.array_equal(alone.depth, r.depth)


def _host_stage(body, args, device):
    return step_graph.RenderGraph(body, args)


def _member_inputs(snapshot, occ_step: int, seed: int = 7):
    """One member's (params, origins, dirs, ts, EMA, 0-d fold count), the
    EMA zero while no fold is in."""
    params, occ = snapshot
    ema = bridge.occ_to_torch(occ, "cpu")[0]
    if not occ_step:
        ema = torch.zeros_like(ema)
    pose = j_rendering.sphere_poses(1, seed=seed)[0]
    o, d, _n, _chunk = t_trainer.image_rays(pose, HW, HW, FOCAL, CHUNK, "cpu")
    return (bridge.params_to_torch(params, "cpu"), o, d,
            t_rendering.sample_ts(None, CHUNK, T_RCFG, "cpu"), ema,
            torch.tensor(occ_step, dtype=torch.int32))


@pytest.mark.parametrize("v3", [False, True])
def test_bound_staging_gives_the_eager_bytes_across_folds(snapshot, v3):
    """One member graph staged (HostReplay) from a snapshot with no fold
    yet -- all cells occupied -- then a folded snapshot bound into the same
    static buffers: every view the eager entry's bytes, every chunk a
    replay."""
    fn = t_trainer.batched_redistributed_render_fn(T_FCFG, T_RCFG, T_OCFG, CHUNK, 2, SPR,
                                                   redistribute_v3=v3)
    unfolded, folded = _member_inputs(snapshot, 0), _member_inputs(snapshot, 3)
    first = (unfolded[0], unfolded[1][:CHUNK], unfolded[2][:CHUNK], *unfolded[3:])
    graph = step_graph.RenderGraph(fn.member.body, first)
    assert graph.chunk == CHUNK
    views = []
    for args in (unfolded, folded, unfolded):
        rgb = torch.full(args[1].shape, float("nan"))
        depth = torch.full(args[1].shape[:-1], float("nan"))
        graph.render(args, rgb, depth)
        want = fn.member(*args)
        assert torch.equal(rgb, want[0]) and torch.equal(depth, want[1])
        views.append(rgb)
    assert not torch.equal(views[0], views[1])        # the fold changed the bits
    assert graph.binds == 3 and graph.replays == 3 * HW * HW // CHUNK


def test_a_group_binds_each_member_in_turn(snapshot, monkeypatch):
    """A group of an unfolded and a folded member through the entry's
    real call, its member graph staged on the CPU: the eager group's
    bytes, one bind a member, every chunk a replay, one graph for both
    group sizes."""
    monkeypatch.setattr(step_graph, "CompiledRender",
                        functools.partial(step_graph.CompiledRender, stage=_host_stage))
    members = [_member_inputs(snapshot, 0), _member_inputs(snapshot, 3, seed=8)]
    args = ([m[0] for m in members], torch.stack([m[1] for m in members]),
            torch.stack([m[2] for m in members]), members[0][3], [m[4] for m in members],
            torch.stack([m[5] for m in members]))
    fn = t_trainer.batched_redistributed_render_fn(T_FCFG, T_RCFG, T_OCFG, CHUNK, 2, SPR)
    with t_trainer.eager_steps():
        want = fn(*args)
    got = fn(*args)
    alone = t_trainer.batched_redistributed_render_fn(T_FCFG, T_RCFG, T_OCFG, CHUNK, 1, SPR)(
        [args[0][1]], args[1][1:], args[2][1:], args[3], [args[4][1]], args[5][1:])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(alone[0][0], want[0][1]) and torch.equal(alone[1][0], want[1][1])
    (graph,) = fn.member.graphs.values()
    assert graph.binds == 3 and graph.replays == 3 * HW * HW // CHUNK
    assert list(t_trainer._MEMBER_RENDERS.values()) == [fn.member]
    with pytest.raises(ValueError, match="group 1 called on 2"):
        t_trainer.batched_redistributed_render_fn(T_FCFG, T_RCFG, T_OCFG, CHUNK, 1, SPR)(*args)


def test_bitfield_reads_no_fold_count_on_the_host():
    """A fold count on the meta device cannot be read: the bitfield's
    choice is made where the EMA lives, as a captured render needs."""
    ema = torch.rand(T_OCFG.resolution ** 3)
    for step in (0, 2):
        want = t_occ.bitfield(t_occ.OccupancyState(ema, step), T_OCFG)
        got = t_occ.bitfield(t_occ.OccupancyState(ema, torch.tensor(step, dtype=torch.int32)),
                             T_OCFG)
        assert torch.equal(got, want)
    meta = t_occ.bitfield(t_occ.OccupancyState(ema.to("meta"), torch.zeros(
        (), dtype=torch.int32, device="meta")), T_OCFG)
    assert meta.device.type == "meta" and meta.shape == ema.shape


def test_clear_render_cache_empties_the_caches():
    t_trainer.eval_render_fn(T_FCFG, T_RCFG, CHUNK)
    t_trainer.redistributed_render_fn(T_FCFG, T_RCFG, T_OCFG, CHUNK, SPR)
    t_trainer.batched_render_fn(T_FCFG, T_RCFG, CHUNK, 2)
    t_trainer.batched_redistributed_render_fn(T_FCFG, T_RCFG, T_OCFG, CHUNK, 2, SPR)
    assert [len(getattr(t_trainer, name)) for name in J_CACHES] == [1, 1, 2]
    assert len(t_trainer._MEMBER_RENDERS) == 2
    t_trainer.clear_render_cache()
    assert [len(getattr(t_trainer, name)) for name in J_CACHES] == [0, 0, 0]
    assert not t_trainer._MEMBER_RENDERS
    assert not [k for k in step_graph._devices if k[1] == "render"]


@pytest.mark.parametrize("route", ["redist", "dense"])
def test_phase_11_on_the_cpu(snapshot, monkeypatch, route):
    """chip_smoke's phase 11 (`compiled_against_eager_renders`) at a tiny
    size, the render graphs staged on the CPU through `CompiledRender`'s
    real call: the staged drains are the eager drain's bytes, the built
    keys are the groups taken (3 views keyed as padded to 4, and the
    preview's group of 1), one member graph serves both, every chunk of
    every member -- and of the lone latency requests -- a replay."""
    params, occ = snapshot
    tcfg = t_trainer.TrainerConfig(render=T_RCFG, occ=T_OCFG, eval_chunk=CHUNK)
    tr = t_trainer.Instant3DTrainer(t_field.Field(T_FCFG), tcfg, device="cpu")
    ema, step = bridge.occ_to_torch(occ, "cpu")
    run = {"trainer": tr, "state": t_trainer.TrainState(
        bridge.params_to_torch(params, "cpu"), None, t_occ.OccupancyState(ema, step), 8)}
    monkeypatch.setattr(step_graph, "CompiledRender",
                        functools.partial(step_graph.CompiledRender, stage=_host_stage))
    res = smoke.compiled_against_eager_renders("cpu", run, route, hw=HW, n_latency=3)
    tail = (SPR, False) if route == "redist" else ()
    assert res["keys"] == res["taken"] == {(CHUNK, 4) + tail, (CHUNK, 1) + tail}
    assert res["same"] == {"capture_drain": True, "replay_drain": True}
    assert res["every_chunk_replayed"]
    stats = res["stats"]
    assert stats["replays"] == res["chunks"] == 2 * (3 * HW * HW + HW * HW // 4) // CHUNK
    assert stats["graphs"] == 1 and stats["entries"] == 2 and stats["binds"] == 2 * 4
    assert set(stats["capture_ms"]) == {f"member {(CHUNK,) + tail}"}
    for lat in res["latency"].values():
        assert lat["n"] == len(lat["latency_ms"]) == 3
        assert 0 < lat["p50_ms"] <= lat["p95_ms"] <= lat["max_ms"]
    assert smoke._ms_per_view(res["captured"][1], HW) > 0
    assert not t_trainer._MEMBER_RENDERS            # the phase empties the caches
