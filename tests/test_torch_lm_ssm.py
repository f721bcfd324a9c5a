"""The SSM and hybrid decoders (Mamba-1, Mamba-2/SSD and zamba2's
weight-shared attention block) in the port against the JAX package on the
CPU.

The port keeps an SSM state as the dict ``{"h", "conv_tail"}``; the
reference's `SSMState` NamedTuple is compared through its `_asdict()`.

Tolerances (f32 throughout; the same operations in the same order, matmul
and einsum accumulation orders differ): the scan helper is
`jax.lax.associative_scan`'s bytes (the same combination tree); the causal
conv within 1e-6 at f32 and one bf16 rounding (2^-7 of the largest |value|)
at bf16, its tail exactly; `mamba1` / `mamba2` outputs and states within
`BLOCK_TOL` and their gradients (params, input, incoming state) within
`BLOCK_GRAD_TOL` of JAX's, at a sequence a multiple of the chunk, with a
remainder and from an incoming state; the reference's two SSM properties
(chunked == tokenwise, state continuation) within its 1e-3.  For both smoke
configs, params bridged from `repro.models.lm.LM.init`: logits within
`LOGITS_TOL`, the loss within `LOSS_TOL` (~10 f32 ulps at 5.5), every
gradient within `GRAD_TOL` (the shared block's summed over its application
points), `prefill` and three `decode_step`s and every cache leaf (`h`,
`conv_tail`, the shared block's k / v) within `LOGITS_TOL`; remat on the
bytes of remat off; ``dedup_embed_grad=True`` the bytes of the default
backward; a hybrid whose layers fill its groups (empty tail) and one with
no group.  Then `param_count` of both full configs, the f32 SSM leaves
through bridge, a step and a checkpoint, both CLIs (train resumed byte for
byte, serve with slots reused, a reused slot decoding as its request alone)
and a CPU rehearsal of chip_smoke's phase 14 (`smoke_ssm`).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.models import ssm as j_ssm
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import SSMConfig as JSSMConfig
from repro.models.lm import LM as JLM
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import counting
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tfm
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.models.lm import LM
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_from_paths, tree_paths
from repro_torch.runtime import resume_or_init

ARCHS = ["falcon-mamba-7b", "zamba2-7b"]
KINDS = ["mamba1", "mamba2"]
BLOCK_TOL, BLOCK_GRAD_TOL = 1e-5, 1e-5
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 2e-5, 5e-6, 2e-6
CONV_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jit(f, *args):
    """f(*args) through `jax.jit`, compiled at XLA's lowest backend
    optimisation level (the compile, not the run, is what costs here)."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _np(x):
    return np.asarray(x, np.float32)


def _plain(tree):
    """A JAX tree as nested dicts of numpy arrays (an `SSMState` as its
    `_asdict()`)."""
    if isinstance(tree, j_ssm.SSMState):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_trees_close(got: dict, want: dict, tol: float):
    want = _plain(want)
    assert [p for p, _ in tree_paths(got)] == [p for p, _ in tree_paths(want)]
    for (path, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.detach().float().numpy(), _np(w), atol=tol, rtol=0,
                                   err_msg=str(path))


# --- pieces ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_jax(dtype, with_tail, rng):
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = (rng.normal(size=(4, 12)) * 0.5).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    tail = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_tail else None
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    j_args = [jnp.asarray(a).astype(jd) if a is not None else None for a in (x, w, b, tail)]
    want_y, want_tail = _jit(lambda *a: j_ssm.causal_conv(*a), *j_args)
    t_args = [torch.from_numpy(a).to(td) if a is not None else None for a in (x, w, b, tail)]
    got_y, got_tail = t_ssm.causal_conv(*t_args)
    assert got_y.dtype == got_tail.dtype == td
    tol = CONV_TOL if dtype == "float32" else 2.0 ** -7 * float(np.abs(_np(want_y)).max())
    np.testing.assert_allclose(got_y.float().numpy(), _np(want_y), atol=tol, rtol=0)
    assert np.array_equal(got_tail.float().numpy(), _np(want_tail))


@pytest.mark.parametrize("q", [8, 128, 13])
def test_associative_scan_is_jaxs_bytes(q, rng):
    """The scan helper against `jax.lax.associative_scan` of the selective
    scan's operator on random (a, bx), at power-of-two and odd lengths."""
    a = rng.uniform(0.3, 1.0, (2, q, 5, 4)).astype(np.float32)
    bx = rng.normal(size=(2, q, 5, 4)).astype(np.float32)

    def j_scan(a, bx):
        return jax.lax.associative_scan(lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]),
                                        (a, bx), axis=1)

    want = _jit(j_scan, jnp.asarray(a), jnp.asarray(bx))
    got = t_ssm.associative_scan(torch.from_numpy(a), torch.from_numpy(bx))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), _np(w))


# --- blocks ---------------------------------------------------------------------------

def _block_cfg(kind):
    """The reference test's SSM block config (chunk 4), in both packages."""
    kw = dict(name="t", family="ssm", n_layers=1, d_model=16, n_heads=1, n_kv_heads=1, d_ff=0,
              vocab=64, dtype="float32")
    ssm = dict(kind=kind, d_state=8, d_conv=4, expand=2, headdim=8, chunk=4)
    return JModelConfig(**kw, ssm=JSSMConfig(**ssm)), ModelConfig(**kw, ssm=SSMConfig(**ssm))


@functools.lru_cache(maxsize=None)
def _block_params(kind):
    jc, _ = _block_cfg(kind)
    return _jit(lambda k: j_ssm.init_ssm(k, jc, jnp.float32), jax.random.PRNGKey(0))


@pytest.mark.parametrize("case", ["chunks", "remainder", "from_state"])
@pytest.mark.parametrize("kind", KINDS)
def test_ssm_block_outputs_states_and_gradients_match_jax(kind, case, rng):
    jc, tc = _block_cfg(kind)
    jp = _block_params(kind)
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    seq = {"chunks": 8, "remainder": 11, "from_state": 7}[case]
    x = (rng.normal(size=(2, seq, 16)) * 0.5).astype(np.float32)
    r = rng.normal(size=(2, seq, 16)).astype(np.float32)
    j_state = t_state = None
    if case == "from_state":      # the state of a 6-token call before this one
        x0 = (rng.normal(size=(2, 6, 16)) * 0.5).astype(np.float32)
        j_state = _jit(lambda p, v: j_ssm.ssm_block(p, jc, v)[1], jp, jnp.asarray(x0))
        t_state = {k: torch.tensor(v) for k, v in _plain(j_state).items()}

    def j_loss(p, v, st):
        y, new = j_ssm.ssm_block(p, jc, v, st)
        return jnp.sum(y * r) + jnp.sum(new.h), (y, new)

    (_, (want_y, want_state)), want_g = _jit(
        jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True), jp, jnp.asarray(x), j_state)
    live = tree_from_paths([(p, t.clone().requires_grad_()) for p, t in tree_paths(tp)])
    tx = torch.from_numpy(x).requires_grad_()
    t_in = None if t_state is None else {k: v.clone().requires_grad_() for k, v in t_state.items()}
    y, state = t_ssm.ssm_block(live, tc, tx, t_in)
    np.testing.assert_allclose(y.detach().numpy(), _np(want_y), atol=BLOCK_TOL, rtol=0)
    _assert_trees_close(state, want_state, BLOCK_TOL)
    leaves = [t for _, t in tree_paths(live)] + [tx] + \
        ([] if t_in is None else [t_in["conv_tail"], t_in["h"]])
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)) + torch.sum(state["h"]),
                                leaves)
    want = list(jax.tree_util.tree_leaves(want_g[0])) + [want_g[1]]
    if t_in is not None:
        want += [want_g[2].conv_tail, want_g[2].h]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=BLOCK_GRAD_TOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_ssm_chunked_equals_tokenwise_in_the_port(kind, rng):
    """The reference's property: the chunked scan over a sequence == the
    tokens fed one by one through the decode path."""
    _, tc = _block_cfg(kind)
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, _block_params(kind)), "cpu")
    x = torch.from_numpy((rng.normal(size=(2, 12, 16)) * 0.5).astype(np.float32))
    y_par, state_par = t_ssm.ssm_block(tp, tc, x)
    state = t_ssm.init_ssm_state(tc, 2, torch.float32)
    ys = []
    for t in range(12):
        y_t, state = t_ssm.ssm_block(tp, tc, x[:, t: t + 1], state)
        ys.append(y_t)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(state_par["h"].numpy(), state["h"].numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_ssm_state_continuation_in_the_port(kind, rng):
    """The reference's property: a sequence split across two calls with the
    state carried == one call."""
    _, tc = _block_cfg(kind)
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, _block_params(kind)), "cpu")
    x = torch.from_numpy((rng.normal(size=(1, 16, 16)) * 0.5).astype(np.float32))
    y_full, _ = t_ssm.ssm_block(tp, tc, x)
    y1, st = t_ssm.ssm_block(tp, tc, x[:, :8])
    y2, _ = t_ssm.ssm_block(tp, tc, x[:, 8:], st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), atol=1e-3,
                               rtol=1e-3)


# --- models ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_init(arch, **overrides):
    """`repro.models.lm.LM.init` of `arch`'s smoke config, seed 0."""
    return _jit(JLM(dataclasses.replace(j_get_smoke(arch), **overrides)).init,
                jax.random.PRNGKey(0))


def _pair(arch, **overrides):
    """(JAX model, port model, JAX params, the same params bridged)."""
    jp = _j_init(arch, **overrides)
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return (JLM(dataclasses.replace(j_get_smoke(arch), **overrides)),
            LM(dataclasses.replace(get_smoke_config(arch), **overrides), device="cpu"), jp, tp)


def _loss_and_grads(model, params, batch):
    live = tree_from_paths([(p, t.detach().clone().requires_grad_())
                            for p, t in tree_paths(params)])
    loss = model.loss(live, batch)
    grads = torch.autograd.grad(loss, [t for _, t in tree_paths(live)], allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip([p for p, _ in tree_paths(live)], grads))


def _prefill_and_decode(jm, tm, jp, tp, toks, s, steps=3):
    """prefill of toks[:, :s] and `steps` decode steps on both sides: the
    logits of each, and the final caches (JAX's decode step compiled
    once)."""
    logits, jcache, _ = _jit(lambda p, t: jm.prefill(p, tokens=t, max_seq=s + steps + 1), jp,
                             jnp.asarray(toks[:, :s]))
    want = [logits]
    b = toks.shape[0]
    j_decode = jax.jit(jm.decode_step).lower(
        jp, jcache, jnp.asarray(toks[:, s: s + 1]), jnp.full((b, 1), s, jnp.int32)).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    for k in range(steps):
        logits, jcache = j_decode(jp, jcache, jnp.asarray(toks[:, s + k: s + k + 1]),
                                  jnp.full((b, 1), s + k, jnp.int32))
        want.append(logits)
    tl, tc, _ = tm.prefill(tp, tokens=torch.from_numpy(toks[:, :s]), max_seq=s + steps + 1)
    got = [tl]
    for k in range(steps):
        pos = torch.full((b, 1), s + k, dtype=torch.int32)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, s + k: s + k + 1]), pos)
        got.append(tl)
    return got, want, tc, jcache


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_models_forward_loss_grads_decode_remat_and_dedup_match_jax(arch, rng):
    """Sequences of 19 tokens at the smoke configs' chunk of 8: two chunks
    and a remainder of 3; the prompt of 11, one chunk and a remainder."""
    jm, tm, jp, tp = _pair(arch)
    assert ("shared_attn" in tp) == bool(tm.cfg.hybrid_attn_every)
    ssm_p = tp[f"seg0_{tm.segs[0][0]}"]["ssm"]
    assert all(ssm_p[k].dtype == torch.float32 for k in ("A_log", "D", "dt_bias"))
    toks = rng.integers(0, tm.cfg.vocab, (2, 19)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}

    def j_loss(p, b):
        return jm.loss(p, b), jm.forward(p, tokens=b["tokens"])[0]

    (want_loss, want_logits), want_grads = _jit(jax.value_and_grad(j_loss, has_aux=True), jp, jb)
    got_logits, _ = tm.forward(tp, tokens=tb["tokens"])
    np.testing.assert_allclose(got_logits.numpy(), _np(want_logits), atol=LOGITS_TOL, rtol=0)
    loss, grads = _loss_and_grads(tm, tp, tb)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
    assert len(grads) == len(jax.tree_util.tree_leaves(want_grads))
    for (path, g), wg in zip(sorted(grads.items()), jax.tree_util.tree_leaves(want_grads)):
        np.testing.assert_allclose(g.numpy(), _np(wg), atol=GRAD_TOL, rtol=0, err_msg=str(path))
    stoks = rng.integers(1, tm.cfg.vocab, (2, 14)).astype(np.int32)
    got, want, tc, jcache = _prefill_and_decode(jm, tm, jp, tp, stoks, 11)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=LOGITS_TOL, rtol=0)
    _assert_trees_close(tc, jcache, LOGITS_TOL)
    empty = tm.init_caches(2, 15)
    assert [(p, c.shape, c.dtype) for p, c in tree_paths(empty)] == \
        [(p, c.shape, c.dtype) for p, c in tree_paths(tc)]
    # remat on: the same bytes as remat off; the merged embedding backward
    # (its plain version here): the same bytes as the default's
    for override in ({"remat": True}, {"dedup_embed_grad": True}):
        other = LM(dataclasses.replace(tm.cfg, **override), device="cpu")
        o_loss, o_grads = _loss_and_grads(other, tp, tb)
        assert torch.equal(o_loss, loss), override
        assert all(torch.equal(o_grads[p], grads[p]) for p in grads), override


@pytest.mark.parametrize("n_layers", [4, 1])
def test_hybrid_with_an_empty_tail_or_no_group_matches_jax(n_layers, rng):
    """zamba2's smoke config (the shared block every 2 layers) at 4 layers
    (two groups, no tail: `stack_trees` / `unstack_tree` of nothing) and at
    1 (no group: the shared block never applied, its caches stacked zero
    times, its gradient zero): logits, prefill / decode and the caches
    against JAX."""
    jm, tm, jp, tp = _pair("zamba2-7b", n_layers=n_layers)
    toks = rng.integers(1, tm.cfg.vocab, (2, 13)).astype(np.int32)
    want_logits = _jit(lambda p, t: jm.forward(p, tokens=t)[0], jp, jnp.asarray(toks))
    got_logits, _ = tm.forward(tp, tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(got_logits.numpy(), _np(want_logits), atol=LOGITS_TOL, rtol=0)
    _, grads = _loss_and_grads(tm, tp, {"tokens": torch.from_numpy(toks)})
    shared = [g for p, g in grads.items() if p[0] == "shared_attn"]
    assert all(g.any() for g in shared if g.ndim > 1) if n_layers == 4 else \
        not any(g.any() for g in shared)
    got, want, tc, jcache = _prefill_and_decode(jm, tm, jp, tp, toks, 10)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=LOGITS_TOL, rtol=0)
    _assert_trees_close(tc, jcache, LOGITS_TOL)
    assert tc["shared_attn"]["self"]["k"].shape[0] == n_layers // 2
    empty = tm.init_caches(2, 14)
    assert [(p, c.shape) for p, c in tree_paths(empty)] == \
        [(p, c.shape) for p, c in tree_paths(tc)]


# --- configs and CLIs -----------------------------------------------------------------

def test_param_counts_of_both_ssm_configs_and_their_depth_cuts():
    want = {"falcon-mamba-7b": (7_272_665_088, 3, 848_617_472),
            "zamba2-7b": (6_751_130_832, 7, 980_754_096)}
    for arch, (total, layers, cut) in want.items():
        cfg = get_config(arch)
        assert counting.param_count(cfg) == j_get_config(arch).param_count() == total, arch
        assert counting.active_param_count(cfg) == total, arch
        assert counting.param_count(dataclasses.replace(cfg, n_layers=layers)) == cut, arch
        assert LM(cfg, device="meta").segs == [(cfg.ssm.kind, cfg.n_layers)]
    assert not hasattr(t_tfm, "NOT_PORTED")     # whisper's kinds, the last, ported too


def _state_bytes(state):
    params, opt = state
    return [t.contiguous().view(torch.uint8) if t.dtype != torch.int32 else t
            for _, t in tree_paths({"p": params, "m": opt.m, "v": opt.v, "s": opt.step})]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_ssm_leaves_stay_f32_through_the_bridge_a_step_and_a_checkpoint(arch, tmp_path):
    """In a bf16 model `A_log`, `D` and `dt_bias` are f32 (the reference's
    `init_ssm`); the bridge, AdamW and a checkpoint round trip keep every
    leaf's dtype."""
    cfg = dataclasses.replace(j_get_smoke(arch), dtype="bfloat16")
    shapes = jax.eval_shape(JLM(cfg).init, jax.random.PRNGKey(0))   # the bf16 init's dtypes
    jp = jax.tree.map(lambda x, a: x.astype(a.dtype), _j_init(arch), shapes)
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    dtypes = [(p, t.dtype) for p, t in tree_paths(tp)]
    assert [str(d).split(".")[-1] for _, d in dtypes] == \
        [str(w.dtype) for w in jax.tree_util.tree_leaves(jp)]
    ssm_p = tp[f"seg0_{cfg.ssm.kind}"]["ssm"]
    assert all(ssm_p[k].dtype == torch.float32 for k in ("A_log", "D", "dt_bias"))
    assert ssm_p["in_proj"].dtype == torch.bfloat16
    model = LM(dataclasses.replace(get_smoke_config(arch), dtype="bfloat16"), device="cpu")
    ours = model.init(torch.Generator().manual_seed(0))
    assert [(p, t.dtype) for p, t in tree_paths(ours)] == dtypes
    opt = AdamW(lr=1e-3, clip_norm=1.0, weight_decay=0.01)
    toks = torch.from_numpy(np.arange(24, dtype=np.int32).reshape(2, 12))
    state = t_train.train_step(model, opt, tp, opt.init(tp), {"tokens": toks})[:2]
    assert [(p, t.dtype) for p, t in tree_paths(state[0])] == dtypes
    assert all(t.dtype == torch.float32 for _, t in tree_paths(state[1].m))
    mgr = CheckpointManager(tmp_path / "ck", async_save=False)
    mgr.save(1, state, extra={"data_cursor": 1})
    restored, cursor = resume_or_init(mgr, state, lambda: None)
    assert cursor == 1
    assert all(torch.equal(a, b) for a, b in zip(_state_bytes(restored), _state_bytes(state)))
    assert [(p, t.dtype) for p, t in tree_paths(restored[0])] == dtypes


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_clis_train_resume_byte_for_byte_and_serve_reusing_slots(arch, tmp_path, capsys):
    args = ["--arch", arch, "--smoke", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--device", "cpu"]
    full = t_train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert full["summary"]["step"] == 4 and all(np.isfinite(full["loss"]))
    part = t_train.train(arch, smoke=True, steps=4, batch=2, seq=16, ckpt_every=2,
                         device="cpu", ckpt_dir=str(tmp_path / "b"), stop_after=2)
    assert part["summary"]["step"] == 2
    resumed = t_train.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--auto-resume"])
    assert resumed["start"] == 2 and resumed["step"] == [3, 4]
    assert resumed["loss"] == full["loss"][2:]
    assert all(torch.equal(a, b) for a, b in zip(_state_bytes(resumed["state"]),
                                                 _state_bytes(full["state"])))
    out = t_serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "5",
                        "--max-new", "4", "--requests", "5"])
    assert out["completed"] >= 5 and out["tok_s"] > 0 and out["finite"]
    assert "served" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_a_reused_slot_decodes_as_its_request_alone(arch, rng):
    """`_reset_slot` copies a fresh prefill's SSM state (and zamba2's
    shared-block caches) into slot 1 of a batch mid-decode: slot 1 then
    decodes as the new request does alone, slot 0 as before."""
    model = LM(get_smoke_config(arch), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    p, max_seq = 6, 12
    toks = torch.from_numpy(rng.integers(1, model.cfg.vocab, (3, p + 3)).astype(np.int32))
    _, caches, _ = model.prefill(params, tokens=toks[:2, :p], max_seq=max_seq)
    pos = torch.full((2, 1), p, dtype=torch.int32)
    _, caches = model.decode_step(params, caches, toks[:2, p: p + 1], pos)
    _, fresh, _ = model.prefill(params, tokens=toks[2:, :p], max_seq=max_seq)
    t_serve._reset_slot(caches, fresh, 1)
    for path, c in tree_paths(caches):
        assert torch.equal(c[:, 1:2], dict(tree_paths(fresh))[path]), path
    step = torch.stack([toks[0, p + 1], toks[2, p]])[:, None]
    got, _ = model.decode_step(params, caches, step, torch.tensor([[p + 1], [p]],
                                                                  dtype=torch.int32))
    alone, _ = model.decode_step(params, fresh, toks[2:, p: p + 1], pos[:1])
    np.testing.assert_allclose(got[1].numpy(), alone[0].numpy(), atol=1e-5, rtol=0)
    want0, _ = model.forward(params, tokens=toks[:1, : p + 2])
    np.testing.assert_allclose(got[0].numpy(), want0[0, -1].numpy(), atol=1e-5, rtol=0)


def test_phase_14_rehearsal_on_the_cpu(monkeypatch, capsys):
    """chip_smoke's phase 14 (`smoke_ssm.model_runs`) on the smoke configs,
    shrunk: both archs' three runs (the merged ones byte-identical from one
    seed) with the held-out gate, zamba2's merged run stopped halfway and
    resumed byte for byte, prefill / decode against the full forward and
    the f32 forward against itself on a prompt of two chunks and a
    remainder, and serving with a slot reused.  A run at lr 0 fails the
    training gate."""
    from repro_torch import smoke_lm, smoke_ssm
    for name, value in {"TRAIN_STEPS": 12, "TRAIN_BATCH": 4, "TRAIN_SEQ": 32, "STOP": 6,
                        "TRAIN_LR": dict.fromkeys(ARCHS, 3e-3), "PROBE_BATCH": 16,
                        "PARITY_PROMPT": 19, "SERVE_ARGS": {"batch": 2, "prompt_len": 5,
                                                            "max_new": 4, "requests": 3}}.items():
        monkeypatch.setattr(smoke_ssm, name, value)
    out = smoke_ssm.model_runs("cpu", "cpu", smoke=True)
    assert sorted(out["launches"]) == sorted(f"{p}_{s}" for p in ("lm_ssm", "lm_hybrid")
                                             for s in ("train", "train_dedup", "serve"))
    res = out["lm_hybrid"]["resume"]
    assert res["stopped_at"] == res["start"] == 6 and all(res["same"].values())
    for name in ("lm_ssm", "lm_hybrid"):
        par = out[name]["parity"]
        assert par["decode"]["ok"] and par["cpu"]["max_abs_err"] == 0.0
    assert all(s["completed"] >= 3 and s["finite"] for s in out["served"].values())
    assert "lm_hybrid train stopped at 6" in capsys.readouterr().out
    monkeypatch.setattr(smoke_ssm, "TRAIN_LR", dict.fromkeys(ARCHS, 0.0))
    with pytest.raises(RuntimeError, match="lm_ssm training gate failed"):
        smoke_ssm.train_and_check("cpu", "falcon-mamba-7b", "cpu", smoke=True)
