"""The LM substrate's dense decoders in the port against the JAX package on
the CPU, with params bridged from `repro.models.lm.LM.init`.

For each of the five `attn_dense` archs' smoke configs (qwen1.5-0.5b,
qwen3-8b, yi-9b, chatglm3-6b, qwen2-vl-2b; f32): the forward logits within
2e-5 abs, the loss within 2e-6 and every parameter's gradient within 1e-6
abs of JAX's (the same f32 operations in the same order; matmul
accumulation order differs); `prefill` and three `decode_step`s within
2e-5 of JAX's logits; the chunked online-softmax attention (a tiny
monkeypatched threshold and chunks) within 2e-5 of the dense path, as
`tests/test_attention.py` holds JAX's own; remat on gives the bytes of remat
off.  At bf16 (qwen1.5-0.5b's smoke config in bfloat16): the loss within
1e-2 and the logits within 3e-2 abs of JAX's (both round the same f32
results to bf16 once per op; the last bf16 ulp can differ).  Then: AdamW
with clip_norm and weight_decay under warmup_cosine over three steps
within 1e-6 of JAX's (params and moments); `SyntheticLMStream`'s tokens
bit for bit; `TrainDriver` runs, preempts and `resume_or_init` as
`tests/test_substrate.py` holds the reference's; both CLIs on a smoke
config with ``--device cpu`` (the train CLI's resume byte for byte);
`param_count` of the five full configs equal to the reference's; the other
five archs raise NotImplementedError naming their ROADMAP item.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.data import LMStreamConfig as JStreamConfig
from repro.data import SyntheticLMStream as JStream
from repro.models import attention as j_attention
from repro.models.lm import LM as JLM
from repro.optim import AdamW as JAdamW
from repro.optim import schedule as j_schedule
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import LMStreamConfig, SyntheticLMStream
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import attention as t_attention
from repro_torch.models import counting
from repro_torch.models.lm import LM
from repro_torch.optim import AdamW, schedule
from repro_torch.optim.adamw import tree_from_paths, tree_paths
from repro_torch.runtime import DriverConfig, StragglerStats, TrainDriver, resume_or_init

DENSE = ["qwen1.5-0.5b", "qwen3-8b", "yi-9b", "chatglm3-6b", "qwen2-vl-2b"]
OTHERS = {"deepseek-v2-lite-16b": "2.1", "deepseek-v3-671b": "2.1", "falcon-mamba-7b": "2.2",
          "zamba2-7b": "2.2", "whisper-medium": "2.3"}
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 2e-5, 2e-6, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jit(f, *args):
    """f(*args) through `jax.jit`, compiled at XLA's lowest backend
    optimisation level (the compile, not the run, is what costs here)."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _pair(arch, **overrides):
    """(JAX model, port model, JAX params, the same params bridged)."""
    jc = dataclasses.replace(j_get_smoke(arch), **overrides)
    tc = dataclasses.replace(get_smoke_config(arch), **overrides)
    jm = JLM(jc)
    jp = _jit(jm.init, jax.random.PRNGKey(0))
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jm, LM(tc, device="cpu"), jp, tp


def _batch(cfg, rng, b=2, s=12):
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.frontend == "vision_stub":
        e = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        pos = np.tile(np.arange(s, dtype=np.int32)[None, None], (3, b, 1))
        pos[1:] = rng.integers(0, s, size=(2, b, s))       # real 3D position streams
        jb.update(embeds=jnp.asarray(e), positions=jnp.asarray(pos))
        tb.update(embeds=torch.from_numpy(e), positions=torch.from_numpy(pos))
    return jb, tb


def _loss_and_grads(model, params, batch):
    live = tree_from_paths([(p, t.detach().clone().requires_grad_())
                            for p, t in tree_paths(params)])
    loss = model.loss(live, batch)
    grads = torch.autograd.grad(loss, [t for _, t in tree_paths(live)])
    return loss.detach(), dict(zip([p for p, _ in tree_paths(live)], grads))


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_loss_grads_decode_chunked_and_remat_match_jax(arch, rng, monkeypatch):
    jm, tm, jp, tp = _pair(arch)
    jb, tb = _batch(tm.cfg, rng)
    # forward logits, loss and every parameter's gradient (JAX's jitted)
    fwd = {k: v for k, v in tb.items() if k != "tokens"}

    def j_loss(p, b):
        logits, _ = jm.forward(p, tokens=None if "embeds" in b else b["tokens"],
                               embeds=b.get("embeds"), positions=b.get("positions"))
        return jm.loss(p, b), logits

    (want_loss, want_logits), want_grads = _jit(jax.value_and_grad(j_loss, has_aux=True), jp, jb)
    got_logits, _ = tm.forward(tp, tokens=None if "embeds" in tb else tb["tokens"], **fwd)
    np.testing.assert_allclose(got_logits.numpy(), _np(want_logits), atol=LOGITS_TOL, rtol=0)
    loss, grads = _loss_and_grads(tm, tp, tb)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
    for (path, g), wg in zip(sorted(grads.items()), jax.tree_util.tree_leaves(want_grads)):
        np.testing.assert_allclose(g.numpy(), _np(wg), atol=GRAD_TOL, rtol=0, err_msg=str(path))
    # prefill, then three decode steps from text tokens (JAX's in one jit)
    toks = rng.integers(1, tm.cfg.vocab, (2, 11)).astype(np.int32)
    s = 8

    def j_serve(p, t):
        logits, caches, _ = jm.prefill(p, tokens=t[:, :s], max_seq=s + 4)
        out = [logits]
        for k in range(3):
            logits, caches = jm.decode_step(p, caches, t[:, s + k: s + k + 1],
                                            jnp.full((2, 1), s + k, jnp.int32))
            out.append(logits)
        return out, caches

    want, jc = _jit(j_serve, jp, jnp.asarray(toks))
    tl, tc, _ = tm.prefill(tp, tokens=torch.from_numpy(toks[:, :s]), max_seq=s + 4)
    np.testing.assert_allclose(tl.numpy(), _np(want[0]), atol=LOGITS_TOL, rtol=0)
    for k in range(3):
        pos = torch.full((2, 1), s + k, dtype=torch.int32)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, s + k: s + k + 1]), pos)
        np.testing.assert_allclose(tl.numpy(), _np(want[k + 1]), atol=LOGITS_TOL, rtol=0)
    for (path, c), wc in zip(tree_paths(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(c.numpy(), _np(wc), atol=LOGITS_TOL, rtol=0,
                                   err_msg=str(path))
    empty = tm.init_caches(2, s + 4)
    assert [(p, c.shape, c.dtype) for p, c in tree_paths(empty)] == \
        [(p, c.shape, c.dtype) for p, c in tree_paths(tc)] and not any(
            c.any() for _, c in tree_paths(empty))
    # the chunked online softmax against the dense path, in the whole model
    dense_logits = got_logits
    monkeypatch.setattr(t_attention, "_CHUNKED_THRESHOLD", 0)
    monkeypatch.setattr(t_attention, "_Q_CHUNK", 5)
    monkeypatch.setattr(t_attention, "_K_CHUNK", 4)
    chunked, _ = tm.forward(tp, tokens=None if "embeds" in tb else tb["tokens"], **fwd)
    np.testing.assert_allclose(chunked.numpy(), dense_logits.numpy(), atol=LOGITS_TOL, rtol=0)
    chunked_loss, chunked_grads = _loss_and_grads(tm, tp, tb)
    assert abs(float(chunked_loss) - float(loss)) <= LOSS_TOL
    monkeypatch.undo()
    # remat on: the same bytes as remat off
    remat = LM(dataclasses.replace(tm.cfg, remat=True), device="cpu")
    r_loss, r_grads = _loss_and_grads(remat, tp, tb)
    assert torch.equal(r_loss, loss)
    assert all(torch.equal(r_grads[p], grads[p]) for p in grads)


@pytest.mark.parametrize("sq,sk,kh,rep,causal", [(64, 64, 2, 2, True), (128, 50, 1, 4, False)])
def test_chunked_attention_matches_dense_and_jax(sq, sk, kh, rep, causal, rng, monkeypatch):
    monkeypatch.setattr(t_attention, "_Q_CHUNK", 32)
    monkeypatch.setattr(t_attention, "_K_CHUNK", 32)
    monkeypatch.setattr(j_attention, "_Q_CHUNK", 32)
    monkeypatch.setattr(j_attention, "_K_CHUNK", 32)
    h, hd = kh * rep, 16
    q = rng.normal(size=(2, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(2, sk, kh, hd)).astype(np.float32)
    v = rng.normal(size=(2, sk, kh, hd)).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    dense = t_attention._sdpa_dense(tq, tk, tv, causal)
    chunked = t_attention._sdpa_chunked(tq, tk, tv, causal)
    np.testing.assert_allclose(chunked.numpy(), dense.numpy(), atol=2e-5, rtol=2e-5)
    want = j_attention._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    np.testing.assert_allclose(chunked.numpy(), _np(want), atol=2e-5, rtol=0)


def test_bf16_forward_and_loss_match_jax(rng):
    """qwen1.5-0.5b's smoke config in bf16, the f32 init's params cast."""
    cfg = dataclasses.replace(j_get_smoke("qwen1.5-0.5b"), dtype="bfloat16")
    jm = JLM(cfg)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), _jit(jm.init, jax.random.PRNGKey(0)))
    tm = LM(dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), dtype="bfloat16"), device="cpu")
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    jb, tb = _batch(tm.cfg, rng)
    want_loss, want = _jit(lambda p, b: (jm.loss(p, b), jm.forward(p, tokens=b["tokens"])[0]),
                           jp, jb)
    got, _ = tm.forward(tp, tokens=tb["tokens"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), atol=3e-2, rtol=0)
    assert abs(float(tm.loss(tp, tb)) - float(want_loss)) <= 1e-2


def test_adamw_clip_and_weight_decay_under_warmup_cosine_match_jax(rng):
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 2, 4)}}
    leaves = lambda tree: {k: (leaves(v) if isinstance(v, dict) else  # noqa: E731
                               rng.normal(size=v).astype(np.float32)) for k, v in tree.items()}
    params = leaves(shapes)
    grads = [leaves(shapes) for _ in range(3)]
    kw = dict(clip_norm=1.0, weight_decay=0.01)
    jopt = JAdamW(lr=j_schedule.warmup_cosine(3e-3, 2, 5), **kw)
    topt = AdamW(lr=schedule.warmup_cosine(3e-3, 2, 5), **kw)
    jp, tp = jax.tree.map(jnp.asarray, params), bridge.params_to_torch(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    j_apply = jax.jit(jopt.apply)
    for g in grads:
        jp, js = j_apply(jp, jax.tree.map(lambda x: jnp.asarray(x) * 3.0, g), js)
        tp, ts = topt.apply(tp, bridge.params_to_torch(
            {k: v for k, v in jax.tree.map(lambda x: x * 3.0, g).items()}, "cpu"), ts)
    assert int(ts.step) == int(js.step) == 3
    for want, got in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
        for w, (_, t) in zip(jax.tree_util.tree_leaves(want), tree_paths(got)):
            np.testing.assert_allclose(t.numpy(), _np(w), atol=1e-6, rtol=0)
    for step in (0, 1, 2, 3, 5, 9):
        s = jnp.asarray(step, jnp.int32)
        assert abs(float(schedule.warmup_cosine(3e-3, 2, 5)(torch.tensor(step, dtype=torch.int32)))
                   - float(j_schedule.warmup_cosine(3e-3, 2, 5)(s))) <= 1e-9
        assert abs(float(schedule.exponential_decay(1e-3, 0.5, 3)(torch.tensor(step)))
                   - float(j_schedule.exponential_decay(1e-3, 0.5, 3)(s))) <= 1e-10


def test_synthetic_lm_stream_is_the_references_bit_for_bit():
    for cfg in ((256, 16, 4), (151_936, 32, 8)):
        want = JStream(JStreamConfig(*cfg)).batch(3, dp_rank=1, dp_size=2)
        got = SyntheticLMStream(LMStreamConfig(*cfg)).batch(3, dp_rank=1, dp_size=2)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    it = SyntheticLMStream(LMStreamConfig(256, 8, 2)).iterator(start_step=5)
    assert np.array_equal(next(it)["tokens"], JStream(JStreamConfig(256, 8, 2)).batch(5))


# ---- the driver, as tests/test_substrate.py holds the reference's ----

def _fake_step(state, batch):
    return state + 1, {"loss": float(batch["x"])}


def test_driver_runs_preempts_and_resumes(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_save=False)
    drv = TrainDriver(DriverConfig(total_steps=7, checkpoint_every=3, log_every=2,
                                   metrics_path=str(tmp_path / "m.jsonl")), mgr)
    state, summary = drv.run(torch.zeros(()), _fake_step, iter([{"x": i} for i in range(100)]))
    drv.close()
    assert int(state) == 7 and not summary["preempted"]
    assert mgr.all_steps() == [3, 6, 7]
    assert (tmp_path / "m.jsonl").read_text().count('"train"') == 3

    mgr = CheckpointManager(tmp_path / "pre", async_save=False)
    drv = TrainDriver(DriverConfig(total_steps=1000, checkpoint_every=10 ** 6), mgr)
    calls = {"n": 0}

    def step(state, batch):
        calls["n"] += 1
        if calls["n"] == 5:
            drv._preempted = True           # SIGTERM mid-training
        return state + 1, {}

    state, summary = drv.run(torch.zeros(()), step, iter([{"x": i} for i in range(100)]))
    assert summary["preempted"] and int(state) == 5 and mgr.latest_step() == 5

    mgr = CheckpointManager(tmp_path / "res", async_save=False)
    tmpl = {"w": torch.zeros(3), "h": torch.zeros(2, dtype=torch.bfloat16)}
    state, cursor = resume_or_init(mgr, tmpl, lambda: {"w": torch.ones(3)})
    assert cursor == 0 and float(state["w"][0]) == 1.0
    mgr.save(42, {"w": torch.full((3,), 7.0), "h": torch.full((2,), 0.5, dtype=torch.bfloat16)},
             extra={"data_cursor": 42})
    state, cursor = resume_or_init(mgr, tmpl, lambda: {"w": torch.ones(3)})
    assert cursor == 42 and float(state["w"][0]) == 7.0
    assert state["h"].dtype == torch.bfloat16 and float(state["h"][1]) == 0.5

    s = StragglerStats()
    assert not any(s.update(1.0, sigma=4.0, alpha=0.1) for _ in range(20))
    assert s.update(10.0, sigma=4.0, alpha=0.1) and s.n_flagged == 1


def _state_bytes(state):
    params, opt = state
    return [t.contiguous().view(torch.uint8) if t.dtype != torch.int32 else t
            for _, t in tree_paths({"p": params, "m": opt.m, "v": opt.v, "s": opt.step})]


def test_train_cli_resumes_byte_for_byte_and_serve_cli_completes(tmp_path, capsys):
    args = ["--smoke", "--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-every", "3",
            "--device", "cpu"]
    full = t_train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert full["summary"]["step"] == 6 and not full["summary"]["preempted"]
    assert all(np.isfinite(full["loss"])) and len(full["loss"]) == 6
    part = t_train.train(smoke=True, steps=6, batch=2, seq=16, ckpt_every=3, device="cpu",
                         ckpt_dir=str(tmp_path / "b"), stop_after=4)
    assert part["summary"]["step"] == 4
    resumed = t_train.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--auto-resume"])
    assert resumed["start"] == 4 and resumed["step"] == [5, 6]
    assert resumed["loss"] == full["loss"][4:]
    assert all(torch.equal(a, b) for a, b in zip(_state_bytes(resumed["state"]),
                                                 _state_bytes(full["state"])))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_train.main(args + ["--ckpt-dir", str(tmp_path / "c"), "--compress-grads"])
    for arch in ("qwen1_5-0_5b", "qwen2-vl-2b"):
        out = t_serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len",
                            "5", "--max-new", "4", "--requests", "3"])
        assert out["completed"] >= 3 and out["tok_s"] > 0
    assert "served" in capsys.readouterr().out


def test_param_counts_and_unported_archs():
    for arch in DENSE:
        assert counting.param_count(get_config(arch)) == j_get_config(arch).param_count(), arch
    assert counting.param_count(get_config("qwen1.5-0.5b")) == 463_987_712
    names = lambda archs: sorted(get_config(a).name for a in archs)  # noqa: E731
    assert names(DENSE + list(OTHERS)) == names(list_archs())
    for arch, item in OTHERS.items():
        with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
            LM(get_smoke_config(arch), device="cpu")


def test_phase_12_rehearsal_on_the_cpu(tmp_path):
    """chip_smoke's phase 12 (`smoke_lm`) on qwen1.5-0.5b's smoke config:
    the five training runs (the merged ones byte-identical from one seed
    and across the stop at 20 and the resume), serving, prefill / decode
    against the full forward, and the f32 forward against itself, at the
    CLI's peak lr.  A run at lr 0 leaves the held-out batches' loss exactly
    where it was and fails the training gate."""
    from repro_torch import smoke_lm
    size = {"batch": 8, "seq": 64}
    runs = smoke_lm.train_runs("cpu", smoke=True, lr=3e-3, **size)
    assert smoke_lm.check_train_runs(runs, on_card=False) == []
    steps = 3
    still = smoke_lm.train_run("cpu", str(tmp_path), smoke=True, steps=steps, lr=0.0,
                               ckpt_every=steps + 1, **size)
    still["probe_loss"] = smoke_lm.probe_loss("cpu", still["state"][0], smoke=True, **size)
    assert smoke_lm.probe_fall(runs["probe"], still) == 0.0
    assert not smoke_lm.trains(runs["probe"], still, steps)
    assert runs["stopped_at"] == smoke_lm.LM_STOP and all(runs["resume"].values())
    served = smoke_lm.serve_run("cpu", runs["dedup"]["state"][0], smoke=True)
    assert served["completed"] == served["requests"] == 8
    assert smoke_lm.decode_parity("cpu", runs["dedup"]["state"][0], smoke=True)["ok"]
    assert smoke_lm.cpu_parity("cpu", smoke=True)["ok"]
