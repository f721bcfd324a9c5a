"""DeepSeek's MLA attention, its mixture-of-experts and the MTP head in the
port against the JAX package on the CPU.

Tolerances (f32 throughout; the same operations in the same order, matmul
accumulation orders differ): `route`'s expert ids exactly, in order, a
constructed tie included (the lower index first, as `jax.lax.top_k`), its
gates within 1e-6; `moe_dense` within 2e-6; `mla_attention` and the absorbed
`mla_decode_attention` within 2e-5 of JAX's, and the absorbed decode within
the reference test's 2e-4 of the expanded attention
(`tests/test_attention.py`).  For both deepseek smoke configs, with params
bridged from `repro.models.lm.LM.init`: the forward logits within 2e-5,
the loss (with the MTP head's on deepseek-v3) within 2e-6, every gradient
within 1e-6 (`router_bias`'s zeros exactly), `prefill` and three
`decode_step`s within 2e-5, the chunked attention within 2e-5 of the dense
path, remat on the bytes of remat off, and ``dedup_embed_grad=True`` the
bytes of the default backward.  Then `param_count` / `active_param_count`
of both full configs equal to the reference's, both CLIs on deepseek-v3's
smoke config (the train CLI's resume byte for byte), and a CPU rehearsal of
chip_smoke's phase 13 (`smoke_moe`).
"""
import dataclasses
import functools
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.models import attention as j_attention
from repro.models import moe as j_moe
from repro.models.lm import LM as JLM
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import attention as t_attention
from repro_torch.models import counting
from repro_torch.models import moe as t_moe
from repro_torch.models.lm import LM
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_from_paths, tree_paths
from repro_torch.runtime import resume_or_init

DEEPSEEK = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 2e-5, 2e-6, 1e-6
GATE_TOL, MOE_TOL, MLA_TOL = 1e-6, 2e-6, 2e-5
ABSORBED_TOL = 2e-4          # tests/test_attention.py's absorbed-vs-expanded tolerance


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


@functools.lru_cache(maxsize=None)
def _j_init(arch):
    """`repro.models.lm.LM.init` of `arch`'s smoke config, seed 0 (each
    arch's init compiled once for the whole file)."""
    return _jit(JLM(j_get_smoke(arch)).init, jax.random.PRNGKey(0))


def _layer0(tree, *keys):
    """The first layer's leaves of a stacked JAX subtree."""
    for k in keys:
        tree = tree[k]
    return jax.tree.map(lambda t: t[0], tree)


def _moe_cfg(arch, **moe_overrides):
    """(JAX config, port config) of `arch`'s smoke config with its MoE
    fields replaced."""
    jc, tc = j_get_smoke(arch), get_smoke_config(arch)
    return (dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe_overrides)),
            dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe_overrides)))


def _moe_params(arch, n_shared=True):
    """An MoE layer's params from `arch`'s init (its first MoE layer)."""
    jp = dict(_layer0(_j_init(arch), "seg1_mla_moe", "moe"))
    if not n_shared:
        del jp["shared"]
    return jp, bridge.params_to_torch(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("arch", DEEPSEEK)     # softmax scores; sigmoid with a bias
def test_route_ids_exact_and_gates_match_jax(arch, rng):
    jc, tc = _moe_cfg(arch, top_k=3)
    jp, tp = _moe_params(arch)
    bias = rng.normal(size=jc.moe.n_routed).astype(np.float32) * 0.1
    jp["router_bias"], tp["router_bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    x = rng.normal(size=(40, jc.d_model)).astype(np.float32)
    # a constructed tie: experts 1 and 6 score alike on every token (the
    # first four tokens lean towards them), and the last rows score all
    # experts alike (the lowest ids win, in order)
    router = np.asarray(jp["router"]).copy()
    router[:, 6] = router[:, 1]
    x[:4] = router[:, 1] / np.linalg.norm(router[:, 1]) * np.float32(3.0)
    x[-4:] = 0.0
    jp["router"], tp["router"] = jnp.asarray(router), torch.from_numpy(router)
    if jc.moe.score == "sigmoid":
        b = bias.copy()
        b[6] = b[1]
        jp["router_bias"], tp["router_bias"] = jnp.asarray(b), torch.from_numpy(b)
    want_g, want_i = _jit(lambda p, v: j_moe.route(p, v, jc.moe), jp, jnp.asarray(x))
    got_g, got_i = t_moe.route(tp, torch.from_numpy(x), tc.moe)
    assert got_i.dtype == torch.int32
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_g.numpy(), _np(want_g), atol=GATE_TOL, rtol=0)
    tied = (got_i == 1).any(-1) & (got_i == 6).any(-1)
    assert tied.any()       # both tied experts selected somewhere, 1 before 6
    rows = got_i[tied].tolist()
    assert all(r.index(1) < r.index(6) for r in rows)
    if jc.moe.score == "softmax":
        assert got_i[-1].tolist() == [0, 1, 2]


@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_dense_matches_jax(n_shared, rng):
    jc, tc = _moe_cfg("deepseek-v2-lite-16b", n_shared=n_shared)
    jp, tp = _moe_params("deepseek-v2-lite-16b", n_shared)
    assert ("shared" in tp) == bool(n_shared)
    x = rng.normal(size=(2, 7, jc.d_model)).astype(np.float32)
    want = _jit(lambda p, v: j_moe.moe_layer(p, v, jc), jp, jnp.asarray(x))
    got = t_moe.moe_layer(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=MOE_TOL, rtol=0)
    # a one-device EP mesh takes the dense path; on a mesh of two gloo ranks
    # moe_layer is moe_ep, on both ranks
    one = types.SimpleNamespace(shape={"model": 1})
    assert torch.equal(t_moe.moe_layer(tp, torch.from_numpy(x), tc, one), got)
    ranks = _two_rank_moe_layer()[n_shared]
    assert len(ranks) == 2
    for res in ranks:
        assert res["mesh"] == {"data": 1, "model": 2}
        assert np.array_equal(res["layer"], res["ep"]) and np.isfinite(res["ep"]).all()
    assert np.array_equal(ranks[0]["layer"], ranks[1]["layer"])


@functools.lru_cache(maxsize=None)
def _two_rank_moe_layer():
    """`moe_layer` and `moe_ep` of the first MoE layer's params (without and
    with the shared experts) on x = the `rng` fixture's first (2, 7, d)
    draw, on a (1, 2) mesh of two gloo ranks: {n_shared: [rank 0, rank 1]}."""
    flat = {"x": np.random.default_rng(0).normal(
        size=(2, 7, j_get_smoke("deepseek-v2-lite-16b").d_model)).astype(np.float32)}
    for n_shared in (0, 2):
        _, tp = _moe_params("deepseek-v2-lite-16b", n_shared)
        flat.update({f"p{n_shared}/" + "/".join(p): t.numpy() for p, t in tree_paths(tp)})
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/inputs.npz", **flat)
        ranks = _torch_ranks.start_ranks("moe_layer_vs_moe_ep", 2, f"{tmp}/inputs.npz",
                                         (0, 2)).result()
    return {n: [r[n] for r in ranks] for n in (0, 2)}


@pytest.mark.parametrize("arch", DEEPSEEK)     # a direct q projection; q_lora
def test_mla_attention_and_absorbed_decode_match_jax_and_each_other(arch, rng):
    jc, tc = j_get_smoke(arch), get_smoke_config(arch)
    jp = _layer0(_j_init(arch), "seg0_mla_dense", "attn")
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    q_lora = tc.mla.q_lora
    assert ("wq_a" in tp) == bool(q_lora) and ("wq" in tp) == (not q_lora)
    b, s = 2, 10
    x = rng.normal(size=(b, s, jc.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32)[None], (b, 1))
    want = _jit(lambda p, v, q: j_attention.mla_attention(p, jc, v, q), jp, jnp.asarray(x),
                jnp.asarray(pos))
    full = t_attention.mla_attention(tp, tc, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(full.numpy(), _np(want), atol=MLA_TOL, rtol=0)

    def j_decode(p, v):
        cache = j_attention.init_mla_cache(jc, b, s, jnp.float32)
        outs = []
        for t in range(s):
            o, cache = j_attention.mla_decode_attention(p, jc, v[:, t: t + 1], cache,
                                                        jnp.full((b, 1), t, jnp.int32))
            outs.append(o)
        return jnp.concatenate(outs, axis=1), cache

    want_dec, want_cache = _jit(j_decode, jp, jnp.asarray(x))
    cache = t_attention.init_mla_cache(tc, b, s, torch.float32)
    outs = []
    for t in range(s):
        o, cache = t_attention.mla_decode_attention(tp, tc, torch.from_numpy(x[:, t: t + 1]),
                                                    cache, torch.full((b, 1), t,
                                                                      dtype=torch.int32))
        outs.append(o)
    dec = torch.cat(outs, dim=1)
    np.testing.assert_allclose(dec.numpy(), _np(want_dec), atol=MLA_TOL, rtol=0)
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[key].numpy(), _np(want_cache[key]), atol=MLA_TOL,
                                   rtol=0)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=ABSORBED_TOL, rtol=ABSORBED_TOL)
    # the prefill variant returns the latents the decode wrote
    _, c_kv, k_rope = t_attention.mla_attention_with_cache(tp, tc, torch.from_numpy(x),
                                                           torch.from_numpy(pos))
    np.testing.assert_allclose(c_kv.numpy(), cache["c_kv"].numpy(), atol=MLA_TOL, rtol=0)
    np.testing.assert_allclose(k_rope.numpy(), cache["k_rope"].numpy(), atol=MLA_TOL, rtol=0)


def _pair(arch, **overrides):
    """(JAX model, port model, JAX params, the same params bridged)."""
    jm = JLM(dataclasses.replace(j_get_smoke(arch), **overrides))
    jp = _j_init(arch)
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jm, LM(dataclasses.replace(get_smoke_config(arch), **overrides), device="cpu"), jp, tp


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _loss_and_grads(model, params, batch):
    live = tree_from_paths([(p, t.detach().clone().requires_grad_())
                            for p, t in tree_paths(params)])
    loss = model.loss(live, batch)
    grads = torch.autograd.grad(loss, [t for _, t in tree_paths(live)], allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip([p for p, _ in tree_paths(live)], grads))


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_deepseek_forward_loss_grads_decode_chunked_remat_and_dedup_match_jax(arch, rng,
                                                                              monkeypatch):
    jm, tm, jp, tp = _pair(arch)
    assert ("mtp" in tp) == bool(tm.cfg.mtp_depth)
    assert tp["seg1_mla_moe"]["moe"]["router"].dtype == torch.float32
    toks = rng.integers(0, tm.cfg.vocab, (2, 12)).astype(np.int32)
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
        assert g.dtype == _leaf(tp, path).dtype, path
        np.testing.assert_allclose(g.numpy(), _np(wg), atol=GRAD_TOL, rtol=0, err_msg=str(path))
    for path, g in grads.items():
        if path[-1] == "router_bias":
            assert not g.any(), path
    # prefill, then three decode steps (JAX's decode step compiled once)
    stoks = rng.integers(1, tm.cfg.vocab, (2, 11)).astype(np.int32)
    s = 8
    logits, jcache, _ = _jit(lambda p, t: jm.prefill(p, tokens=t, max_seq=s + 4), jp,
                             jnp.asarray(stoks[:, :s]))
    want = [logits]
    j_decode = jax.jit(jm.decode_step).lower(
        jp, jcache, jnp.asarray(stoks[:, s: s + 1]), jnp.full((2, 1), s, jnp.int32)).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    for k in range(3):
        logits, jcache = j_decode(jp, jcache, jnp.asarray(stoks[:, s + k: s + k + 1]),
                                  jnp.full((2, 1), s + k, jnp.int32))
        want.append(logits)
    tl, tc, _ = tm.prefill(tp, tokens=torch.from_numpy(stoks[:, :s]), max_seq=s + 4)
    np.testing.assert_allclose(tl.numpy(), _np(want[0]), atol=LOGITS_TOL, rtol=0)
    for k in range(3):
        pos = torch.full((2, 1), s + k, dtype=torch.int32)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(stoks[:, s + k: s + k + 1]), pos)
        np.testing.assert_allclose(tl.numpy(), _np(want[k + 1]), atol=LOGITS_TOL, rtol=0)
    assert [p for p, _ in tree_paths(tc)] == [
        tuple(getattr(k, "key", k) for k in kp)
        for kp, _ in jax.tree_util.tree_flatten_with_path(jcache)[0]]
    for (path, c), wc in zip(tree_paths(tc), jax.tree_util.tree_leaves(jcache)):
        np.testing.assert_allclose(c.numpy(), _np(wc), atol=LOGITS_TOL, rtol=0,
                                   err_msg=str(path))
    empty = tm.init_caches(2, s + 4)
    assert [(p, c.shape, c.dtype) for p, c in tree_paths(empty)] == \
        [(p, c.shape, c.dtype) for p, c in tree_paths(tc)]
    # the chunked online softmax against the dense path, in the whole model
    monkeypatch.setattr(t_attention, "_CHUNKED_THRESHOLD", 0)
    monkeypatch.setattr(t_attention, "_Q_CHUNK", 5)
    monkeypatch.setattr(t_attention, "_K_CHUNK", 4)
    chunked, _ = tm.forward(tp, tokens=tb["tokens"])
    np.testing.assert_allclose(chunked.numpy(), got_logits.numpy(), atol=LOGITS_TOL, rtol=0)
    chunked_loss, _ = _loss_and_grads(tm, tp, tb)
    assert abs(float(chunked_loss) - float(loss)) <= LOSS_TOL
    monkeypatch.undo()
    # remat on: the same bytes as remat off; the merged embedding backward
    # (its plain version here): the same bytes as the default's
    for override in ({"remat": True}, {"dedup_embed_grad": True}):
        other = LM(dataclasses.replace(tm.cfg, **override), device="cpu")
        o_loss, o_grads = _loss_and_grads(other, tp, tb)
        assert torch.equal(o_loss, loss), override
        assert all(torch.equal(o_grads[p], grads[p]) for p in grads), override


def test_param_counts_of_both_deepseek_configs():
    """The reference's counts (its `param_count`, and the active counts its
    `active_param_count` gives: 2,661,151,872 and 49,162,358,528)."""
    want = {"deepseek-v2-lite-16b": (15_706_485_888, 2_661_151_872),
            "deepseek-v3-671b": (682_636_480_256, 49_162_358_528)}
    for arch, (total, active) in want.items():
        cfg = get_config(arch)
        assert counting.param_count(cfg) == j_get_config(arch).param_count() == total, arch
        assert counting.active_param_count(cfg) == active, arch
    cut = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=3)
    assert counting.param_count(cut) == 1_670_135_424


def _state_bytes(state):
    params, opt = state
    return [t.contiguous().view(torch.uint8) if t.dtype != torch.int32 else t
            for _, t in tree_paths({"p": params, "m": opt.m, "v": opt.v, "s": opt.step})]


def test_deepseek_v3_clis_train_resume_byte_for_byte_and_serve(tmp_path, capsys):
    args = ["--arch", "deepseek-v3-671b", "--smoke", "--steps", "4", "--batch", "2", "--seq",
            "16", "--ckpt-every", "2", "--device", "cpu"]
    full = t_train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert full["summary"]["step"] == 4 and all(np.isfinite(full["loss"]))
    part = t_train.train("deepseek-v3-671b", smoke=True, steps=4, batch=2, seq=16,
                         ckpt_every=2, device="cpu", ckpt_dir=str(tmp_path / "b"),
                         stop_after=2)
    assert part["summary"]["step"] == 2
    resumed = t_train.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--auto-resume"])
    assert resumed["start"] == 2 and resumed["step"] == [3, 4]
    assert resumed["loss"] == full["loss"][2:]
    assert all(torch.equal(a, b) for a, b in zip(_state_bytes(resumed["state"]),
                                                 _state_bytes(full["state"])))
    # no checkpoints: nothing written, the same bytes; nothing to resume from
    bare = t_train.train("deepseek-v3-671b", smoke=True, steps=4, batch=2, seq=16,
                         device="cpu", ckpt_dir=str(tmp_path / "none"), checkpoints=False)
    assert not (tmp_path / "none").exists() and bare["loss"] == full["loss"]
    assert all(torch.equal(a, b) for a, b in zip(_state_bytes(bare["state"]),
                                                 _state_bytes(full["state"])))
    with pytest.raises(ValueError, match="checkpoints"):
        t_train.train("deepseek-v3-671b", smoke=True, steps=4, device="cpu",
                      checkpoints=False, auto_resume=True)
    # the f32 router leaves stay f32 through AdamW and the checkpoint
    params, opt = resumed["state"]
    assert params["seg1_mla_moe"]["moe"]["router_bias"].dtype == torch.float32
    assert opt.m["seg1_mla_moe"]["moe"]["router"].dtype == torch.float32
    out = t_serve.main(["--arch", "deepseek-v3-671b", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "5", "--max-new", "4", "--requests", "3"])
    assert out["completed"] >= 3 and out["tok_s"] > 0 and out["finite"]
    assert "served" in capsys.readouterr().out


def test_bf16_router_leaves_stay_f32_through_the_bridge_a_step_and_a_checkpoint(tmp_path):
    """In a bf16 model the router and its bias are f32 (the reference's
    `init_moe`); the bridge, AdamW and a checkpoint round trip keep every
    leaf's dtype."""
    cfg = dataclasses.replace(j_get_smoke("deepseek-v2-lite-16b"), dtype="bfloat16")
    shapes = jax.eval_shape(JLM(cfg).init, jax.random.PRNGKey(0))   # the bf16 init's dtypes
    jp = jax.tree.map(lambda x, a: x.astype(a.dtype), _j_init("deepseek-v2-lite-16b"), shapes)
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    dtypes = [(p, t.dtype) for p, t in tree_paths(tp)]
    assert [str(d).split(".")[-1] for _, d in dtypes] == \
        [str(w.dtype) for w in jax.tree_util.tree_leaves(jp)]
    moe_p = tp["seg1_mla_moe"]["moe"]
    assert moe_p["router"].dtype == moe_p["router_bias"].dtype == torch.float32
    assert moe_p["w_gate"].dtype == torch.bfloat16
    model = LM(dataclasses.replace(get_smoke_config("deepseek-v2-lite-16b"), dtype="bfloat16"),
               device="cpu")
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


def test_the_three_archs_beyond_mla_and_moe_construct():
    """Of the three archs not ported with MLA + MoE, the SSM two construct
    since slice 18 (`tests/test_torch_lm_ssm.py`) and whisper-medium since
    slice 19 (`tests/test_torch_lm_whisper.py`), its count JAX's."""
    for arch in ("falcon-mamba-7b", "zamba2-7b", "whisper-medium"):
        assert LM(get_smoke_config(arch), device="cpu").segs
    assert counting.param_count(get_config("whisper-medium")) == \
        j_get_config("whisper-medium").param_count() == 811_579_392


def test_phase_13_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke's phase 13 (`smoke_moe`) on the smoke configs: three
    deepseek-v2-lite runs (the merged ones byte-identical from one seed),
    the deepseek-v3 merged run stopped halfway and resumed, prefill / decode
    against the full forward at f32 with its routing decisions, the f32
    forward and the step-1 loss against themselves, serving.  A run at lr
    0 leaves the held-out loss where it was and fails the training gate."""
    from repro_torch import smoke_lm, smoke_moe
    size = {"batch": 4, "seq": 32}
    steps, stop = 12, 6
    runs = smoke_moe.train_runs("cpu", smoke=True, steps=steps, lr=3e-3, probe_batch=4,
                                **size)
    assert smoke_moe.check_train_runs(runs, steps, on_card=False) == []
    still = smoke_lm.train_run("cpu", str(tmp_path), smoke_moe.MOE_ARCH, smoke=True,
                               steps=3, lr=0.0, ckpt_every=4, **size)
    still["probe_loss"] = smoke_lm.probe_loss("cpu", still["state"][0], smoke_moe.MOE_ARCH,
                                              smoke=True, **size)
    assert smoke_lm.probe_fall(runs["probe"], still) == 0.0
    assert not smoke_lm.trains(runs["probe"], still, 3)
    # a held-out batch of more than PROBE_ROWS rows, taken in row chunks:
    # the whole batch's loss
    probe = dict(arch=smoke_moe.MOE_ARCH, smoke=True, batch=2 * smoke_lm.PROBE_ROWS, seq=32,
                 batches=2)
    chunked = smoke_lm.probe_losses("cpu", runs["dedup"]["state"][0], **probe)
    monkeypatch.setattr(smoke_lm, "PROBE_ROWS", 4 * smoke_lm.PROBE_ROWS)
    whole = smoke_lm.probe_losses("cpu", runs["dedup"]["state"][0], **probe)
    monkeypatch.undo()
    np.testing.assert_allclose(chunked, whole, atol=1e-5, rtol=0)
    mtp = smoke_moe.mtp_runs("cpu", steps=steps, stop=stop, **size)
    assert smoke_moe.check_mtp_runs(mtp, steps, stop, on_card=False) == []
    params = runs["dedup"]["state"][0]
    dec = smoke_moe.decode_parity("cpu", params, smoke=True)
    assert dec["ok"] and dec["routes"]["flips"] == 0
    n_moe = 2 * 4 * (16 + smoke_lm.DECODE_STEPS)       # layers x batch x tokens
    assert dec["routes"]["decisions"] == n_moe and dec["routes"]["min_margin"] > 0
    cpu = smoke_moe.cpu_parity("cpu", params, smoke=True)
    assert cpu["ok"] and cpu["max_abs_err"] == 0.0 and cpu["routes"]["flips"] == 0
    loss = smoke_moe.mtp_loss_parity("cpu")
    assert loss["ok"] and loss["abs_err"] == 0.0 and loss["routes"]["flips"] == 0
    served = smoke_moe.serve_run("cpu", smoke=True)
    assert served["completed"] == served["requests"] == 8 and served["finite"]
    assert smoke_moe.route_flips(
        [(torch.tensor([[0.5, 0.3, 0.2]]), torch.tensor([[0]]))],
        [(torch.tensor([[0.3, 0.5, 0.2]]), torch.tensor([[1]]))]) == {
            "decisions": 1, "flips": 1, "min_margin_flipped": pytest.approx(0.2),
            "min_margin": pytest.approx(0.2)}
