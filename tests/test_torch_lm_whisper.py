"""Whisper's encoder-decoder (the `enc_attn` / `dec_attn` blocks, the
cross-attention and its cached keys and values, the sinusoidal positions)
and `configs/shapes.py` in the port against the JAX package on the CPU.

Tolerances: the sinusoid tables within 1e-6 abs of JAX's (the same f32
angles, the trig functions' last ulp may differ; at whisper's full
1500 x 1024 the largest difference is one ulp, 6e-8), and
`sinusoidal_at` the bytes of the table's rows; a block's output and every
gradient (params, input, encoder output) within `BLOCK_TOL` of JAX's, its
params perturbed so the biases and norms are not the init's zeros and
ones; the smoke config at f32 with params bridged from
`repro.models.lm.LM.init` and perturbed: logits, loss and every gradient
(`enc_segs` included) within `test_torch_lm_model.py`'s `LOGITS_TOL` /
`LOSS_TOL` / `GRAD_TOL`, under remat and without (remat on the bytes of
remat off) and with ``dedup_embed_grad=True`` (the default backward's
bytes); prefill, three decode steps and every cache leaf (`cross`
included) within `LOGITS_TOL`; at bf16 (the f32 init cast) the logits
within 3e-2 and the loss within 1e-2, as the dense decoders' bf16 test.
Then `param_count`, `input_specs` and `applicable` for every arch and
shape, the missing-`encoder_embeds` ValueError, a JAX whisper's params and
AdamW state through `bridge` and one step each side, the serve CLI with
the reference's draws and a reused slot, a train-and-resume run through
`train_step` and `TrainDriver`, and a CPU rehearsal of chip_smoke's phase
15 (`smoke_whisper`).
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
from repro.configs import list_archs as j_list_archs
from repro.configs import shapes as j_shapes
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tfm
from repro.models.lm import LM as JLM
from repro.models.lm import sinusoidal as j_sinusoidal
from repro.optim import AdamW as JAdamW
from repro_torch import bridge, smoke_whisper
from repro_torch.configs import get_config, get_smoke_config, list_archs, shapes
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import counting
from repro_torch.models import transformer as t_tfm
from repro_torch.models.lm import LM, sinusoidal, sinusoidal_at
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_from_paths, tree_paths

ARCH = "whisper-medium"
BLOCK_TOL = 1e-5       # test_torch_lm_ssm.py's block tolerance: O(1-10) sums over 14 rows
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 2e-5, 2e-6, 1e-6      # test_torch_lm_model.py's
SINUSOID_TOL = 1e-6


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
    return tree


def _perturb(tree, rng, scale=0.05):
    """Every leaf plus N(0, scale^2) noise, as numpy f32 (so biases and
    norm params leave the init's zeros and ones)."""
    return jax.tree.map(lambda x: (np.asarray(x, np.float32)
                                   + scale * rng.normal(size=x.shape)).astype(np.float32), tree)


def _assert_trees_close(got: dict, want, tol: float):
    want = _plain(want)
    assert [p for p, _ in tree_paths(got)] == [p for p, _ in tree_paths(want)]
    for (path, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
        assert tuple(g.shape) == np.shape(w), path
        np.testing.assert_allclose(g.detach().float().numpy(), _np(w), atol=tol, rtol=0,
                                   err_msg=str(path))


def _frames(cfg, rng, b=2):
    return rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


# --- sinusoids ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,d", [(32, 64), (1500, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoids_match_jax_and_the_rows_at_positions_are_the_tables_bytes(seq, d, dtype):
    want = _np(j_sinusoidal(seq, d, jnp.dtype(dtype)))
    got = sinusoidal(seq, d, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (seq, d)
    tol = SINUSOID_TOL if dtype == "float32" else 0.0     # one rounding of the same f32 values
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    pos = torch.from_numpy(np.random.default_rng(seq).integers(0, seq, (5, 1)).astype(np.int32))
    at = sinusoidal_at(pos, d, getattr(torch, dtype))
    assert tuple(at.shape) == (5, 1, d)
    assert torch.equal(at[:, 0], got[pos[:, 0].long()])


# --- blocks ------------------------------------------------------------------------------

@pytest.mark.parametrize("kind,with_encoder", [("enc_attn", False), ("dec_attn", True),
                                               ("dec_attn", False)])
def test_whisper_blocks_and_their_gradients_match_jax(kind, with_encoder, rng):
    """One `enc_attn` block (non-causal) and one `dec_attn` block with and
    without `encoder_out` (without: its cross-attention skipped, its
    `ln_x` / `xattn` gradients zero on both sides)."""
    jc, tc = j_get_smoke(ARCH), get_smoke_config(ARCH)
    jp = _jit(lambda k: j_tfm.init_block(k, jc, kind, jnp.float32), jax.random.PRNGKey(1))
    ours = t_tfm.init_block(torch.Generator().manual_seed(0), tc, kind, torch.float32)
    assert [(p, tuple(t.shape)) for p, t in tree_paths(ours)] == \
        [(p, np.shape(w)) for p, w in tree_paths(_plain(jax.tree.map(np.asarray, jp)))]
    params = _perturb(jp, rng)
    x = rng.normal(size=(2, 7, tc.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 9, tc.d_model)).astype(np.float32) if with_encoder else None
    r = rng.normal(size=x.shape).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32)[None], (2, 1))

    def j_loss(p, v, e):
        y = j_tfm.apply_block(p, jc, kind, v, pos, encoder_out=e)
        return jnp.sum(y * r), y

    argnums = (0, 1, 2) if with_encoder else (0, 1)
    (_, want_y), want_g = _jit(jax.value_and_grad(j_loss, argnums=argnums, has_aux=True),
                               params, x, enc)
    live = tree_from_paths([(p, torch.tensor(t, requires_grad=True))
                            for p, t in tree_paths(params)])
    tx = torch.tensor(x, requires_grad=True)
    te = torch.tensor(enc, requires_grad=True) if with_encoder else None
    y = t_tfm.apply_block(live, tc, kind, tx, torch.from_numpy(pos), te)
    np.testing.assert_allclose(y.detach().numpy(), _np(want_y), atol=BLOCK_TOL, rtol=0)
    leaves = [t for _, t in tree_paths(live)] + [tx] + ([te] if with_encoder else [])
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)), leaves, allow_unused=True,
                                materialize_grads=True)
    want = list(jax.tree_util.tree_leaves(want_g[0])) + list(want_g[1:])
    assert len(grads) == len(want)
    names = [p for p, _ in tree_paths(live)] + ["x", "encoder_out"]
    for path, g, w in zip(names, grads, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=BLOCK_TOL, rtol=0, err_msg=str(path))
    if kind == "dec_attn" and not with_encoder:
        assert not any(g.any() for (p, _), g in zip(tree_paths(live), grads)
                       if p[0] in ("ln_x", "xattn"))


# --- the model ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_init():
    return _jit(JLM(j_get_smoke(ARCH)).init, jax.random.PRNGKey(0))


def _pair(seed=3, **overrides):
    """(JAX model, port model, JAX params perturbed, the same params
    bridged)."""
    jp = _perturb(_j_init(), np.random.default_rng(seed), scale=0.02)
    return (JLM(dataclasses.replace(j_get_smoke(ARCH), **overrides)),
            LM(dataclasses.replace(get_smoke_config(ARCH), **overrides), device="cpu"),
            jax.tree.map(jnp.asarray, jp), bridge.params_to_torch(jp, "cpu"))


def _loss_and_grads(model, params, batch):
    live = tree_from_paths([(p, t.detach().clone().requires_grad_())
                            for p, t in tree_paths(params)])
    loss = model.loss(live, batch)
    grads = torch.autograd.grad(loss, [t for _, t in tree_paths(live)])
    return loss.detach(), dict(zip([p for p, _ in tree_paths(live)], grads))


def _batch(cfg, rng, b=2, s=12):
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    frames = _frames(cfg, rng, b)
    return ({"tokens": jnp.asarray(toks), "encoder_embeds": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks), "encoder_embeds": torch.from_numpy(frames)})


@functools.lru_cache(maxsize=None)
def _want_loss_logits_grads(seed):
    jm, _, jp, _ = _pair(seed)
    jb, _ = _batch(jm.cfg, np.random.default_rng(seed))

    def j_loss(p, b):
        return jm.loss(p, b), jm.forward(p, tokens=b["tokens"],
                                         encoder_embeds=b["encoder_embeds"])[0]

    return _jit(jax.value_and_grad(j_loss, has_aux=True), jp, jb)


@pytest.mark.parametrize("variant", [{}, {"remat": True}, {"dedup_embed_grad": True}])
def test_whisper_logits_loss_and_every_gradient_match_jax(variant):
    """The smoke config (2 + 2 layers, 32 frames) at f32; with remat the
    decoder's gradient reaches the encoder through `encoder_out`, an input
    of each checkpointed layer (`enc_segs`' gradients held to JAX's)."""
    seed = 3
    _, tm, _, tp = _pair(seed, **variant)
    _, tb = _batch(tm.cfg, np.random.default_rng(seed))
    (want_loss, want_logits), want_grads = _want_loss_logits_grads(seed)
    got_logits, _ = tm.forward(tp, **tb)
    np.testing.assert_allclose(got_logits.detach().numpy(), _np(want_logits), atol=LOGITS_TOL,
                               rtol=0)
    loss, grads = _loss_and_grads(tm, tp, tb)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
    want = dict(tree_paths(_plain(jax.tree.map(np.asarray, want_grads))))
    assert sorted(grads) == sorted(want) and any(p[0] == "enc_segs" for p in grads)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), _np(want[path]), atol=GRAD_TOL, rtol=0,
                                   err_msg=str(path))
    assert all(grads[p].any() for p in grads if p[0] == "enc_segs" and p[-1] != "bias")
    if variant:       # the same bytes as the plain config's
        plain = LM(get_smoke_config(ARCH), device="cpu")
        p_loss, p_grads = _loss_and_grads(plain, tp, tb)
        assert torch.equal(p_loss, loss)
        assert all(torch.equal(p_grads[p], grads[p]) for p in grads)


def test_whisper_prefill_decode_and_caches_match_jax(rng):
    """prefill of 8 tokens (encoder output returned, `cross` the encoder's
    keys and values at its own length), then three decode steps handed the
    encoder output (unread: the cross-attention reads the cache)."""
    jm, tm, jp, tp = _pair()
    toks = rng.integers(1, tm.cfg.vocab, (2, 11)).astype(np.int32)
    frames = _frames(tm.cfg, rng)
    s = 8

    def j_serve(p, t, e):
        logits, caches, enc = jm.prefill(p, tokens=t[:, :s], encoder_embeds=e, max_seq=s + 4)
        out = [logits]
        for k in range(3):
            logits, caches = jm.decode_step(p, caches, t[:, s + k: s + k + 1],
                                            jnp.full((2, 1), s + k, jnp.int32), encoder_out=enc)
            out.append(logits)
        return out, caches, enc

    want, jcache, jenc = _jit(j_serve, jp, jnp.asarray(toks), jnp.asarray(frames))
    tl, tc, enc = tm.prefill(tp, tokens=torch.from_numpy(toks[:, :s]),
                             encoder_embeds=torch.from_numpy(frames), max_seq=s + 4)
    np.testing.assert_allclose(enc.numpy(), _np(jenc), atol=LOGITS_TOL, rtol=0)
    got = [tl]
    for k in range(3):
        pos = torch.full((2, 1), s + k, dtype=torch.int32)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, s + k: s + k + 1]), pos,
                                encoder_out=enc)
        got.append(tl)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=LOGITS_TOL, rtol=0)
    _assert_trees_close(tc, jcache, LOGITS_TOL)
    assert tuple(tc["seg0_dec_attn"]["cross"]["k"].shape) == (
        tm.cfg.n_layers, 2, tm.cfg.encoder_seq, tm.cfg.n_kv_heads, tm.cfg.hd)
    empty = tm.init_caches(2, s + 4)
    assert [(p, c.shape, c.dtype) for p, c in tree_paths(empty)] == \
        [(p, c.shape, c.dtype) for p, c in tree_paths(tc)]
    assert not any(c.any() for _, c in tree_paths(empty))
    full, _ = tm.forward(tp, tokens=torch.from_numpy(toks), encoder_embeds=torch.from_numpy(frames))
    np.testing.assert_allclose(got[-1].numpy(), full[:, -1].numpy(), atol=LOGITS_TOL, rtol=0)


def test_bf16_whisper_forward_and_loss_match_jax(rng):
    """The smoke config in bf16, the f32 init's params cast: the positions
    are cast to bf16 before the add on both sides."""
    cfg = dataclasses.replace(j_get_smoke(ARCH), dtype="bfloat16")
    jm = JLM(cfg)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), _j_init())
    tm = LM(dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16"), device="cpu")
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["enc_segs"]["attn"]["wq"].dtype == tp["seg0_dec_attn"]["xattn"]["wq"].dtype \
        == torch.bfloat16
    jb, tb = _batch(tm.cfg, rng)
    want_loss, want = _jit(lambda p, b: (jm.loss(p, b), jm.forward(p, **b)[0]), jp, jb)
    got, _ = tm.forward(tp, **tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), atol=3e-2, rtol=0)
    assert abs(float(tm.loss(tp, tb)) - float(want_loss)) <= 1e-2


def test_without_encoder_embeds_an_encoder_decoder_raises_naming_them(rng):
    """forward, loss and prefill without frames raise ValueError naming
    `encoder_embeds` (the reference fails there with an AttributeError on
    None), so the training CLI, whose step feeds tokens only as the
    reference's does, refuses whisper."""
    _, tm, jp, tp = _pair()
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab, (2, 6)).astype(np.int32))
    for call in (lambda: tm.forward(tp, tokens=toks), lambda: tm.loss(tp, {"tokens": toks}),
                 lambda: tm.prefill(tp, tokens=toks, max_seq=8)):
        with pytest.raises(ValueError, match="encoder_embeds"):
            call()
    with pytest.raises(AttributeError):
        JLM(j_get_smoke(ARCH)).loss(jp, {"tokens": jnp.asarray(toks.numpy())})
    with pytest.raises(ValueError, match="encoder_embeds"):
        t_train.train(ARCH, smoke=True, steps=2, batch=2, seq=8, device="cpu",
                      checkpoints=False)


# --- counts, shapes, the bridge --------------------------------------------------------

def test_param_counts_of_whisper_and_its_smoke_config():
    assert counting.param_count(get_config(ARCH)) == j_get_config(ARCH).param_count() \
        == 811_579_392
    assert counting.param_count(get_smoke_config(ARCH)) == j_get_smoke(ARCH).param_count()
    assert counting.active_param_count(get_config(ARCH)) == 811_579_392
    model = LM(get_config(ARCH), device="meta")
    assert model.segs == [("dec_attn", 24)]
    params = model.init(None)
    assert params["enc_segs"]["attn"]["wq"].shape == (24, 1024, 16, 64)
    assert params["seg0_dec_attn"]["xattn"]["bk"].shape == (24, 16, 64)


def _spec_tree(tree):
    """(path, shape, dtype name) of every leaf of a batch spec, either side."""
    return [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tree_paths(_plain(tree))]


@pytest.mark.parametrize("shape", list(j_shapes.SHAPES))
@pytest.mark.parametrize("arch", j_list_archs())
def test_input_specs_match_jax(arch, shape):
    """The batch of each step kind on the meta device: JAX's tree, shapes
    and dtypes (decode's caches included), and `applicable`'s verdict."""
    assert list(shapes.SHAPES) == list(j_shapes.SHAPES)
    assert shapes.SHAPES[shape] == shapes.Shape(**dataclasses.asdict(j_shapes.SHAPES[shape]))
    jc, tc = j_get_config(arch), get_config(arch)
    assert shapes.applicable(tc, shape) == j_shapes.applicable(jc, shape)
    got = shapes.input_specs(tc, shapes.SHAPES[shape])
    assert all(t.device.type == "meta" for _, t in tree_paths(got))
    assert _spec_tree(got) == _spec_tree(j_shapes.input_specs(jc, j_shapes.SHAPES[shape]))


def test_a_jax_whisper_state_crosses_the_bridge_and_steps_as_jax_does(rng):
    """A JAX whisper's params and AdamW state (after one JAX step) cross
    `bridge` unchanged, both ways; one more step on each side gives
    moments within 1e-6.  (Not the params: AdamW divides each moment by
    its root, which turns the noise-level gradient of the keys' biases --
    zero in exact arithmetic, a constant added to every score of a row --
    into steps of either sign.)"""
    jm, tm, jp, tp = _pair()
    jb, tb = _batch(tm.cfg, rng)
    kw = dict(lr=1e-3, clip_norm=1.0, weight_decay=0.01)
    jopt, topt = JAdamW(**kw), AdamW(**kw)

    @jax.jit
    def j_step(p, s, b):
        grads = jax.grad(jm.loss)(p, b)
        return jopt.apply(p, grads, s)

    jp, js = j_step(jp, jopt.init(jp), jb)
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    ts = bridge.opt_to_torch(jax.tree.map(np.asarray, js), "cpu")
    for want, got in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
        for w, (_, t) in zip(jax.tree_util.tree_leaves(want), tree_paths(got)):
            assert np.array_equal(t.numpy(), np.asarray(w))
    back = bridge.params_to_numpy(tp)
    assert all(np.array_equal(b, np.asarray(w)) for (_, b), w in
               zip(tree_paths(back), jax.tree_util.tree_leaves(jp)))
    assert int(bridge.opt_to_numpy(ts)[0]) == int(js.step) == 1
    jp, js = j_step(jp, js, jb)
    tp, ts, _ = t_train.train_step(tm, topt, tp, ts, tb)
    assert int(ts.step) == int(js.step) == 2
    for want, got in ((js.m, ts.m), (js.v, ts.v)):
        for w, (path, t) in zip(jax.tree_util.tree_leaves(want), tree_paths(got)):
            np.testing.assert_allclose(t.numpy(), _np(w), atol=1e-6, rtol=0, err_msg=str(path))


# --- the CLIs ----------------------------------------------------------------------------

def test_serve_cli_serves_whisper_from_the_references_draws(monkeypatch, capsys):
    """The frames are drawn before the prompts from one generator, the
    first prefill takes all of them, and a refilled slot's prefill the
    first row (the reference's `serve.main`)."""
    calls = []
    prefill = LM.prefill

    def recording(self, params, **kw):
        calls.append({k: v.clone() for k, v in kw.items() if torch.is_tensor(v)})
        return prefill(self, params, **kw)

    monkeypatch.setattr(LM, "prefill", recording)
    out = t_serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "5",
                        "--max-new", "4", "--requests", "5"])
    assert out["completed"] >= 5 and out["tok_s"] > 0 and out["finite"]
    assert "served" in capsys.readouterr().out
    cfg = get_smoke_config(ARCH)
    draws = np.random.default_rng(0)
    frames = torch.as_tensor(draws.normal(size=(2, cfg.encoder_seq, cfg.d_model)),
                             dtype=torch.float32)
    prompts = [torch.as_tensor(draws.integers(1, cfg.vocab, (5,)), dtype=torch.int32)
               for _ in range(5)]
    assert len(calls) == 4
    assert torch.equal(calls[0]["tokens"], torch.stack(prompts[:2]))
    assert torch.equal(calls[0]["encoder_embeds"], frames)
    for call, prompt in zip(calls[1:], prompts[2:]):
        assert torch.equal(call["tokens"], prompt[None])
        assert torch.equal(call["encoder_embeds"], frames[:1])


def test_a_reused_slot_decodes_as_its_request_alone(rng):
    """`_reset_slot` copies a fresh prefill's caches, its cross keys and
    values too, into slot 1 mid-decode: slot 1 then decodes as the new
    request (with its own frames) does alone, slot 0 as before."""
    model = LM(get_smoke_config(ARCH), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    p, max_seq = 6, 12
    toks = torch.from_numpy(rng.integers(1, model.cfg.vocab, (3, p + 3)).astype(np.int32))
    frames = torch.from_numpy(_frames(model.cfg, rng, 3))
    _, caches, enc = model.prefill(params, tokens=toks[:2, :p], encoder_embeds=frames[:2],
                                   max_seq=max_seq)
    pos = torch.full((2, 1), p, dtype=torch.int32)
    _, caches = model.decode_step(params, caches, toks[:2, p: p + 1], pos, encoder_out=enc)
    _, fresh, _ = model.prefill(params, tokens=toks[2:, :p], encoder_embeds=frames[2:],
                                max_seq=max_seq)
    t_serve._reset_slot(caches, fresh, 1)
    for path, c in tree_paths(caches):
        assert torch.equal(c[:, 1:2], dict(tree_paths(fresh))[path]), path
    step = torch.stack([toks[0, p + 1], toks[2, p]])[:, None]
    got, _ = model.decode_step(params, caches, step,
                               torch.tensor([[p + 1], [p]], dtype=torch.int32))
    alone, _ = model.decode_step(params, fresh, toks[2:, p: p + 1], pos[:1])
    np.testing.assert_allclose(got[1].numpy(), alone[0].numpy(), atol=1e-5, rtol=0)
    want0, _ = model.forward(params, tokens=toks[:1, : p + 2], encoder_embeds=frames[:1])
    np.testing.assert_allclose(got[0].numpy(), want0[0, -1].numpy(), atol=1e-5, rtol=0)


def _state_bytes(state):
    params, opt = state
    return [t.contiguous().view(torch.uint8) if t.dtype != torch.int32 else t
            for _, t in tree_paths({"p": params, "m": opt.m, "v": opt.v, "s": opt.step})]


def test_train_step_under_the_driver_resumes_byte_for_byte(tmp_path):
    """`smoke_whisper.train_run` (`train_step` on the audio batch under
    `TrainDriver`): stopped at 2 of 4 steps and resumed through
    `resume_or_init`, the uninterrupted run's losses and bytes (params,
    moments, step); the batch in `input_specs`' train layout."""
    size = {"steps": 4, "batch": 2, "seq": 16, "lr": 3e-3}
    full = smoke_whisper.train_run("cpu", str(tmp_path / "a"), smoke=True, **size)
    assert full["summary"]["step"] == 4 and all(np.isfinite(full["loss"]))
    part = smoke_whisper.train_run("cpu", str(tmp_path / "b"), smoke=True, stop_after=2, **size)
    assert part["summary"]["step"] == 2 and part["loss"] == full["loss"][:2]
    resumed = smoke_whisper.train_run("cpu", str(tmp_path / "b"), smoke=True, auto_resume=True,
                                      **size)
    assert resumed["start"] == 2 and resumed["step"] == [3, 4]
    assert resumed["loss"] == full["loss"][2:]
    assert all(torch.equal(a, b) for a, b in zip(_state_bytes(resumed["state"]),
                                                 _state_bytes(full["state"])))
    cfg = get_smoke_config(ARCH)
    b = smoke_whisper.audio_batch(cfg, np.zeros((2, 16), np.int32), 5, "cpu")
    spec = shapes.input_specs(cfg, shapes.Shape("t", 16, 2, "train"))
    assert [(k, t.shape, t.dtype) for k, t in b.items()] == \
        [(k, t.shape, t.dtype) for k, t in spec.items()]
    assert torch.equal(b["encoder_embeds"],
                       smoke_whisper.audio_batch(cfg, np.ones((2, 16), np.int32), 5,
                                                 "cpu")["encoder_embeds"])


def test_phase_15_rehearsal_on_the_cpu(monkeypatch, capsys):
    """chip_smoke's phase 15 (`smoke_whisper.model_runs`) on the smoke
    config, shrunk: three runs (the merged ones byte-identical from one
    seed) with the held-out gate, prefill / decode against the full
    forward and the f32 forward against itself, serving with slots
    reused.  A run at lr 0 fails the training gate."""
    for name, value in {"TRAIN_STEPS": 12, "TRAIN_SEQ": 32, "TRAIN_LR": 3e-3,
                        "PROBE_BATCH": 16, "PARITY_PROMPT": 10,
                        "SERVE_ARGS": {"batch": 2, "prompt_len": 5, "max_new": 4,
                                       "requests": 3}}.items():
        monkeypatch.setattr(smoke_whisper, name, value)
    out = smoke_whisper.model_runs("cpu", "cpu", smoke=True)
    assert sorted(out["launches"]) == ["lm_encdec_serve", "lm_encdec_train",
                                       "lm_encdec_train_dedup"]
    assert out["parity"]["decode"]["ok"] and out["parity"]["cpu"]["max_abs_err"] == 0.0
    assert out["served"]["completed"] >= 3 and out["served"]["finite"]
    assert "lm_encdec train two dedup runs from one seed, same bytes" in capsys.readouterr().out
    monkeypatch.setattr(smoke_whisper, "TRAIN_LR", 0.0)
    with pytest.raises(RuntimeError, match="lm_encdec training gate failed"):
        smoke_whisper.model_runs("cpu", "cpu", smoke=True)


def test_every_arch_constructs():
    names = lambda archs: sorted(get_config(a).name for a in archs)  # noqa: E731
    assert names(list_archs()) == names(j_list_archs())
    for arch in list_archs():
        assert LM(get_smoke_config(arch), device="cpu").segs == \
            [tuple(s) for s in j_tfm.segments(j_get_smoke(arch))]
