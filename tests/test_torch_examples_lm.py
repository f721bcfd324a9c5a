"""The port's LM example scripts (`repro_torch.examples.lm_pretrain`,
`repro_torch.examples.serve_lm`) against the JAX package's on the CPU.

* `lm_pretrain`: qwen1.5-0.5b's smoke config at batch 2, seq 16, 8 steps,
  on params bridged from `repro.models.lm.LM.init(PRNGKey(0))` and the
  stream's batches: each step's loss through the script's `train_step`
  (`loss.backward()` and `AdamW.apply`) within 1e-5 relative of a JAX loop
  built as ``examples/lm_pretrain.py`` builds its `train_step`
  (`value_and_grad` of `LM.loss`, then `AdamW.apply`, jitted) at f32.  The
  CLI at the script's batch and seq, run twice into one checkpoint
  directory: the second run, with more ``--steps``, prints ``auto-resumed
  at step N`` and goes on from N.
* `serve_lm`: batch 2, prompt 8, 4 greedy steps on bridged f32 params of
  qwen3-8b's, falcon-mamba-7b's and whisper-medium's smoke configs (the
  last with the audio stub's frame embeddings): the ids equal those of
  ``examples/serve_lm.py``'s loop (prefill, then its jitted `decode_step`
  on the same draws) exactly.
* Both CLIs at their default ``--device cuda`` raise without a card.
* Phase 18 of ``chip_smoke.py`` rehearsed on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.data import LMStreamConfig as JStreamConfig
from repro.data import SyntheticLMStream as JStream
from repro.models.lm import LM as JLM
from repro.optim import AdamW as JAdamW
from repro.optim import schedule as j_schedule
from repro_torch import bridge, smoke_examples
from repro_torch.configs import get_smoke_config
from repro_torch.data import LMStreamConfig, SyntheticLMStream
from repro_torch.examples import lm_pretrain, serve_lm
from repro_torch.models.lm import LM

LOSS_RTOL = 1e-5
ARCH, BATCH, SEQ, STEPS = "qwen1.5-0.5b", 2, 16, 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _bridged(arch):
    """(JAX model, its params from PRNGKey(0), the same params on the CPU)."""
    jm = JLM(j_get_smoke(arch))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jm, jp, bridge.params_to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _jax_losses(jm, jp, steps):
    opt = JAdamW(lr=j_schedule.warmup_cosine(3e-3, 10, steps), clip_norm=1.0,
                 weight_decay=0.01)

    @jax.jit
    def train_step(state, batch):
        params, opt_state = state
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        params, opt_state = opt.apply(params, grads, opt_state)
        return (params, opt_state), loss

    stream = JStream(JStreamConfig(jm.cfg.vocab, SEQ, BATCH))
    state, losses = (jp, opt.init(jp)), []
    for _, b in zip(range(steps), stream.iterator()):
        state, loss = train_step(state, {"tokens": jnp.asarray(b["tokens"])})
        losses.append(float(loss))
    return losses


def test_lm_pretrain_steps_equal_jax():
    jm, jp, tp = _bridged(ARCH)
    want = _jax_losses(jm, jp, STEPS)
    model, opt = lm_pretrain.build(ARCH, STEPS, "cpu")
    stream = SyntheticLMStream(LMStreamConfig(model.cfg.vocab, SEQ, BATCH))
    state, got = (tp, opt.init(tp)), []
    for _, b in zip(range(STEPS), stream.iterator()):
        state, loss = lm_pretrain.train_step(model, opt, state, b)
        got.append(loss)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_lm_pretrain_cli_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--ckpt-dir", str(tmp_path)]     # the script's batch and seq
    first = lm_pretrain.main(argv + ["--steps", "10"])
    assert first["start"] == 0 and len(first["losses"]) == 10
    assert "auto-resumed" not in capsys.readouterr().out
    second = lm_pretrain.main(argv + ["--steps", "20"])
    printed = capsys.readouterr().out
    assert "auto-resumed at step 10" in printed and "step   20  loss" in printed
    assert second["start"] == 10 and len(second["losses"]) == 10
    assert second["summary"]["step"] == 20


@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b", "whisper-medium"])
def test_serve_lm_ids_equal_jax(arch):
    b, p, steps = 2, 8, 4
    jm, jp, tp = _bridged(arch)
    cfg = jm.cfg
    rng = np.random.default_rng(0)
    prompts = jnp.asarray(rng.integers(1, cfg.vocab, (b, p)), jnp.int32)
    kw = {}
    if cfg.frontend == "audio_stub":
        kw["encoder_embeds"] = jnp.asarray(
            rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)), jnp.float32)
    logits, caches, enc_out = jm.prefill(jp, tokens=prompts, max_seq=p + steps + 1, **kw)
    decode = jax.jit(lambda pr, c, t, pos: jm.decode_step(pr, c, t, pos, encoder_out=enc_out))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    want = [tok]
    for step in range(steps):
        logits, caches = decode(jp, caches, tok, jnp.full((b, 1), p + step, jnp.int32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        want.append(tok)
    out = serve_lm.generate(LM(get_smoke_config(arch), device="cpu"), tp, b, p, steps)
    assert out["finite"]
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(jnp.concatenate(want, 1)))


@pytest.mark.parametrize("script", [lm_pretrain, serve_lm])
def test_examples_need_a_card_by_default(script, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    argv = ["--steps", "1"] + (["--ckpt-dir", str(tmp_path)] if script is lm_pretrain else [])
    with pytest.raises((RuntimeError, AssertionError)):
        script.main(argv)


def test_phase_18_rehearsal_on_the_cpu(capsys):
    """Phase 18 of ``chip_smoke.py`` (`repro_torch.smoke_examples`) on the
    CPU: both scripts at their defaults, with its gates."""
    out = smoke_examples.examples_phase("cpu", "cpu rehearsal")
    assert out["pretrain"]["losses"][-1] < out["pretrain"]["losses"][0]
    assert all(r["finite"] for r in out["served"].values())
    assert sorted(out["launches"]) == ["example_lm_pretrain", "example_serve_lm"]
    printed = capsys.readouterr().out
    assert "examples serve_lm whisper-medium" in printed and "examples phase" in printed
