"""The port's entry points on the CPU: the training CLI, the quickstart and
the service demo, and the small APIs they call, against the JAX package.

* `repro_torch.examples.train_nerf_instant3d.main` trains its own
  configuration (768 rays x 24 samples, L=6) for 2 steps, resumes to 4
  (``--auto-resume``), and must end on the bytes of an uninterrupted
  4-step run, whose ``--trace-out`` trace `tools/check_trace.py --require
  trainer/step` accepts;
* the CLI restores a checkpoint that the reference's `CheckpointManager`
  wrote in the reference CLI's tree (``params``, ``opt``, ``occ``,
  ``occ_step``; from `repro.core.Instant3DTrainer.init` at the CLI's
  configuration, moments and EMA filled with seeded values), bit for bit,
  also without ``occ_step``;
* `quickstart.main(iters=2)` and `reconstruct_service` with
  ``--async-serving --device cpu`` at a tiny size;

The CLI's and the quickstart's scenes are built at 16x16, 4 views and 32
ground-truth samples (`small_scenes`); their trainer configurations stay
the scripts' own.
* `Field.param_counts` and `HashEncoding.param_bytes` equal the JAX
  package's; `configure`, `traced`, `record`, `Registry.get` and
  `Registry.names` behave as the reference's.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import Field as JField, FieldConfig as JFieldConfig
from repro.core import Instant3DTrainer as JTrainer, TrainerConfig as JTrainerConfig
from repro.core import occupancy as j_occ
from repro.core.rendering import RenderConfig as JRenderConfig
from repro.obs import metrics as j_metrics
from repro.obs import trace as j_trace
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.field import Field, FieldConfig
from repro_torch.examples import quickstart, reconstruct_service
from repro_torch.examples import train_nerf_instant3d as cli
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adamw import tree_paths
from repro_torch.serve3d import DONE, RenderResult

ROOT = Path(__file__).resolve().parents[1]
CLI_FIELD = dict(n_levels=6, max_resolution=96, log2_table_density=13, log2_table_color=11)


@pytest.fixture(autouse=True)
def _one_thread_and_clean_obs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    was = obs_trace.enabled()
    yield
    obs_trace.set_enabled(was)
    obs_trace.clear()
    obs_metrics.REGISTRY.reset()
    torch.set_num_threads(n)


@pytest.fixture
def small_scenes(monkeypatch):
    for mod in (cli, quickstart):
        def small(seed, real=mod.build_dataset, **kw):
            return real(seed, **{**kw, "n_views": 4, "h": 16, "w": 16, "gt_samples": 32})
        monkeypatch.setattr(mod, "build_dataset", small)


def _cli(tmp_path, *argv):
    return cli.main(["--device", "cpu", "--ckpt-dir", str(tmp_path), *argv])


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_paths(a), tree_paths(b)))


# ---- the training CLI ----

def test_cli_resume_is_an_uninterrupted_run(tmp_path, capsys, small_scenes):
    first = _cli(tmp_path / "a", "--iters", "2", "--ckpt-every", "2")
    assert first["start"] == 0 and first["state"].step == 2
    resumed = _cli(tmp_path / "a", "--iters", "4", "--ckpt-every", "2", "--auto-resume")
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert resumed["start"] == 2 and resumed["state"].step == 4
    trace = tmp_path / "trace.json"
    whole = _cli(tmp_path / "b", "--iters", "4", "--ckpt-every", "2", "--trace-out", str(trace))
    a, b = resumed["state"], whole["state"]
    assert _same(a.params, b.params)
    assert _same(a.opt_state.m, b.opt_state.m) and _same(a.opt_state.v, b.opt_state.v)
    assert torch.equal(a.occ_state.density_ema, b.occ_state.density_ema)
    assert resumed["eval"] == whole["eval"]
    assert "final PSNR rgb=" in capsys.readouterr().out
    # both runs checkpointed step 4
    ckpts = [CheckpointManager(tmp_path / d) for d in ("a", "b")]
    assert [c.latest_step() for c in ckpts] == [4, 4]
    done = subprocess.run([sys.executable, str(ROOT / "tools" / "check_trace.py"), str(trace),
                           "--require", "trainer/step"], capture_output=True, text=True)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "[ok]" in done.stdout


def _reference_checkpoint(path, step: int, with_occ_step: bool) -> dict:
    """The reference CLI's checkpoint tree from `repro.core`'s
    `Instant3DTrainer.init` at the CLI's configuration, moments and EMA
    filled with seeded values, written by the reference's manager."""
    render = JRenderConfig(n_samples=24)
    trainer = JTrainer(JField(JFieldConfig(**CLI_FIELD)), JTrainerConfig(
        n_rays=768, iters=step, f_color=0.5, render=render,
        occ=j_occ.OccupancyConfig(update_interval=16, warmup_steps=32)))
    state = trainer.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(step)

    def fill(x):
        return jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32))

    opt = state.opt_state._replace(step=jnp.asarray(step, jnp.int32),
                                   m=jax.tree.map(fill, state.opt_state.m),
                                   v=jax.tree.map(lambda x: jnp.abs(fill(x)), state.opt_state.v))
    tree = {"params": state.params, "opt": opt, "occ": fill(state.occ_state.density_ema)}
    if with_occ_step:
        tree["occ_step"] = jnp.asarray(3, jnp.int32)
    ckpt = JCheckpointManager(str(path), keep_last=2)
    ckpt.save(step, tree)
    ckpt.wait()
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("with_occ_step", [True, False])
def test_cli_restores_the_reference_clis_checkpoint(tmp_path, with_occ_step):
    want = _reference_checkpoint(tmp_path, 4, with_occ_step)
    args = cli.build_parser().parse_args(["--device", "cpu", "--iters", "8"])
    trainer = cli.build_trainer(args)
    state = cli._resume(trainer, trainer.init(torch.Generator().manual_seed(0)),
                        CheckpointManager(tmp_path))
    assert state.step == 4

    def equal(got, ref):
        ref = dict(tree_paths(ref))
        for path, t in tree_paths(got):
            np.testing.assert_array_equal(t.numpy(), ref[path])

    equal(state.params, want["params"])
    equal(state.opt_state.m, want["opt"].m)
    equal(state.opt_state.v, want["opt"].v)
    assert int(state.opt_state.step) == 4
    np.testing.assert_array_equal(state.occ_state.density_ema.numpy(), want["occ"])
    assert int(state.occ_state.step) == (3 if with_occ_step else 0)
    # the reference's tree has no bookkeeping: dense until the next fold
    assert trainer._live_frac == 1.0 and not any(trainer._overflow_window)


# ---- the quickstart and the service demo ----

def test_quickstart_runs_on_the_cpu(capsys, small_scenes):
    out = quickstart.main(iters=2, device="cpu")
    text = capsys.readouterr().out
    assert "params:" in text and "PSNR: rgb=" in text
    assert np.isfinite(out["eval"]["psnr_rgb"]) and np.isfinite(out["eval"]["psnr_depth"])
    assert out["state"].step == 2
    j_counts = JField(JFieldConfig(**CLI_FIELD)).param_counts(
        JField(JFieldConfig(**CLI_FIELD)).init(jax.random.PRNGKey(0)))
    assert out["param_counts"] == j_counts


def test_reconstruct_service_async_on_the_cpu(capsys):
    out = reconstruct_service.main(["--device", "cpu", "--scenes", "2", "--iters", "16",
                                    "--slice", "4", "--hw", "8", "--async-serving"])
    text = capsys.readouterr().out
    tel = out["telemetry"]
    assert tel["async_serving"] is True and tel["scenes_done"] == 2
    assert all(s.status == DONE for s in out["service"].sessions.values())
    ids = [r.request_id for r in out["answered"]]
    assert len(out["asked"]) == 4 and sorted(ids) == sorted(out["asked"])
    assert all(isinstance(r, RenderResult) for r in out["answered"])
    assert "scenes on 1 device(s)" in text and "metrics snapshot:" in text
    with pytest.raises(NotImplementedError, match="not ported yet"):
        reconstruct_service.main(["--device", "cpu", "--scenes", "1", "--devices", "2"])


def test_entry_points_default_to_the_card():
    import inspect
    assert cli.build_parser().parse_args([]).device == "cuda"
    assert reconstruct_service.build_parser().parse_args([]).device == "cuda"
    params = inspect.signature(quickstart.main).parameters
    assert params["device"].default == "cuda" and params["iters"].default == 200


# ---- the small APIs they call ----

@pytest.mark.parametrize("field", [CLI_FIELD, dict(n_levels=4, log2_table_density=12,
                                                  log2_table_color=10, hidden=16),
                                   dict(CLI_FIELD, decomposed=False)])
def test_param_counts_and_bytes_equal_jaxs(field):
    j_field, t_field = JField(JFieldConfig(**field)), Field(FieldConfig(**field))
    t_params = t_field.init(torch.Generator().manual_seed(0), "cpu")
    want = j_field.param_counts(j_field.init(jax.random.PRNGKey(0)))
    assert t_field.param_counts(t_params) == want
    assert t_field.density_enc.param_bytes == j_field.density_enc.param_bytes
    if field.get("decomposed", True):
        assert t_field.color_enc.param_bytes == j_field.color_enc.param_bytes


def test_trace_configure_traced_record_follow_the_reference():
    obs_trace.configure(enabled=False)
    j_trace.configure(enabled=False)
    try:
        made = {}
        for mod in (obs_trace, j_trace):
            @mod.traced()
            def work(x):
                return x + 1

            @mod.traced("named/span", cat="test")
            def named():
                return 7

            mod.clear()
            assert work(1) == 2 and mod.events() == []   # decorated while off
            mod.configure(enabled=True)
            t0 = mod.clock()
            assert work(2) == 3 and named() == 7
            mod.record("manual/span", t0, t0 + 0.25, cat="test", args={"k": 1})
            mod.record("backwards", t0 + 1.0, t0, cat="test")
            mod.configure(enabled=False)
            mod.record("dropped", t0, t0 + 1.0)
            with mod.span("dropped"):
                pass
            made[mod] = [(e.name.rsplit(".", 1)[-1], e.cat, e.args) for e in mod.events()]
            durs = {e.name: e.dur_us for e in mod.events()}
            assert durs["manual/span"] == pytest.approx(0.25e6)
            assert durs["backwards"] == 0.0
        assert made[obs_trace] == made[j_trace]
        assert made[obs_trace][0][0] == "work" and made[obs_trace][1][:2] == ("named/span", "test")
        # a smaller buffer keeps the newest events
        obs_trace.configure(enabled=True, buffer_size=2)
        for k in range(4):
            obs_trace.instant(f"i{k}")
        assert [e.name for e in obs_trace.events()] == ["i2", "i3"]
    finally:
        for mod in (obs_trace, j_trace):
            mod.configure(enabled=False, buffer_size=262144)
            mod.clear()


def test_registry_get_and_names_follow_the_reference():
    regs = (obs_metrics.Registry(), j_metrics.Registry())
    for reg in regs:
        assert reg.get("a.count") is None and reg.names() == []
        reg.counter("b.count").inc(3)
        reg.gauge("a.level").set(2)
        reg.histogram("c.ms").observe(1.5)
    for reg in regs:
        assert reg.names() == ["a.level", "b.count", "c.ms"]
        assert reg.get("b.count").value == 3 and reg.get("missing") is None
    assert regs[0].snapshot() == regs[1].snapshot()
