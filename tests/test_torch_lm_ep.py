"""The expert-parallel MoE, the LM on a mesh and the training CLI's
parallel flags in the port against the JAX package, across gloo ranks on
the CPU.

The JAX side runs in a subprocess with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
`tests/test_sharding_and_dryrun.py` runs its meshes), so the suite itself
still sees one device; the port's side runs on 1, 2 and 4 gloo ranks
(`_torch_ranks`), all at once.  Inputs come from a numpy seed and cross as
``.npz`` files.

`moe_ep` on deepseek-v2-lite's smoke MoE layer (8 experts, top-2, d 64,
2 shared), 2 x 9 tokens (the sequence padded to the 'model' size), on
('data', 'model') meshes (1, 1), (1, 2), (1, 4) and (2, 2) with EP over
('model',), and (2, 2) over ('data', 'model') (deepseek-v3's two-axis
EP): at capacity factor 1.3 (drops happen in every case: the tokens share
an offset, so routing crowds), at 100 and on the decode path (S = 1).  On
every rank: the output and the gradients of sum(y * w) with respect to x
and every param within `EP_TOL` times the largest magnitude of JAX's (f32;
the products group differently; ~5e-7 seen), the kept assignments exactly JAX's (JAX's found by routing
each token to one of its choices at a time, with the shared experts off: a
dropped assignment's output is exactly zero); at 100 nothing dropped and
the output within that of `moe_dense`.  The decode path with EP over
('data', 'model') sums other batch blocks' tokens in the reference (its
all-reduce spans 'data', which also shards the batch): the port does
what JAX does there, and differs from `moe_dense` as JAX does.

deepseek-v2-lite's smoke config under `LM(cfg, mesh=make_host_mesh(model=2))`
on two ranks (n_ep = 2 of 8 routed experts: every MoE layer takes
`moe_ep`): the loss within `LOSS_TOL` and every gradient within `EP_TOL`
of JAX's `LM(cfg, mesh)` on a (1, 2) mesh, on both ranks.

The training CLI: ``--compress-grads`` on deepseek-v3's smoke config,
stopped and resumed, ends on the uninterrupted run's bytes, its error
state included; a two-process ``--coordinator`` run (gloo) ends on the
same params on both processes.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import _torch_ranks
from repro.configs import get_smoke_config as j_get_smoke
from repro.models.lm import LM as JLM
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as t_train
from repro_torch.models import moe as t_moe
from repro_torch.optim.adamw import tree_paths

ARCH = "deepseek-v2-lite-16b"
EP_TOL, LOSS_TOL = 1e-5, 2e-6
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
MESHES = [((1, 1), ("model",)), ((1, 2), ("model",)), ((1, 4), ("model",)),
          ((2, 2), ("model",)), ((2, 2), ("data", "model"))]
# (name, mesh shape, ep_axes, capacity factor, decode)
CASES = [(f"{s[0]}x{s[1]}_{'+'.join(ep)}_{'decode' if dec else f'cf{cf:g}'}", s, ep, cf, dec)
         for s, ep in MESHES for cf, dec in ((1.3, False), (100.0, False), (1.3, True))]
LM_TOKENS = (2, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


_JAX_SIDE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {src!r})
    import dataclasses
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models import moe as j_moe
    from repro.models.lm import LM

    flat = dict(np.load({inputs!r}))
    def tree(prefix):
        out = {{}}
        for k, v in flat.items():
            if k.startswith(prefix + "/"):
                *path, leaf = k[len(prefix) + 1:].split("/")
                node = out
                for p in path:
                    node = node.setdefault(p, {{}})
                node[leaf] = jnp.asarray(v)
        return out
    def flatten(prefix, t):
        return {{prefix + "/" + "/".join(str(k.key) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}}
    def run(f, *args):
        return jax.jit(f).lower(*args).compile(
            compiler_options={{"xla_backend_optimization_level": 0}})(*args)
    def mesh_of(shape):
        return jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)

    cfg = get_smoke_config({arch!r})
    out = {{}}
    for name, shape, ep, cf, decode in json.loads({cases!r}):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_axes=tuple(ep)))
        mesh = mesh_of(shape)
        x = jnp.asarray(flat["x"][:, :1] if decode else flat["x"])
        w = jnp.asarray(flat["w"][:, :1] if decode else flat["w"])
        p = tree("p")
        def loss(pp, xv):
            y = j_moe.moe_ep(pp, xv, c, mesh, capacity_factor=cf)
            return jnp.sum(y * w), y
        (_, y), (gp, gx) = run(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True), p, x)
        out[name + "/y"], out[name + "/dx"] = np.asarray(y), np.asarray(gx)
        out.update(flatten(name + "/g", gp))
        out[name + "/dense"] = np.asarray(run(lambda pp, xv: j_moe.moe_dense(pp, xv, c), p, x))
        if cf < 2 and not decode:
            # which assignments were kept: route every token to its k-th
            # choice alone (gate 1), the shared experts off
            c0 = dataclasses.replace(c, moe=dataclasses.replace(c.moe, n_shared=0))
            p0 = {{k: v for k, v in p.items() if k != "shared"}}
            orig, kept = j_moe.route, []
            for kk in range(c.moe.top_k):
                def probe(pp, xf, m, kk=kk):
                    g, ids = orig(pp, xf, m)
                    return jax.nn.one_hot(jnp.full(g.shape[:1], kk), g.shape[1],
                                          dtype=g.dtype), ids
                j_moe.route = probe
                yk = run(lambda pp, xv: j_moe.moe_ep(pp, xv, c0, mesh, capacity_factor=cf),
                         p0, x)
                j_moe.route = orig
                kept.append(np.any(np.asarray(yk) != 0, axis=-1))
            out[name + "/kept"] = np.stack(kept, -1)

    lm_mesh = mesh_of((1, 2))
    model = LM(cfg, mesh=lm_mesh)
    loss, g = run(jax.value_and_grad(lambda pp, t: model.loss(pp, {{"tokens": t}})),
                  tree("lm"), jnp.asarray(flat["tokens"]))
    out["lm/loss"] = np.asarray(loss)
    out.update(flatten("lm/g", g))
    np.savez({out!r}, **out)
    print("ok")
""")


def _flat_np(prefix, tree) -> dict:
    return {f"{prefix}/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _inputs(path) -> str:
    """The MoE layer's params (normal, std 0.02, as `init_moe` draws), x
    with a shared offset (so routing crowds and drops happen), the loss
    weights w, the LM's params (JAX's init, seed 0) and its tokens."""
    cfg = j_get_smoke(ARCH)
    rng = np.random.default_rng(0)
    d, e, f = cfg.d_model, cfg.moe.n_routed, cfg.moe.d_expert_ff
    normal = lambda *shape: (rng.normal(size=shape) * 0.02).astype(np.float32)  # noqa: E731
    flat = {"p/router": normal(d, e), "p/router_bias": np.zeros(e, np.float32),
            "p/w_gate": normal(e, d, f), "p/w_up": normal(e, d, f),
            "p/w_down": normal(e, f, d),
            **{f"p/shared/{k}": normal(*s) for k, s in (
                ("w_gate", (d, 2 * f)), ("w_up", (d, 2 * f)), ("w_down", (2 * f, d)))}}
    flat["x"] = (rng.normal(size=(2, 9, d)) + 1.5 * rng.normal(size=(d,))).astype(np.float32)
    flat["w"] = rng.normal(size=(2, 9, d)).astype(np.float32)
    lm = jax.jit(JLM(cfg).init)(jax.random.PRNGKey(0))
    flat.update(_flat_np("lm", lm))
    flat["tokens"] = rng.integers(0, cfg.vocab, LM_TOKENS).astype(np.int32)
    np.savez(path, **flat)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_ep")
    inputs, out = _inputs(tmp / "inputs.npz"), str(tmp / "jax.npz")
    script = _JAX_SIDE.format(src=SRC, inputs=inputs, arch=ARCH, out=out,
                              cases=json.dumps(CASES))
    jax_side = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                env=dict(os.environ, JAX_PLATFORMS="cpu"))
    by_world = {n: [c for c in CASES if c[1][0] * c[1][1] == n] for n in (1, 2, 4)}
    four = _torch_ranks.start_ranks("moe_cases", 4, inputs, by_world[4])
    two = _torch_ranks.start_ranks("run_jobs", 2, [("moe_cases", (inputs, by_world[2])),
                                                   ("lm_loss_and_grads", (inputs, ARCH, 2))])
    one = _torch_ranks.moe_cases(0, inputs, by_world[1])
    two_res = two.result()
    torch_side = {name: [res] for name, res in one.items()}
    for ranks in (four.result(), [r[0] for r in two_res]):
        for name in ranks[0]:
            torch_side[name] = [r[name] for r in ranks]
    stdout, stderr = jax_side.communicate(timeout=300)
    assert jax_side.returncode == 0 and stdout.strip().endswith("ok"), stderr[-3000:]
    with np.load(out) as z:
        want = {k: z[k] for k in z.files}
    return {"torch": torch_side, "jax": want, "lm": [r[1] for r in two_res],
            "inputs": dict(np.load(inputs))}


def _close(got, want, err_msg=""):
    """|got - want| <= EP_TOL x the largest |want| (values and gradients are
    O(1e-2) and below: an absolute bound would hide a wrong small leaf)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=err_msg,
                               atol=EP_TOL * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_ep_matches_jax_on_every_rank(runs, case):
    name, shape, ep, cf, decode = case
    want, ranks = runs["jax"], runs["torch"][name]
    assert len(ranks) == shape[0] * shape[1]
    dropped = []
    for got in ranks:
        _close(got["y"], want[f"{name}/y"])
        _close(got["dx"], want[f"{name}/dx"])
        assert sorted(got["grads"]) == sorted(k[len(name) + 3:] for k in want
                                              if k.startswith(f"{name}/g/"))
        for key, g in got["grads"].items():
            _close(g, want[f"{name}/g/{key}"], key)
        assert got["grads"]["router_bias"].any() == want[f"{name}/g/router_bias"].any()
        if cf < 2 and not decode:
            assert np.array_equal(got["kept"], want[f"{name}/kept"])
        else:
            assert got["kept"].all()
        dropped.append(int((~got["kept"]).sum()))
    assert len(set(dropped)) == 1
    if cf < 2 and not decode:
        assert dropped[0] > 0           # the capacity limits bit
    if not (decode and len(ep) > 1) and (cf > 2 or decode):
        _close(want[f"{name}/y"], want[f"{name}/dense"])
        cfg = get_smoke_config(ARCH)
        inp = runs["inputs"]
        params = _torch_ranks._tree(inp, "p")
        x = torch.from_numpy(inp["x"][:, :1] if decode else inp["x"])
        _close(ranks[0]["y"], t_moe.moe_dense(params, x, cfg).numpy())


def test_lm_on_a_two_rank_mesh_matches_jax(runs):
    want = runs["jax"]
    for got in runs["lm"]:
        assert got["mesh"] == {"data": 1, "model": 2}
        assert abs(got["loss"] - float(want["lm/loss"])) <= LOSS_TOL
        keys = sorted(k[len("lm/g/"):] for k in want if k.startswith("lm/g/"))
        assert sorted(got["grads"]) == keys
        for key in keys:
            _close(got["grads"][key], want[f"lm/g/{key}"], key)
        assert len(got["dropped"]) == 2     # two MoE layers, each through moe_ep
    assert runs["lm"][0]["dropped"] == runs["lm"][1]["dropped"]


def _state_bytes(state):
    params, opt, *err = state
    return [t.contiguous().view(torch.uint8) if t.dtype != torch.int32 else t
            for _, t in tree_paths({"p": params, "m": opt.m, "v": opt.v, "s": opt.step,
                                    "e": err[0] if err else {}})]


def test_train_cli_compress_grads_resumes_byte_for_byte(tmp_path):
    args = ["--arch", "deepseek-v3-671b", "--smoke", "--steps", "4", "--batch", "2", "--seq",
            "16", "--ckpt-every", "2", "--device", "cpu", "--compress-grads"]
    full = t_train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert full["summary"]["step"] == 4 and len(full["state"]) == 3
    part = t_train.train("deepseek-v3-671b", smoke=True, steps=4, batch=2, seq=16,
                         ckpt_every=2, device="cpu", ckpt_dir=str(tmp_path / "b"),
                         stop_after=2, compress_grads=True)
    assert part["summary"]["step"] == 2
    resumed = t_train.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--auto-resume"])
    assert resumed["start"] == 2 and resumed["loss"] == full["loss"][2:]
    assert all(torch.equal(a, b) for a, b in zip(_state_bytes(resumed["state"]),
                                                 _state_bytes(full["state"])))
    # the error state is checkpointed with the rest (the reference's "2/..." keys)
    restored, _ = CheckpointManager(tmp_path / "b").restore(full["state"])
    assert [p for p, _ in tree_paths(restored[2])] == [p for p, _ in tree_paths(full["state"][0])]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_two_process_coordinator_run(tmp_path):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--steps", "3",
         "--batch", "2", "--seq", "16", "--ckpt-every", "3", "--device", "cpu",
         "--ckpt-dir", str(tmp_path / f"rank{i}"), "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")) for i in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr[-3000:]
        assert "summary: {'step': 3" in stdout
    arrays = [np.load(tmp_path / f"rank{i}" / "step_00000003" / "arrays.npz") for i in range(2)]
    assert arrays[0].files == arrays[1].files and len(arrays[0].files) > 10
    for key in arrays[0].files:
        assert np.array_equal(arrays[0][key], arrays[1][key]), key


def test_phase_16_rehearsal_on_the_cpu(capsys):
    """chip_smoke's phase 16 (`smoke_parallel.parallel_phase`) on the smoke
    configs over world-1 gloo groups: moe_ep against moe_dense (nothing
    dropped at its no-drop capacity factor), the CPU and decode; the sync's
    payloads against the CPU's and the error-feedback loop; the CLI with
    --compress-grads --coordinator stopped and resumed byte for byte;
    serving on the host mesh and without one, the same answers."""
    from repro_torch import smoke_parallel
    out = smoke_parallel.parallel_phase("cpu", "cpu", smoke=True)
    assert sorted(out["launches"]) == ["parallel_moe_ep", "parallel_serve", "parallel_sync",
                                       "parallel_train_cli"]
    assert out["moe_ep"]["no_drop"]["dropped"] == 0
    assert out["sync"]["payloads_bit_identical_to_cpu"] and out["sync"]["feedback_rel"] < 0.01
    assert all(out["train_cli"]["same"].values()) and out["train_cli"]["error_state_zero"]
    assert out["serve"]["same_answers"]
    assert "parallel phase:" in capsys.readouterr().out
