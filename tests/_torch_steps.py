"""Shared by the step tests (`test_torch_launch_steps.py`,
`test_torch_launch_moe_step.py`): JAX's step on a smoke config at world 1,
the port's on the same arrays, and the comparison within `STEP_TOL` times
the largest magnitude of JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_smoke_config as j_get_smoke
from repro.configs import shapes as j_shapes
from repro.launch import steps as j_steps
from repro.models.lm import LM as JLM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.configs import shapes as t_shapes
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps as t_steps
from repro_torch.optim.adamw import tree_paths

STEP_TOL = 1e-5


def _numpy_batch(j_batch, vocab, seq, rng) -> dict:
    """Arrays for a batch of JAX abstract leaves: token ids, positions in
    [0, seq), normal floats (caches, embeddings) at 0.1."""
    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if np.issubdtype(leaf.dtype, np.integer):
            hi = vocab if "tokens" in name else seq
            return rng.integers(0, hi, leaf.shape).astype(leaf.dtype)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return jax.tree_util.tree_map_with_path(fill, j_batch)


def _t_batch(arrays) -> dict:
    return bridge.params_to_torch(jax.tree.map(np.asarray, arrays), "cpu")


def _close(got: torch.Tensor, want, what: str) -> None:
    g = got.full_tensor() if hasattr(got, "full_tensor") else got
    g = g.detach().to(torch.float32).numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(float(np.max(np.abs(w))), 1e-30)
    assert float(np.max(np.abs(g - w))) <= STEP_TOL * scale, what


def _close_tree(got: dict, want, what: str) -> None:
    flat = {"/".join(p): t for p, t in tree_paths(got)}
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(leaves) == len(flat)
    for path, w in leaves:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        _close(flat[key], w, f"{what} {key}")


def jax_step(arch: str, kind: str) -> dict:
    """JAX's step on its smoke config at world 1, with the arrays it ran
    on (numpy): params, optimizer state (train) and batch, and its out."""
    jcfg = j_get_smoke(arch)
    rng = np.random.default_rng(0)
    jm = jax.make_mesh((1, 1), ("data", "model"),
                       axis_types=(jax.sharding.AxisType.Auto,) * 2)
    make = {"train": j_steps.build_train_step, "prefill": j_steps.build_prefill_step,
               "decode": j_steps.build_decode_step}[kind]
    with jax.set_mesh(jm):
        jfn, jargs = make(jcfg, jm, j_shapes.Shape("t", 16, 2, kind))
        jp = JLM(jcfg, mesh=jm).init(jax.random.PRNGKey(0))
        run = {"params": jax.tree.map(np.asarray, jp),
               "batch": _numpy_batch(jargs[-1], jcfg.vocab, 16, rng)}
        batch = jax.tree.map(jnp.asarray, run["batch"])
        if kind == "train":
            jo = j_steps.make_optimizer(jcfg).init(jp)
            run["opt"] = jax.tree.map(np.asarray, jo)
            run["out"] = jfn(jp, jo, batch)        # donates jp and jo: copied above
        else:
            run["out"] = jfn(jp, batch)
    return run


def check_world_one(arch: str, kind: str, world: str, run: dict) -> None:
    """The port's step at world 1 (`world`: "plain", no process group, or
    "dtensor", a world-1 group up) against JAX's `run`."""
    tp, tb = bridge.params_to_torch(run["params"], "cpu"), _t_batch(run["batch"])
    mesh = t_mesh.Mesh((1, 1), ("data", "model"), device="cpu")
    assert (mesh.device_mesh is None) == (world == "plain")
    (tfn, targs), _, _ = t_steps.build_step_cfg(get_smoke_config(arch),
                                                t_shapes.Shape("t", 16, 2, kind), mesh)
    assert [p for p, _ in tree_paths(targs[0])] == [p for p, _ in tree_paths(tp)]
    if kind == "train":
        params, state, loss = tfn(tp, bridge.opt_to_torch(run["opt"], "cpu"), tb)
        j_params, j_state, j_loss = run["out"]
        _close(loss, j_loss, "loss")
        _close_tree(params, j_params, "params")
        _close_tree(state.m, j_state.m, "m")
        assert int(state.step.full_tensor() if world == "dtensor" else state.step) == 1
    else:
        logits, caches = tfn(tp, tb)
        _close(logits, run["out"][0], "logits")
        _close_tree(caches, run["out"][1], "caches")


@pytest.fixture
def world(request, tmp_path):
    """A world-1 gloo group for the placed (DTensor) route, nothing for the
    plain one."""
    if request.param == "dtensor":
        dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                                rank=0, world_size=1)
    try:
        yield request.param
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
