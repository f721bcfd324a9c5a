"""The LM steps and policies in the port
(`repro_torch.launch.steps`) against the JAX package on the CPU, and the
package-level names.

* `FSDP_ARCHS`, `policy_for`, `_act_spec` and `opt_state_specs` equal
  JAX's on (16, 16) and (2, 16, 16) abstract meshes, for every arch.
* At world 1, `build_train_step` / `build_prefill_step` /
  `build_decode_step` on qwen3-8b's smoke config (2 x 16 tokens) give
  JAX's loss, params and gradient moments after one step, logits and
  caches within `_torch_steps.STEP_TOL` times the largest magnitude of
  JAX's (f32; the weights cross through `repro_torch.bridge`, the batch is
  drawn from a numpy seed), both unplaced (no process group) and placed as
  DTensors over a world-1 gloo group (`steps._step_on_shards`).  Each JAX
  step is computed once for both routes (`jax_steps`).  The MoE's train
  step is `test_torch_launch_moe_step.py`'s.
* Every package-level name the reference's ``__init__`` files import
  exists in the port's package (the Pallas and backend-selection names
  excepted), and importing every package, the launchers included, builds
  no kernel and imports no JAX.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

import _torch_steps
from _torch_steps import world  # noqa: F401  (a fixture of the tests below)
from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.configs import shapes as j_shapes
from repro.launch import steps as j_steps
from repro.models.lm import LM as JLM
from repro.parallel import sharding as j_shd
from repro_torch.configs import get_config
from repro_torch.configs import shapes as t_shapes
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps as t_steps
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import tree_paths
from repro_torch.parallel import sharding as t_shd

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
# the reference's Pallas and backend-selection names, which the port's
# dispatch by device replaces
BACKEND_NAMES = {"pallas", "KernelBackend", "PALLAS_INTERPRET", "PALLAS_TPU", "REF",
                 "available_backends", "get_backend", "resolve_backend", "set_backend"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pol(p) -> tuple:
    return (p.tp, p.fsdp, tuple(p.dp_axes), tuple(p.fsdp_axes), p.model_axis)


def _j_flat(specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): tuple(s)
            for path, s in leaves}


def _t_flat(specs) -> dict:
    return {"/".join(p): tuple(s) for p, s in tree_paths(specs)}


@pytest.mark.parametrize("arch", list_archs())
def test_policies_and_specs_equal_jax(arch):
    assert t_steps.FSDP_ARCHS == j_steps.FSDP_ARCHS
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for train in (True, False):
        for variant in ("baseline", "optimized"):
            assert _pol(t_steps.policy_for(tcfg, train, variant)) == \
                _pol(j_steps.policy_for(jcfg, train, variant))
    j_params, t_params = JLM(jcfg).init_abstract(), LM(tcfg, device="meta").init(None)
    for shape, names in MESHES:
        jm, tm = jax.sharding.AbstractMesh(shape, names), t_mesh.AbstractMesh(shape, names)
        for train in (True, False):
            jp, tp = j_steps.policy_for(jcfg, train), t_steps.policy_for(tcfg, train)
            for suite in j_shapes.SHAPES:
                assert tuple(t_steps._act_spec(t_shapes.SHAPES[suite], tm, tp)) == \
                    tuple(j_steps._act_spec(j_shapes.SHAPES[suite], jm, jp)), (shape, suite)
            j_os = j_steps.opt_state_specs(j_shd.param_specs(jcfg, j_params, jm, jp))
            t_os = t_steps.opt_state_specs(t_shd.param_specs(tcfg, t_params, tm, tp))
            assert tuple(t_os.step) == tuple(j_os.step) == ()
            assert _t_flat(t_os.m) == _j_flat(j_os.m) and _t_flat(t_os.v) == _j_flat(j_os.v)


# --- the steps at world 1 -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps():
    """JAX's steps by (arch, kind), each computed on first use."""
    runs: dict = {}

    def get(arch: str, kind: str) -> dict:
        if (arch, kind) not in runs:
            runs[arch, kind] = _torch_steps.jax_step(arch, kind)
        return runs[arch, kind]
    return get


@pytest.mark.parametrize("world", ["plain", "dtensor"], indirect=True)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_steps_at_world_one_equal_jax(kind, world, jax_steps):
    _torch_steps.check_world_one("qwen3-8b", kind, world, jax_steps("qwen3-8b", kind))


# --- package-level names ------------------------------------------------------------

def _reference_exports() -> dict:
    """{package: names its __init__ imports from its own modules}."""
    out = {}
    for init in sorted((ROOT / "src" / "repro").glob("*/__init__.py")):
        names = set()
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom) and node.level >= 1:
                names |= {a.asname or a.name for a in node.names}
        out[init.parent.name] = sorted(names - BACKEND_NAMES)
    return out


def test_package_level_names_exist_and_build_nothing():
    exports = _reference_exports()
    assert "Field" in exports["core"] and "RaySampler" in exports["data"]
    code = (
        "import json, importlib, sys\n"
        "import repro_torch.kernels as k\n"
        "def refuse(*a, **kw):\n"
        "    raise SystemExit('a kernel was built at import')\n"
        "k.build = refuse\n"
        f"exports = json.loads({json.dumps(json.dumps(exports))})\n"
        "missing = {p: [n for n in ns if not hasattr(importlib.import_module('repro_torch.' + p), n)]\n"
        "           for p, ns in exports.items()}\n"
        "import repro_torch.launch.steps, repro_torch.launch.dryrun, repro_torch.launch.report\n"
        "print(json.dumps({'missing': {p: m for p, m in missing.items() if m},\n"
        "                  'libs': sorted(k._libs), 'jax': 'jax' in sys.modules}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=SRC), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"missing": {}, "libs": [], "jax": False}


