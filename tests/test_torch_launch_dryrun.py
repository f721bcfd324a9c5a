"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's on the CPU.

The mini dry-run cells of phase 17 (`repro_torch.smoke_dryrun.MINI_CELLS`,
smoke configs at a shape of their own) on a (2, 2, 2) ('pod', 'data',
'model') mesh: at Shape("t", 32, 8, kind) the reference's
(`tests/test_sharding_and_dryrun.py`: qwen3-8b's train step,
deepseek-v2-lite's train step and falcon-mamba-7b's decode step) and
falcon-mamba-7b's train step, deepseek-v2-lite's absorbed MLA decode and
zamba2-7b's hybrid train and decode steps; and three whose residual stream
splits along its sequence (qwen3-8b's train step and zamba2-7b's prefill
at batch 2, deepseek-v2-lite's prefill at batch 4).  The port traces each
on a fake world of 8 under `FakeTensorMode` (one subprocess a cell,
`smoke_dryrun.mini_cell`), JAX compiles all ten in one subprocess with
eight host devices; all run at once.  The collective kind a cell names
appears in the port's trace and in JAX's (the all-to-all is `moe_ep`'s
own), and the per-device argument bytes equal JAX's
`argument_size_in_bytes` exactly, as do the JAX bytes `MINI_CELLS`
records for phase 17 on the card.  The flops and wire bytes are printed beside JAX's, not gated: XLA
counts every op before fusion and a scan body once, the trace counts
matmuls on the local shards.

The per-device flops of a one-layer smoke cell (qwen1.5-0.5b's prefill,
2 x 16 tokens, world 1) equal a hand count of its matmuls exactly; on a
fake world of 4, `corrected_metrics` (probes at 1 and 2 layers,
extrapolated) equals the direct trace of a 4-layer decoder (flops, bytes
and wire, rel 1e-9: the port's layer loop is Python, so every layer is
counted).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.smoke_dryrun import MINI_CELLS

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")


def _id(cell, last) -> str:
    """A cell's test id: arch-kind-`last`, and -b<batch> off batch 8."""
    b = cell.shape.global_batch
    return f"{cell.arch}-{cell.shape.kind}-{last}" + ("" if b == 8 else f"-b{b}")

_JAX_CELLS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys, json
    sys.path.insert(0, {src!r})
    import jax
    from repro.launch.steps import build_step_cfg
    from repro.launch.roofline import collective_stats
    from repro.configs import get_smoke_config
    from repro.configs.shapes import Shape
    import repro.configs.shapes as shp

    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    out = {{}}
    for arch, kind, seq, batch in {cells!r}:
        shp.SHAPES["t"] = Shape("t", seq, batch, kind)
        with jax.set_mesh(mesh):
            (fn, args), cfg, shape = build_step_cfg(get_smoke_config(arch), "t", mesh)
            compiled = fn.lower(*args).compile()
            coll = collective_stats(compiled.as_text(), default_group=2)
            mem = compiled.memory_analysis()
            cost = compiled.cost_analysis() or {{}}
        out[f"{{arch}} {{kind}} {{batch}}"] = {{"kinds": sorted(coll["ops"]),
                                  "wire": coll["wire_bytes_per_device"],
                     "args_bytes": int(mem.argument_size_in_bytes),
                     "flops": float(cost.get("flops", 0.0))}}
    print(json.dumps(out))
""")

_TORCH_CELL = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.shapes import Shape
    from repro_torch.smoke_dryrun import mini_cell

    r = mini_cell({arch!r}, Shape("t", {seq!r}, {batch!r}, {kind!r}), "cpu")
    print(json.dumps({{"kinds": r["kinds"], "wire": r["wire"], "flops": r["flops"],
                      "args_bytes": r["argument_size_in_bytes"],
                      "alias_bytes": r["alias_size_in_bytes"],
                      "temp_bytes": r["temp_size_in_bytes"]}}))
""")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mini_cells():
    """Both sides of the ten cells, run at once: {"jax": {cell name: ...},
    cell name: the port's result} (`MiniCell.name`)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    cells = [(c.arch, c.shape.kind, c.shape.seq, c.shape.global_batch) for c in MINI_CELLS]
    procs = {"jax": subprocess.Popen(
        [sys.executable, "-c", _JAX_CELLS.format(src=SRC, cells=cells)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)}
    for c in MINI_CELLS:
        procs[c.name] = subprocess.Popen(
            [sys.executable, "-c", _TORCH_CELL.format(src=SRC, arch=c.arch, kind=c.shape.kind,
                                                      seq=c.shape.seq,
                                                      batch=c.shape.global_batch)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, (name, stderr[-3000:])
            out[name] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("cell", [pytest.param(c, id=_id(c, c.coll)) for c in MINI_CELLS])
def test_mini_dryrun_multipod(cell, mini_cells):
    mine, ref = mini_cells[cell.name], mini_cells["jax"][cell.name]
    expect_coll = cell.coll
    print(f"{cell.name}: port flops/dev {mine['flops']:.6g} wire/dev {mine['wire']:.6g} "
          f"kinds {mine['kinds']}; JAX flops/dev {ref['flops']:.6g} wire/dev "
          f"{ref['wire']:.6g} kinds {ref['kinds']}")
    if expect_coll is not None:
        assert expect_coll in ref["kinds"]
        assert expect_coll in mine["kinds"], mine
    assert mine["args_bytes"] == ref["args_bytes"]
    if cell.shape.kind == "prefill":
        assert mine["alias_bytes"] == 0            # prefill donates nothing
    else:
        assert 0 < mine["alias_bytes"] <= mine["args_bytes"]
    assert mine["temp_bytes"] > 0 and mine["flops"] > 0


@pytest.mark.parametrize("cell", [pytest.param(c, id=_id(c, c.jax_bytes)) for c in MINI_CELLS])
def test_mini_cells_record_jax_bytes(cell, mini_cells):
    """Phase 17 gates the card's trace against these recorded bytes."""
    assert cell.jax_bytes == mini_cells["jax"][cell.name]["args_bytes"]


def test_one_layer_flops_equal_a_hand_count():
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), n_layers=1)
    b, s = 2, 16
    d, h, k, hd, f, v = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab
    tokens = b * s
    want = (2 * tokens * d * h * hd            # q
            + 2 * 2 * tokens * d * k * hd      # k, v
            + 2 * 2 * b * h * s * s * hd       # scores, probabilities x values
            + 2 * tokens * h * hd * d          # output projection
            + 3 * 2 * tokens * d * f           # SwiGLU: gate, up, down
            + 2 * b * d * v)                   # the last token's logits (tied head)
    with dryrun.fake_world(1):
        mesh = Mesh((1, 1), ("data", "model"), device="cpu")
        mem, m, coll, _ = dryrun._compile_cell(cfg, Shape("p", s, b, "prefill"), mesh)
    assert m["flops"] == want
    assert coll["wire_bytes_per_device"] == 0.0
    assert mem.alias_size_in_bytes == 0            # prefill donates nothing


def test_corrected_metrics_equal_the_direct_count():
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), n_layers=4)
    shape = Shape("d", 64, 4, "decode")
    with dryrun.fake_world(4):
        mesh = Mesh((2, 2), ("data", "model"), device="cpu")
        _, direct, _, _ = dryrun._compile_cell(cfg, shape, mesh)
        est = dryrun.corrected_metrics(cfg, shape, mesh)
    for key in ("flops", "bytes", "wire"):
        assert direct[key] > 0
        assert est[key] == pytest.approx(direct[key], rel=1e-9), key
