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
at batch 2, deepseek-v2-lite's prefill at batch 4); two whose logits
take most of the memory (qwen3-8b at a vocab of 32768, batch 8: the TP
policy's training, whose logits split along the vocab, and the prefill's
last-token head product); and four whose temp bytes are held to JAX's and
whose largest storage to the term 'model' halves: the TP policy's
training of falcon-mamba-7b, zamba2-7b and deepseek-v3 (both at 128
tokens), and deepseek-v3's at batch 4 and 256 tokens, whose MTP block
runs on uneven sequence blocks.  The port traces each on a fake world of 8
under `FakeTensorMode` (one subprocess a cell, `smoke_dryrun.mini_cell`),
JAX compiles all of them in one subprocess with eight host devices; all
run at once.  The collective kind a cell names appears in the port's
trace and in JAX's (the all-to-all is `moe_ep`'s own), and the
per-device argument bytes equal JAX's `argument_size_in_bytes` exactly,
as do the JAX bytes `MINI_CELLS` records for phase 17 on the card (and
JAX's temp bytes, where recorded).  The two vocab cells' temp bytes are
held to JAX's (`MiniCell.max_temp`).  The flops, wire bytes and the
other memory fields are printed beside JAX's, not gated: XLA counts
every op before fusion and a scan body once, the trace counts matmuls on
the local shards.

`StepTrace` counts a functional collective's result (a fake world's
all-gather; the gathered embedding table of the mini prefill).  A
state-less SSM scan runs on each rank's channel block (`ssm._scan_layout`,
held to the reference's TP rule for the channel params, and its state
rule where the heads do not divide), and deepseek-v3's MTP block on each
rank's heads (TP) or uneven sequence block (FSDP-pure).  A remat'd
layer's chunked attention keeps no keys live past the layer's forward.

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
    """A cell's test id: arch-kind-`last`, and -b<batch> off batch 8,
    -s<seq> off 32 tokens, the policy off the optimized one, -v<vocab> where
    the vocab is replaced."""
    b, seq = cell.shape.global_batch, cell.shape.seq
    return f"{cell.arch}-{cell.shape.kind}-{last}" + ("" if b == 8 else f"-b{b}") \
        + ("" if seq == 32 else f"-s{seq}") \
        + ("" if cell.policy == "optimized" else f"-{cell.policy}") \
        + ("" if cell.vocab is None else f"-v{cell.vocab}")

_JAX_CELLS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, sys, json
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
    for name, arch, kind, seq, batch, policy, vocab in {cells!r}:
        shp.SHAPES["t"] = Shape("t", seq, batch, kind)
        cfg = get_smoke_config(arch)
        if vocab is not None:
            cfg = dataclasses.replace(cfg, vocab=vocab)
        with jax.set_mesh(mesh):
            (fn, args), cfg, shape = build_step_cfg(cfg, "t", mesh, policy)
            compiled = fn.lower(*args).compile()
            coll = collective_stats(compiled.as_text(), default_group=2)
            mem = compiled.memory_analysis()
            cost = compiled.cost_analysis() or {{}}
        out[name] = {{"kinds": sorted(coll["ops"]), "wire": coll["wire_bytes_per_device"],
                     "args_bytes": int(mem.argument_size_in_bytes),
                     "temp_bytes": int(mem.temp_size_in_bytes),
                     "out_bytes": int(mem.output_size_in_bytes),
                     "alias_bytes": int(mem.alias_size_in_bytes),
                     "flops": float(cost.get("flops", 0.0))}}
    print(json.dumps(out))
""")

_TORCH_CELL = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    from repro_torch.smoke_dryrun import MINI_CELLS, mini_cell

    r = mini_cell(MINI_CELLS[{index!r}], "cpu")
    print(json.dumps({{"kinds": r["kinds"], "wire": r["wire"], "flops": r["flops"],
                      "args_bytes": r["argument_size_in_bytes"],
                      "alias_bytes": r["alias_size_in_bytes"],
                      "out_bytes": r["output_size_in_bytes"],
                      "temp_bytes": r["temp_size_in_bytes"],
                      "largest_storage": r["largest_storage"]}}))
""")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mini_cells():
    """Both sides of the cells, run at once: {"jax": {cell name: ...},
    cell name: the port's result} (`MiniCell.name`)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    cells = [(c.name, c.arch, c.shape.kind, c.shape.seq, c.shape.global_batch, c.policy,
              c.vocab) for c in MINI_CELLS]
    procs = {"jax": subprocess.Popen(
        [sys.executable, "-c", _JAX_CELLS.format(src=SRC, cells=cells)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)}
    for i, c in enumerate(MINI_CELLS):
        procs[c.name] = subprocess.Popen(
            [sys.executable, "-c", _TORCH_CELL.format(src=SRC, index=i)],
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
          f"{ref['wire']:.6g} kinds {ref['kinds']}; bytes/dev args / temp / out / alias: port "
          f"{mine['args_bytes']} / {mine['temp_bytes']} / {mine['out_bytes']} / "
          f"{mine['alias_bytes']}, JAX {ref['args_bytes']} / {ref['temp_bytes']} / "
          f"{ref['out_bytes']} / {ref['alias_bytes']}")
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
    if cell.jax_temp is not None:
        assert cell.jax_temp == mini_cells["jax"][cell.name]["temp_bytes"]


@pytest.mark.parametrize("cell", [pytest.param(c, id=_id(c, "memory")) for c in MINI_CELLS
                                  if c.vocab is not None])
def test_mini_cells_hold_the_logits_memory_to_jax(cell, mini_cells):
    """At a vocab of 32768 the logits dominate.  The TP policy's training
    scores its vocab-split logits on each rank's block (no whole-batch
    gradient of them): its temp bytes a device at most twice JAX's.  The
    prefill's last-token head product makes no copy of the head per row:
    no storage larger than the whole head in f32, its temp bytes at most
    1.5 times that.  Both limits are `MiniCell.max_temp`, which phase 17
    gates on the card."""
    mine, ref = mini_cells[cell.name], mini_cells["jax"][cell.name]
    head = cell.config().d_model * cell.vocab * 4
    print(f"{cell.name}: temp {mine['temp_bytes']} B (limit {cell.max_temp}, JAX "
          f"{ref['temp_bytes']}), largest storage {mine['largest_storage']} B (head {head})")
    assert mine["temp_bytes"] <= cell.max_temp
    assert mine["args_bytes"] == ref["args_bytes"]
    if cell.shape.kind == "prefill":
        assert mine["largest_storage"] <= head
        assert cell.max_temp == 3 * head // 2
    else:
        assert cell.max_temp == 2 * ref["temp_bytes"]


def test_the_mtp_head_scores_each_ranks_rows(monkeypatch):
    """deepseek-v3's smoke config widened (d_model 256: the MTP head's
    projection splits over the FSDP axes along its contracted dim) traced
    under the FSDP-pure policy at batch 2 on a fake ('data', 'model') =
    (2, 2) world, the main stream's sequence split over 'model' as two
    pods' `train_4k` splits it: both losses score logits laid out by the
    batch (and the sequence), none a partial sum, which would sum the whole
    batch's logits on every rank (deepseek-v3 `train_4k` at two pods)."""
    from repro_torch.models import lm
    seen, score = [], lm._next_token_nll

    def spy(logits, tokens):
        seen.append(list(logits.placements))
        return score(logits, tokens)

    monkeypatch.setattr(lm, "_next_token_nll", spy)
    cfg = dataclasses.replace(get_smoke_config("deepseek-v3-671b"), d_model=256)
    with dryrun.fake_world(4):
        mesh = Mesh((2, 2), ("data", "model"), device="cpu")
        dryrun._compile_cell(cfg, Shape("t", 16, 2, "train"), mesh)
    assert len(seen) == 2, seen                      # the main loss, then the MTP head's
    assert [p.is_shard(0) for p in seen[1]] == [True, False], seen
    assert not any(p.is_partial() for pl in seen for p in pl), seen


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


@pytest.mark.parametrize("cell", [pytest.param(c, id=_id(c, "memory")) for c in MINI_CELLS
                                  if c.max_largest is not None])
def test_mini_cells_hold_the_block_memory_to_jax(cell, mini_cells):
    """The TP policy's SSM scans on each rank's channels, its MLA attention
    on each rank's heads (deepseek-v3's MTP block too) and the MTP block on
    each rank's uneven block of S - 1 tokens: temp bytes a device at most
    JAX's, and no storage larger than `MiniCell.max_largest` (the term
    that 'model' = 2 halves, at its block; see `MiniCell`).  Phase 17 gates
    both on the card."""
    mine, ref = mini_cells[cell.name], mini_cells["jax"][cell.name]
    print(f"{cell.name}: temp {mine['temp_bytes']} B (limit {cell.max_temp}, JAX "
          f"{ref['temp_bytes']}), largest storage {mine['largest_storage']} B (limit "
          f"{cell.max_largest})")
    assert cell.max_temp == ref["temp_bytes"]
    assert mine["temp_bytes"] <= cell.max_temp
    assert mine["largest_storage"] <= cell.max_largest
    assert mine["args_bytes"] == ref["args_bytes"]


def test_step_trace_counts_a_collectives_result():
    """A functional collective's result is a storage the step made: a fake
    world's all-gather of (1024, 64) f32 over 4 ranks makes 1 MiB, live
    until it dies, in the peak and in `at_peak()` with its op; the
    result's `wait` counts it once."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    with dryrun.fake_world(4), FakeTensorMode() as fake:
        x = torch.empty(1024, 64)
        trace = dryrun.StepTrace(fake, known=[x], attribute=4)
        with trace:
            y = funcol.all_gather_tensor(x, 0, dist.group.WORLD)
            y = y.wait() if isinstance(y, funcol.AsyncCollectiveTensor) else y
            assert tuple(y.shape) == (4096, 64) and trace.live == 4096 * 64 * 4
            del y
    assert trace.peak == trace.largest == 4096 * 64 * 4 and trace.live == 0
    assert [(a["op"], a["shape"]) for a in trace.at_peak()] == [
        ("_c10d_functional.all_gather_into_tensor.default", [4096, 64])]
    assert trace.collectives == [("all_gather_into_tensor", 4096 * 64 * 4, 4)]


def test_the_embedding_table_gathered_for_a_prefill_is_counted():
    """The FSDP-pure prefill of qwen3-8b at a vocab of 32768 looks its
    tokens up in the whole table, gathered over the batch's mesh dims:
    that (32768, 64) f32 all-gather is among the storages at its peak."""
    from repro_torch import smoke_dryrun
    cell = next(c for c in MINI_CELLS if c.shape.kind == "prefill" and c.vocab is not None)
    row = smoke_dryrun.mini_cell(cell, "cpu", attribute=4)
    assert any(a["op"].startswith("_c10d_functional.") and a["shape"] == [cell.vocab, 64]
               for a in row["at_peak"]), row["at_peak"]


def _spy(monkeypatch, module, name, record):
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        record(*args, **kwargs)
        return orig(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("arch,kind,batch,policy", [
    ("falcon-mamba-7b", "train", 4, "baseline"),         # di over 'model'
    ("zamba2-7b", "train", 4, "baseline"),               # heads
    ("zamba2-7b", "prefill", 2, "optimized"),            # the sequence on 'model'
])
def test_the_ssm_scans_run_on_each_ranks_channels(monkeypatch, arch, kind, batch, policy):
    """On a fake ('data', 'model') = (2, 2) world, a state-less scan (the TP
    policy's training; the FSDP-pure prefill, whose sequence 'model'
    splits) runs on each rank's block of the state's channels over
    'model' (`ssm._scan_layout`), not on whole rows: every scan's state
    holds half of Mamba-1's di or of Mamba-2's heads."""
    from repro_torch.models import ssm
    seen = []
    for name in ("_mamba1_scan", "_ssd_scan"):
        _spy(monkeypatch, ssm, name, lambda h, *args: seen.append(tuple(h.shape)))
    cfg = get_smoke_config(arch)
    chans = ssm.d_inner(cfg) if cfg.ssm.kind == "mamba1" else ssm.d_inner(cfg) // cfg.ssm.headdim
    with dryrun.fake_world(4):
        mesh = Mesh((2, 2), ("data", "model"), device="cpu")
        dryrun._compile_cell(cfg, Shape("t", 16, batch, kind), mesh, policy)
    assert seen, "no placed scan"
    assert all(shape[1] == chans // 2 for shape in seen), (chans, seen)


def test_the_scan_layout_follows_the_reference_channel_split():
    """`ssm._scan_layout` splits over 'model' the channels the reference's
    TP rule (`repro.parallel.sharding.param_specs`) splits `dt_bias` along:
    Mamba-1's di, Mamba-2's heads (zamba2-7b's 112 at 16, its smoke
    config's 8 at 2).  Where the heads do not divide (3 heads of 64 at 2),
    `dt_bias` stays whole, and the scan takes the head dims, the dim the
    reference's state rule (`_cache_spec`) splits in that state; where
    neither divides (3 heads of 3), it runs whole."""
    import dataclasses as dc
    import types
    import numpy as np
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro.parallel.sharding import ShardingPolicy, _cache_spec, param_specs
    from repro_torch.configs import get_config
    from repro_torch.models import shards, ssm
    z, f = get_smoke_config("zamba2-7b"), get_smoke_config("falcon-mamba-7b")
    cases = [   # (config, 'model' size, the state dim split or None)
        (get_config("zamba2-7b"), 16, 1), (z, 2, 1), (get_config("falcon-mamba-7b"), 16, 1),
        (f, 2, 1), (dc.replace(z, d_model=96, ssm=dc.replace(z.ssm, headdim=64)), 2, 2),
        (dc.replace(z, d_model=9, n_heads=1, ssm=dc.replace(z.ssm, headdim=3, expand=1)), 2, None),
    ]
    with dryrun.fake_world(32):
        for cfg, n, want in cases:
            mesh = Mesh((32 // n, n), ("data", "model"), device="cpu")
            x = DTensor.from_local(torch.zeros(2, 4, cfg.d_model), mesh.device_mesh,
                                   [Shard(0), Replicate()], run_check=False)
            layout = ssm._scan_layout(shards.Ranks(x), cfg)
            assert layout == [Shard(0), Replicate() if want is None else Shard(want)], \
                (cfg.name, n, layout)
            di = ssm.d_inner(cfg)
            bias = (1, di if cfg.ssm.kind == "mamba1" else di // cfg.ssm.headdim)
            ref = param_specs(cfg, {f"seg0_{cfg.ssm.kind}": {"ssm": {"dt_bias": np.zeros(bias)}}},
                              types.SimpleNamespace(shape={"data": 32 // n, "model": n}),
                              ShardingPolicy())[f"seg0_{cfg.ssm.kind}"]["ssm"]["dt_bias"]
            assert (ref[1] == "model") == (want == 1), (cfg.name, ref)
            if want == 2:
                state = (1,) + tuple(ssm.init_ssm_state(cfg, 2, torch.float32,
                                                        "meta")["h"].shape)
                assert _cache_spec("h", state, (), n, 1, ShardingPolicy())[3] == "model"


def test_a_remat_layer_keeps_no_keys_of_its_chunked_attention():
    """A layer under remat (`torch.utils.checkpoint`) whose chunked
    attention (4096 tokens) reads keys the layer made (as a gathered
    sequence's) leaves only its output live after the forward: the query
    blocks' checkpoints take k and v as inputs, where a closure held them
    to the backward (a placed layer's gathered keys and values, each
    layer's, at deepseek-v3's peak at two pods)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import attention

    def layer(x):
        k = x * 2
        return attention._sdpa_chunked(x, k, k, causal=True)
    with FakeTensorMode() as fake:
        x = torch.empty(1, 4096, 1, 64, requires_grad=True)
        trace = dryrun.StepTrace(fake, known=[x])
        with trace:
            y = checkpoint(layer, x, use_reentrant=False)
            live = trace.live
            y.sum().backward()
    nbytes = 4096 * 64 * 4
    assert nbytes <= live < 2 * nbytes, live         # y, not k too


@pytest.mark.parametrize("policy,batch,seq,dim", [("baseline", 4, 16, 2), ("optimized", 2, 24, 1)])
def test_the_mtp_block_runs_on_each_ranks_heads_and_tokens(monkeypatch, policy, batch, seq, dim):
    """deepseek-v3's MTP block on a fake ('data', 'model') = (2, 2) world:
    under the TP policy its attention keeps the heads' split over 'model'
    (its z laid out as the stream, not split along D by the projection's
    columns); under the FSDP-pure policy at batch 2 its S - 1 = 23 tokens
    split along the stream's sequence split over 'model', in DTensor's
    uneven blocks (12 and 11)."""
    from torch.distributed.tensor import Shard
    from repro_torch.models import attention
    seen = []
    _spy(monkeypatch, attention, "_sdpa_on_shards",
         lambda q, k, v, causal: seen.append((q.shape[1], list(q.placements))))
    cfg = dataclasses.replace(get_smoke_config("deepseek-v3-671b"), d_model=256)
    with dryrun.fake_world(4):
        mesh = Mesh((2, 2), ("data", "model"), device="cpu")
        dryrun._compile_cell(cfg, Shape("t", seq, batch, "train"), mesh, policy)
    mtp = [pl for s, pl in seen if s == seq - 1]
    assert mtp and all(s in (seq, seq - 1) for s, _ in seen), seen
    assert all(pl[1] == Shard(dim) for _, pl in seen), seen
