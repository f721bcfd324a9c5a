"""Phase 17 of ``chip_smoke.py``: the LM dry-run launchers on one card.

1. The dry run of a real cell: qwen1.5-0.5b at full width and depth (24
   layers, d 1024, vocab 151,936, bf16) with the merged embedding backward
   (``dedup_embed_grad=True``: #7 `bum_scatter` and `bum_sort`, the exact
   route on a card), trained at a `Shape` of its own, 4 x 1024 tokens,
   traced by `launch.dryrun._compile_cell` on a fake world of 1 with its
   fake tensors on the card (no kernel, no ctypes call, nothing
   allocated): per-device memory, flops and the H100 roofline.
2. The same cell for real: `launch.steps.build_train_step` over a world-1
   NCCL mesh ('data', 'model') = (1, 1), params, AdamW state and batch
   placed as DTensors, two steps.  Gates: the first step's loss equals
   `LM.loss` on the same params and batch bit for bit; the params stay
   finite; the bytes the placed params, optimizer state and batch hold on
   the card (their local storages, each rounded up to the caching
   allocator's 512-byte block) equal the dry run's
   `argument_bytes_per_device` within that rounding a tensor.  The
   allocator's own count around making and placing them
   (`torch.cuda.memory_allocated`) is printed beside it, not gated: it
   also counts any other block made meanwhile.  The second step's wall time is printed
   beside the dry run's predicted step (the largest roofline term, H100
   constants) and their ratio, not gated.  The kernels' launches in the
   steps are this path's (``dryrun_step``).
3. One production cell: qwen1.5-0.5b x decode_32k on a fake world of 256
   (``python -m repro_torch.launch.dryrun --device cuda --no-probes``), in
   a subprocess started before part 1 (a process of its own: this one's
   process groups come and go), its JSON row's summary and wall time
   printed.
4. The mini cells (`MINI_CELLS`): smoke configs at a shape of their own
   (Shape("t", 32, 8, kind), or another batch or sequence) on fake (2, 2, 2)
   ('pod', 'data', 'model') worlds, fake tensors on the CPU (as the CPU
   tests trace them; no CUDA context a process), one subprocess a cell
   (``python -m repro_torch.smoke_dryrun ARCH KIND --batch N --device
   cpu``) started beside the production cell: the reference's three
   (qwen3-8b and deepseek-v2-lite training, falcon-mamba-7b's decode) and
   falcon-mamba-7b's training, the absorbed MLA decode and zamba2-7b's
   hybrid training and decode at batch 8; and three whose residual stream
   splits along its sequence, as the production `prefill_32k` cells' and
   the two-pod `train_4k` cells' do: qwen3-8b's training and zamba2-7b's
   prefill at batch 2 (the batch on 'pod', the sequence on ('data',
   'model')) and deepseek-v2-lite's prefill at batch 4 (the batch on
   ('pod', 'data'), the sequence on 'model'; the reference's `moe_ep`
   needs the batch to divide over ('pod', 'data')); and two of qwen3-8b
   at batch 8 and a vocab of 32768, where the logits take most of the
   memory as at production: the TP (baseline) policy's training (its
   logits split along the vocab, scored by `lm._vocab_parallel_nll`) and
   the prefill (the last token's head product, `LM._head_rows`); and four
   whose blocks run on each rank's share of the work: the TP (baseline)
   policy's training of falcon-mamba-7b and zamba2-7b (at 128 tokens; the
   SSM block on each rank's channels, `ssm._scan_layout`) and of
   deepseek-v3 (at 128 tokens: MLA's attention, the MTP block's too, on
   each rank's heads), and deepseek-v3's at batch 4 and 256 tokens (the
   MTP block on each rank's uneven block of 255 tokens).  Gates: each
   traces; the collective kind named is in its trace; its argument bytes
   a device equal JAX's; the six gated cells' temp bytes at most
   `MiniCell.max_temp` (twice JAX's recorded temp for the TP vocab
   training, 1.5 times the whole head in f32 for the prefill, JAX's for
   the four), the four's largest storage at most `MiniCell.max_largest`.  Temp bytes, the largest storage,
   flops, wire bytes (each collective kind's too) and seconds printed.

`dryrun_phase(device, card, smoke=True)` runs the same on the smoke config
at a small shape (gloo on the CPU), which the CPU tests rehearse.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

from . import kernels
from .configs import get_config, get_smoke_config
from .configs.shapes import Shape
from .launch import dryrun, steps
from .launch.mesh import Mesh
from .launch.roofline import model_flops_for, roofline
from .models.lm import LM
from .optim.adamw import tree_paths
from .smoke_parallel import world_of_one

ARCH = "qwen1_5-0_5b"
STEP_SHAPE = Shape("phase17", 1024, 4, "train")
SMOKE_SHAPE = Shape("phase17_smoke", 16, 2, "train")
PRODUCTION_CELL = ("decode_32k", 600)     # (shape, subprocess timeout s)
ALLOC_ROUND = 512                         # the CUDA caching allocator's rounding
MINI_MESH = ((2, 2, 2), ("pod", "data", "model"))
MINI_SEQ = 32
MINI_TIMEOUT = 300                        # s, a cell's subprocess


class MiniCell(NamedTuple):
    """A mini cell: the arch's smoke config at `shape`, its vocab replaced by
    `vocab` where given (the logits then take most of the memory, as at
    production), under the policy `policy`; `coll` a collective kind its
    trace must show (the reference's test asserts the first three's) or
    None; `jax_bytes` JAX's `argument_size_in_bytes` a device and
    `jax_temp` its `temp_size_in_bytes` (recorded for the cells whose
    memory is gated), checked against JAX on the CPU by
    tests/test_torch_launch_dryrun.py::test_mini_cells_record_jax_bytes;
    `max_temp` the most temp bytes a device the port's trace may show, or
    None; `max_largest` the largest storage it may make, or None.

    The limits: the TP vocab cell's temp twice JAX's; the prefill vocab
    cell's 1.5 times the whole head in f32, 3 * head // 2 (head = 64 x
    32768 x 4 B).  The four cells of the TP policy's SSM scans and MLA
    attention and of the MTP head's uneven blocks: temp at most JAX's, and
    their largest storage at most the term that 'model' = 2 halves, at its
    block (B_l rows a rank, 2 of 8 here; S the cell's sequence):
    falcon-mamba-7b's scan terms (B_l, S, di / 2, n) f32, 2 x 32 x 64 x 8
    x 4; deepseek-v3's score tiles (B_l, H / 2, S, S) f32 under the TP
    policy, 2 x 2 x 128 x 128 x 4, and (B_l, H, S / 2, S) f32 on the
    sequence split, 1 x 4 x 128 x 256 x 4; zamba2-7b's shared attention's
    score tile (B_l, H / 2, S, S) f32, 2 x 2 x 128 x 128 x 4, above its SSD
    block's largest term at the head block, in_proj's output (B_l, S, di
    + 2n + P / 2) f32, 2 x 128 x 164 x 4 (whole, 296 channels, above it)."""
    arch: str
    shape: Shape
    coll: str | None
    jax_bytes: int
    vocab: int | None = None
    policy: str = "optimized"
    jax_temp: int | None = None
    max_temp: int | None = None
    max_largest: int | None = None

    @property
    def name(self) -> str:
        return " ".join([self.arch, self.shape.kind, str(self.shape.global_batch)]
                        + ([f"s{self.shape.seq}"] if self.shape.seq != MINI_SEQ else [])
                        + ([self.policy] if self.policy != "optimized" else [])
                        + ([f"v{self.vocab}"] if self.vocab else []))

    def config(self):
        cfg = get_smoke_config(self.arch)
        return cfg if self.vocab is None else dataclasses.replace(cfg, vocab=self.vocab)


def _mini(arch: str, kind: str, batch: int, coll, jax_bytes: int, seq: int = MINI_SEQ,
          **kw) -> MiniCell:
    return MiniCell(arch, Shape("t", seq, batch, kind), coll, jax_bytes, **kw)


BIG_VOCAB = 32768
MINI_CELLS = (
    _mini("qwen3-8b", "train", 8, "all-reduce", 938628),
    _mini("deepseek-v2-lite-16b", "train", 8, "all-to-all", 3920580),
    _mini("falcon-mamba-7b", "decode", 8, None, 260872),
    _mini("falcon-mamba-7b", "train", 8, None, 1116804),
    _mini("deepseek-v2-lite-16b", "decode", 8, None, 1039504),
    _mini("zamba2-7b", "train", 8, None, 1237668),
    _mini("zamba2-7b", "decode", 8, None, 513808),
    # the residual stream split along its sequence
    _mini("qwen3-8b", "train", 2, "all-gather", 938532),
    _mini("deepseek-v2-lite-16b", "prefill", 4, "all-to-all", 1306816),
    _mini("zamba2-7b", "prefill", 2, "all-gather", 412544),
    # the logits at a vocab of 32768: the TP policy's vocab-split loss (its
    # temp at most twice JAX's) and the last token's head product (at most
    # 1.5 times the whole head in f32, 64 x 32768 x 4 B)
    _mini("qwen3-8b", "train", 8, "all-reduce", 25613060, vocab=BIG_VOCAB,
          policy="baseline", jax_temp=21557752, max_temp=2 * 21557752),
    _mini("qwen3-8b", "prefill", 8, None, 2393728, vocab=BIG_VOCAB, jax_temp=138560,
          max_temp=3 * 64 * BIG_VOCAB * 4 // 2),
    # the TP policy's SSM scans on each rank's channels and MLA attention on
    # each rank's heads (deepseek-v3's MTP block too), and the MTP block on
    # each rank's uneven block of S - 1 tokens (the batch on ('pod', 'data'),
    # the sequence on 'model'): temp at most JAX's, the largest storage at
    # most the term at its block (`MiniCell`)
    _mini("falcon-mamba-7b", "train", 8, None, 732164, policy="baseline", jax_temp=5843136,
          max_temp=5843136, max_largest=2 * 32 * 64 * 8 * 4),
    _mini("zamba2-7b", "train", 8, None, 1008260, seq=128, policy="baseline",
          jax_temp=18267264, max_temp=18267264, max_largest=2 * 2 * 128 * 128 * 4),
    _mini("deepseek-v3-671b", "train", 8, None, 3957572, seq=128, policy="baseline",
          jax_temp=16631984, max_temp=16631984, max_largest=2 * 2 * 128 * 128 * 4),
    _mini("deepseek-v3-671b", "train", 4, "all-to-all", 6307140, seq=256, jax_temp=19488432,
          max_temp=19488432, max_largest=1 * 4 * 128 * 256 * 4),
)


def _cfg(smoke: bool):
    cfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    return dataclasses.replace(cfg, dedup_embed_grad=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _allocated(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    gc.collect()
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


def start_production_cell(device, out_dir: str) -> subprocess.Popen:
    """The dry-run CLI on the production cell, in the background."""
    src = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", PRODUCTION_CELL[0], "--device", torch.device(device).type,
         "--no-probes", "--out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def finish_production_cell(proc: subprocess.Popen, out_dir: str, t0: float) -> dict:
    try:
        _, stderr = proc.communicate(timeout=PRODUCTION_CELL[1])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"the production cell's dry run failed:\n{stderr[-3000:]}")
    row = json.loads((Path(out_dir) / f"{ARCH}__{PRODUCTION_CELL[0]}__pod1.json").read_text())
    return {"row": row, "wall_s": time.perf_counter() - t0}


def mini_cell(cell: MiniCell, device, attribute: int = 0) -> dict:
    """One mini cell traced on a fake world of 8 in this process: its
    collective kinds, per-device flops, bytes and wire bytes, memory, the
    largest storage the step made, and the seconds the trace took; with
    `attribute` > 0, the largest storages live at the peak
    (`dryrun.StepTrace`)."""
    t0 = time.perf_counter()
    with dryrun.fake_world(8):
        mesh = Mesh(*MINI_MESH, device=device)
        mem, m, coll, _, trace = dryrun.trace_cell(cell.config(), cell.shape, mesh, cell.policy,
                                                   attribute)
    out = {"arch": cell.arch, "kind": cell.shape.kind, "batch": cell.shape.global_batch,
           "kinds": sorted(coll["ops"]),
           "wire_by_kind": {k: v["wire_bytes"] for k, v in sorted(coll["ops"].items())}, **m,
           **dataclasses.asdict(mem), "largest_storage": trace.largest,
           "trace_s": time.perf_counter() - t0}
    return {**out, "at_peak": trace.at_peak()} if attribute else out


def _cli(cell: MiniCell) -> list[str]:
    """`main`'s arguments for `cell`."""
    return [cell.arch, cell.shape.kind, "--batch", str(cell.shape.global_batch),
            "--seq", str(cell.shape.seq), "--policy", cell.policy] \
        + (["--vocab", str(cell.vocab)] if cell.vocab else [])


def start_mini_cells() -> list:
    """Each mini cell in a subprocess of its own, in the background, its
    fake tensors on the CPU."""
    src = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.smoke_dryrun", *_cli(cell), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
        for cell in MINI_CELLS]


def finish_mini_cells(procs: list, t0: float) -> list[dict]:
    """Each cell's row: its `mini_cell` result and status "ok", or status
    "failed" and the end of its errors; with the wall time since `t0`."""
    rows = []
    try:
        for cell, proc in procs:
            try:
                stdout, stderr = proc.communicate(timeout=MINI_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            if proc.returncode == 0:
                row = {**json.loads(stdout.strip().splitlines()[-1]), "status": "ok"}
            else:
                row = {"arch": cell.arch, "kind": cell.shape.kind,
                       "batch": cell.shape.global_batch, "status": "failed",
                       "error": stderr[-2000:]}
            rows.append({**row, "wall_s": time.perf_counter() - t0})
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rows


def check_mini(rows: list[dict]) -> list[str]:
    problems = []
    for cell, row in zip(MINI_CELLS, rows):
        if row["status"] != "ok":
            problems.append(f"mini cell {cell.name} failed: {row['error']}")
            continue
        if cell.coll is not None and cell.coll not in row["kinds"]:
            problems.append(f"mini cell {cell.name}: no {cell.coll} in {row['kinds']}")
        if row["argument_size_in_bytes"] != cell.jax_bytes:
            problems.append(f"mini cell {cell.name}: args {row['argument_size_in_bytes']} B "
                            f"!= JAX's {cell.jax_bytes} B")
        if cell.max_temp is not None and row["temp_size_in_bytes"] > cell.max_temp:
            problems.append(f"mini cell {cell.name}: temp {row['temp_size_in_bytes']} B > "
                            f"{cell.max_temp} B (JAX's {cell.jax_temp} B)")
        if cell.max_largest is not None and row["largest_storage"] > cell.max_largest:
            problems.append(f"mini cell {cell.name}: largest storage {row['largest_storage']} B "
                            f"> {cell.max_largest} B")
    return problems


def dry_cell(device, smoke: bool) -> dict:
    """Part 1: the traced cell at world 1, fake tensors on `device`."""
    cfg, shape = _cfg(smoke), SMOKE_SHAPE if smoke else STEP_SHAPE
    t0 = time.perf_counter()
    with dryrun.fake_world(1):
        mesh = Mesh((1, 1), ("data", "model"), device=device)
        mem, raw, coll, _ = dryrun._compile_cell(cfg, shape, mesh)
    min_bytes = float(mem.argument_size_in_bytes + mem.output_size_in_bytes
                      - mem.alias_size_in_bytes)
    rl = roofline({"flops": raw["flops"], "bytes accessed": raw["bytes"]}, coll, 1,
                  model_flops_for(cfg, shape), min_bytes).to_dict()
    return {"memory": dataclasses.asdict(mem), "raw": raw, "roofline": rl,
            "trace_s": time.perf_counter() - t0}


def real_step(device, smoke: bool) -> dict:
    """Part 2: two placed train steps over a world-1 group."""
    cfg, shape = _cfg(smoke), SMOKE_SHAPE if smoke else STEP_SHAPE
    gen = torch.Generator(device=device).manual_seed(0)
    with world_of_one(device):
        mesh = Mesh((1, 1), ("data", "model"), device=device)
        fn, (abstract_params, _, abstract_batch) = steps.build_train_step(cfg, mesh, shape)
        opt = steps.make_optimizer(cfg)
        torch.randn((1,), generator=gen, device=device)    # the generator's own state first
        m0 = _allocated(device)
        params = LM(cfg, device=device).init(gen)
        tokens = torch.randint(0, cfg.vocab, tuple(abstract_batch["tokens"].shape),
                               generator=gen, device=device, dtype=torch.int32)
        placed = fn.place(params, opt.init(params), {"tokens": tokens})
        del params, tokens
        held = _allocated(device) - m0
        n_tensors = sum(len(steps._state_items(t)) for t in placed)
        local = [steps._local_tree(t) for t in placed]
        storages = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                    for tree in local for _, t in steps._state_items(tree)}
        rounded = sum(-(-n // ALLOC_ROUND) * ALLOC_ROUND for n in storages.values())
        loss_ref = LM(cfg, device=device).loss(local[0], local[2])
        kernels.reset_launches()
        t0 = time.perf_counter()
        _, _, loss1 = fn(*placed)
        _sync(device)
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _, _, loss2 = fn(*placed)
        _sync(device)
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
        finite = all(bool(torch.isfinite(t).all()) for _, t in tree_paths(local[0]))
        loss1, loss2 = loss1.full_tensor(), loss2.full_tensor()
        out = {"loss_ref": float(loss_ref), "loss1": float(loss1), "loss2": float(loss2),
               "bit_identical": bool(torch.equal(loss1, loss_ref)), "finite": finite,
               "held_bytes": held, "storage_bytes": rounded, "n_tensors": n_tensors,
               "first_ms": first_ms,
               "step_ms": step_ms, "launches": launches,
               "dtensor": type(placed[0]["embed"]).__name__}
        del placed, local
    return out


def dryrun_phase(device, card: str, smoke: bool = False) -> dict:
    """Phase 17, with its gates."""
    t_phase = time.perf_counter()
    device = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        t_cell = time.perf_counter()
        proc = start_production_cell(device, tmp)
        minis = start_mini_cells()
        try:
            dry = dry_cell(device, smoke)
            real = real_step(device, smoke)
        except BaseException:
            for p in [proc] + [p for _, p in minis]:
                p.kill()
                p.wait()
            raise
        mini = finish_mini_cells(minis, t_cell)
        cell = finish_production_cell(proc, tmp, t_cell)
    mem, rl = dry["memory"], dry["roofline"]
    shape = SMOKE_SHAPE if smoke else STEP_SHAPE
    predicted_s = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
    print(f"dryrun cell {ARCH} train {shape.global_batch} x {shape.seq} at world 1 (traced in "
          f"{dry['trace_s']:.2f} s): args {mem['argument_size_in_bytes']} B, temp "
          f"{mem['temp_size_in_bytes']} B, flops/dev {rl['flops_per_device']:.6g}; roofline "
          f"(H100 989.4 TFLOP/s bf16, 3.35 TB/s): compute {rl['compute_s'] * 1e3:.3f} ms, "
          f"memory {rl['memory_s'] * 1e3:.3f} ms, collective {rl['collective_s'] * 1e3:.3f} ms "
          f"-> {rl['bound']}-bound [{card}]", flush=True)
    print(f"dryrun real step ({real['dtensor']} params, world-1 group): loss "
          f"{real['loss1']:.6f} (LM.loss {real['loss_ref']:.6f}, bit identical "
          f"{real['bit_identical']}), step 2 loss {real['loss2']:.6f}; args on the card "
          f"{real['storage_bytes']} B (storages, each rounded to 512 B; the allocator's "
          f"count {real['held_bytes']} B) vs dry run {mem['argument_size_in_bytes']} B over "
          f"{real['n_tensors']} tensors; step {real['step_ms']:.2f} ms (first "
          f"{real['first_ms']:.2f} ms) vs predicted {predicted_s * 1e3:.3f} ms: measured / "
          f"predicted {real['step_ms'] / 1e3 / max(predicted_s, 1e-30):.3f} [{card}]",
          flush=True)
    row = cell["row"]
    summary = {k: row[k] for k in ("arch", "shape", "n_devices", "status", "compile_s")}
    summary.update(memory=row["memory"], collectives=row["collectives"],
                   roofline=row["roofline_raw"])
    print(f"dryrun production cell {ARCH} x {PRODUCTION_CELL[0]} on a fake world of 256 "
          f"(subprocess wall {cell['wall_s']:.2f} s): {json.dumps(summary)} [{card}]",
          flush=True)
    for mc, r in zip(MINI_CELLS, mini):
        if r["status"] != "ok":
            continue        # its error is in the phase's problems
        print(f"dryrun mini cell {mc.name} on a fake (2, 2, 2) world (torch "
              f"{torch.__version__}, subprocess wall {r['wall_s']:.2f} s, traced in "
              f"{r['trace_s']:.2f} s): ok, args {r['argument_size_in_bytes']} B (JAX "
              f"{mc.jax_bytes} B), temp {r['temp_size_in_bytes']} B"
              + (f" (JAX {mc.jax_temp} B, limit {mc.max_temp} B)" if mc.max_temp else "")
              + f", largest storage {r['largest_storage']} B"
              + (f" (limit {mc.max_largest} B)" if mc.max_largest else "")
              + f", flops/dev {r['flops']:.0f}, "
              f"wire/dev {r['wire']:.0f} B {json.dumps(r['wire_by_kind'])}, bytes/dev "
              f"{r['bytes']:.0f} [{card}]", flush=True)
    problems = check(real, mem, device.type == "cuda") + check_mini(mini)
    if row["status"] != "ok" or row["n_devices"] != 256:
        problems.append(f"production cell: {summary}")
    if problems:
        raise RuntimeError(f"dry-run phase: {problems}")
    print(f"dryrun_step-path launches: {json.dumps(real['launches'])}", flush=True)
    seconds = {"trace": dry["trace_s"], "production_cell": cell["wall_s"],
               "mini_cells": max(r["wall_s"] for r in mini),
               "phase": time.perf_counter() - t_phase}
    print(f"dryrun phase: {json.dumps(seconds)} [{card}]", flush=True)
    return {"dry": dry, "real": real, "cell": cell, "mini": mini, "seconds": seconds,
            "launches": {"dryrun_step": real["launches"]}}


def check(real: dict, mem: dict, on_card: bool) -> list[str]:
    problems = []
    if not real["bit_identical"]:
        problems.append(f"first loss {real['loss1']!r} != LM.loss {real['loss_ref']!r}")
    if not real["finite"]:
        problems.append("params not finite after two steps")
    if real["dtensor"] != "DTensor":
        problems.append(f"the step's params are {real['dtensor']}, not placed")
    if on_card:
        slack = ALLOC_ROUND * real["n_tensors"]
        if not 0 <= real["storage_bytes"] - mem["argument_size_in_bytes"] <= slack:
            problems.append(f"args on the card {real['storage_bytes']} B vs dry run "
                            f"{mem['argument_size_in_bytes']} B (slack {slack})")
        missing = [k for k in ("bum_sort", "bum_scatter") if real["launches"].get(k, 0) == 0]
        if missing:
            problems.append(f"the step never launched {missing}")
    return problems


def main(argv=None) -> None:
    """``python -m repro_torch.smoke_dryrun ARCH KIND [--batch 8] [--seq 32]
    [--policy optimized] [--vocab V] [--device cuda] [--attribute K]``: one
    mini cell; its JSON row printed last (with `--attribute`, the K largest
    storages live at its peak, each with its op and source lines)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("kind")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=MINI_SEQ)
    ap.add_argument("--policy", default="optimized", choices=["baseline", "optimized"])
    ap.add_argument("--vocab", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attribute", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cell = _mini(args.arch, args.kind, args.batch, None, 0, seq=args.seq, vocab=args.vocab,
                 policy=args.policy)
    print(json.dumps(mini_cell(cell, args.device, args.attribute)))


if __name__ == "__main__":
    main()
