"""Multi-pod dry run: trace one step of every (arch x shape x mesh) cell on
fake tensors -- nothing allocated, no compiler -- and record its per-device
memory, flops and collectives for the roofline table.

The port of `repro.launch.dryrun`:

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--out results/dryrun_torch] [--jobs 8]
        [--arch a,b] [--shape s,t] [--pods 1,2]

`--all` runs each cell in a subprocess, `--jobs` of them at once, and
skips a cell whose row is written already (`--force` runs it again);
`--arch` / `--shape` / `--pods` narrow it to those cells.  The rows'
names do not carry the policy: give `--policy baseline` its own `--out`.

Where the reference lowers and compiles each cell for 256 / 512 host
devices, the port runs the step once (`steps.build_step_cfg`) on a fake
process group of the mesh's size (`fake_world`: backend "fake", every
collective returns at once) under `FakeTensorMode`, with its params,
optimizer state and batch placed as DTensors, and watches it with
`StepTrace`, a dispatch mode that sees the ops each rank runs on its own
local shards:

* flops: `torch.utils.flop_counter`'s formulas (FlopCounterMode's) on the
  local shards -- per device, as `cost_analysis()` reports; FlopCounterMode
  itself, over DTensors, counts the global product.  Matmuls, attention
  and convolutions only, where XLA counts every op.
* bytes: every op's local operands and results (before any fusion, as the
  reference's "bytes accessed" is).
* collectives: each one the step runs, DTensor's and the port's own
  `torch.distributed` calls (`moe_ep`'s all_to_all) alike, with its result
  bytes and group size -> `roofline.collective_stats`.
* memory: `argument_bytes_per_device` is rank 0's local shard bytes of
  every argument the step reads (jit drops the others; DTensor splits as `torch.chunk`, the first ranks taking
  the ceiling, as JAX's padded shards do); outputs likewise; the aliased
  bytes are the donated ones the step updates in place (params and
  optimizer state in training, the caches in decode);
  `temp_bytes_per_device` is the fake-tensor peak: the largest sum of live
  storages the step made, less its outputs that alias no argument.

The layer loop is Python, so a full-depth trace counts every layer:
`corrected_metrics` (the reference's probe-and-extrapolate, which undoes
its scan's count-once) agrees with the direct count and is kept for the
reference's JSON.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs import get_config
from ..configs.shapes import SHAPES, applicable
from .mesh import make_production_mesh
from .roofline import KINDS, collective_stats, model_flops_for, roofline
from .steps import _state_items, build_step_cfg, materialize

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


def probe_variants(cfg):
    """Small config variants whose costs solve for per-layer-body costs.
    Returns (variants, coeff_rows, full_counts):
    cost(variant_i) = coeff_rows[i] · body_costs;  true = full_counts · body_costs.
    """
    r = dataclasses.replace
    if cfg.enc_dec:
        a = r(cfg, n_layers=1, n_encoder_layers=1, unroll_layers=True)
        b = r(cfg, n_layers=1, n_encoder_layers=2, unroll_layers=True)
        c = r(cfg, n_layers=2, n_encoder_layers=1, unroll_layers=True)
        return [a, b, c], [[1, 1, 1], [1, 2, 1], [1, 1, 2]], \
            [1, cfg.n_encoder_layers, cfg.n_layers]
    if cfg.hybrid_attn_every:
        ev = cfg.hybrid_attn_every
        a = r(cfg, n_layers=1, hybrid_attn_every=0, unroll_layers=True)
        b = r(cfg, n_layers=2, hybrid_attn_every=0, unroll_layers=True)
        c = r(cfg, n_layers=ev, hybrid_attn_every=ev, unroll_layers=True)
        return [a, b, c], [[1, 1, 0], [1, 2, 0], [1, ev, 1]], \
            [1, cfg.n_layers, cfg.n_layers // ev]
    if cfg.moe is not None and cfg.moe.n_dense_layers:
        nd = cfg.moe.n_dense_layers
        a = r(cfg, n_layers=2, moe=r(cfg.moe, n_dense_layers=1), unroll_layers=True)
        b = r(cfg, n_layers=3, moe=r(cfg.moe, n_dense_layers=1), unroll_layers=True)
        c = r(cfg, n_layers=3, moe=r(cfg.moe, n_dense_layers=2), unroll_layers=True)
        return [a, b, c], [[1, 1, 1], [1, 1, 2], [1, 2, 1]], \
            [1, nd, cfg.n_layers - nd]
    a = r(cfg, n_layers=1, unroll_layers=True)
    b = r(cfg, n_layers=2, unroll_layers=True)
    return [a, b], [[1, 1], [1, 2]], [1, cfg.n_layers]


# --- the fake world ---------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A process group of `world_size` ranks in this one process, as rank
    `rank`, whose collectives do nothing (backend "fake"); destroyed on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --- the trace ------------------------------------------------------------------

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _group_size(args, kwargs) -> int | None:
    """The size of the process group a collective op runs over."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
        size = getattr(a, "size", None)
        if callable(size) and not isinstance(a, torch.Tensor) and hasattr(a, "rank"):
            return int(size())
    return None


class StepTrace(TorchDispatchMode):
    """Watches the ops each rank runs on its local tensors: the flops (by
    FlopCounterMode's formulas), the bytes every op reads and writes, the
    collectives (kind, result bytes, group size), the storages read, and
    the peak of live storages made while active (`known`: tensors that
    exist already, the step's arguments, whose in-place updates make
    nothing).  Only ops on the fake tensors of `fake_mode`, the step's,
    count: DTensor infers each op's global shape on fake tensors of a mode
    of its own.  An op on DTensors is let through so that DTensor runs it
    as local ops and collectives, which this mode then sees.  `largest` is
    the largest storage made; with `attribute` > 0, `at_peak()` lists the
    `attribute` largest storages live at the peak, each with the op that
    made it and the innermost lines of the port's source on its stack (a
    frame walk an op: the trace runs slower)."""

    def __init__(self, fake_mode, known=(), attribute: int = 0):
        super().__init__()
        self.fake_mode = fake_mode
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int, int | None]] = []
        self.live = 0
        self.peak = 0
        self.largest = 0
        self.attribute = attribute
        self._where: dict[int, tuple] = {}
        self._at_peak: list[tuple] = []
        self._seen: set[int] = {id(_local(t).untyped_storage()) for t in known}
        self._made: dict[int, int] = {}
        self._read: set[int] = set()
        self._in_dtensor = False

    def _free(self, key: int, nbytes: int) -> None:
        self._seen.discard(key)
        self._where.pop(key, None)
        if self._made.pop(key, None) is not None:
            self.live -= nbytes

    def _hand_over(self, src, dst) -> None:
        """`wait_tensor` hands back its argument's storage; a fake one is a
        new storage of its own, so the argument's count moves to it (the
        result is counted once, for as long as it lives)."""
        key = id(src.untyped_storage())
        if key != id(dst.untyped_storage()) and key in self._made:
            self.live -= self._made.pop(key)
            self._where.pop(key, None)

    def _track(self, t: torch.Tensor, func) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self._made[key] = n
        self.live += n
        self.largest = max(self.largest, n)
        if self.attribute:
            self._where[key] = (n, str(func), tuple(t.shape), str(t.dtype), _source_lines())
            if self.live > self.peak:
                self._at_peak = sorted(self._where.values(), key=lambda w: -w[0])[
                    :self.attribute]
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def at_peak(self) -> list[dict]:
        """The largest storages live at the peak (`attribute` > 0)."""
        return [{"bytes": n, "op": op, "shape": list(shape), "dtype": dtype, "source": src}
                for n, op, shape, dtype, src in self._at_peak]

    def made_bytes(self, tensors) -> int:
        """Bytes of the storages among `tensors` that the step made."""
        keys = {id(_local(t).untyped_storage()) for t in tensors}
        return sum(self._made.get(k, 0) for k in keys)

    def was_read(self, t) -> bool:
        return id(_local(t).untyped_storage()) in self._read

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._in_dtensor:
                return NotImplemented
            # DTensor's own bookkeeping (a strided shard's offsets) computes
            # on real index tensors: run its dispatch outside the fake mode
            # (the fake local shards keep theirs), this mode still watching
            self._in_dtensor = True
            try:
                with unset_fake_temporarily(), self:
                    return func(*args, **kwargs)
            finally:
                self._in_dtensor = False
        flat_in = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        out = func(*args, **kwargs)
        flat_out = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not any(isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode
                   for t in flat_in + flat_out):
            return out     # DTensor's bookkeeping: no step's work
        # a view or a metadata query (`prim.device`) reads and writes nothing
        moves = not func.is_view and bool(flat_out)
        if moves:
            self._read.update(id(t.untyped_storage()) for t in flat_in)
        packet = func._overloadpacket
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if packet.__name__ in KINDS:
                # a c10d op writes its result into its first argument
                result = out if func.namespace != "c10d" else \
                    args[0][0] if isinstance(args[0], (list, tuple)) else args[0]
                self.collectives.append((packet.__name__, _nbytes(result),
                                         _group_size(args, kwargs)))
            # a functional collective's result is a storage the step made; a
            # c10d op writes into its argument, known already
            if func.namespace == "_c10d_functional":
                if packet.__name__ == "wait_tensor":
                    self._hand_over(args[0], out)
                for t in flat_out:
                    self._track(t, func)
            return out
        if packet in self._flops:
            self.flops += int(self._flops[packet](*args, **kwargs, out_val=out))
        if moves:
            self.bytes += sum(_nbytes(t) for t in flat_in + flat_out)
            for t in flat_out:
                self._track(t, func)
        return out


_PORT = str(Path(__file__).resolve().parent.parent)


def _source_lines(depth: int = 3) -> list[str]:
    """The innermost `depth` frames of the port's own source on the stack
    (this module's left out), as "models/lm.py:380 _nll"."""
    out, frame = [], sys._getframe(1)
    while frame is not None and len(out) < depth:
        path = frame.f_code.co_filename
        if path.startswith(_PORT) and path != __file__:
            out.append(f"{path[len(_PORT) + 1:]}:{frame.f_lineno} {frame.f_code.co_name}")
        frame = frame.f_back
    return out


@dataclasses.dataclass
class MemoryAnalysis:
    """The fields of XLA's `memory_analysis()` the reference reads."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return [t for part in tree for t in _leaves(part)]
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for _, t in _state_items(tree)]


def _shard_bytes(tensors) -> int:
    return sum(_nbytes(_local(t)) for t in tensors)


def _donated(shape, placed) -> list:
    """The arguments a step updates in place: params and optimizer state
    in training, the caches in decode."""
    if shape.kind == "train":
        return _leaves(placed[0]) + _leaves(placed[1])
    if shape.kind == "decode":
        return _leaves(placed[1]["caches"])
    return []


def _compile_cell(cfg, shape_name, mesh, variant="optimized"):
    """Trace one step of one config on fake tensors on the mesh's device;
    returns (memory analysis, metrics dict, collective stats, shape).  The
    mesh's world must be up (a `fake_world` of its size)."""
    return trace_cell(cfg, shape_name, mesh, variant)[:4]


def trace_cell(cfg, shape_name, mesh, variant="optimized", attribute: int = 0):
    """`_compile_cell`'s four results and the `StepTrace` itself (its
    `attribute` as given)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    # DTensor's own index tensors (an uneven or strided shard's) are real
    with FakeTensorMode(allow_non_fake_inputs=True) as fake_mode:
        (fn, abstract_args), cfg, shape = build_step_cfg(cfg, shape_name, mesh, variant)
        placed = fn.place(*(materialize(a, mesh.device) for a in abstract_args))
        donated = {id(_local(t).untyped_storage()) for t in _donated(shape, placed)}
        trace = StepTrace(fake_mode, known=_leaves(placed), attribute=attribute)
        with trace:
            out = fn(*placed)
            out_leaves = _leaves(out)
            made = trace.made_bytes(out_leaves)
        # an argument the step never reads is no argument of the program,
        # as jit drops it (a Mamba decode's `pos`)
        args_bytes = _shard_bytes([t for t in _leaves(placed) if trace.was_read(t)])
        out_bytes = _shard_bytes(out_leaves)
        alias_bytes = sum(_nbytes(_local(t)) for t in out_leaves
                          if id(_local(t).untyped_storage()) in donated)
    mem = MemoryAnalysis(args_bytes, out_bytes, max(trace.peak - made, 0), alias_bytes)
    coll = collective_stats(trace.collectives, default_group=mesh.shape.get("model", 1))
    metrics = {"flops": float(trace.flops), "bytes": float(trace.bytes),
               "wire": float(coll["wire_bytes_per_device"])}
    return mem, metrics, coll, shape, trace


def corrected_metrics(cfg, shape_name, mesh, variant="optimized"):
    """Probe-and-extrapolate per-step flops / bytes / wire per device."""
    variants, rows, full = probe_variants(cfg)
    ys = []
    for v in variants:
        _, m, _, _ = _compile_cell(v, shape_name, mesh, variant)
        ys.append([m["flops"], m["bytes"], m["wire"]])
    a = np.asarray(rows, dtype=np.float64)
    y = np.asarray(ys, dtype=np.float64)
    body, *_ = np.linalg.lstsq(a, y, rcond=None)
    est = np.asarray(full, dtype=np.float64) @ body
    est = np.maximum(est, 0.0)
    return {"flops": float(est[0]), "bytes": float(est[1]), "wire": float(est[2])}


def run_cell(arch: str, shape_name: str, multi_pod: bool, probes: bool = True,
             variant: str = "optimized", device="cuda") -> dict:
    """One cell's JSON row (the reference's keys).  Starts a fake world of
    the production mesh's size unless a process group is up already."""

    cfg = get_config(arch)
    ok, why = applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    world = fake_world(512 if multi_pod else 256) if not dist.is_initialized() \
        else contextlib.nullcontext()
    with world:
        return _run_cell(cfg, arch, shape_name, multi_pod, probes, variant, device)


def _run_cell(cfg, arch, shape_name, multi_pod, probes, variant, device) -> dict:

    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    n_devices = mesh.size
    t0 = time.time()
    mem, raw, coll, shape = _compile_cell(cfg, shape_name, mesh, variant)
    t_compile = time.time() - t0

    result = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "policy": variant,
        "status": "ok",
        "n_devices": int(n_devices),
        "compile_s": round(t_compile, 1),
        "memory": {
            "argument_bytes_per_device": int(mem.argument_size_in_bytes),
            "output_bytes_per_device": int(mem.output_size_in_bytes),
            "temp_bytes_per_device": int(mem.temp_size_in_bytes),
            "alias_bytes_per_device": int(mem.alias_size_in_bytes),
            "peak_estimate_gib": round(
                (mem.argument_size_in_bytes + mem.output_size_in_bytes
                 + mem.temp_size_in_bytes - mem.alias_size_in_bytes) / 2**30, 3),
        },
        "collectives": coll["ops"],
        "raw_scan_metrics": raw,  # the direct full-depth count; see corrected_metrics
    }

    mf = model_flops_for(cfg, shape)
    # analytic HBM-traffic lower bound: every input byte read once, every
    # output byte written once (donated buffers alias, counted once)
    min_bytes = float(mem.argument_size_in_bytes + mem.output_size_in_bytes
                      - mem.alias_size_in_bytes)
    if probes and not multi_pod:
        t1 = time.time()
        est = corrected_metrics(cfg, shape_name, mesh, variant)
        result["probe_s"] = round(time.time() - t1, 1)
        cost = {"flops": est["flops"], "bytes accessed": est["bytes"]}
        coll_est = {"wire_bytes_per_device": est["wire"]}
        result["roofline"] = roofline(cost, coll_est, n_devices, mf, min_bytes).to_dict()
    else:
        cost = {"flops": raw["flops"], "bytes accessed": raw["bytes"]}
        coll_est = {"wire_bytes_per_device": raw["wire"]}
        result["roofline_raw"] = roofline(cost, coll_est, n_devices, mf, min_bytes).to_dict()
    return result


def all_cells():
    # smallest archs first so results accumulate fast
    order = ["qwen1_5-0_5b", "qwen2-vl-2b", "whisper-medium", "chatglm3-6b",
             "qwen3-8b", "yi-9b", "falcon-mamba-7b", "zamba2-7b",
             "deepseek-v2-lite-16b", "deepseek-v3-671b"]
    for multi_pod in (False, True):
        for arch in order:
            for shape in SHAPES:
                yield arch, shape, multi_pod


def _run_subprocess(arch: str, shape: str, multi_pod: bool, out_dir: Path, args) -> None:
    """One cell of `--all` in a subprocess of its own; its row written by
    the subprocess, or an "error" / "timeout" row here."""
    tag = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"
    path = out_dir / f"{tag}.json"
    if path.exists() and not args.force:
        print(f"[skip-cached] {tag}", flush=True)
        return
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", str(out_dir),
           "--policy", args.policy, "--device", args.device]
    if multi_pod:
        cmd.append("--multi-pod")
    if args.no_probes:
        cmd.append("--no-probes")
    print(f"[run] {tag}", flush=True)
    t0 = time.time()
    try:
        r = subprocess.run(cmd, timeout=args.timeout, capture_output=True, text=True)
        if r.returncode != 0:
            err = (r.stderr or "")[-2000:]
            path.write_text(json.dumps({
                "arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "error", "stderr_tail": err}, indent=2))
            print(f"[FAIL] {tag}: {err.splitlines()[-1] if err else '?'}", flush=True)
        else:
            print(f"[ok] {tag} {time.time() - t0:.1f} s", flush=True)
    except subprocess.TimeoutExpired:
        path.write_text(json.dumps({
            "arch": arch, "shape": shape, "multi_pod": multi_pod,
            "status": "timeout"}, indent=2))
        print(f"[TIMEOUT] {tag}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="the cell's arch (with --all: a comma list to run)")
    ap.add_argument("--shape", help="the cell's shape (with --all: a comma list to run)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--pods", help="with --all: the pods to run, a comma list of 1 and 2")
    ap.add_argument("--jobs", type=int, default=1, help="with --all: cells run at once")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--policy", default="optimized", choices=["baseline", "optimized"])
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the probe configs (the roofline then reads the direct count)")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors sit on (cuda or cpu)")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        keep = [set(v.split(",")) if v else None for v in (args.arch, args.shape, args.pods)]
        cells = [(arch, shape, multi_pod) for arch, shape, multi_pod in all_cells()
                 if all(k is None or v in k for k, v in
                        zip(keep, (arch, shape, "2" if multi_pod else "1")))]
        with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
            list(pool.map(lambda cell: _run_subprocess(*cell, out_dir, args), cells))
        return
    result = run_cell(args.arch, args.shape, args.multi_pod, probes=not args.no_probes,
                      variant=args.policy, device=args.device)
    tag = f"{args.arch}__{args.shape}__{'pod2' if args.multi_pod else 'pod1'}"
    path = out_dir / f"{tag}.json"
    path.write_text(json.dumps(result, indent=2))
    print(json.dumps(result, indent=2))
    if result["status"] == "ok":
        m = result["memory"]
        r = result.get("roofline") or result.get("roofline_raw")
        print(f"\n[{tag}] peak/device={m['peak_estimate_gib']} GiB  "
              f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
              f"collective={r['collective_s']:.4f}s -> {r['bound']}-bound  "
              f"useful={r['useful_ratio']:.2%}")


if __name__ == "__main__":
    main()
