"""Phase 16 of ``chip_smoke.py``: the parallel substrate on one card.

On one H100 the world is one rank: every collective below runs through
NCCL over a world-1 process group (joined through a `FileStore` in a
temporary directory, so no port can collide, and destroyed when its part
ends), or through the world-1 group the training CLI's ``--coordinator``
makes.  An exchange between ranks cannot run on a one-card machine; the
CPU tests carry it (`tests/test_torch_lm_ep.py`,
`tests/test_torch_parallel.py`, on 2 and 4 gloo ranks).

1. `moe_ep` on one MoE layer of deepseek-v2-lite at full width (64 routed
   experts 2048 -> 1408, top-6, 2 shared; f32 from a seed, ~2.2 GB), on
   4 x 128 tokens, over a ('data', 'model') = (1, 1) mesh: at
   `NO_DROP_CF` (nothing can drop: the send buffer holds every assignment
   and each expert's window every token; the reference test's capacity
   factor of 100 would run each of the 64 windows over 307,200 rows, ~340
   TFLOP) the output and the gradients of sum(y * w) against `moe_dense`
   within `EP_TOL` of the largest magnitude, with both paths' wall ms; at
   the default 1.3, on the tokens plus an offset they all share (`CROWD`:
   the routing crowds and the capacity bites), the dropped assignments
   exactly the port's CPU run's (the same params and tokens) and the
   output within `CPU_TOL` of it, the
   routing decisions that differ counted (a flip fails the gate); the
   decode path (S = 1) against `moe_dense`;
2. `compressed_grad_sync` over a ('pod', 'data', 'model') = (1, 1, 1) mesh
   on the gradient tree of a deepseek-v2-lite step at full width, depth
   cut to `SYNC_LAYERS` (bf16, 4 x 128 tokens): every int8 payload (the
   chunks sent and the reduced chunk) bit for bit the CPU's on the same
   gradients, with the sync's wall ms per GB of gradients; and the
   reference test's error-feedback loop (`FEEDBACK_STEPS` steps of
   linspace(-1, 1, 64), relative distance < 0.01);
3. the training CLI (`launch.train.main`) with ``--compress-grads
   --coordinator`` (world 1) on deepseek-v3's smoke config with the merged
   embedding backward (``dedup_embed_grad=True``: #7 and `bum_sort`, the
   exact route on a card): a run stopped at `CLI_STOP` (`train(...,
   stop_after=)` in a group of its own) and resumed through
   ``--auto-resume`` ends on the uninterrupted run's bytes, the error
   state included (``parallel_train_cli``);
4. deepseek-v2-lite's smoke config served through `launch.serve.serve`
   on the host mesh and with mesh=None: the same answers, byte for byte
   (on a one-rank mesh the MoE layers take the dense path, the reference's
   rule) (``parallel_serve``).

Each function takes the device, so a CPU test rehearses the phase on the
smoke configs (``smoke=True``, gloo in place of NCCL).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import socket
import tempfile
import time

import torch
import torch.distributed as dist

from . import kernels, smoke_lm, smoke_moe
from .configs import get_config, get_smoke_config
from .launch import serve as serve_lib
from .launch import train as train_lib
from .launch.mesh import Mesh, init_distributed
from .models import moe
from .models.lm import LM
from .optim.adamw import tree_from_paths, tree_paths
from .parallel import collectives

EP_ARCH = "deepseek-v2-lite-16b"
CLI_ARCH = "deepseek-v3-671b"
EP_TOKENS = (4, 128)
SMOKE_TOKENS = (2, 8)
# A capacity factor at which nothing drops: at world 1 the send buffer
# holds ceil(A * 4) >= A assignments, and each expert's window
# ceil(ceil(A * 4) / E * 4) rows >= the tokens (A = tokens * k; k * 16 / E
# >= 1 for 6 of 64 and 2 of 8).
NO_DROP_CF = 4.0
# moe_ep against moe_dense, each relative to the largest |value| of its
# leaf: the same f32 products grouped differently (per-expert windows
# against one batched product of every expert)
EP_TOL = 1e-4
# the card's moe_ep at 1.3 against the CPU's, same measure
CPU_TOL = 1e-4
# the offset, in units of x's spread, that crowds the routing at 1.3 (as the
# CPU tests crowd theirs)
CROWD = 1.5
SYNC_LAYERS = 3
FEEDBACK_STEPS = 50
FEEDBACK_TOL = 0.01
CLI_STEPS, CLI_STOP, CLI_BATCH, CLI_SEQ = 8, 4, 8, 64
SERVE_ARGS = smoke_lm.SERVE_ARGS


@contextlib.contextmanager
def world_of_one(device):
    """A world-1 process group (NCCL on a card, gloo on the CPU) joined
    through a FileStore in a temporary directory, destroyed on exit."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(_backend(device).lower(),
                                store=dist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _backend(device) -> str:
    return "NCCL" if torch.device(device).type == "cuda" else "gloo"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn, device, iters: int = 3) -> float:
    """Mean wall milliseconds of one call of fn (the device drained before
    and after), after one warm-up call."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / iters


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b| (0 when both are all zeros)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    scale = float(b.abs().max())
    diff = float((a - b).abs().max())
    return diff / scale if scale else diff


def _moe_cfg(smoke: bool):
    cfg = get_smoke_config(EP_ARCH) if smoke else get_config(EP_ARCH)
    return dataclasses.replace(cfg, dtype="float32")


def value_and_grads(fn, params: dict, x: torch.Tensor, w: torch.Tensor) -> dict:
    """fn(params, x), and the gradients of sum(fn * w) with respect to x and
    every param (a leaf the loss does not read gets zeros)."""
    live = tree_from_paths([(p, t.detach().requires_grad_()) for p, t in tree_paths(params)])
    xl = x.detach().requires_grad_()
    y = fn(live, xl)
    leaves = [t for _, t in tree_paths(live)]
    grads = torch.autograd.grad((y * w).sum(), [xl] + leaves, allow_unused=True,
                                materialize_grads=True)
    return {"y": y.detach(), "x": grads[0],
            **{"/".join(p): g for (p, _), g in zip(tree_paths(live), grads[1:])}}


def ep_checks(device, card: str, smoke: bool = False) -> dict:
    """Part 1: moe_ep at full width against moe_dense, the CPU and decode."""
    cfg = _moe_cfg(smoke)
    b, s = SMOKE_TOKENS if smoke else EP_TOKENS
    gen = torch.Generator(device=device).manual_seed(0)
    params = moe.init_moe(gen, cfg, torch.float32, device)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=device)
    w = torch.randn((b, s, cfg.d_model), generator=gen, device=device)
    n_params = sum(t.numel() for _, t in tree_paths(params))
    out = {"params_gb": n_params * 4 / 1e9, "tokens": b * s}
    with world_of_one(device):
        mesh = Mesh((1, 1), ("data", "model"), device)
        ep_fn = lambda p, v: moe.moe_ep(p, v, cfg, mesh, capacity_factor=NO_DROP_CF)  # noqa: E731
        dense_fn = lambda p, v: moe.moe_dense(p, v, cfg)  # noqa: E731
        kernels.reset_launches()
        with moe.record_drops() as drops:
            ep = value_and_grads(ep_fn, params, x, w)
        _sync(device)
        out["launches"] = dict(kernels.LAUNCHES)
        dense = value_and_grads(dense_fn, params, x, w)
        out["no_drop"] = {"capacity_factor": NO_DROP_CF, "dropped": int((~drops[0]).sum()),
                          "rel_err": {k: _rel(ep[k], dense[k]) for k in ep}}
        del ep, dense
        out["ms"] = {
            "moe_ep_fwd": wall_ms(lambda: ep_fn(params, x), device),
            "moe_dense_fwd": wall_ms(lambda: dense_fn(params, x), device),
            "moe_ep_fwd_bwd": wall_ms(lambda: value_and_grads(ep_fn, params, x, w), device),
            "moe_dense_fwd_bwd": wall_ms(lambda: value_and_grads(dense_fn, params, x, w),
                                         device)}
        # routing crowded by an offset every token shares, so the capacity bites
        x13 = x + CROWD * torch.randn((cfg.d_model,), generator=gen, device=device)
        with torch.no_grad(), moe.record_drops() as drops, moe.record_routes() as routes:
            y13 = moe.moe_ep(params, x13, cfg, mesh)
        card13 = {"y": y13.cpu(), "kept": drops[0].cpu(), "ids": routes[0][1].cpu(),
                  "sel": routes[0][0].cpu()}
        dec = value_and_grads(ep_fn, params, x[:, :1], w[:, :1])
        dec_dense = value_and_grads(dense_fn, params, x[:, :1], w[:, :1])
        out["decode_rel_err"] = {k: _rel(dec[k], dec_dense[k]) for k in dec}
        del dec, dec_dense, y13
    # the same layer on the CPU: no process group, plain collectives
    cpu_params = smoke_lm._to(params, "cpu")
    del params
    smoke_moe._free(device)
    cpu_mesh = Mesh((1, 1), ("data", "model"), "cpu")
    with torch.no_grad(), moe.record_drops() as drops, moe.record_routes() as routes:
        y_cpu = moe.moe_ep(cpu_params, x13.cpu(), cfg, cpu_mesh)
    flips = smoke_moe.route_flips([(card13["sel"], card13["ids"])], routes)
    out["default"] = {"capacity_factor": 1.3, "dropped": int((~card13["kept"]).sum()),
                      "dropped_cpu": int((~drops[0]).sum()),
                      "same_dropped_set": bool(torch.equal(card13["kept"], drops[0])),
                      "route_flips": flips["flips"], "min_route_margin": flips["min_margin"],
                      "rel_err_vs_cpu": _rel(card13["y"], y_cpu)}
    print(f"parallel moe_ep {cfg.name} one MoE layer, {cfg.moe.n_routed} + {cfg.moe.n_shared} "
          f"experts {cfg.d_model} -> {cfg.moe.d_expert_ff} top-{cfg.moe.top_k}, f32 "
          f"{out['params_gb']:.2f} GB, {b} x {s} tokens, (1, 1) mesh over NCCL [{card}]: "
          f"{json.dumps({k: out[k] for k in ('no_drop', 'ms', 'default', 'decode_rel_err')})}",
          flush=True)
    return out


def check_ep(out: dict) -> list[str]:
    problems = []
    nd, df = out["no_drop"], out["default"]
    if nd["dropped"] or max(nd["rel_err"].values()) > EP_TOL:
        problems.append(f"moe_ep at {NO_DROP_CF} vs moe_dense: {nd}")
    if max(out["decode_rel_err"].values()) > EP_TOL:
        problems.append(f"decode vs moe_dense: {out['decode_rel_err']}")
    if df["route_flips"] or not df["same_dropped_set"] or df["dropped"] != df["dropped_cpu"] \
            or df["rel_err_vs_cpu"] > CPU_TOL:
        problems.append(f"moe_ep at 1.3, card vs CPU: {df}")
    return problems


def sync_checks(device, card: str, smoke: bool = False) -> dict:
    """Part 2: compressed_grad_sync on a depth-cut step's gradients, its
    payloads against the CPU's, and the error-feedback loop."""
    cfg = get_smoke_config(EP_ARCH) if smoke else \
        dataclasses.replace(get_config(EP_ARCH), n_layers=SYNC_LAYERS)
    model = LM(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    tokens = torch.from_numpy(smoke_lm._tokens(SMOKE_TOKENS if smoke else EP_TOKENS,
                                               cfg.vocab)).to(device)
    _, grads = train_lib.loss_and_grads(model, params, {"tokens": tokens})
    del params
    smoke_moe._free(device)
    n_bytes = sum(t.numel() * t.element_size() for _, t in tree_paths(grads))
    n_elems = sum(t.numel() for _, t in tree_paths(grads))
    err = collectives.init_error_state(grads)
    payloads = []
    out = {"leaves": len(tree_paths(grads)), "grad_gb": n_bytes / 1e9,
           "dtype": str(cfg.dtype)}
    with world_of_one(device):
        mesh = Mesh((1, 1, 1), ("pod", "data", "model"), device)
        kernels.reset_launches()
        with _tap(payloads):
            new_g, new_e = collectives.compressed_grad_sync(grads, err, mesh, "pod")
        _sync(device)
        out["launches"] = dict(kernels.LAUNCHES)
        del new_g, new_e
        ms = wall_ms(lambda: collectives.compressed_grad_sync(grads, err, mesh, "pod"), device)
        out["sync_ms"], out["ms_per_gb"] = ms, ms / (n_bytes / 1e9)
        out["int8_wire_gb"] = 2 * n_elems / 1e9      # the sent chunks and the reduced chunk
        g = torch.linspace(-1, 1, 64, device=device)
        e = torch.zeros_like(g)
        total, exact = torch.zeros_like(g), torch.zeros_like(g)
        for _ in range(FEEDBACK_STEPS):
            o, e = collectives.compressed_psum_mean(g, e, mesh.group("pod"))
            total, exact = total + o, exact + g
        out["feedback_rel"] = float(torch.linalg.norm(total - exact) / torch.linalg.norm(exact))
    del err
    # the CPU's payloads on the same gradients, leaf by leaf
    t0 = time.perf_counter()
    same, it = True, iter(payloads)
    for _, gl in tree_paths(grads):
        seen = []
        g_cpu = gl.cpu()
        with _tap(seen):
            collectives.compressed_psum_mean(g_cpu, torch.zeros(g_cpu.shape), None)
        for (q, sc), (q_card, sc_card) in zip(seen, (next(it), next(it))):
            same &= torch.equal(q, q_card) and sc.tobytes() == sc_card.tobytes()
    out["payloads_bit_identical_to_cpu"] = bool(same)
    out["cpu_check_s"] = time.perf_counter() - t0
    print(f"parallel compressed_grad_sync {cfg.name} depth {cfg.n_layers}, {out['leaves']} "
          f"leaves, {out['grad_gb']:.3f} GB of {cfg.dtype} gradients, (1, 1, 1) mesh over "
          f"{_backend(device)} [{card}]: {json.dumps(out)}", flush=True)
    return out


@contextlib.contextmanager
def _tap(record: list):
    """Record every int8 payload `collectives._quantize` makes (on the host:
    (int8 tensor, the scale's bytes)) while active."""
    orig = collectives._quantize

    def tap(t):
        q, scale = orig(t)
        record.append((q.cpu(), scale.float().cpu().numpy()))
        return q, scale

    collectives._quantize = tap
    try:
        yield record
    finally:
        collectives._quantize = orig


def check_sync(out: dict) -> list[str]:
    problems = []
    if not out["payloads_bit_identical_to_cpu"]:
        problems.append("compressed_grad_sync's int8 payloads differ from the CPU's")
    if not out["feedback_rel"] < FEEDBACK_TOL:
        problems.append(f"error feedback: relative distance {out['feedback_rel']}")
    return problems


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cli_checks(device, card: str) -> dict:
    """Part 3: the training CLI with --compress-grads --coordinator, stopped
    and resumed, against the uninterrupted run."""
    def args(ckpt_dir, *extra):
        return ["--arch", CLI_ARCH, "--smoke", "--steps", str(CLI_STEPS), "--batch",
                str(CLI_BATCH), "--seq", str(CLI_SEQ), "--ckpt-every", str(CLI_STOP),
                "--device", str(device), "--compress-grads", "--coordinator",
                f"127.0.0.1:{_free_port()}", "--ckpt-dir", ckpt_dir, *extra]

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launches()
        full = train_lib.main(args(f"{tmp}/full"), dedup_embed_grad=True)
        _sync(device)
        launches = dict(kernels.LAUNCHES)
        init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device)
        try:
            part = train_lib.train(CLI_ARCH, smoke=True, steps=CLI_STEPS, batch=CLI_BATCH,
                                   seq=CLI_SEQ, ckpt_every=CLI_STOP, device=device,
                                   ckpt_dir=f"{tmp}/part", stop_after=CLI_STOP,
                                   compress_grads=True, dedup_embed_grad=True)
        finally:
            dist.destroy_process_group()
        resumed = train_lib.main(args(f"{tmp}/part", "--auto-resume"), dedup_embed_grad=True)
    same = smoke_lm._same_state(full["state"], resumed["state"])
    same["error_state"] = smoke_lm._same_tree(full["state"][2], resumed["state"][2])
    out = {"steps": CLI_STEPS, "stopped_at": part["summary"]["step"], "start": resumed["start"],
           "same": same, "same_losses": resumed["loss"] == full["loss"][CLI_STOP:],
           "loss": [full["loss"][0], full["loss"][-1]],
           "error_state_zero": all(not t.any() for _, t in tree_paths(full["state"][2])),
           "wall_s": time.perf_counter() - t0, "launches": launches}
    print(f"parallel training CLI {CLI_ARCH} smoke config --compress-grads --coordinator "
          f"(world 1), {CLI_STEPS} steps of {CLI_BATCH} x {CLI_SEQ}, dedup_embed_grad, stopped "
          f"at {CLI_STOP} and resumed [{card}]: {json.dumps(out)}", flush=True)
    return out


def check_cli(out: dict, on_card: bool = True) -> list[str]:
    problems = []
    if out["stopped_at"] != CLI_STOP or out["start"] != CLI_STOP or \
            not all(out["same"].values()) or not out["same_losses"]:
        problems.append(f"the CLI's resumed run differs from the uninterrupted one: {out}")
    got = out["launches"]
    if on_card and (got["bum_sort"] != 2 * CLI_STEPS or got["bum_scatter"] != 2 * CLI_STEPS):
        problems.append(f"the CLI run launched bum_sort / bum_scatter {got['bum_sort']} / "
                        f"{got['bum_scatter']} times, expected twice a step")
    return problems


def serve_checks(device, card: str) -> dict:
    """Part 4: launch.serve on the host mesh against mesh=None."""
    with world_of_one(device):
        kernels.reset_launches()
        meshed = serve_lib.serve(EP_ARCH, smoke=True, device=device, **SERVE_ARGS)
        _sync(device)
        launches = dict(kernels.LAUNCHES)
    plain = serve_lib.serve(EP_ARCH, smoke=True, device=device, mesh=None, **SERVE_ARGS)
    out = {"completed": meshed["completed"], "requests": meshed["requests"],
           "finite": meshed["finite"] and plain["finite"],
           "same_answers": bool(torch.equal(meshed["answers"], plain["answers"])),
           "tok_s": meshed["tok_s"], "tok_s_no_mesh": plain["tok_s"], "launches": launches}
    print(f"parallel serve {EP_ARCH} smoke config on the host mesh vs mesh=None [{card}]: "
          f"{json.dumps(out)}", flush=True)
    return out


def check_serve(out: dict) -> list[str]:
    if out["completed"] < out["requests"] or not out["finite"] or not out["same_answers"]:
        return [f"serving on the host mesh: {out}"]
    return []


def parallel_phase(device, card: str, smoke: bool = False) -> dict:
    """Phase 16, with its gates (the launch counts on a card only)."""
    t_phase = time.perf_counter()
    out, times = {}, {}
    for name, run, check in (
            ("moe_ep", lambda: ep_checks(device, card, smoke), check_ep),
            ("sync", lambda: sync_checks(device, card, smoke), check_sync),
            ("train_cli", lambda: cli_checks(device, card),
             lambda o: check_cli(o, torch.device(device).type == "cuda")),
            ("serve", lambda: serve_checks(device, card), check_serve)):
        t0 = time.perf_counter()
        out[name] = run()
        times[name] = time.perf_counter() - t0
        smoke_moe._free(device)
        problems = check(out[name])
        if problems:
            raise RuntimeError(f"parallel phase, {name}: {problems}")
    out["launches"] = {f"parallel_{name}": out[name]["launches"] for name in times}
    for path, counts in out["launches"].items():
        print(f"{path}-path launches: {json.dumps(counts)}", flush=True)
    out["seconds"] = {**times, "phase": time.perf_counter() - t_phase}
    print(f"parallel phase: {json.dumps(out['seconds'])} [{card}]", flush=True)
    return out
