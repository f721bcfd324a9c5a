"""Where one training step spends its time on the card, per route.

Trains the port's `TrainerConfig()` at `FieldConfig()` on the synthetic
scene of chip_smoke.py (`build_dataset(0)`, 4 views held out) past its first
compacted step, then profiles one warm step on each route from that state
with torch.profiler: a dense step (budget None, the bitfield live) and a
compacted step at the trainer's current budget, each with the color branch
updating (an odd step) and, for the compacted route, also frozen.  Each
step is run eagerly (`Instant3DTrainer.step`) and as a replay of its
captured CUDA graph (`Instant3DTrainer.step_fn`, captured before the
window), five times in a row under the profiler, each call ended by its
loss on the host as the training loop reads it.  Prints per step: wall
time, device busy time (sum of kernel and copy time), idle share, the
same idle share against the wall of 20 unprofiled steps (the profiler's
own host cost per op inflates a profiled wall), the kernel launches of the
profiled steps and the top device kernels by time; for the replay also, from CUDA events over
20 calls, the ms of its copy-in (every input into the static buffers), of
a copy-out that clones every output, of the graph's replay alone and of
the whole call.  Needs a CUDA card:

    python3 tools/torch_train_profile.py [--steps 112]
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import kernels, smoke  # noqa: E402
from repro_torch.core import rendering, step_graph  # noqa: E402
from repro_torch.core.field import Field, FieldConfig  # noqa: E402
from repro_torch.core.trainer import Instant3DTrainer, TrainerConfig, default_draws  # noqa: E402
from repro_torch.data.rays_dataset import RaySampler  # noqa: E402
from repro_torch.data.synthetic_scene import build_dataset  # noqa: E402

PROFILED_STEPS = 5


def _device_rows(prof) -> list[tuple[str, int, float]]:
    """(name, count, ms) of every event that ran on the device, longest first."""
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda t: -t[2])


def _profile(call, steps: int = PROFILED_STEPS) -> tuple[float, list, dict]:
    """(wall ms, device rows) a step over `steps` calls under
    torch.profiler, each ended by its loss on the host, as the training
    loop reads it, and the kernel launches of the `steps` calls."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            _, _, loss, _ = call()
            float(loss)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    return (wall_ms, [(k, c / steps, ms / steps) for k, c, ms in _device_rows(prof)],
            dict(kernels.LAUNCHES))


def _host_ms(call, iters: int = 20) -> float:
    """Wall ms a step, unprofiled, each call ended by its loss on the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        _, _, loss, _ = call()
        float(loss)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _event_ms(fn, iters: int = 20) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _summary(wall_ms: float, rows: list, launches: dict, host_ms: float) -> dict:
    busy_ms = sum(t[2] for t in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "host_wall_ms": host_ms,
            "device_idle_share_unprofiled": 1.0 - busy_ms / host_ms,
            "device_launches": sum(t[1] for t in rows),
            "launches": launches,
            "top_device_ms": [{"name": k[:80], "count": c, "ms": ms} for k, c, ms in rows[:14]]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=112,
                    help="steps to train before profiling (the first compacted step is 96)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: needs a CUDA card")
    card = smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    device = torch.device("cuda")
    cfg = TrainerConfig()
    _, ds = build_dataset(0, device=device)
    sampler = RaySampler(ds, views=range(smoke.HELD_OUT, ds.images.shape[0]), device=device)
    trainer = Instant3DTrainer(Field(FieldConfig()), cfg, device=device)
    state, hist = trainer.train(trainer.init(), sampler, iters=args.steps, log_every=args.steps)
    budget = trainer._current_budget(True)
    draws = default_draws(cfg, sampler.n)
    report = {"card": card, "trained_steps": args.steps, "budget": budget,
              "live_fraction": trainer._live_frac}
    print(f"trained {args.steps} steps: loss {hist['loss'][-1]:.5f}, next budget {budget}, "
          f"live fraction {trainer._live_frac:.4f} [{card}]")
    cases = [("dense", None, False), ("compacted", budget, False),
             ("compacted_color_frozen", budget, True)]
    for name, b, freeze_color in cases:
        i = args.steps + 1
        ray_idx, u_ts, _ = draws(i)
        batch = sampler.gather(ray_idx)
        ts = rendering.sample_ts(None, cfg.n_rays, cfg.render, device, u=u_ts)
        step = lambda: trainer.step(state.params, state.opt_state, batch, ts,  # noqa: E731
                                    state.occ_state.density_ema, freeze_color=freeze_color,
                                    budget=b, use_bits=True)
        fn = trainer.step_fn(freeze_color, budget=b, use_bits=True)
        replay = lambda: fn(state.params, state.opt_state, batch, ts,  # noqa: E731
                            state.occ_state.density_ema)
        for _ in range(3):                     # warm-up: allocator, cuBLAS handles, capture
            step()
            replay()
        report[name] = _summary(*_profile(step), _host_ms(step))
        report[name]["replayed"] = rep = _summary(*_profile(replay), _host_ms(replay))
        (graph,) = fn.graphs.values()
        inputs = (state.params, state.opt_state, batch, ts, state.occ_state.density_ema)
        rep["copy_in_ms"] = _event_ms(lambda: graph._copy_in(inputs))
        rep["copy_out_ms"] = _event_ms(lambda: [t.clone() for _, t in step_graph._flatten(
            graph.static_out) if isinstance(t, torch.Tensor)])
        rep["graph_replay_ms"] = _event_ms(graph.graph.replay)
        rep["call_ms"] = _event_ms(replay)
        rep["capture_ms"] = graph.capture_ms
        for label, r in ((name, report[name]), (f"{name} replayed", rep)):
            print(f"{label} (budget {b}): wall {r['wall_ms']:.2f} ms, device busy "
                  f"{r['device_busy_ms']:.2f} ms, idle share {r['device_idle_share']:.3f}; "
                  f"unprofiled wall {r['host_wall_ms']:.2f} ms, idle share "
                  f"{r['device_idle_share_unprofiled']:.3f}; {r['device_launches']:.0f} device "
                  f"ops a step [{card}]")
            for row in r["top_device_ms"]:
                print(f"  {row['ms']:9.3f} ms  x{row['count']:<7.1f} {row['name']}")
        print(f"{name} replayed: copy-in {rep['copy_in_ms']:.3f} ms, copy-out (every output "
              f"cloned) {rep['copy_out_ms']:.3f} ms, graph replay "
              f"{rep['graph_replay_ms']:.3f} ms, whole call {rep['call_ms']:.3f} ms "
              f"(CUDA events, 20 calls), capture {rep['capture_ms']:.1f} ms [{card}]")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
