"""Where one training step spends its time on the card, per route.

Trains the port's `TrainerConfig()` at `FieldConfig()` on the synthetic
scene of chip_smoke.py (`build_dataset(0)`, 4 views held out) past its first
compacted step, then profiles one warm step on each route from that state
with torch.profiler: a dense step (budget None, the bitfield live) and a
compacted step at the trainer's current budget, each with the color branch
updating (an odd step) and, for the compacted route, also frozen.  Prints
per step: wall time, device busy time (sum of kernel and copy time on the
one stream), idle share, the kernel launches, and the top device kernels by
time.  Needs a CUDA card:

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
from repro_torch.core import rendering  # noqa: E402
from repro_torch.core.field import Field, FieldConfig  # noqa: E402
from repro_torch.core.trainer import Instant3DTrainer, TrainerConfig, default_draws  # noqa: E402
from repro_torch.data.rays_dataset import RaySampler  # noqa: E402
from repro_torch.data.synthetic_scene import build_dataset  # noqa: E402


def _device_rows(prof) -> list[tuple[str, int, float]]:
    """(name, count, ms) of every event that ran on the device, longest first."""
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda t: -t[2])


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
        for _ in range(3):                     # warm-up: allocator, cuBLAS handles
            step()
        torch.cuda.synchronize()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, _, loss, _ = step()
            float(loss)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = _device_rows(prof)
        busy_ms = sum(t[2] for t in rows)
        report[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_launches": sum(t[1] for t in rows),
            "launches": dict(kernels.LAUNCHES),
            "top_device_ms": [{"name": k[:80], "count": c, "ms": ms} for k, c, ms in rows[:14]],
        }
        print(f"{name} (budget {b}): wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
              f"idle share {1.0 - busy_ms / wall_ms:.3f}, "
              f"{sum(t[1] for t in rows)} device ops [{card}]")
        for k, c, ms in rows[:14]:
            print(f"  {ms:9.3f} ms  x{c:<5} {k[:90]}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
