"""Where one served 800x800 render spends its time on the card.

Serves warm-up requests through the port's `RenderService` at the paper's
field configuration (the same snapshot and service as chip_smoke.py; the
warm-up captures each route's render graph), then profiles one request on
each route (redistributed S' = 12, dense S = 48) twice with
torch.profiler: eagerly (`eager_steps()`) and with every chunk a replay of
its captured CUDA graph.  Prints, per route and mode: the request's wall
time, the device's busy time (sum of kernel and copy time) and idle share,
the same idle share against the wall of an unprofiled request (the
profiler's own host cost per op inflates a profiled wall), the kernel
launches per request and the top device kernels by time; for the replay
also, from CUDA events over 20 calls, the ms of binding the view's shared
inputs (params, ts, occupancy: one `torch._foreach_copy_`), of one chunk's
copy-in (origins, dirs) and copy-out (rgb, depth into the view's buffers),
of the graph's replay alone, and the chunks per view.  Needs a CUDA card:

    python3 tools/torch_serve_profile.py
"""
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import kernels, smoke  # noqa: E402
from repro_torch.core import occupancy  # noqa: E402
from repro_torch.core.field import FieldConfig  # noqa: E402
from repro_torch.core.rendering import RenderConfig, sample_ts, sphere_poses  # noqa: E402
from repro_torch.core.trainer import (batched_redistributed_render_fn,  # noqa: E402
                                      batched_render_fn, default_samples_per_ray,
                                      eager_steps, image_rays)


def _device_rows(prof) -> list[tuple[str, int, float]]:
    """(name, count, ms) of every event that ran on the device (kernels and
    copies, not the host ops that launched them), longest first."""
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda t: -t[2])


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


def _request(svc, sid, pose) -> float:
    """Wall ms of one request, submit to its answer on the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.submit(sid, pose)
    (res,) = svc.drain()
    torch.cuda.synchronize()
    assert res.rgb.shape == (smoke.IMAGE_HW, smoke.IMAGE_HW, 3)
    return (time.perf_counter() - t0) * 1e3


def _graph_costs(svc, sid: str, field_cfg, render_cfg, occ_cfg, pose) -> dict:
    """CUDA-event ms of the route's member graph (the one graph every
    group size of the route replays): bind, one chunk's copy-in and
    copy-out, the replay alone."""
    snap = svc.store.latest(sid)
    params, ema = svc._resident_copy(snap, svc.device)
    o, d, n, chunk = image_rays(pose, smoke.IMAGE_HW, smoke.IMAGE_HW,
                                smoke.focal_for(smoke.IMAGE_HW), smoke.EVAL_CHUNK, "cuda")
    ts = sample_ts(None, chunk, render_cfg, "cuda")
    if sid == "redist":
        fn = batched_redistributed_render_fn(field_cfg, render_cfg, occ_cfg, chunk, 1,
                                             default_samples_per_ray(render_cfg.n_samples))
        bound = (params, ts, ema,
                 torch.tensor(int(snap.occ[1]), dtype=torch.int32, device="cuda"))
    else:
        fn = batched_render_fn(field_cfg, render_cfg, chunk, 1)
        bound = (params, ts)
    (graph,) = fn.member.graphs.values()
    rgb = torch.empty((chunk, 3), device="cuda")
    depth = torch.empty((chunk,), device="cuda")
    return {"chunks_per_view": o.shape[0] // chunk,
            "bind_ms": _event_ms(lambda: graph.bind(*bound)),
            "copy_in_ms": _event_ms(lambda: graph.copy_in(o[:chunk], d[:chunk])),
            "copy_out_ms": _event_ms(lambda: graph.copy_out(rgb, depth)),
            "graph_replay_ms": _event_ms(graph.graph.replay),
            "capture_ms": graph.capture_ms}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_profile: needs a CUDA card")
    card = smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    field_cfg, render_cfg = FieldConfig(), RenderConfig()
    occ_cfg = occupancy.OccupancyConfig()
    store = smoke.make_snapshot_store("cuda", field_cfg, occ_cfg)
    svc = smoke.make_service(store, "cuda", field_cfg, render_cfg, occ_cfg,
                             smoke.IMAGE_HW, smoke.EVAL_CHUNK)
    smoke.serve_requests(svc, smoke.IMAGE_HW, 2)       # warm-up: captures
    with eager_steps():
        smoke.serve_requests(svc, smoke.IMAGE_HW, 2)   # warm-up of the eager route
    pose = sphere_poses(1, seed=7)[0]
    report = {"card": card}
    for sid in ("redist", "dense"):
        report[sid] = {}
        for mode in ("eager", "replayed"):
            ctx = eager_steps() if mode == "eager" else contextlib.nullcontext()
            with ctx:
                host_ms = _request(svc, sid, pose)
                kernels.reset_launches()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    wall_ms = _request(svc, sid, pose)
            device = _device_rows(prof)
            busy_ms = sum(t[2] for t in device)
            report[sid][mode] = r = {
                "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_idle_share": 1.0 - busy_ms / wall_ms, "host_wall_ms": host_ms,
                "device_idle_share_unprofiled": 1.0 - busy_ms / host_ms,
                "device_ops": sum(t[1] for t in device),
                "launches": dict(kernels.LAUNCHES),
                "top_device_ms": [{"name": k[:80], "count": c, "ms": ms}
                                  for k, c, ms in device[:12]],
            }
            print(f"{sid} {mode}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle "
                  f"share {r['device_idle_share']:.3f}; unprofiled wall {host_ms:.1f} ms, "
                  f"idle share {r['device_idle_share_unprofiled']:.3f}; "
                  f"{r['device_ops']:.0f} device ops [{card}]")
            for k, c, ms in device[:12]:
                print(f"  {ms:9.3f} ms  x{c:<5} {k[:90]}")
        costs = _graph_costs(svc, sid, field_cfg, render_cfg, occ_cfg, pose)
        report[sid]["replayed"].update(costs)
        print(f"{sid} replayed: bind {costs['bind_ms']:.3f} ms a view, copy-in "
              f"{costs['copy_in_ms']:.4f} / copy-out {costs['copy_out_ms']:.4f} ms a chunk, "
              f"graph replay {costs['graph_replay_ms']:.3f} ms a chunk, "
              f"{costs['chunks_per_view']} chunks a view (CUDA events, 20 calls), capture "
              f"{costs['capture_ms']:.1f} ms [{card}]")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
