"""Where one quantum of the reconstruction service spends its time on the
card while the async serving plane renders beside it.

Builds chip_smoke.py's service configuration (four scenes of
`build_dataset(k)` at `TrainerConfig()`: the Instant-NGP baseline on scene 0
alone, the Instant-3D field on scenes 1-3 in one cohort, slices of 16
steps, the guard on, snapshots persisted), starts the serving thread and
trains quanta until every scene has trained 48 steps, where chip_smoke asks
its first renders.  One render a scene warms the render path; then it asks
one more a scene and profiles, with torch.profiler, the next quantum up to
the moment the serving thread has answered all four.  It prints the
window's wall time, the device's busy time (the union of kernel, copy and
memset intervals over all streams) and idle share, the render stream's
kernels (the serving thread's: it renders on the render service's own
stream, which a marker kernel identifies in the trace) and every other
stream's (the slice's), their busy time, and the time both ran on the
device at once.  Needs a CUDA card:

    python3 tools/torch_service_profile.py
"""
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import kernels, smoke  # noqa: E402
from repro_torch.core.field import FieldConfig  # noqa: E402
from repro_torch.core.rendering import sphere_poses  # noqa: E402
from repro_torch.core.trainer import TrainerConfig  # noqa: E402
from repro_torch.serve3d import ReconstructionService, RenderResult  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"      # torch.cuda._sleep's kernel
WAIT_S = 120.0


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(union) -> float:
    return sum(b - a for a, b in union)


def _intersection(u, v) -> float:
    """Total length where two unions of intervals overlap."""
    i = j = 0
    total = 0.0
    while i < len(u) and j < len(v):
        lo, hi = max(u[i][0], v[j][0]), min(u[i][1], v[j][1])
        total += max(0.0, hi - lo)
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return total


def _answers(svc, n: int, got: list) -> list:
    t_end = time.monotonic() + WAIT_S
    while len(got) < n and time.monotonic() < t_end:
        got += svc.renderer.poll_results()
        time.sleep(0.001)
    if len(got) < n or not all(isinstance(r, RenderResult) for r in got):
        raise RuntimeError(f"the serving thread answered {got} of {n} requests")
    return got


def classify(trace: dict) -> dict:
    """Split the trace's device events into render and slice work by
    stream: the render stream is the one that ran the marker kernel
    (`torch.cuda._sleep`, launched on it at the window's start); every
    other stream's work is the slice's (its main and autograd threads, the
    snapshot copies)."""
    device = [e for e in trace["traceEvents"] if e.get("cat") in DEVICE_CATS]
    markers = [e for e in device if MARKER in e.get("name", "")]
    if len(markers) != 1:
        raise RuntimeError(f"expected one marker kernel on the render stream, found "
                           f"{len(markers)}")
    stream = markers[0]["args"].get("stream")
    out = {"render": [], "slice": [], "render_stream": stream}
    for e in device:
        if e is not markers[0]:
            out["render" if e["args"].get("stream") == stream else "slice"].append(e)
    return out


def _kind_report(events) -> dict:
    union = _union((e["ts"], e["ts"] + e["dur"]) for e in events)
    kernels_ = [e for e in events if e.get("cat") == "kernel"]
    names: dict = {}
    for e in kernels_:
        names[e["name"][:60]] = names.get(e["name"][:60], 0.0) + e["dur"] / 1e3
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    return {"device_events": len(events), "kernels": len(kernels_),
            "busy_ms": _length(union) / 1e3,
            "streams": sorted({e["args"].get("stream") for e in events}),
            "top_kernels_ms": {k: round(v, 4) for k, v in top}, "_union": union}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_service_profile: needs a CUDA card")
    card = smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    datasets = smoke.service_datasets("cuda")
    plan = ((FieldConfig(decomposed=False), smoke.NGP_SERVICE_ITERS),) \
        + ((FieldConfig(), smoke.SERVICE_ITERS),) * 3
    poses = sphere_poses(8, seed=123)
    with tempfile.TemporaryDirectory() as tmp:
        svc = ReconstructionService(slice_iters=smoke.SERVICE_SLICE, guard=True,
                                    persist_dir=f"{tmp}/snapshots", async_serving=True,
                                    device="cuda")
        for k, (ds, (field_cfg, iters)) in enumerate(zip(datasets, plan)):
            svc.submit_scene(ds, field_cfg, TrainerConfig(), target_iters=iters, seed=k,
                             train_views=range(smoke.HELD_OUT, ds.images.shape[0]))
        svc.renderer.start_async()
        try:
            while min(s.step for s in svc.sessions.values()) < smoke.SERVICE_RENDER_STEPS[0]:
                svc.step()
            for k, sid in enumerate(svc.sessions):          # warm the render path
                svc.request_render(sid, poses[k])
            _answers(svc, len(svc.sessions), [])
            torch.cuda.synchronize()
            kernels.reset_launches()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                with torch.cuda.stream(svc.renderer.render_stream()):
                    torch.cuda._sleep(1000)        # marks the render stream
                for k, sid in enumerate(svc.sessions):
                    svc.request_render(sid, poses[4 + k])
                event = svc.step()
                quantum_ms = (time.perf_counter() - t0) * 1e3
                got = _answers(svc, len(svc.sessions), list(event["results"]))
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            launches = dict(kernels.LAUNCHES)
            prof.export_chrome_trace(f"{tmp}/trace.json")
            trace = json.loads(Path(f"{tmp}/trace.json").read_text())
        finally:
            svc.renderer.stop_async()
        svc.store.wait()

    split = classify(trace)
    render, slice_ = _kind_report(split["render"]), _kind_report(split["slice"])
    busy = _union(render.pop("_union") + slice_.pop("_union"))
    busy_ms = _length(busy) / 1e3
    overlap_ms = _intersection(_union((e["ts"], e["ts"] + e["dur"]) for e in split["render"]),
                               _union((e["ts"], e["ts"] + e["dur"]) for e in split["slice"]))
    report = {
        "card": card,
        "quantum_cohort": event["cohort"], "quantum_step": event["step"],
        "quantum_ms": quantum_ms, "window_ms": wall_ms,
        "renders": [{"session": r.session_id, "latency_ms": r.latency_s * 1e3,
                     "snapshot_version": r.snapshot_version} for r in got],
        "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "render_kernels": render["kernels"], "slice_kernels": slice_["kernels"],
        "render": render, "slice": slice_,
        "overlap_ms": overlap_ms / 1e3,
        "overlap_share_of_render_busy": (overlap_ms / 1e3 / render["busy_ms"]
                                         if render["busy_ms"] else 0.0),
        "render_stream": split["render_stream"], "launches": launches,
    }
    print(f"async quantum (cohort {event['cohort']}): quantum {quantum_ms:.1f} ms, window "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.2f} ms, idle share "
          f"{1.0 - busy_ms / wall_ms:.3f}; render kernels {render['kernels']} "
          f"({render['busy_ms']:.2f} ms busy, streams {render['streams']}), slice kernels "
          f"{slice_['kernels']} ({slice_['busy_ms']:.2f} ms, streams {slice_['streams']}), "
          f"overlap {overlap_ms / 1e3:.3f} ms [{card}]", file=sys.stderr)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
