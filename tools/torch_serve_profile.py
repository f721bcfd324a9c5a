"""Where one served 800x800 render spends its time on the card.

Serves warm-up requests through the port's `RenderService` at the paper's
field configuration (the same snapshot and service as chip_smoke.py), then
profiles one request on each route (redistributed S' = 12, dense S = 48)
with torch.profiler and prints, per route: the request's wall time, the
device's busy time (sum of kernel and copy time on the one stream) and idle
share, the kernel launches per request, and the top device kernels by
time.  Needs a CUDA card:

    python3 tools/torch_serve_profile.py
"""
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
from repro_torch.core.rendering import RenderConfig, sphere_poses  # noqa: E402


def _device_rows(prof) -> list[tuple[str, int, float]]:
    """(name, count, ms) of every event that ran on the device (kernels and
    copies, not the host ops that launched them), longest first."""
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda t: -t[2])


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
    smoke.serve_requests(svc, smoke.IMAGE_HW, 2)       # warm-up
    pose = sphere_poses(1, seed=7)[0]
    report = {"card": card}
    for sid in ("redist", "dense"):
        kernels.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc.submit(sid, pose)
            (res,) = svc.drain()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        assert res.rgb.shape == (smoke.IMAGE_HW, smoke.IMAGE_HW, 3)
        device = _device_rows(prof)
        busy_ms = sum(t[2] for t in device)
        report[sid] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "launches": dict(kernels.LAUNCHES),
            "top_device_ms": [{"name": k[:80], "count": c, "ms": ms}
                              for k, c, ms in device[:12]],
        }
        print(f"{sid}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
              f"idle share {1.0 - busy_ms / wall_ms:.3f} [{card}]")
        for k, c, ms in device[:12]:
            print(f"  {ms:9.3f} ms  x{c:<5} {k[:90]}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
