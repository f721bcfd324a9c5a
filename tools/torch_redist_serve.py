"""Served latency of the redistributed route (stage 2b v2) at 800x800.

Trains chip_smoke.py's Instant-3D run (`TrainerConfig()` at `FieldConfig()`,
400 steps on `build_dataset(0)`, 4 views held out), publishes its params
and occupancy as a snapshot, serves one warm-up request and then
``--requests`` requests on the redistributed route (12 samples a ray), one
drain each, and prints each request's latency (submit to answer, host
clock) and their p50 as one JSON line.  ``--src`` picks the checkout whose
`repro_torch` is measured, so two trees can be compared in one call on one
card (run them alternately: parent, change, change, parent).  Needs a CUDA
card:

    python3 tools/torch_redist_serve.py [--src path/to/checkout/src]
"""
import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--requests", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import numpy as np
    import torch

    from repro_torch import kernels, smoke
    from repro_torch.core import occupancy
    from repro_torch.core.field import FieldConfig
    from repro_torch.core.rendering import RenderConfig, sphere_poses

    if not torch.cuda.is_available():
        raise SystemExit("torch_redist_serve: needs a CUDA card")
    card = smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    run = smoke.train_main_path("cuda", FieldConfig())
    store = smoke.snapshot_store(run["state"].params, run["state"].occ_state)
    svc = smoke.make_service(store, "cuda", FieldConfig(), RenderConfig(),
                             occupancy.OccupancyConfig(), smoke.IMAGE_HW, smoke.EVAL_CHUNK)
    poses = sphere_poses(args.requests + 1, seed=11)
    latencies, digest = [], []
    for k, pose in enumerate(poses):
        svc.submit("redist", pose)
        (res,) = svc.drain()
        if k:                                  # the first one warms up
            latencies.append(res.latency_s * 1e3)
            digest.append(float(np.asarray(res.rgb, np.float64).sum()))
    print(json.dumps({"card": card, "src": args.src, "route": "redist",
                      "hw": smoke.IMAGE_HW, "requests": args.requests,
                      "latency_ms": latencies, "p50_ms": float(np.median(latencies)),
                      "psnr_rgb": run["eval"]["psnr_rgb"], "rgb_sums": digest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
