"""Multi-scene reconstruction service demo (Instant-3D as a service primitive).

    PYTHONPATH=src python -m repro_torch.examples.reconstruct_service \
        --scenes 4 --iters 96 --slice 8 --async-serving
    PYTHONPATH=src python -m repro_torch.examples.reconstruct_service \
        --device cpu --scenes 2 --iters 16

The port of ``examples/reconstruct_service.py``, with its configuration and
output lines.  Procedural scenes train concurrently in one process: the
scheduler time-slices the card across their sessions (in cohorts where
configs match), each slice publishes a snapshot, and novel-view renders
are answered mid-training from the latest snapshot and scored against the
scene's ground truth.  ``--snapshot-levels k`` streams h>>k previews
before each scene's first full snapshot, ``--async-serving`` serves
renders from a serving thread, ``--device`` (default ``cuda``) picks where
everything runs; ``--devices N`` shards the sessions over the first N
cards, ``--devices cuda:0,cuda:0`` (or ``cpu,cpu``) over an explicit list
of slots.
"""
from __future__ import annotations

import argparse

import torch

from ..core import losses, occupancy
from ..core.field import FieldConfig
from ..core.rendering import RenderConfig
from ..core.trainer import TrainerConfig
from ..data.synthetic_scene import build_dataset
from ..launch.serve3d import devices_arg
from ..obs import export as obs_export
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..serve3d import ReconstructionService


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--iters", type=int, default=96, help="per-scene iterations")
    ap.add_argument("--slice", type=int, default=8, help="iterations per time slice")
    ap.add_argument("--hw", type=int, default=24)
    ap.add_argument("--max-resident", type=int, default=None)
    ap.add_argument("--max-cohort", type=int, default=None,
                    help="train-cohort cap (default unlimited; 1 = pure time-slicing)")
    ap.add_argument("--dense-render", action="store_true",
                    help="serve views dense instead of redistributed")
    ap.add_argument("--devices", type=devices_arg, default=None,
                    help="shard sessions over the first N cards, or over an "
                         "explicit comma-separated device list (cuda:0,cuda:0)")
    ap.add_argument("--snapshot-levels", type=int, default=0,
                    help="publish h>>k preview snapshots until a scene's "
                         "first full snapshot (0 = off)")
    ap.add_argument("--async-serving", action="store_true",
                    help="serve renders from a serving thread")
    ap.add_argument("--device", default="cuda",
                    help="where sessions train and render (cuda or cpu)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON of the demo run")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    # the demo always runs instrumented: the progress lines below and the
    # final summary both read from the one obs metrics plane
    obs_trace.configure(enabled=True)

    render = RenderConfig(n_samples=16)
    field_cfg = FieldConfig(n_levels=4, max_resolution=64,
                            log2_table_density=12, log2_table_color=10)
    trainer_cfg = TrainerConfig(
        n_rays=256, render=render,
        occ=occupancy.OccupancyConfig(update_interval=8, warmup_steps=16),
        eval_chunk=args.hw * args.hw,
    )

    print(f"building {args.scenes} procedural scenes ({args.hw}x{args.hw}) on {args.device}...")
    service = ReconstructionService(slice_iters=args.slice,
                                    max_resident=args.max_resident,
                                    max_cohort=args.max_cohort,
                                    redistributed_render=not args.dense_render,
                                    devices=args.devices,
                                    snapshot_levels=args.snapshot_levels,
                                    async_serving=args.async_serving,
                                    device=args.device)
    datasets = {}
    for i in range(args.scenes):
        _scene, ds = build_dataset(seed=i, n_views=6, h=args.hw, w=args.hw,
                                   cfg=render, gt_samples=48, device=args.device)
        sid = service.submit_scene(ds, field_cfg, trainer_cfg,
                                   target_iters=args.iters, seed=i)
        datasets[sid] = ds

    t0 = obs_trace.clock()
    held_out = 0  # every served render targets view 0, scored against its GT
    asked, answered = [], []

    def hook(svc, event):
        # ask for a fresh view of every scene that just trained a slice
        # (one quantum advances a whole cohort when configs match)
        for sid in event["cohort"]:
            if svc.sessions[sid].step % (2 * args.slice) == 0:
                asked.append(svc.request_render(sid, datasets[sid].poses[held_out]))
        for r in event["results"]:
            answered.append(r)
            gt = datasets[r.session_id].images[held_out]
            psnr = float(losses.psnr(torch.from_numpy(r.rgb), torch.from_numpy(gt)))
            # served-view quality lands in the metrics plane the final
            # summary prints from
            obs_metrics.gauge(f"demo.psnr_db.{r.session_id}").set(psnr)
            print(f"[{obs_trace.clock() - t0:6.1f}s] render {r.session_id} "
                  f"@step {r.snapshot_step:3d} (v{r.snapshot_version})  "
                  f"psnr {psnr:5.2f} dB  latency {r.latency_s * 1e3:5.0f} ms")

    tel = service.run(hook=hook)

    print("\nfinal state:")
    evals = {}
    for p in tel["sessions"]:
        sess = service.sessions[p["session_id"]]
        ev = evals[p["session_id"]] = sess.evaluate(views=[0, 1])
        obs_metrics.gauge(f"demo.final_psnr_rgb_db.{p['session_id']}").set(ev["psnr_rgb"])
        obs_metrics.gauge(f"demo.final_psnr_depth_db.{p['session_id']}").set(ev["psnr_depth"])
        print(f"  {p['session_id']}: {p['step']}/{p['target_iters']} iters, "
              f"psnr rgb {ev['psnr_rgb']:.2f} dB  depth {ev['psnr_depth']:.2f} dB  "
              f"(train {p['train_wall_s']:.1f}s)")
    r = tel["render"]
    print(f"\n{tel['scenes_done']} scenes on {tel['devices']} device(s) "
          f"in {tel['wall_s']:.1f}s "
          f"({tel['scenes_per_sec']:.3f} scenes/sec)  "
          f"renders {r.get('count', 0)}: p50 {r.get('p50_ms', 0):.0f} ms, "
          f"p95 {r.get('p95_ms', 0):.0f} ms")
    if tel["placement"] is not None:
        print(f"placement loads {tel['placement']['loads']} over "
              f"{tel['placement']['devices']}")
    print("\nmetrics snapshot:")
    print(obs_export.format_metrics(service.metrics()))
    if args.trace_out:
        print(f"\ntrace -> {service.dump_trace(args.trace_out)}")
    return {"service": service, "telemetry": tel, "asked": asked, "answered": answered,
            "evals": evals}


if __name__ == "__main__":
    main()
