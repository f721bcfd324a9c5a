"""The multi-scene reconstruction service from the command line.

    PYTHONPATH=src python -m repro_torch.launch.serve3d \
        --scenes 4 --iters 128 --slice 16 --renders-per-scene 3
    PYTHONPATH=src python -m repro_torch.launch.serve3d --device cpu \
        --scenes 2 --iters 24

The port of `repro.launch.serve3d`, with its flags and defaults; ``--device``
(default ``cuda``) takes the place of ``--backend``, since the port
dispatches on the tensor's device.  It submits N procedural scene jobs and
advances them in train cohorts (``--max-cohort 1`` for pure time-slicing)
under round-robin or EDF selection with a bounded resident set, and serves
novel-view renders mid-training from the published snapshots
(``--dense-render`` for the dense path).  The session guard is on by
default; ``--chaos`` injects one NaN-params fault into scene-001 mid-run;
``--async-serving`` serves renders from a serving thread.  ``--devices``
is not ported yet and raises.
Prints per-session progress, scenes/s, render-latency percentiles and the
guard's telemetry.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import occupancy
from ..core.field import FieldConfig
from ..core.rendering import RenderConfig, sphere_poses
from ..core.trainer import TrainerConfig
from ..data.synthetic_scene import build_dataset
from ..obs import export as obs_export
from ..obs import trace as obs_trace
from ..serve3d import GuardConfig, ReconstructionService
from ..testing import faults


def build_service(args) -> tuple[ReconstructionService, dict]:
    render = RenderConfig(n_samples=args.samples)
    field_cfg = FieldConfig(n_levels=4, max_resolution=64,
                            log2_table_density=12, log2_table_color=10)
    trainer_cfg = TrainerConfig(
        n_rays=args.rays, render=render,
        occ=occupancy.OccupancyConfig(update_interval=8, warmup_steps=16),
        eval_chunk=args.hw * args.hw)
    guard = (GuardConfig(checkpoint_every=args.guard_ckpt_every,
                         max_retries=args.guard_max_retries)
             if not args.no_guard else None)
    service = ReconstructionService(
        slice_iters=args.slice, policy=args.policy, max_resident=args.max_resident,
        persist_dir=args.persist_dir, max_cohort=args.max_cohort,
        redistributed_render=not args.dense_render,
        render_samples_per_ray=args.render_spr, guard=guard,
        render_deadline_s=args.render_deadline, shed_threshold=args.shed_threshold,
        devices=args.devices, snapshot_levels=args.snapshot_levels,
        async_serving=args.async_serving, device=args.device)
    datasets = {}
    for i in range(args.scenes):
        _scene, ds = build_dataset(seed=i, n_views=args.views, h=args.hw, w=args.hw,
                                   cfg=render, gt_samples=args.gt_samples,
                                   device=args.device)
        # staggered deadlines under EDF: earlier scenes are more urgent
        deadline = 30.0 * (i + 1) if args.policy == "edf" else None
        sid = service.submit_scene(ds, field_cfg, trainer_cfg, target_iters=args.iters,
                                   seed=i, deadline=deadline)
        datasets[sid] = ds
    return service, datasets


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--iters", type=int, default=128, help="per-scene iterations")
    ap.add_argument("--slice", type=int, default=16, help="iterations per time slice")
    ap.add_argument("--policy", choices=["round_robin", "edf"], default="round_robin")
    ap.add_argument("--max-resident", type=int, default=None,
                    help="device slots; extra sessions queue (slot-reset admission)")
    ap.add_argument("--max-cohort", type=int, default=None,
                    help="train-cohort cap (default unlimited; 1 = pure time-slicing)")
    ap.add_argument("--dense-render", action="store_true",
                    help="serve renders dense instead of redistributed")
    ap.add_argument("--render-spr", type=int, default=None,
                    help="redistributed samples per ray (default n_samples // 4)")
    ap.add_argument("--renders-per-scene", type=int, default=3,
                    help="novel-view render requests submitted per scene mid-training")
    ap.add_argument("--rays", type=int, default=256)
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--hw", type=int, default=24)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--gt-samples", type=int, default=48)
    ap.add_argument("--persist-dir", default=None,
                    help="persist published snapshots (atomic per-session checkpoints)")
    ap.add_argument("--no-guard", action="store_true",
                    help="disable the session guard (slice errors unwind the run)")
    ap.add_argument("--guard-ckpt-every", type=int, default=4,
                    help="guard last-good checkpoint cadence, in healthy slices")
    ap.add_argument("--guard-max-retries", type=int, default=3,
                    help="consecutive rollbacks before a session is quarantined")
    ap.add_argument("--render-deadline", type=float, default=None,
                    help="per-request render deadline in seconds (expired "
                         "requests return a typed error instead of hanging)")
    ap.add_argument("--shed-threshold", type=int, default=None,
                    help="ready-request queue depth that triggers quality "
                         "shedding (halved samples per ray) before drops")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard sessions across N cards (not ported yet)")
    ap.add_argument("--snapshot-levels", type=int, default=0,
                    help="preview snapshot level k: publish cheap h>>k "
                         "previews every healthy slice until a scene's first "
                         "full snapshot lands (0 = full snapshots only)")
    ap.add_argument("--async-serving", action="store_true",
                    help="drive renders from a serving thread")
    ap.add_argument("--chaos", action="store_true",
                    help="demo fault injection: poison scene-001's params "
                         "with NaN mid-run and watch the guard roll it back")
    ap.add_argument("--device", default="cuda",
                    help="where sessions train and render (cuda or cpu)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON of the run (enables obs)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final metrics snapshot JSON (enables obs)")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="print a serve3d metrics snapshot every N quanta")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.trace_out or args.metrics_out or args.metrics_every:
        obs_trace.set_enabled(True)
    print(f"device: {args.device}")

    if args.chaos:
        if args.scenes < 2:
            raise SystemExit("--chaos needs at least 2 scenes")
        faults.configure(enabled=True)
        faults.inject("serve3d.slice", "nan_params", session="scene-001",
                      at_step=args.iters // 2, times=1)
        print(f"chaos: NaN-params fault armed for scene-001 at step {args.iters // 2}")

    service, datasets = build_service(args)
    novel = sphere_poses(max(8, args.renders_per_scene), seed=123)
    # render triggers land on slice boundaries: event["step"] only takes
    # multiples of --slice, clamped to --iters on the final slice
    boundaries = list(range(args.slice, args.iters, args.slice)) + [args.iters]
    picks = np.linspace(0, len(boundaries) - 1, min(args.renders_per_scene, len(boundaries)))
    slice_marks = {boundaries[int(round(i))] for i in picks}
    quanta = [0]

    def hook(svc, event):
        for sid in event["cohort"]:  # cohort members share the slice boundary
            if svc.sessions[sid].step in slice_marks:
                k = svc.renderer.served.get(sid, 0) + svc.renderer.pending
                svc.request_render(sid, novel[k % len(novel)])
        for r in event["results"]:
            print(f"  render {r.session_id} req#{r.request_id} "
                  f"snapshot v{r.snapshot_version}@{r.snapshot_step} "
                  f"latency {r.latency_s * 1e3:.0f} ms")
        quanta[0] += 1
        if args.metrics_every and quanta[0] % args.metrics_every == 0:
            print(f"-- metrics @ quantum {quanta[0]} --")
            print(obs_export.format_metrics(svc.metrics(), prefix="serve3d."))

    tel = service.run(hook=hook)

    if args.trace_out:
        print(f"trace -> {service.dump_trace(args.trace_out)}")
    if args.metrics_out:
        obs_export.dump_metrics(args.metrics_out, extra=service.metrics()["meta"])
        print(f"metrics -> {args.metrics_out}")
    print("\nper-session progress:")
    for p in tel["sessions"]:
        print(f"  {p['session_id']}: {p['status']} step {p['step']}/{p['target_iters']} "
              f"loss {p['loss']:.5f} train {p['train_wall_s']:.1f}s")
    r = tel["render"]
    print(f"\ndevices {tel['devices']}  scenes/sec {tel['scenes_per_sec']:.3f}  "
          f"renders {r.get('count', 0)}  "
          f"p50 {r.get('p50_ms', float('nan')):.0f} ms  p95 {r.get('p95_ms', float('nan')):.0f} ms")
    g = tel.get("guard")
    if g is not None:
        print(f"guard: rollbacks {g['rollbacks']}  "
              f"quarantined {g['quarantined'] or 'none'}  "
              f"checkpoints {g['checkpoints']}  "
              f"publish retries {tel['publish_failures']}  "
              f"stragglers {tel['stragglers_flagged']}")
        if g["recovery_ms"]["count"]:
            print(f"guard recovery p50 {g['recovery_ms']['p50']:.1f} ms "
                  f"(n={g['recovery_ms']['count']})")
    if args.chaos:
        print(f"chaos: nan_params fired {faults.fired_count('nan_params')}x, "
              f"guard rollbacks {g['rollbacks'] if g else 0}")
        faults.reset()
    return tel


if __name__ == "__main__":
    main()
