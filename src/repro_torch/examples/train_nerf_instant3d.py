"""End-to-end Instant-3D training from the command line: checkpoints,
auto-resume and the straggler watchdog around the paper's algorithm.

    PYTHONPATH=src python -m repro_torch.examples.train_nerf_instant3d \
        --scene-seed 0 --iters 300 --ckpt-dir /tmp/i3d_ckpt --auto-resume
    PYTHONPATH=src python -m repro_torch.examples.train_nerf_instant3d \
        --device cpu --iters 8 --ckpt-every 4

The port of ``examples/train_nerf_instant3d.py``, with its flags, defaults
and configuration (a 48x48 procedural scene of 12 views, 768 rays x 24
samples, ``FieldConfig(n_levels=6, max_resolution=96)`` with the table
sizes ``--sd-sc`` derives and the color update frequency ``--fd-fc``
gives); ``--device`` (default ``cuda``) takes the place of ``--backend``,
since the port dispatches on the tensor's device.  It trains in chunks of
``--ckpt-every`` steps and checkpoints after each (`CheckpointManager`,
the reference's layout); kill it and rerun with ``--auto-resume`` to go on
from the last checkpoint with the same draws (they are keyed by the
absolute step).

A checkpoint holds the reference CLI's tree, ``{"params", "opt", "occ",
"occ_step"}``, and also the trainer's live fraction and overflow window
(``"live_frac"``, ``"overflow_window"``, the keys of
`Instant3DTrainer.suspend`), so a resumed run takes the compacted budget
an uninterrupted one takes and ends on the same bytes.  A checkpoint
without them (the reference CLI's) resumes as the reference does: dense
steps until the next occupancy fold re-measures the live fraction; one
without ``occ_step`` resumes with no fold counted.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..core import occupancy
from ..core.field import Field, FieldConfig
from ..core.rendering import RenderConfig
from ..core.trainer import Instant3DTrainer, TrainerConfig
from ..data.rays_dataset import RaySampler
from ..data.synthetic_scene import build_dataset
from ..obs import export as obs_export
from ..obs import trace as obs_trace
from ..runtime.driver import StragglerStats

# the trainer's bookkeeping a checkpoint carries beside the reference's tree
BOOKKEEPING = ("live_frac", "overflow_window")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene-seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "i3d_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--auto-resume", action="store_true")
    ap.add_argument("--sd-sc", default="1:0.25", help="grid size ratio S_D:S_C")
    ap.add_argument("--fd-fc", default="1:0.5", help="update freq ratio F_D:F_C")
    ap.add_argument("--device", default="cuda", help="where to train (cuda or cpu)")
    ap.add_argument("--no-compact", action="store_true",
                    help="disable occupancy-compacted field queries (dense path)")
    ap.add_argument("--no-fused-path", action="store_true",
                    help="shade the compacted batch with the per-grid encode "
                         "path instead of the fused kernels (compaction stays "
                         "Morton-ordered either way)")
    ap.add_argument("--redistribute", action="store_true",
                    help="occupancy-guided sample redistribution (pipeline "
                         "stage 2b): re-spend each ray's freed sample budget "
                         "on its live strata by inverse-CDF placement")
    ap.add_argument("--redistribute-v3", action="store_true",
                    help="density-weighted, workload-balanced redistribution "
                         "(stage 2b v3): per-ray S' from one global inverse "
                         "CDF, sum(S') <= budget; supersedes --redistribute")
    ap.add_argument("--max-budget", type=int, default=None,
                    help="hard per-step point ceiling (see "
                         "trainer.autotune_max_budget)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON of the run (enables obs)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final metrics snapshot JSON (enables obs)")
    return ap


def build_trainer(args) -> Instant3DTrainer:
    """The CLI's trainer: the field and trainer configs its flags give."""
    render = RenderConfig(n_samples=24)
    sc = float(args.sd_sc.split(":")[1])
    fc = float(args.fd_fc.split(":")[1])
    field = Field(FieldConfig(n_levels=6, max_resolution=96,
                              log2_table_density=13,
                              log2_table_color=int(13 + np.log2(sc))))
    return Instant3DTrainer(field, TrainerConfig(
        n_rays=768, iters=args.iters, f_color=fc, render=render,
        occ=occupancy.OccupancyConfig(update_interval=16, warmup_steps=32),
        compact=not args.no_compact,
        fused_path=not args.no_fused_path,
        redistribute=args.redistribute,
        redistribute_v3=args.redistribute_v3,
        max_budget=args.max_budget,
    ), device=args.device)


def _checkpoint_tree(trainer: Instant3DTrainer, state) -> dict:
    host = trainer.suspend(state)
    return {"params": host["params"], "opt": host["opt"], "occ": host["occ_ema"],
            "occ_step": host["occ_step"],
            **{k: host[k] for k in BOOKKEEPING}}


def _resume(trainer: Instant3DTrainer, state, ckpt: CheckpointManager):
    """The state of the newest valid checkpoint, restored through the
    fallbacks the module docstring lists."""
    tmpl = _checkpoint_tree(trainer, state)
    fresh = {k: tmpl[k] for k in BOOKKEEPING}   # 1.0 and an empty window
    try:
        restored, meta = ckpt.restore(tmpl)
    except KeyError:   # the reference CLI's tree: no bookkeeping
        for k in BOOKKEEPING:
            del tmpl[k]
        try:
            restored, meta = ckpt.restore(tmpl)
        except KeyError:   # a checkpoint older than the occ_step leaf
            del tmpl["occ_step"]
            restored, meta = ckpt.restore(tmpl)
    return trainer.resume({
        "params": restored["params"], "opt": restored["opt"],
        "occ_ema": restored["occ"],
        # occ_step matters: the trainer renders dense until the EMA has
        # folded at least one real update
        "occ_step": restored.get("occ_step", np.zeros((), np.int32)),
        "step": np.asarray(int(meta["step"]), np.int32),
        **{k: restored.get(k, fresh[k]) for k in BOOKKEEPING},
    })


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.trace_out or args.metrics_out:
        obs_trace.configure(enabled=True)
    device = torch.device(args.device)
    print(f"device: {device}")

    trainer = build_trainer(args)
    _scene, ds = build_dataset(seed=args.scene_seed, n_views=12, h=48, w=48,
                               cfg=trainer.cfg.render, gt_samples=128, device=device)

    ckpt = CheckpointManager(args.ckpt_dir, keep_last=2)
    state = trainer.init(torch.Generator().manual_seed(0))
    start = 0
    if args.auto_resume and ckpt.latest_step() is not None:
        state = _resume(trainer, state, ckpt)
        start = state.step
        print(f"resumed from step {start}")

    sampler = RaySampler(ds, device=device)
    watchdog = StragglerStats()
    done = start
    step_s = []
    while done < args.iters:
        chunk = min(args.ckpt_every, args.iters - done)
        t0 = time.perf_counter()
        state, hist = trainer.train(state, sampler, iters=chunk, log_every=chunk)
        dt = (time.perf_counter() - t0) / chunk
        step_s.append(dt)
        if watchdog.update(dt, sigma=4.0, alpha=0.1):
            print(f"[straggler] step time {dt:.3f}s vs ewma {watchdog.ewma:.3f}s")
        done += chunk
        ckpt.save(done, _checkpoint_tree(trainer, state))
        print(f"step {done:5d}  loss {hist['loss'][-1]:.5f}  ({dt:.3f}s/iter)  ckpt saved")

    ckpt.wait()
    ev = trainer.evaluate(state.params, ds, views=[0, 1, 2])
    print(f"final PSNR rgb={ev['psnr_rgb']:.2f} depth={ev['psnr_depth']:.2f}")
    if args.trace_out:
        path = obs_export.dump_trace(args.trace_out, process_name="repro_torch.train")
        print(f"trace -> {path}")
    if args.metrics_out:
        print(f"metrics -> {obs_export.dump_metrics(args.metrics_out, extra={'iters': done})}")
    return {"trainer": trainer, "state": state, "start": start, "eval": ev,
            "step_s": step_s}


if __name__ == "__main__":
    main()
