"""Quickstart: reconstruct a procedural scene with Instant-3D.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

The port of ``examples/quickstart.py``, with its configuration: a 40x40
scene of 10 views, the paper's decomposed grids (S_D : S_C = 1 : 0.25,
F_D : F_C = 1 : 0.5), 512 rays x 24 samples, 200 steps; it prints the
parameter counts, the loss every 50 steps and the PSNR of views 0 and 1.
`main(iters=..., device=...)` runs it on the card by default.
"""
from __future__ import annotations

import time

import torch

from ..core import occupancy
from ..core.field import Field, FieldConfig
from ..core.rendering import RenderConfig
from ..core.trainer import Instant3DTrainer, TrainerConfig
from ..data.rays_dataset import RaySampler
from ..data.synthetic_scene import build_dataset


def main(iters: int = 200, device="cuda") -> dict:
    print(f"== Instant-3D quickstart (paper config, scaled down) on {device} ==")
    render = RenderConfig(n_samples=24)
    t0 = time.time()
    _scene, ds = build_dataset(seed=0, n_views=10, h=40, w=40, cfg=render, gt_samples=96,
                               device=device)
    print(f"built procedural scene + {ds.images.shape[0]} GT views in {time.time() - t0:.1f}s")

    # Instant-3D: decomposed grids, S_D:S_C = 1:0.25, F_D:F_C = 1:0.5 (paper section 5.1)
    field = Field(FieldConfig(
        n_levels=6, max_resolution=96,
        log2_table_density=13, log2_table_color=11,   # S_D : S_C = 1 : 0.25
    ))
    trainer = Instant3DTrainer(field, TrainerConfig(
        n_rays=512, iters=iters, f_density=1.0, f_color=0.5, render=render,
        occ=occupancy.OccupancyConfig(update_interval=16, warmup_steps=32),
    ), device=device)
    state = trainer.init(torch.Generator().manual_seed(0))
    counts = field.param_counts(state.params)
    print("params:", {k: f"{v:,}" for k, v in counts.items()})

    t0 = time.time()
    state, _hist = trainer.train(state, RaySampler(ds, device=device), log_every=50,
                                 callback=lambda i, p, h: print(
                                     f"  iter {i:4d}  loss {h['loss'][-1]:.5f}  "
                                     f"live {h['live_fraction'][-1]:.0%}"))
    train_s = time.time() - t0
    print(f"trained {trainer.cfg.iters} iters in {train_s:.1f}s")

    ev = trainer.evaluate(state.params, ds, views=[0, 1])
    print(f"PSNR: rgb={ev['psnr_rgb']:.2f} dB  depth={ev['psnr_depth']:.2f} dB "
          f"(paper's instant target: >25 dB rgb)")
    return {"eval": ev, "param_counts": counts, "train_s": train_s, "state": state}


if __name__ == "__main__":
    main()
