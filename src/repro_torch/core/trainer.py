"""Render functions of the Instant-3D trainer, shared with serving.

The port of the render part of `repro.core.trainer`: the chunk renderers
that `RenderService` (and, with the training slice, the trainer's
`evaluate`) call, and the full-image ray layout they consume.  JAX compiled
and cached these per (config, chunk, group); PyTorch runs eagerly, so they
are plain closures, and a group of sessions renders as a loop over its
members where JAX used `vmap`.  `Instant3DTrainer` comes with the training
slice.
"""
from __future__ import annotations

import torch

from . import field as field_lib
from . import occupancy, rendering
from .pipeline import RenderPipeline


def make_render_chunk(field_cfg, render_cfg: rendering.RenderConfig):
    """Dense-pipeline chunk renderer built from configs:
    (params, origins (N, 3), dirs (N, 3), ts (N, S)) -> (rgb, depth)."""
    pipeline = RenderPipeline(field_lib.Field(field_cfg), render_cfg)

    def render_chunk(params, origins, dirs, ts):
        out = pipeline(params, origins, dirs, ts)
        return out["rgb"], out["depth"]

    return render_chunk


def make_redistributed_render_chunk(field_cfg, render_cfg: rendering.RenderConfig,
                                    occ_cfg: occupancy.OccupancyConfig, budget: int):
    """Occupancy-redistributed chunk renderer (pipeline stage 2b) built from
    configs: (params, origins (N, 3), dirs (N, 3), ts (N, S), occ_ema (R^3,),
    occ_step) -> (rgb, depth).  The snapshot's EMA rebuilds the bitfield;
    the dense candidates' liveness is each ray's probe, and S' = budget // N
    samples per ray are shaded.  While occ_step == 0 the bitfield reads
    all-occupied and this is a uniform S'-sample render."""
    pipeline = RenderPipeline(field_lib.Field(field_cfg), render_cfg,
                              redistribute=True)

    def render_chunk(params, origins, dirs, ts, occ_ema, occ_step):
        bits = occupancy.bitfield(occupancy.OccupancyState(occ_ema, occ_step), occ_cfg)
        out = pipeline(params, origins, dirs, ts, bitfield=bits, budget=int(budget))
        return out["rgb"], out["depth"]

    return render_chunk


def default_samples_per_ray(n_samples: int) -> int:
    """The serving default for the redistributed per-ray budget: S/4,
    floored at 4 and capped at S."""
    s = int(n_samples)
    return min(s, max(4, s // 4))


def batched_render_fn(field_cfg, render_cfg: rendering.RenderConfig):
    """(params list of G dicts, origins (G, chunk, 3), dirs (G, chunk, 3),
    ts (chunk, S)) -> (rgb (G, chunk, 3), depth (G, chunk)), one member at
    a time."""
    render = make_render_chunk(field_cfg, render_cfg)

    def fn(params, origins, dirs, ts):
        outs = [render(p, origins[g], dirs[g], ts) for g, p in enumerate(params)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    return fn


def batched_redistributed_render_fn(field_cfg, render_cfg: rendering.RenderConfig,
                                    occ_cfg, chunk: int, samples_per_ray: int):
    """Redistributed flavor of `batched_render_fn`, shading chunk *
    samples_per_ray points per member: adds per-member occupancy inputs
    (occ_ema list of G (R^3,) tensors, occ_step list of G ints)."""
    render = make_redistributed_render_chunk(
        field_cfg, render_cfg, occ_cfg, int(chunk) * int(samples_per_ray))

    def fn(params, origins, dirs, ts, occ_ema, occ_step):
        outs = [render(p, origins[g], dirs[g], ts, occ_ema[g], occ_step[g])
                for g, p in enumerate(params)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    return fn


def image_rays(pose, h: int, w: int, focal: float, eval_chunk: int, device="cuda"):
    """Full-image rays padded to a chunk quantum.

    Returns (origins, dirs, n, chunk) with origins/dirs of length
    ceil(n/chunk)*chunk -- the padding repeats the last ray so dirs stay
    unit-norm; callers trim to n."""
    py, px = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
    o, d = rendering.pixel_rays(pose, px.reshape(-1), py.reshape(-1), h, w, focal)
    n = h * w
    chunk = min(int(eval_chunk), n)
    pad = (-n) % chunk
    if pad:
        o = torch.cat([o, torch.broadcast_to(o[-1:], (pad, 3))])
        d = torch.cat([d, torch.broadcast_to(d[-1:], (pad, 3))])
    return o, d, n, chunk
