"""Cameras, rays and sample placement (paper steps 1-2).

The port of `repro.core.rendering`.  Scene contents live inside the box
`aabb` (default [-1.5, 1.5]^3); sample positions are normalised to [0, 1)^3
before they reach the hash grids.  Poses are numpy, as in the reference;
everything else is torch on an explicit device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


@dataclass(frozen=True)
class RenderConfig:
    n_samples: int = 48
    near: float = 2.0
    far: float = 6.0
    aabb_min: float = -1.5
    aabb_max: float = 1.5
    white_background: bool = True
    stratified: bool = True


class RayBatch(NamedTuple):
    origins: torch.Tensor   # (B, 3)
    dirs: torch.Tensor      # (B, 3) unit norm
    rgb_gt: torch.Tensor    # (B, 3) ground-truth pixel colors (training only)


# --- cameras -----------------------------------------------------------------

def look_at_pose(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenGL-style camera-to-world (3, 4): columns = [right, up, -forward | eye]."""
    eye = np.asarray(eye, np.float32)
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float32))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, forward)
    return np.stack([right, true_up, -forward, eye], axis=1).astype(np.float32)


def sphere_poses(n_views: int, radius: float = 4.0, elevation_deg: float = 30.0,
                 seed: int = 0) -> np.ndarray:
    """(V, 3, 4) poses on a view sphere looking at the origin (NeRF-Synthetic style)."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_views):
        az = 2 * np.pi * i / n_views + rng.uniform(0, 0.1)
        el = np.deg2rad(elevation_deg + rng.uniform(-12, 12))
        eye = radius * np.array(
            [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)], np.float32
        )
        poses.append(look_at_pose(eye, np.zeros(3, np.float32)))
    return np.stack(poses)


def pixel_rays(pose: torch.Tensor, px: torch.Tensor, py: torch.Tensor, h: int,
               w: int, focal: float):
    """Rays through pixel centers. pose (3, 4); px, py (B,) -> origins, dirs (B, 3)."""
    x = (px.to(torch.float32) + 0.5 - w * 0.5) / focal
    y = -(py.to(torch.float32) + 0.5 - h * 0.5) / focal
    dirs_cam = torch.stack([x, y, -torch.ones_like(x)], dim=-1)  # (B, 3)
    dirs = dirs_cam @ pose[:3, :3].T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = torch.broadcast_to(pose[:3, 3], dirs.shape)
    return origins, dirs


# --- sampling ----------------------------------------------------------------

def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """f32 linspace with `jnp.linspace`'s arithmetic (start*(1-step) +
    stop*step, exact endpoints), so the strata edges match the reference
    bit for bit."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    # filled on the device: no host-to-device copy
    start_t = torch.full((), start, dtype=torch.float32, device=device)
    stop_t = torch.full((), stop, dtype=torch.float32, device=device)
    head = start_t * (1 - step) + stop_t * step
    return torch.cat([head, stop_t[None]])


def sample_ts(generator: torch.Generator | None, n_rays: int, cfg: RenderConfig,
              device="cuda", u: torch.Tensor | None = None) -> torch.Tensor:
    """Stratified sample distances (B, S) in [near, far].

    One sample per uniform stratum of width (far - near)/S, at the in-stratum
    fraction u: drawn from `generator`, or passed in ready-made as a (B, S)
    tensor of U(0, 1) draws (the trainer's draw stream; tests pass the
    reference's draws).  With neither, the stratum midpoints (the
    deterministic serving path).  The redistribute stage (2b) reuses these
    samples' in-stratum jitter."""
    s = cfg.n_samples
    edges = _linspace(cfg.near, cfg.far, s + 1, device)
    lo, hi = edges[:-1], edges[1:]
    if cfg.stratified and u is not None:
        u = u.to(device=device, dtype=torch.float32)
    elif cfg.stratified and generator is not None:
        u = torch.rand((n_rays, s), generator=generator,
                       device=generator.device).to(device)
    else:
        u = torch.full((n_rays, s), 0.5, device=device)
    return lo[None, :] + u * (hi - lo)[None, :]


def normalize_points(points: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """World -> [0, 1)^3 grid coords, clipped to the box."""
    unit = (points - cfg.aabb_min) / (cfg.aabb_max - cfg.aabb_min)
    return torch.clamp(unit, 0.0, 1.0 - 1e-6)


def inside_aabb(points: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    return torch.all((points >= cfg.aabb_min) & (points <= cfg.aabb_max), dim=-1)


def render_rays(field, params: dict, origins: torch.Tensor, dirs: torch.Tensor,
                ts: torch.Tensor, cfg: RenderConfig, occupancy_mask_fn=None) -> dict:
    """Differentiable dense render, origins / dirs (B, 3), ts (B, S) -> the
    pipeline's output dict: every point queried, culled sigmas zeroed.
    occupancy_mask_fn: optional (points_unit (N, 3) -> bool (N,)) cull hook,
    e.g. `occupancy.occupied_mask_fn`.  A wrapper over `RenderPipeline`,
    which with a point budget skips the culled queries instead."""
    from .pipeline import RenderPipeline  # the pipeline imports this module

    return RenderPipeline(field, cfg)(params, origins, dirs, ts, mask_fn=occupancy_mask_fn)
