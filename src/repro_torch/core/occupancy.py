"""Occupancy grid: empty-space skipping for ray marching (Instant-NGP section 3).

The port of `repro.core.occupancy`.  A coarse grid over the unit cube whose
cell densities are re-queried at jittered cell centers, folded into an EMA
and thresholded into the bitfield the pipeline's cull stage reads.  A
published snapshot carries the EMA and its fold count.  Stage 2b v3 reads
the EMA itself per point (`point_density`) to weight its strata.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class OccupancyConfig:
    resolution: int = 32
    # every cell is re-queried on each update, so the EMA is pure hysteresis
    # against jitter flicker and a fast decay tracks the field
    ema_decay: float = 0.6
    # cull only near-empty cells (alpha of sigma = 0.05 at the default
    # stratum width is ~2/255, below visibility)
    density_threshold: float = 0.05
    update_interval: int = 16
    warmup_steps: int = 64          # all-occupied until the field knows something


class OccupancyState(NamedTuple):
    density_ema: torch.Tensor  # (R^3,) f32
    step: int                  # number of updates folded in (or a 0-d int tensor)


def init_state(cfg: OccupancyConfig, device="cuda") -> OccupancyState:
    """EMA at zero; `bitfield` reads all-occupied while step == 0."""
    return OccupancyState(
        torch.zeros((cfg.resolution ** 3,), dtype=torch.float32, device=device), 0)


def cell_centers(cfg: OccupancyConfig, device="cuda") -> torch.Tensor:
    """(R^3, 3) cell centers, x-major (flat = x*R*R + y*R + z)."""
    r = cfg.resolution
    axis = (torch.arange(r, dtype=torch.float32, device=device) + 0.5) / r
    gx, gy, gz = torch.meshgrid(axis, axis, axis, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def update(field, params: dict, state: OccupancyState, cfg: OccupancyConfig,
           generator: torch.Generator | None = None,
           jitter: torch.Tensor | None = None) -> OccupancyState:
    """Requery every cell's density at a jittered center, EMA-fold
    (`max(ema * decay, sigma)`), step + 1.

    The jitter is either drawn from `generator` as (U(0,1) - 0.5) / R or
    passed in ready-made as an (R^3, 3) tensor (tests pass the reference's
    draws).  The query runs on the params' device."""
    device = params["density_grid"].device
    pts = cell_centers(cfg, device)
    if jitter is None:
        if generator is None:
            raise ValueError("occupancy.update needs a generator or a jitter tensor")
        u = torch.rand(pts.shape, generator=generator, device=generator.device)
        jitter = (u.to(device) - 0.5) / cfg.resolution
    sigma, _ = field.density(params, torch.clamp(pts + jitter.to(device), 0.0, 1.0 - 1e-6))
    ema = torch.maximum(state.density_ema.to(device) * cfg.ema_decay, sigma)
    return OccupancyState(ema, int(state.step) + 1)


def bitfield(state: OccupancyState, cfg: OccupancyConfig) -> torch.Tensor:
    """Thresholded occupancy bits (R^3,) bool -- the cull stage's input;
    all True while no update has been folded in (step == 0).  The step may
    be a 0-d tensor on the EMA's device: the choice is made there, with no
    host read, so a captured render serves any snapshot's fold count."""
    return (state.density_ema > cfg.density_threshold) | (state.step == 0)


def _cell_flat(points_unit: torch.Tensor, resolution: int) -> torch.Tensor:
    """Each point's cell in the x-major flattening (x*R*R + y*R + z)."""
    r = resolution
    cell = torch.clamp((points_unit * r).to(torch.int64), 0, r - 1)
    return cell[..., 0] * r * r + cell[..., 1] * r + cell[..., 2]


def point_liveness(bits: torch.Tensor, points_unit: torch.Tensor,
                   resolution: int) -> torch.Tensor:
    """Per-point occupancy lookup: bits (R^3,) bool, points (..., 3) in
    [0, 1) -> bool with the leading shape (x-major flattening)."""
    return bits[_cell_flat(points_unit, resolution)]


def ray_segment_mask(bits: torch.Tensor, unit_midpoints: torch.Tensor,
                     resolution: int) -> torch.Tensor:
    """Per-ray live-bin mask (B, M) bool for probe midpoints (B, M, 3): the
    binary placement density stage 2b v2 inverts."""
    return point_liveness(bits, unit_midpoints, resolution)


def point_density(ema: torch.Tensor, points_unit: torch.Tensor,
                  resolution: int) -> torch.Tensor:
    """Per-point occupancy-EMA gather, the float twin of `point_liveness`:
    ema (R^3,) f32, points (..., 3) -> f32 with the leading shape."""
    return ema[_cell_flat(points_unit, resolution)]


def ray_segment_mass(ema: torch.Tensor, unit_midpoints: torch.Tensor,
                     resolution: int, threshold: float) -> torch.Tensor:
    """EMA-weighted live mass per probe bin: the cell's EMA where it exceeds
    `threshold`, else 0.  `> 0` of it is `ray_segment_mask` of the bitfield
    `ema > threshold`."""
    d = point_density(ema, unit_midpoints, resolution)
    return torch.where(d > threshold, d, torch.zeros_like(d))


def occupied_mask_fn(state: OccupancyState, cfg: OccupancyConfig):
    """The cull stage as a closure over the state's bitfield, for
    `rendering.render_rays`."""
    bits = bitfield(state, cfg)
    return lambda points_unit: point_liveness(bits, points_unit, cfg.resolution)


def occupancy_fraction(state: OccupancyState, cfg: OccupancyConfig) -> torch.Tensor:
    """Fraction of cells above threshold (the cell-level sparsity, not the
    pipeline's per-sample live fraction)."""
    return torch.mean((state.density_ema > cfg.density_threshold).to(torch.float32))
