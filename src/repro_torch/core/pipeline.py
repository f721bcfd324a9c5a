"""Staged render pipeline with occupancy-compacted field queries.

The port of `repro.core.pipeline` for the serving and training paths:

    1. generate_samples   rays x ts -> world points, per-sample dirs
    2. cull               AABB test + occupancy-bitfield lookup -> live mask
   2b. redistribute       (v2, optional) re-spend each ray's sample budget on
                          its live strata by inverse-CDF placement, S' =
                          budget // B per ray, with per-sample deltas
    3. compact            stable argsort to a fixed budget, live points first
                          in Morton (Z-order) key order
    4. shade              hash encode + MLPs on the compacted points only;
                          with the fused path on, the fused encode and the
                          MLP heads (`Field.query_fused`), or with the fused
                          step on too, the one-op fused step
                          (`Field.query_step`)
    5. scatter/composite  scatter sigma/rgb back to B x S, volume-render

With ``budget=None`` the pipeline runs the dense path (query every point,
zero the culled sigmas).  Every stage is differentiable in the params: the
compacted scatter is an `index_copy` whose backward gathers the gradient
back to the compacted sigma / rgb.  `suggest_budget` picks the pow2 point
budget from a measured live fraction.  Integer stage outputs (Morton keys,
the compaction order, the redistribute stratum index, the budget) match the
reference exactly on the same inputs.  Stage 2b v3 is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import occupancy as occ_lib
from . import rendering as _r
from ..kernels.fused_path import ref as fp_ref
from ..kernels.volume_render import ops as vr_ops
from ..kernels.volume_render import ref as vr_ref
from ..obs import trace as _trace

# dead lanes sort after every live Morton key (the reference's uint32 max)
DEAD_KEY = 0xFFFFFFFF


def _cube_root(n: int) -> int:
    r = round(n ** (1.0 / 3.0))
    for cand in (r - 1, r, r + 1):
        if cand > 0 and cand ** 3 == n:
            return cand
    raise ValueError(f"bitfield length {n} is not a cube")


def suggest_budget(live_fraction: float, n_total: int, *, headroom: float = 1.3,
                   min_budget: int = 512, max_budget: int | None = None) -> int:
    """Pow2-bucketed point budget for a measured live fraction: the smallest
    min_budget * 2^k at or above n_total * min(1, live_fraction * headroom),
    capped at n_total and at `max_budget` (a hard per-step ceiling)."""
    want = int(n_total * min(1.0, max(0.0, live_fraction) * headroom))
    b = min_budget
    while b < want:
        b *= 2
    b = min(b, n_total)
    if max_budget is not None:
        b = min(b, int(max_budget))
    return b


class CompactionPlan(NamedTuple):
    idx: torch.Tensor       # (budget,) int64 unique flat-sample indices, live first
    keep: torch.Tensor      # (budget,) bool, False on padded dead lanes
    n_live: torch.Tensor    # () int64 live points before compaction
    overflow: torch.Tensor  # () int64 live points dropped (budget too small)


def inverse_cdf_strata(ts: torch.Tensor, live: torch.Tensor, n_out: int,
                       near: float, far: float):
    """The placement plan of `RenderPipeline.redistribute`.

    Each ray's live mask over its S strata becomes a piecewise-constant CDF
    (dead rays: uniform), and `n_out` stratified u in (0, 1), with jitter
    recycled from `ts`, are inverted through it.  Returns (j (B, n_out)
    int64 stratum index, u, cdf_lo, p): sample k lands in stratum j[k] at
    fraction (u - cdf_lo) / p of it."""
    b, s = ts.shape
    w = live.to(torch.float32)
    total = torch.sum(w, dim=-1, keepdim=True)
    w = torch.where(total > 0, w, torch.ones_like(w))       # dead ray -> uniform
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)

    k = torch.arange(n_out, device=ts.device)
    jitter = (ts[:, :n_out] - near) / (far - near) * s - k
    jitter = torch.clamp(jitter, 0.0, 1.0 - 1e-6)
    u = (k + jitter) / n_out                                 # ascending per ray
    u = u * cdf[:, -1:]                                      # absorb cumsum rounding

    j = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    j = torch.clamp(j, 0, s - 1)
    cdf_lo = torch.where(
        j > 0, torch.gather(cdf, 1, torch.clamp(j - 1, min=0)), torch.zeros_like(u))
    p = torch.clamp(torch.gather(pdf, 1, j), min=1e-12)
    return j, u, cdf_lo, p


class RenderPipeline:
    """Callable pipeline; the stages are methods so tests can hold each one
    against the reference.

    fused_path: route the compacted shade stage (budgeted branch only)
    through the field's fused encode, `query_fused` (kernel #8 on the card,
    then the MLP heads); with fused_step also on, through the one-op fused
    step, `query_step` (which the NGP baseline answers with `query_fused`).
    The dense path always uses the plain per-grid `query`.

    redistribute: adaptive ray marching (stage 2b, v2).  With a bitfield and
    a budget present, each ray's S samples are re-spent on its live strata,
    S' = budget // B per ray, placed by inverse CDF over the liveness of the
    uniform candidates; off, the stage never runs."""

    def __init__(self, field, cfg: _r.RenderConfig, *, fused_path: bool = True,
                 fused_step: bool = True, redistribute: bool = False):
        self.field = field
        self.cfg = cfg
        self.fused_path = fused_path and hasattr(field, "query_fused")
        self.fused_step = self.fused_path and fused_step and hasattr(field, "query_step")
        self.redistribute_on = redistribute

    # ---- stage 1: sample generation ----

    def generate_samples(self, origins, dirs, ts):
        """-> (flat world points (N, 3), flat dirs (N, 3), unit coords (N, 3)),
        N = B*S ray-major: flat index i*S + k is ray i's k-th sample."""
        points = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
        flat_pts = points.reshape(-1, 3)
        flat_dirs = torch.broadcast_to(dirs[:, None, :], points.shape).reshape(-1, 3)
        unit = _r.normalize_points(flat_pts, self.cfg)
        return flat_pts, flat_dirs, unit

    # ---- stage 2: cull ----

    def cull(self, flat_pts, unit, bitfield=None):
        """AABB test, and the occupancy lookup when a bitfield (R^3,) is given."""
        live = _r.inside_aabb(flat_pts, self.cfg)
        if bitfield is not None:
            r = _cube_root(bitfield.shape[0])
            live = live & occ_lib.point_liveness(bitfield, unit, r)
        return live

    # ---- stage 2b: redistribute (v2) ----

    def redistribute(self, ts, live, *, n_out: int | None = None):
        """Inverse-CDF sample redistribution over live occupancy strata.

        `live` (B, S) is the cull liveness of the uniform candidates `ts`;
        their in-stratum jitter is reused, so the stage is a deterministic
        function of (ts, live).  Returns (ts_new (B, n_out) ascending per
        ray, deltas (B, n_out) = h / (p * n_out), the live arc length each
        sample stands for)."""
        b, s = ts.shape
        n_out = s if n_out is None else int(n_out)
        near, far = self.cfg.near, self.cfg.far
        h = (far - near) / s
        j, u, cdf_lo, p = inverse_cdf_strata(ts, live, n_out, near, far)
        frac = torch.clamp((u - cdf_lo) / p, 0.0, 1.0 - 1e-6)
        ts_new = near + (j.to(torch.float32) + frac) * h
        deltas = h / (p * n_out)
        return ts_new, deltas

    # ---- stage 3: compact ----

    def compact(self, live, budget: int, unit=None) -> CompactionPlan:
        """Live-first compaction to a fixed budget, padded with dead samples.

        With `unit` given, live points are ordered by Morton key (dead lanes
        keyed 0xFFFFFFFF sort last); without, in flat order.  The key is
        int64, so the dead key stays above every live one, and the sort is
        stable, so ties keep flat order as in the reference."""
        if unit is None:
            key = torch.logical_not(live).to(torch.int64)
        else:
            key = torch.where(live, fp_ref.morton_key(unit),
                              torch.full_like(live, DEAD_KEY, dtype=torch.int64))
        order = torch.sort(key, stable=True).indices
        idx = order[:budget]
        n_live = torch.sum(live.to(torch.int64))
        keep = live[idx]
        overflow = torch.clamp(n_live - budget, min=0)
        return CompactionPlan(idx, keep, n_live, overflow)

    # ---- stage 4: shade ----

    def shade(self, params, unit, dirs, fused: bool = False):
        """Field query on (already compacted) unit coords -> (sigma, rgb);
        fused=True takes the fused encode (`query_fused`), or the one-op
        fused step (`query_step`) when the pipeline's fused_step is on."""
        if fused:
            if self.fused_step:
                return self.field.query_step(params, unit, dirs)
            return self.field.query_fused(params, unit, dirs)
        return self.field.query(params, unit, dirs)

    # ---- stage 5: scatter + composite ----

    def composite(self, sigma, rgb, ts, deltas=None):
        """Volume-render (B*S,) sigma / (B*S, 3) rgb along ts (B, S); deltas
        default to the uniform-sampler widths."""
        b, s = ts.shape
        if deltas is None:
            deltas = vr_ref.uniform_deltas(ts, self.cfg.far - self.cfg.near)
        out = vr_ops.composite(sigma.reshape(b, s), rgb.reshape(b, s, 3), deltas, ts)
        color = out.color
        if self.cfg.white_background:
            color = color + (1.0 - out.opacity[..., None])
        return {"rgb": color, "depth": out.depth, "opacity": out.opacity,
                "weights": out.weights}

    # ---- full pipeline ----

    def __call__(self, params, origins, dirs, ts, *, bitfield=None,
                 budget: int | None = None):
        """Render a ray batch: the dense path with budget=None, else the
        compacted path at that point budget (stage 2b first when on and a
        bitfield is given and budget >= B)."""
        b, s = ts.shape
        n = b * s
        with _trace.span("pipeline/sample", cat="pipeline"):
            flat_pts, flat_dirs, unit = self.generate_samples(origins, dirs, ts)
        with _trace.span("pipeline/cull", cat="pipeline"):
            live = self.cull(flat_pts, unit, bitfield=bitfield)

        deltas = probe_live_frac = None
        if (self.redistribute_on and bitfield is not None
                and budget is not None and int(budget) >= b):
            with _trace.span("pipeline/redistribute", cat="pipeline"):
                # the candidates' liveness is the probe; its mean is the
                # uniform sampler's live fraction
                probe_live_frac = torch.mean(live.to(torch.float32))
                s = min(s, min(int(budget), n) // b)
                ts, deltas = self.redistribute(ts, live.reshape(b, -1), n_out=s)
                budget = n = b * s
                flat_pts, flat_dirs, unit = self.generate_samples(origins, dirs, ts)
                live = self.cull(flat_pts, unit, bitfield=bitfield)

        if budget is None:
            with _trace.span("pipeline/shade", cat="pipeline",
                             args={"points": n, "dense": True}):
                sigma, rgb = self.shade(params, unit, flat_dirs)
            sigma = torch.where(live, sigma, torch.zeros_like(sigma))
            n_live = torch.sum(live.to(torch.int64))
            overflow = torch.zeros((), dtype=torch.int64, device=live.device)
            points_queried = n
        else:
            budget = min(int(budget), n)
            with _trace.span("pipeline/compact", cat="pipeline",
                             args={"budget": budget}):
                plan = self.compact(live, budget, unit)
            with _trace.span("pipeline/shade", cat="pipeline",
                             args={"points": budget, "dense": False}):
                sigma_c, rgb_c = self.shade(params, unit[plan.idx], flat_dirs[plan.idx],
                                            fused=self.fused_path)
            # the plan's indices are unique, so the scatter is deterministic;
            # its backward gathers the gradient back to sigma_c / rgb_c
            sigma = torch.zeros((n,), dtype=sigma_c.dtype, device=sigma_c.device).index_copy(
                0, plan.idx, torch.where(plan.keep, sigma_c, torch.zeros_like(sigma_c)))
            rgb = torch.zeros((n, 3), dtype=rgb_c.dtype, device=rgb_c.device).index_copy(
                0, plan.idx, rgb_c * plan.keep[:, None].to(rgb_c.dtype))
            n_live, overflow = plan.n_live, plan.overflow
            points_queried = budget

        with _trace.span("pipeline/composite", cat="pipeline"):
            out = self.composite(sigma, rgb, ts, deltas)
        out.update(
            live_fraction=(probe_live_frac if probe_live_frac is not None
                           else torch.mean(live.to(torch.float32))),
            n_live=n_live,
            overflow=overflow,
            points_queried=points_queried,
        )
        return out
