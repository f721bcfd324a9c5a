"""Staged render pipeline with occupancy-compacted field queries.

The port of `repro.core.pipeline` for the serving and training paths:

    1. generate_samples   rays x ts -> world points, per-sample dirs
    2. cull               AABB test + occupancy-bitfield lookup -> live mask
   2b. redistribute       (optional) re-spend each ray's sample budget on
                          its live strata by inverse-CDF placement: v2 at
                          S' = budget // B per ray, or v3 at a per-ray S'_i
                          from one global allocation over the rays' live
                          masses, weighted by the occupancy EMA, on a
                          ragged (B, S_cap) lane grid; both emit per-sample
                          deltas
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
the compaction order, the stratum index, v3's per-ray counts, the budget)
match the reference exactly on the same inputs.  Stage 2b's float sums,
cumulative sums, exp and scalar divisions run in the reference's f32 order
(`ref_sum`, `ref_cumsum`, `ref_exp`, `_div`): v3's counts floor a 1024-ray
cumulative sum and both versions search their CDFs for each sample's
stratum, and `torch.cumsum` on the CPU accumulates in float64 and rounds
otherwise, so a sample on a CDF edge would land in another stratum.
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


# The order in which the reference's f32 reductions add on the CPU (XLA):
# a row sum longer than 32 is a tree of 32-wide windows, each summed in
# order, the padding split around the row (low pad // 2); a cumulative sum
# longer than 16 scans 16-wide blocks in order and adds the scanned block
# totals.  f32 additions in a fixed order round alike on every device.
SUM_WINDOW = 32
SCAN_BLOCK = 16


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def ref_sum(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """f32 sum over the last dim in the reference's order."""
    n = x.shape[-1]
    if n <= SUM_WINDOW:
        out = _sequential_sum(x)
    else:
        nb = -(-n // SUM_WINDOW)
        pad = nb * SUM_WINDOW - n
        xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        out = ref_sum(_sequential_sum(xp.reshape(*x.shape[:-1], nb, SUM_WINDOW)))
    return out[..., None] if keepdim else out


def ref_cumsum(x: torch.Tensor) -> torch.Tensor:
    """f32 cumulative sum over the last dim in the reference's order."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        outs = [x[..., 0]]
        for k in range(1, n):
            outs.append(outs[-1] + x[..., k])
        return torch.stack(outs, dim=-1)
    nb = -(-n // SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * SCAN_BLOCK - n))
    within = ref_cumsum(xp.reshape(*x.shape[:-1], nb, SCAN_BLOCK))
    before = ref_cumsum(within[..., -1])[..., :-1]
    before = torch.cat([torch.zeros_like(before[..., :1]), before], dim=-1)
    return (within + before[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def _f32(v: float) -> float:
    return torch.tensor(v, dtype=torch.float32).item()


# The reference's f32 exp on the CPU (XLA): Cephes' range reduction and
# polynomial, each step a fused multiply-add.  An FMA is emulated in float64,
# where the product of two f32 values is exact.
_LOG2E, _LN2_HI, _LN2_LO = _f32(1.44269504088896341), _f32(0.693359375), _f32(-2.12194440e-4)
_EXP_POLY = tuple(_f32(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                                    4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    return (a.double() * b + c).float()


def ref_exp(x: torch.Tensor) -> torch.Tensor:
    """f32 exp with the reference's bits on the CPU (`jnp.exp` and
    `torch.exp` differ by an ulp on many f32 inputs)."""
    x = torch.clamp(x, -87.8, 88.8)
    n = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    a = _fma(n, -_LN2_HI, x)
    a = _fma(n, -_LN2_LO, a)
    z = _fma(a, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        z = _fma(z, a.double(), c)
    z = 1.0 + _fma(z, (a * a).double(), a.double())
    # 2^n from its exponent bits (n = -127 gives 0); subnormal results flush
    # to 0 as there
    out = z * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(out < torch.finfo(torch.float32).tiny, torch.zeros_like(out), out)


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den rounded once, as the reference divides (`float / Tensor`
    in torch multiplies by the reciprocal)."""
    return torch.full_like(den, num) / den


class CompactionPlan(NamedTuple):
    idx: torch.Tensor       # (budget,) int64 unique flat-sample indices, live first
    keep: torch.Tensor      # (budget,) bool, False on padded dead lanes
    n_live: torch.Tensor    # () int64 live points before compaction
    overflow: torch.Tensor  # () int64 live points dropped (budget too small)


def live_cdf(live: torch.Tensor):
    """v2's per-ray placement density over its strata (B, S) f32, uniform
    over the live ones (dead rays: over all), and its CDF, scanned in the
    reference's f32 order (`ref_cumsum`)."""
    w = live.to(torch.float32)
    total = torch.sum(w, dim=-1, keepdim=True)
    w = torch.where(total > 0, w, torch.ones_like(w))       # dead ray -> uniform
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    return pdf, ref_cumsum(pdf)


def inverse_cdf_strata(ts: torch.Tensor, live: torch.Tensor, n_out: int,
                       near: float, far: float):
    """The placement plan of `RenderPipeline.redistribute`.

    Each ray's live mask over its S strata becomes a piecewise-constant CDF
    (`live_cdf`), and `n_out` stratified u in (0, 1), with jitter recycled
    from `ts`, are inverted through it.  Returns (j (B, n_out)
    int64 stratum index, u, cdf_lo, p): sample k lands in stratum j[k] at
    fraction (u - cdf_lo) / p of it."""
    b, s = ts.shape
    pdf, cdf = live_cdf(live)

    k = torch.arange(n_out, device=ts.device)
    jitter = (ts[:, :n_out] - near) / (far - near) * s - k
    jitter = torch.clamp(jitter, 0.0, 1.0 - 1e-6)
    u = (k + jitter) / n_out                                 # ascending per ray
    u = u * cdf[:, -1:]                                      # absorb cumsum rounding

    return _invert(pdf, cdf, u)


def _invert(pdf, cdf, u):
    """Stratum index j (B, K) int64 of each u (B, K) in its ray's CDF, the
    CDF below that stratum and its density (floored at 1e-12)."""
    s = cdf.shape[-1]
    j = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    j = torch.clamp(j, 0, s - 1)
    cdf_lo = torch.where(
        j > 0, torch.gather(cdf, 1, torch.clamp(j - 1, min=0)), torch.zeros_like(u))
    p = torch.clamp(torch.gather(pdf, 1, j), min=1e-12)
    return j, u, cdf_lo, p


def v3_strata(ts: torch.Tensor, plan: dict, near: float, far: float):
    """The placement plan of `RenderPipeline.redistribute_v3` on its lane
    grid (B, s_cap): lane k of ray i is placed iff k < S'_i (`valid`), at
    stratified u = (k + jitter) / S'_i, the jitter recycled from column
    k mod S of the candidates `ts`.  Returns (j stratum index int64, u,
    cdf_lo, p, valid) as `inverse_cdf_strata` does."""
    s = ts.shape[1]
    k = torch.arange(plan["s_cap"], device=ts.device)
    valid = k[None, :] < plan["s_ray"][:, None]
    jitter = (ts[:, k % s] - near) / (far - near) * s
    jitter = torch.clamp(jitter - torch.floor(jitter), 0.0, 1.0 - 1e-6)
    sr = plan["s_ray"].to(torch.float32)[:, None]
    u = torch.clamp((k[None, :] + jitter) / sr, 0.0, 1.0 - 1e-9)
    u = u * plan["cdf"][:, -1:]
    return (*_invert(plan["pdf"], plan["cdf"], u), valid)


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
    uniform candidates; off, the stage never runs.

    redistribute_v3: the density-weighted, workload-balanced stage 2b.  It
    takes the 2b slot over even when v2 is also set.  Live strata weigh
    the floor plus their cell's saturating EMA alpha (`v3_stratum_weights`),
    and the per-ray count S'_i comes from one global inverse CDF over the
    batch's live masses, sum(S'_i) <= budget by construction (`v3_plan`);
    the ragged rays sit in a (B, S_cap) lane grid whose valid lanes the
    compact stage packs into the budget with zero overflow.  `v3_oversub`
    bounds S_cap at that multiple of the even split."""

    # Weight floor of a live stratum: keeps every live cell sampleable when
    # its EMA alpha is ~0 and bounds the densest / thinnest live ratio to 21.
    V3_WEIGHT_FLOOR = 0.05

    def __init__(self, field, cfg: _r.RenderConfig, *, fused_path: bool = True,
                 fused_step: bool = True, redistribute: bool = False,
                 redistribute_v3: bool = False, v3_oversub: int = 4):
        self.field = field
        self.cfg = cfg
        self.fused_path = fused_path and hasattr(field, "query_fused")
        self.fused_step = self.fused_path and fused_step and hasattr(field, "query_step")
        self.redistribute_on = redistribute or redistribute_v3
        self.redistribute_v3_on = redistribute_v3
        self.v3_oversub = int(v3_oversub)

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

    def cull(self, flat_pts, unit, bitfield=None, mask_fn=None):
        """AABB test, the occupancy lookup when a bitfield (R^3,) is given,
        and `mask_fn(unit) -> bool` when given (`render_rays`' hook)."""
        live = _r.inside_aabb(flat_pts, self.cfg)
        if bitfield is not None:
            r = _cube_root(bitfield.shape[0])
            live = live & occ_lib.point_liveness(bitfield, unit, r)
        if mask_fn is not None:
            live = live & mask_fn(unit)
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
        deltas = _div(h, p * n_out)
        return ts_new, deltas

    # ---- stage 2b, v3: density-weighted, workload-balanced ----

    def v3_stratum_weights(self, live, ema_vals):
        """Sampling weight (B, S) f32 of each stratum: on live strata the
        floor plus the saturating alpha 1 - exp(-ema * h) of the cell's EMA
        (`occupancy.point_density`), 0 on dead ones.  With ema_vals None,
        floor * live: v2's uniform live-strata density."""
        b, s = live.shape
        h = (self.cfg.far - self.cfg.near) / s
        w = torch.full((b, s), self.V3_WEIGHT_FLOOR, dtype=torch.float32, device=live.device)
        if ema_vals is not None:
            w = w + 1.0 - ref_exp(-torch.clamp(ema_vals, min=0.0) * h)
        return live.to(torch.float32) * w

    def v3_plan(self, ts, live, ema_vals, budget: int) -> dict:
        """The global ragged allocation of v3, a dict:

        * ``pdf`` / ``cdf`` (B, S): each ray's weighted placement density
          (dead rays: uniform) and its CDF;
        * ``s_ray`` (B,) int64: per-ray counts S'_i, a floor of 1 each plus
          the E = budget - B extra samples split by stratifying the rays'
          normalised mass CDF at E points, diff(floor(ray_cdf * E + 0.5)),
          which telescopes to at most E; clamped to ``s_cap``;
        * ``s_cap`` int: the lane grid's width, min(oversub x even split,
          E + 1);
        * ``mass`` (B,) the rays' weighted live masses, ``dead`` (B,) bool
          where a ray's mass is 0."""
        b, s = ts.shape
        budget = int(budget)
        e = budget - b
        s_cap = max(1, min(max(1, budget // b) * self.v3_oversub, e + 1))

        w = self.v3_stratum_weights(live, ema_vals)
        mass = ref_sum(w)
        dead = mass <= 0.0
        w_ray = torch.where(dead[:, None], torch.ones_like(w), w)
        pdf = w_ray / ref_sum(w_ray, keepdim=True)
        cdf = ref_cumsum(pdf)

        # normalising by the last entry makes ray_cdf[-1] exactly 1, so the
        # last edge is E and the telescoped sum never exceeds the budget
        ray_mass = torch.where(dead, torch.zeros_like(mass), mass)
        total = ref_sum(ray_mass)
        ray_pdf = torch.where(total > 0.0, ray_mass / torch.clamp(total, min=1e-12),
                              torch.full_like(ray_mass, 1.0 / b))
        ray_cdf = ref_cumsum(ray_pdf)
        ray_cdf = ray_cdf / ray_cdf[-1]
        edges = torch.floor(ray_cdf * e + 0.5).to(torch.int64)
        extra = torch.diff(edges, prepend=torch.zeros_like(edges[:1]))
        s_ray = 1 + torch.clamp(extra, 0, s_cap - 1)
        return {"pdf": pdf, "cdf": cdf, "s_ray": s_ray, "s_cap": s_cap,
                "mass": mass, "dead": dead}

    def redistribute_v3(self, ts, live, ema_vals, budget: int):
        """Density-weighted inverse-CDF placement at ragged per-ray S'_i.

        Liveness and in-stratum jitter come from the uniform candidates
        `ts` (lane k recycles column k mod S), as in v2.  Returns fixed-shape
        lanes (B, s_cap): ts_new ascending per ray, invalid lanes parked at
        `far`; deltas h / (p_j * S'_i) on valid lanes, renormalised so each
        ray's sum is its live arc length (dead rays: far - near), 0 on
        invalid lanes; valid, lane k < S'_i."""
        b, s = ts.shape
        near, far = self.cfg.near, self.cfg.far
        h = (far - near) / s
        plan = self.v3_plan(ts, live, ema_vals, budget)
        j, u, cdf_lo, p, valid = v3_strata(ts, plan, near, far)
        sr = plan["s_ray"].to(torch.float32)[:, None]
        frac = torch.clamp((u - cdf_lo) / p, 0.0, 1.0 - 1e-6)
        ts_new = near + (j.to(torch.float32) + frac) * h
        ts_new = torch.where(valid, ts_new, torch.full_like(ts_new, far))

        dt_raw = torch.where(valid, _div(h, p * sr), torch.zeros_like(p))
        live_len = torch.sum(live.to(torch.float32), dim=-1) * h
        target = torch.where(plan["dead"], torch.full_like(live_len, far - near), live_len)
        scale = target / torch.clamp(ref_sum(dt_raw), min=1e-12)
        return ts_new, dt_raw * scale[:, None], valid

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

    def __call__(self, params, origins, dirs, ts, *, bitfield=None, mask_fn=None,
                 budget: int | None = None, occ_ema=None):
        """Render a ray batch: the dense path with budget=None, else the
        compacted path at that point budget (stage 2b first when on and a
        bitfield is given and budget >= B; below B the budget truncates).

        v3 weighs its strata by `occ_ema` (the (R^3,) f32 occupancy EMA)
        when given, and packs at most `budget` valid lanes, so its
        overflow is 0; no other path reads `occ_ema`."""
        b, s = ts.shape
        n = b * s
        with _trace.span("pipeline/sample", cat="pipeline"):
            flat_pts, flat_dirs, unit = self.generate_samples(origins, dirs, ts)
        with _trace.span("pipeline/cull", cat="pipeline"):
            live = self.cull(flat_pts, unit, bitfield=bitfield, mask_fn=mask_fn)

        deltas = probe_live_frac = None
        if (self.redistribute_on and bitfield is not None
                and budget is not None and int(budget) >= b):
            with _trace.span("pipeline/redistribute", cat="pipeline"):
                # the candidates' liveness is the probe; its mean is the
                # uniform sampler's live fraction
                probe_live_frac = torch.mean(live.to(torch.float32))
                if self.redistribute_v3_on:
                    ema_vals = None
                    if occ_ema is not None:
                        ema_vals = occ_lib.point_density(
                            occ_ema, unit, _cube_root(occ_ema.shape[0])).reshape(b, s)
                    ts, deltas, lane_valid = self.redistribute_v3(
                        ts, live.reshape(b, s), ema_vals, int(budget))
                    n = b * ts.shape[1]
                    flat_pts, flat_dirs, unit = self.generate_samples(origins, dirs, ts)
                    # invalid lanes are dead by decree, and sum(S') <= budget
                    # makes the packing overflow-free
                    live = lane_valid.reshape(-1) & self.cull(
                        flat_pts, unit, bitfield=bitfield, mask_fn=mask_fn)
                else:
                    s = min(s, min(int(budget), n) // b)
                    ts, deltas = self.redistribute(ts, live.reshape(b, -1), n_out=s)
                    budget = n = b * s
                    flat_pts, flat_dirs, unit = self.generate_samples(origins, dirs, ts)
                    live = self.cull(flat_pts, unit, bitfield=bitfield, mask_fn=mask_fn)

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
