"""Instant-3D training loop and the render functions shared with serving.

The port of `repro.core.trainer`.  The paper's two algorithm knobs are
first-class, as in the reference:

* different grid sizes: `FieldConfig.log2_table_density/color` (S_D : S_C);
* different update frequencies: `f_density`, `f_color` in [0, 1].  Step i
  updates branch b iff floor((i+1)*F_b) > floor(i*F_b).  A frozen branch's
  grid is detached, so its table-gradient commit never runs, and the
  optimizer's mask skips its params and moments.

`Instant3DTrainer.train` is the reference's `train_cohort` at one member:
the step-keyed freeze schedule, the occupancy cadence (a fold every
`update_interval` steps after `warmup_steps`), the overflow window that
widens the budget, the live fraction re-measured at each fold, and the
history.  PyTorch runs eagerly, so there is no step cache: each step builds
its autograd graph.  The reference draws with
``split(fold_in(PRNGKey(seed), i), 3)``, bits the port cannot reproduce, so
`train` takes a draw stream `draws(i) -> (ray_idx (B,), u_ts (B, S), u_occ
(R^3, 3))`; by default a `torch.Generator` seeded from (cfg.seed, i) per
step, so the stream is keyed by the absolute step as in the reference.
Cohorts, suspend/resume and checkpoints are not ported yet.

The chunk renderers (`make_render_chunk`, ...) serve `RenderService` and
`evaluate`.  A group of sessions renders as a loop over its members where
JAX used `vmap`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import field as field_lib
from . import losses, occupancy, rendering
from .pipeline import RenderPipeline, suggest_budget
from ..obs import trace as _trace
from ..optim import AdamW
from ..optim.adamw import tree_from_paths, tree_paths


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
    # the fused path stays off for renders, as in the reference: its point
    # is the backward
    pipeline = RenderPipeline(field_lib.Field(field_cfg), render_cfg,
                              fused_path=False, redistribute=True)

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


# ---- training ----------------------------------------------------------------

@dataclass(frozen=True)
class TrainerConfig:
    n_rays: int = 1024
    iters: int = 400
    lr: float = 1e-2
    eps: float = 1e-15              # Instant-NGP's Adam epsilon
    b2: float = 0.99
    mlp_weight_decay: float = 1e-6
    # update frequencies, F_D : F_C = 1 : 0.5 by default (paper section 5.1)
    f_density: float = 1.0
    f_color: float = 0.5
    use_occupancy: bool = True
    occ: occupancy.OccupancyConfig = dc_field(default_factory=occupancy.OccupancyConfig)
    render: rendering.RenderConfig = dc_field(default_factory=rendering.RenderConfig)
    seed: int = 0
    eval_chunk: int = 4096
    # occupancy-compacted field queries: the budget tracks the measured live
    # fraction in pow2 buckets with headroom against drift
    compact: bool = True
    budget_headroom: float = 1.3
    min_budget: int = 512
    # compacted shade through the fused encode (query_fused), and with
    # fused_step also on through the one-op fused step (query_step; the NGP
    # baseline answers it with query_fused)
    fused_path: bool = True
    fused_step: bool = True
    # stage 2b v2 (uniform S' per ray); v3 is not ported
    redistribute: bool = False
    redistribute_v3: bool = False
    # hard per-step point ceiling
    max_budget: int | None = None


def _branch_update(i: int, freq: float) -> bool:
    """Whether the branch with frequency `freq` updates at step i (0-based)."""
    if freq >= 1.0:
        return True
    return math.floor((i + 1) * freq) > math.floor(i * freq)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    occ_state: occupancy.OccupancyState
    step: int


def _make_opt(cfg: TrainerConfig) -> AdamW:
    def lr_scale(path):
        # grids at full lr, MLPs at 0.1x -- the NGP recipe
        return 1.0 if any("grid" in p for p in path) else 0.1

    return AdamW(lr=cfg.lr, b2=cfg.b2, eps=cfg.eps, lr_scale_fn=lr_scale)


def default_draws(cfg: TrainerConfig, n_pool: int) -> Callable:
    """The port's draw stream: step i's (ray indices (B,) into a pool of
    `n_pool` rays, stratified-sample fractions (B, S), occupancy jitter
    draws (R^3, 3)), all U(0, 1) / uniform ints from a CPU generator seeded
    from (cfg.seed, i) -- keyed by the absolute step, so a run cut into
    several `train` calls draws what one long run draws."""
    b, s, r3 = cfg.n_rays, cfg.render.n_samples, cfg.occ.resolution ** 3

    def draws(i: int):
        gen = torch.Generator().manual_seed((int(cfg.seed) << 32) + int(i))
        return (torch.randint(0, n_pool, (b,), generator=gen),
                torch.rand((b, s), generator=gen),
                torch.rand((r3, 3), generator=gen))

    return draws


class Instant3DTrainer:
    def __init__(self, field: field_lib.Field, cfg: TrainerConfig, device="cuda"):
        if cfg.redistribute_v3:
            raise NotImplementedError("redistribute_v3 (stage 2b v3) is not ported yet")
        self.field = field
        self.cfg = cfg
        self.device = torch.device(device)
        self.opt = _make_opt(cfg)
        self.pipeline = RenderPipeline(field, cfg.render, fused_path=cfg.fused_path,
                                       fused_step=cfg.fused_step,
                                       redistribute=cfg.redistribute)
        # host-side live-fraction estimate driving the compaction budget;
        # 1.0 (dense) until the first fold measures it
        self._live_frac = 1.0
        # the last update_interval steps' overflow counts, kept across
        # train() calls so time-sliced training widens as one long run
        self._overflow_window: list = []

    # ---- state ----

    def init(self, generator: torch.Generator | None = None) -> TrainState:
        """Fresh params (`Field.init` from `generator`, default seeded with
        cfg.seed), zero Adam moments, an unfolded occupancy grid, step 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        params = self.field.init(generator, self.device)
        return TrainState(params, self.opt.init(params),
                          occupancy.init_state(self.cfg.occ, self.device), 0)

    # ---- one step ----

    def loss_and_grads(self, params, batch: rendering.RayBatch, ts, occ_ema, *,
                       freeze_color: bool, freeze_density: bool, budget: int | None,
                       use_bits: bool):
        """The reference's `loss_fn` and its gradient: (loss, grads tree with
        None at each frozen grid, aux).  A frozen grid is detached, so no
        table gradient is committed for it."""
        frozen = set()
        if freeze_color and self.field.cfg.decomposed:
            frozen.add(("color_grid",))
        if freeze_density:
            frozen.add(("density_grid",))
        leaves = [(path, t.detach().requires_grad_(path not in frozen))
                  for path, t in tree_paths(params)]
        p_in = tree_from_paths(leaves)
        bits = None
        if use_bits:
            # all-occupied until the first fold: the zero-init EMA is exactly
            # zero until then (trunc_exp densities are positive afterwards)
            bits = (occ_ema > self.cfg.occ.density_threshold) | (torch.amax(occ_ema) <= 0.0)
        out = self.pipeline(p_in, batch.origins, batch.dirs, ts, bitfield=bits, budget=budget)
        loss = losses.mse(out["rgb"], batch.rgb_gt)
        wanted = [(path, t) for path, t in leaves if t.requires_grad]
        got = torch.autograd.grad(loss, [t for _, t in wanted], allow_unused=True)
        grads = tree_from_paths(
            [(path, torch.zeros_like(t) if g is None else g)
             for (path, t), g in zip(wanted, got)]
            + [(path, None) for path, t in leaves if not t.requires_grad])
        aux = {"live_fraction": out["live_fraction"], "overflow": out["overflow"],
               "points_queried": out["points_queried"]}
        return loss.detach(), grads, aux

    def step(self, params, opt_state, batch, ts, occ_ema, *, freeze_color: bool,
             freeze_density: bool = False, budget: int | None = None,
             use_bits: bool = False):
        """One training step: loss, backward, masked AdamW ->
        (params, opt_state, loss, aux)."""
        loss, grads, aux = self.loss_and_grads(
            params, batch, ts, occ_ema, freeze_color=freeze_color,
            freeze_density=freeze_density, budget=budget, use_bits=use_bits)
        mask = tree_from_paths([(path, True) for path, _ in tree_paths(params)])
        if freeze_color and self.field.cfg.decomposed:
            mask["color_grid"] = False
        if freeze_density:
            mask["density_grid"] = False
        with torch.no_grad():
            params, opt_state = self.opt.apply(params, grads, opt_state, mask=mask)
        return params, opt_state, loss, aux

    def _current_budget(self, use_bits: bool) -> int | None:
        """Point budget for the next step, or None for the dense path; dense
        until the bitfield is live (use_bits), since before the first fold
        nearly every in-box sample is live."""
        cfg = self.cfg
        if not (cfg.compact and cfg.use_occupancy and use_bits):
            return None
        n_total = cfg.n_rays * cfg.render.n_samples
        budget = suggest_budget(self._live_frac, n_total, headroom=cfg.budget_headroom,
                                min_budget=cfg.min_budget, max_budget=cfg.max_budget)
        return None if budget >= n_total else budget

    # ---- training loop ----

    def train(self, state: TrainState, sampler, iters: int | None = None,
              log_every: int = 50, callback=None, draws: Callable | None = None):
        """Advance training by `iters` steps -> (new state, history).

        history holds, per logged step (every `log_every` steps and the
        last): step, loss, live_fraction, points_queried, overflow, budget
        (None on a dense step) and wall_s (seconds since the call started,
        read after the step's loss reached the host); plus occ_folds (the
        steps that folded the occupancy grid), overflow_total and
        overflow_steps."""
        cfg, field_cfg = self.cfg, self.field.cfg
        iters = iters if iters is not None else cfg.iters
        draws = draws if draws is not None else default_draws(cfg, sampler.n)
        interval = cfg.occ.update_interval
        step0 = state.step
        params, opt_state, occ_state = state.params, state.opt_state, state.occ_state
        occ_updates = int(occ_state.step) if cfg.use_occupancy else 0
        if occ_updates == 0:
            self._live_frac = 1.0       # fresh state: forget any previous run
            self._overflow_window = []
        hist = {"step": [], "loss": [], "live_fraction": [], "points_queried": [],
                "overflow": [], "budget": [], "wall_s": [], "occ_folds": []}
        overflow_all = []
        t0 = _trace.clock()
        for local_i in range(iters):
            i = step0 + local_i
            ray_idx, u_ts, u_occ = draws(i)
            ts = rendering.sample_ts(None, cfg.n_rays, cfg.render, self.device, u=u_ts)
            freeze_color = (not _branch_update(i, cfg.f_color)) and field_cfg.decomposed
            freeze_density = not _branch_update(i, cfg.f_density)
            use_bits = cfg.use_occupancy and occ_updates > 0
            budget = self._current_budget(use_bits)
            batch = sampler.gather(ray_idx)
            with _trace.span("trainer/step", cat="trainer",
                             args={"step": int(i), "budget": budget, "use_bits": use_bits}):
                params, opt_state, loss, aux = self.step(
                    params, opt_state, batch, ts, occ_state.density_ema,
                    freeze_color=freeze_color, freeze_density=freeze_density,
                    budget=budget, use_bits=use_bits)
            overflow_all.append(aux["overflow"])
            self._overflow_window.append(aux["overflow"])
            del self._overflow_window[:-interval]

            if cfg.use_occupancy and i >= cfg.occ.warmup_steps and (i + 1) % interval == 0:
                jitter = (u_occ.to(self.device) - 0.5) / cfg.occ.resolution
                with _trace.span("trainer/occ_update", cat="trainer", args={"step": int(i)}), \
                        torch.no_grad():
                    occ_state = occupancy.update(self.field, params, occ_state, cfg.occ,
                                                 jitter=jitter)
                hist["occ_folds"].append(i)
                if use_bits:
                    # re-measure the live fraction at the fold (one host sync);
                    # overflow since the last fold means the live set outgrew
                    # the bucket: widen beyond the measurement
                    measured = float(aux["live_fraction"])
                    recent = self._overflow_window[-interval:]
                    if int(sum(int(v) for v in recent)) > 0:
                        measured = min(1.0, measured * 2.0)
                    self._live_frac = measured
                occ_updates += 1

            if (local_i + 1) % log_every == 0 or local_i == iters - 1:
                hist["step"].append(i + 1)
                hist["loss"].append(float(loss))
                hist["wall_s"].append(_trace.clock() - t0)
                hist["live_fraction"].append(float(aux["live_fraction"]))
                hist["points_queried"].append(int(aux["points_queried"]))
                hist["overflow"].append(int(aux["overflow"]))
                hist["budget"].append(budget)
                if callback is not None:
                    callback(i + 1, params, hist)

        ov = torch.stack([torch.as_tensor(v, device=self.device) for v in overflow_all]) \
            if overflow_all else torch.zeros((0,), dtype=torch.int64)
        hist["overflow_total"] = int(ov.sum())
        hist["overflow_steps"] = int((ov > 0).sum())
        self._overflow_window = [int(v) for v in self._overflow_window]
        return TrainState(params, opt_state, occ_state, step0 + iters), hist

    # ---- evaluation ----

    @torch.no_grad()
    def render_image(self, params, pose: np.ndarray, ds, occ=None,
                     samples_per_ray: int | None = None):
        """Render one full view -> (rgb (H, W, 3), depth (H, W)) numpy.  Dense
        by default; with `occ` (the (density EMA, fold count) pair a snapshot
        carries) through the redistributed renderer, as served."""
        cfg = self.cfg
        h, w = ds.h, ds.w
        o, d, n, chunk = image_rays(pose, h, w, ds.focal, cfg.eval_chunk, self.device)
        ts = rendering.sample_ts(None, chunk, cfg.render, self.device)
        if occ is not None and cfg.use_occupancy:
            spr = (int(samples_per_ray) if samples_per_ray is not None
                   else default_samples_per_ray(cfg.render.n_samples))
            render = make_redistributed_render_chunk(self.field.cfg, cfg.render, cfg.occ,
                                                     chunk * spr)
            fn = lambda oo, dd: render(params, oo, dd, ts, occ[0], occ[1])  # noqa: E731
        else:
            render = make_render_chunk(self.field.cfg, cfg.render)
            fn = lambda oo, dd: render(params, oo, dd, ts)  # noqa: E731
        rgb_out, dep_out = [], []
        for i in range(0, o.shape[0], chunk):
            rgb_c, dep_c = fn(o[i:i + chunk], d[i:i + chunk])
            rgb_out.append(rgb_c)
            dep_out.append(dep_c)
        rgb = torch.cat(rgb_out)[:n].reshape(h, w, 3)
        dep = torch.cat(dep_out)[:n].reshape(h, w)
        return rgb.cpu().numpy(), dep.cpu().numpy()

    def evaluate(self, params, ds, views=None, occ=None,
                 samples_per_ray: int | None = None) -> dict:
        """Mean PSNR of rendered RGB and of depth / far against the ground
        truth over `views` (default the first four)."""
        views = views if views is not None else range(min(4, ds.images.shape[0]))
        far = self.cfg.render.far
        rgb_ps, dep_ps = [], []
        for v in views:
            rgb, dep = self.render_image(params, ds.poses[v], ds, occ=occ,
                                         samples_per_ray=samples_per_ray)
            rgb_ps.append(float(losses.psnr(torch.from_numpy(rgb),
                                            torch.from_numpy(ds.images[v]))))
            dep_ps.append(float(losses.psnr(torch.from_numpy(dep / far),
                                            torch.from_numpy(ds.depths[v] / far))))
        return {"psnr_rgb": float(np.mean(rgb_ps)), "psnr_depth": float(np.mean(dep_ps))}
