"""Instant-3D training loop and the render functions shared with serving.

The port of `repro.core.trainer`.  The paper's two algorithm knobs are
first-class, as in the reference:

* different grid sizes: `FieldConfig.log2_table_density/color` (S_D : S_C);
* different update frequencies: `f_density`, `f_color` in [0, 1].  Step i
  updates branch b iff floor((i+1)*F_b) > floor(i*F_b).  A frozen branch's
  grid is detached, so its table-gradient commit never runs, and the
  optimizer's mask skips its params and moments.

`train_cohort` advances M sessions of one (field config, trainer config)
in lockstep, and `Instant3DTrainer.train` is its call at M = 1, as in the
reference, so a session trained in a cohort and one trained alone run the
same code: the step-keyed freeze schedule, the occupancy cadence (a fold
every `update_interval` steps after `warmup_steps`), the overflow window
that widens the budget, the live fraction re-measured at each fold, and the
history.  Where the reference stacks the members and runs one compiled
step over them (`jax.lax.map`), the port's compiled step loops over the
members; each keeps its own bookkeeping in its trainer (live fraction,
overflow window, so its own budget).

The compiled-step cache is the reference's: `cohort_step_fn` builds (or
returns) the step of one variant, keyed by `_cohort_step_key` (field
config, trainer config, freeze flags, budget, bitfield use, cohort size),
process-wide, counting ``trainer.step_cache.hit`` / ``.miss`` while tracing;
`step_variant_cached` says whether a variant is built, and `train_cohort`
names a variant's first call's span ``trainer/step_compile`` and later
ones ``trainer/step``; `occ_update_fn` is the occupancy fold per (field
config, occupancy config, cohort size); `Instant3DTrainer.step_fn` is the
per-instance step and `step_cache_keys` the built keys of a trainer's
configs.  A cache entry is a `step_graph.CompiledStep` over the eager
`Instant3DTrainer.step` (the fold over `occupancy.update`): on a CUDA card
every step is a replay of a CUDA graph captured once per variant and
device, on the CPU the eager body runs.  `eager_steps()` runs the card's
steps eagerly (the counterpart of `jax.disable_jit()`), and
`clear_step_cache()` drops every entry and its graphs' memory, so tests
depend on no earlier test's cache.  The reference draws with
``split(fold_in(PRNGKey(seed), i), 3)``, bits the port cannot reproduce, so
training takes a draw stream per member, `draws(i) -> (ray_idx (B,), u_ts
(B, S), u_occ (R^3, 3))`; by default `default_draws(cfg, sampler.n)`, a
`torch.Generator` seeded from (cfg.seed, i) per step, so the stream is
keyed by the absolute step, and members with equal ray pools draw alike,
as the reference's members share one key.

`suspend` / `resume` move a session's whole state to host numpy and back,
with the reference's tree keys, so `repro_torch.checkpoint` writes it in
the reference's layout.  `tree_all_finite` is the serve3d guard's deep
check.

The render caches are the reference's too: `eval_render_fn` (per field
config, render config and chunk), `redistributed_render_fn`, and the
batched entries `batched_render_fn` / `batched_redistributed_render_fn`
keyed by the padded group size as well, all built on `make_render_chunk` /
`make_redistributed_render_chunk` and shared, under a lock, by
`RenderService` and `evaluate`, so an eval render and a served render run
the same entry.  An entry renders every chunk it is given (the
reference's entries take one chunk a call), on a card each chunk a replay
of a CUDA graph captured once per device for each eval key and each
member key (below), on the CPU or inside
`eager_steps()` the eager chunk renderer.  A group renders as a loop over
its real members where JAX used `vmap` over the padded group: a batched
entry (`step_graph.BatchedRender`) renders each member through the
one-member `step_graph.CompiledRender` of its key less the group
(`_MEMBER_RENDERS`), shared by every group size.
`clear_render_cache()` drops every entry and its graphs' memory.
"""
from __future__ import annotations

import functools
import math
import threading
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import field as field_lib
from . import losses, occupancy, rendering, step_graph
from .pipeline import RenderPipeline, suggest_budget
from .step_graph import eager_steps  # noqa: F401  (the cache's public surface)
from .. import bridge
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..optim import AdamW, AdamWState
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
                                    occ_cfg: occupancy.OccupancyConfig, budget: int,
                                    redistribute_v3: bool = False):
    """Occupancy-redistributed chunk renderer (pipeline stage 2b) built from
    configs: (params, origins (N, 3), dirs (N, 3), ts (N, S), occ_ema (R^3,),
    occ_step, an int or a 0-d tensor) -> (rgb, depth).  The snapshot's EMA
    rebuilds the bitfield; the dense candidates' liveness is each ray's
    probe, and S' = budget // N samples per ray are shaded.  While occ_step == 0 the bitfield reads
    all-occupied and this is a uniform S'-sample render.  With
    redistribute_v3 the budget is spent unevenly across the chunk's rays
    (stage 2b v3), the EMA weighting each ray's placement, as a v3 trainer
    trains."""
    # the fused path stays off for renders, as in the reference: its point
    # is the backward
    pipeline = RenderPipeline(field_lib.Field(field_cfg), render_cfg,
                              fused_path=False, redistribute=True,
                              redistribute_v3=bool(redistribute_v3))

    def render_chunk(params, origins, dirs, ts, occ_ema, occ_step):
        bits = occupancy.bitfield(occupancy.OccupancyState(occ_ema, occ_step), occ_cfg)
        out = pipeline(params, origins, dirs, ts, bitfield=bits, budget=int(budget),
                       occ_ema=occ_ema)
        return out["rgb"], out["depth"]

    return render_chunk


def default_samples_per_ray(n_samples: int) -> int:
    """The serving default for the redistributed per-ray budget: S/4,
    floored at 4 and capped at S."""
    s = int(n_samples)
    return min(s, max(4, s // 4))


# ---- the render caches (process-wide), keyed as the reference's ----

_EVAL_RENDER_CACHE: dict[tuple, step_graph.CompiledRender] = {}
_REDIST_RENDER_CACHE: dict[tuple, step_graph.CompiledRender] = {}
_BATCH_RENDER_CACHE: dict[tuple, step_graph.BatchedRender] = {}
# the batched entries' one-member renders, keyed as them less the group:
# every group size of a chunk, budget and path shares one graph a device
_MEMBER_RENDERS: dict[tuple, step_graph.CompiledRender] = {}
_render_cache_lock = threading.Lock()


def _render_entry(cache: dict, key: tuple, make: Callable) -> step_graph.CompiledRender:
    with _render_cache_lock:
        fn = cache.get(key)
        if fn is None:
            fn = cache[key] = step_graph.CompiledRender(make())
        return fn


def _batched_entry(key: tuple, member_key: tuple, group: int,
                   make: Callable) -> step_graph.BatchedRender:
    """The `_BATCH_RENDER_CACHE` entry of `key`: a group of up to `group`
    members through the member render of `member_key` (`key` less the
    group)."""
    member = _render_entry(_MEMBER_RENDERS, member_key, make)
    with _render_cache_lock:
        fn = _BATCH_RENDER_CACHE.get(key)
        if fn is None:
            fn = _BATCH_RENDER_CACHE[key] = step_graph.BatchedRender(member, group)
        return fn


def eval_render_fn(field_cfg, render_cfg: rendering.RenderConfig,
                   chunk: int) -> step_graph.CompiledRender:
    """The compiled `make_render_chunk` of (field_cfg, render_cfg, chunk):
    (params, origins (k * chunk, 3), dirs, ts (chunk, S)) -> (rgb, depth)."""
    return _render_entry(_EVAL_RENDER_CACHE, (field_cfg, render_cfg, int(chunk)),
                         lambda: make_render_chunk(field_cfg, render_cfg))


def redistributed_render_fn(field_cfg, render_cfg: rendering.RenderConfig,
                            occ_cfg: occupancy.OccupancyConfig, chunk: int,
                            samples_per_ray: int, redistribute_v3: bool = False
                            ) -> step_graph.CompiledRender:
    """The compiled `make_redistributed_render_chunk`, budget = chunk *
    samples_per_ray: (params, origins, dirs, ts, occ_ema, occ_step) ->
    (rgb, depth).  Neither package calls it (serving and `render_image` go
    through the batched entry); it is kept for the reference's API."""
    key = (field_cfg, render_cfg, occ_cfg, int(chunk), int(samples_per_ray),
           bool(redistribute_v3))
    return _render_entry(_REDIST_RENDER_CACHE, key, lambda: make_redistributed_render_chunk(
        field_cfg, render_cfg, occ_cfg, int(chunk) * int(samples_per_ray),
        redistribute_v3=bool(redistribute_v3)))


def batched_render_fn(field_cfg, render_cfg: rendering.RenderConfig, chunk: int,
                      group: int) -> step_graph.BatchedRender:
    """(params list of g <= group dicts, origins (g, k * chunk, 3), dirs
    (g, k * chunk, 3), ts (chunk, S)) -> (rgb (g, k * chunk, 3), depth (g,
    k * chunk)), keyed by the padded group size as the reference."""
    member_key = (field_cfg, render_cfg, int(chunk))
    return _batched_entry(member_key + (int(group),), member_key, group,
                          lambda: make_render_chunk(field_cfg, render_cfg))


def batched_redistributed_render_fn(field_cfg, render_cfg: rendering.RenderConfig,
                                    occ_cfg, chunk: int, group: int, samples_per_ray: int,
                                    redistribute_v3: bool = False
                                    ) -> step_graph.BatchedRender:
    """Redistributed flavor of `batched_render_fn`, shading chunk *
    samples_per_ray points per member: adds per-member occupancy inputs
    (occ_ema list of g (R^3,) tensors, occ_step (g,) int32 fold counts on
    the device).  redistribute_v3: stage 2b v3
    (`make_redistributed_render_chunk`)."""
    key = (field_cfg, render_cfg, occ_cfg, int(chunk), int(group), int(samples_per_ray),
           bool(redistribute_v3))
    return _batched_entry(key, key[:4] + key[5:], group, lambda: make_redistributed_render_chunk(
        field_cfg, render_cfg, occ_cfg, int(chunk) * int(samples_per_ray),
        redistribute_v3=bool(redistribute_v3)))


def clear_render_cache() -> None:
    """Drop every render entry, with its graphs."""
    with _render_cache_lock:
        _EVAL_RENDER_CACHE.clear()
        _REDIST_RENDER_CACHE.clear()
        _BATCH_RENDER_CACHE.clear()
        _MEMBER_RENDERS.clear()
    step_graph.release_devices("render")


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
    # stage 2b: v2 (uniform S' = budget // B per ray) or v3 (per-ray S'_i
    # from the batch's EMA-weighted live masses, sum(S'_i) <= budget, zero
    # overflow); v3 takes over when both are set
    redistribute: bool = False
    redistribute_v3: bool = False
    # hard per-step point ceiling
    max_budget: int | None = None


def autotune_max_budget(field_cfg, render_cfg: rendering.RenderConfig, *,
                        memory_bytes: int | None = None, latency_ms: float | None = None,
                        us_per_point: float | None = None, mlp_width: int = 64,
                        min_budget: int = 512) -> int | None:
    """A `TrainerConfig.max_budget` ceiling from device constraints: the
    smaller of `memory_bytes` over a modelled per-point footprint (per grid
    L*F*4 B of features and L*8*4 B of corner indices, point / dir / sigma /
    rgb lanes, two MLP activation slabs) and `latency_ms` over a measured
    `us_per_point`, floored at `min_budget` and rounded down to a power of
    two; None when neither constraint is given."""
    caps = []
    if memory_bytes is not None:
        n_grids = 2 if getattr(field_cfg, "decomposed", True) else 1
        feat = field_cfg.n_levels * field_cfg.n_features * 4 * n_grids
        corners = field_cfg.n_levels * 8 * 4 * n_grids
        lanes = (3 + 3 + 1 + 3) * 4
        acts = 2 * mlp_width * 4
        caps.append(int(memory_bytes) // (feat + corners + lanes + acts))
    if latency_ms is not None and us_per_point:
        caps.append(int(float(latency_ms) * 1e3 / float(us_per_point)))
    if not caps:
        return None
    cap = max(min(caps), int(min_budget))
    b = 1
    while b * 2 <= cap:
        b *= 2
    return b


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _on_device(tree, device):
    """A nested dict of tensors or numpy arrays -> the same dict of tensors
    on `device` (a tensor already there is returned as it is)."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def tree_all_finite(*trees) -> bool:
    """True iff every floating leaf of every tree (dicts, tuples, tensors or
    numpy arrays) is finite.  Integer leaves (the optimizer's step, fold
    counts) are skipped.  One host sync per device the leaves live on; it
    runs outside the training step, so the guard never changes a step."""
    acc: dict = {}
    for leaf in _leaves(trees):
        x = torch.as_tensor(leaf)
        if x.is_floating_point():
            ok = torch.isfinite(x).all()
            acc[x.device] = ok if x.device not in acc else acc[x.device] & ok
    return all(bool(v) for v in acc.values())


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


# ---- the compiled-step and occupancy-fold caches (process-wide) ----
#
# Keyed as the reference's: every trainer and every cohort with the same
# configs shares one compiled step per variant, so sequential baselines and
# a cohort re-formed under another lead session build nothing new.

_COHORT_STEP_CACHE: dict[tuple, step_graph.CompiledStep] = {}
_OCC_UPDATE_CACHE: dict[tuple, step_graph.CompiledStep] = {}
_cache_lock = threading.Lock()


def _cohort_step_key(field_cfg, cfg: TrainerConfig, freeze_color: bool,
                     freeze_density: bool, budget: int | None, use_bits: bool,
                     m: int) -> tuple:
    """Cache key of one compiled step variant, the reference's tuple."""
    return (field_cfg, cfg, bool(freeze_color), bool(freeze_density),
            budget, bool(use_bits), int(m))


def step_variant_cached(field_cfg, cfg: TrainerConfig, freeze_color: bool,
                        freeze_density: bool, budget: int | None,
                        use_bits: bool, m: int) -> bool:
    """Whether this step variant has been built (so a call of it on a card
    that has run it replays and captures nothing)."""
    return _cohort_step_key(field_cfg, cfg, freeze_color, freeze_density,
                            budget, use_bits, m) in _COHORT_STEP_CACHE


def cohort_step_fn(field_cfg, cfg: TrainerConfig, freeze_color: bool,
                   freeze_density: bool, budget: int | None, use_bits: bool,
                   m: int) -> step_graph.CompiledStep:
    """The compiled step of an M-member cohort's variant:
    (params, opt_states, batches, ts, occ_emas), each a list of M, ->
    (params, opt_states, losses, auxes), lists of M, member r's entries
    `Instant3DTrainer.step` on its own inputs, the members one after
    another (one CUDA graph for the M steps on a card)."""
    key = _cohort_step_key(field_cfg, cfg, freeze_color, freeze_density, budget, use_bits, m)
    with _cache_lock:
        fn = _COHORT_STEP_CACHE.get(key)
        if _trace.enabled():
            _metrics.counter(f"trainer.step_cache.{'miss' if fn is None else 'hit'}").inc()
        if fn is None:
            step = functools.partial(
                Instant3DTrainer(field_lib.Field(field_cfg), cfg).step,
                freeze_color=bool(freeze_color), freeze_density=bool(freeze_density),
                budget=budget, use_bits=bool(use_bits))

            def member_steps(params, opt_states, batches, ts, occ_emas):
                if not len(params) == len(opt_states) == len(batches) == len(ts) \
                        == len(occ_emas) == m:
                    raise ValueError(f"cohort step of {m} members called on "
                                     f"{len(params)}")
                outs = [step(*member) for member in zip(params, opt_states, batches, ts,
                                                        occ_emas)]
                return tuple(list(column) for column in zip(*outs))

            fn = _COHORT_STEP_CACHE[key] = step_graph.CompiledStep(member_steps)
    return fn


def occ_update_fn(field_cfg, occ_cfg: occupancy.OccupancyConfig,
                  m: int) -> step_graph.CompiledStep:
    """The compiled occupancy fold of an M-member cohort: (params, EMAs,
    jitters), each a list of M, -> the new EMAs, member r's
    `occupancy.update` at its jitter (R^3, 3); the fold count stays on the
    host."""
    key = (field_cfg, occ_cfg, int(m))
    with _cache_lock:
        fn = _OCC_UPDATE_CACHE.get(key)
        if fn is None:
            field = field_lib.Field(field_cfg)

            def fold_members(params, emas, jitters):
                with torch.no_grad():
                    return [occupancy.update(field, p, occupancy.OccupancyState(e, 0), occ_cfg,
                                             jitter=j).density_ema
                            for p, e, j in zip(params, emas, jitters)]

            fn = _OCC_UPDATE_CACHE[key] = step_graph.CompiledStep(fold_members)
    return fn


def clear_step_cache() -> None:
    """Drop every compiled step and occupancy fold, with their graphs (a
    trainer's own `step_fn` entries stay with the trainer)."""
    with _cache_lock:
        _COHORT_STEP_CACHE.clear()
        _OCC_UPDATE_CACHE.clear()
    step_graph.release_devices()


class Instant3DTrainer:
    def __init__(self, field: field_lib.Field, cfg: TrainerConfig, device="cuda"):
        self.field = field
        self.cfg = cfg
        self.device = torch.device(device)
        self.opt = _make_opt(cfg)
        self.pipeline = RenderPipeline(field, cfg.render, fused_path=cfg.fused_path,
                                       fused_step=cfg.fused_step,
                                       redistribute=cfg.redistribute,
                                       redistribute_v3=cfg.redistribute_v3)
        # host-side live-fraction estimate driving the compaction budget;
        # 1.0 (dense) until the first fold measures it
        self._live_frac = 1.0
        # the last update_interval steps' overflow counts, kept across
        # train() calls so time-sliced training widens as one long run
        self._overflow_window: list = []
        self._step_fns: dict = {}

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
        # the EMA only weighs stage 2b v3's strata
        out = self.pipeline(p_in, batch.origins, batch.dirs, ts, bitfield=bits, budget=budget,
                            occ_ema=occ_ema if use_bits else None)
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

    def step_fn(self, freeze_color: bool, freeze_density: bool = False,
                budget: int | None = None, use_bits: bool | None = None):
        """This trainer's compiled step of one variant: (params, opt_state,
        batch, ts, occ_ema) -> (params, opt_state, loss, aux), `step` at
        these flags (use_bits defaults to cfg.use_occupancy)."""
        if use_bits is None:
            use_bits = self.cfg.use_occupancy
        key = (freeze_color, freeze_density, budget, use_bits)
        if key not in self._step_fns:
            self._step_fns[key] = step_graph.CompiledStep(functools.partial(
                self.step, freeze_color=bool(freeze_color),
                freeze_density=bool(freeze_density), budget=budget, use_bits=bool(use_bits)))
        return self._step_fns[key]

    def step_cache_keys(self) -> set:
        """The built cohort-step keys of this trainer's configs, without the
        configs: {(freeze_color, freeze_density, budget, use_bits, m)}."""
        return {k[2:] for k in _COHORT_STEP_CACHE
                if k[0] == self.field.cfg and k[1] == self.cfg}

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
        """Advance training by `iters` steps -> (new state, history): the
        cohort of one (`train_cohort`).

        history holds, per logged step (every `log_every` steps and the
        last): step, loss, live_fraction, points_queried, overflow, budget
        (None on a dense step) and wall_s (seconds since the call started,
        read after the step's loss reached the host); plus occ_folds (the
        steps that folded the occupancy grid), overflow_total and
        overflow_steps."""
        states, hists = train_cohort([self], [state], [sampler], iters=iters,
                                     log_every=log_every, callback=callback,
                                     draws=None if draws is None else [draws])
        return states[0], hists[0]

    # ---- suspend / resume ----

    def suspend(self, state: TrainState) -> dict:
        """Device -> host copy of everything needed to go on bit for bit:
        params, Adam state, occupancy EMA and fold count, the step, and the
        trainer's own bookkeeping (live fraction, overflow window padded to
        `update_interval` as int32).  numpy leaves that share no storage
        with the state, under the reference's keys, so the flat keys of a
        checkpoint are the reference's."""
        win = np.zeros((self.cfg.occ.update_interval,), np.int32)
        recent = [int(x) for x in self._overflow_window[-len(win):]]
        if recent:
            win[-len(recent):] = recent
        occ = state.occ_state
        return {
            "params": bridge.params_to_numpy(state.params),
            "opt": AdamWState(*bridge.opt_to_numpy(state.opt_state)),
            "occ_ema": occ.density_ema.detach().cpu().numpy().copy(),
            "occ_step": np.asarray(int(occ.step), np.int32),
            "step": np.asarray(int(state.step), np.int32),
            "live_frac": np.asarray(self._live_frac, np.float32),
            "overflow_window": win,
        }

    def resume(self, tree: dict) -> TrainState:
        """Inverse of `suspend`: the host tree onto this trainer's device,
        and the trainer's bookkeeping re-seeded from it."""
        self._live_frac = float(tree["live_frac"])
        self._overflow_window = [int(v) for v in np.asarray(tree["overflow_window"])]
        dev = self.device
        return TrainState(
            bridge.params_to_torch(tree["params"], dev),
            bridge.opt_to_torch(tree["opt"], dev),
            occupancy.OccupancyState(
                torch.from_numpy(np.array(tree["occ_ema"], dtype=np.float32)).to(dev),
                int(tree["occ_step"])),
            int(tree["step"]))

    # ---- evaluation ----

    @torch.no_grad()
    def render_image(self, params, pose: np.ndarray, ds, occ=None,
                     samples_per_ray: int | None = None):
        """Render one full view -> (rgb (H, W, 3), depth (H, W)) numpy.  Dense
        by default (`eval_render_fn`); with `occ` (the (density EMA, fold
        count) pair a snapshot carries) through the redistributed renderer
        (stage 2b v3 when `cfg.redistribute_v3`), as the group-of-1 entry
        `RenderService` serves a lone request through, so an eval render is
        the served bytes.  `params` and the EMA may be host copies (a
        snapshot's, a suspended tree's): they are moved to the trainer's
        device."""
        cfg = self.cfg
        h, w = ds.h, ds.w
        params = _on_device(params, self.device)
        o, d, n, chunk = image_rays(pose, h, w, ds.focal, cfg.eval_chunk, self.device)
        ts = rendering.sample_ts(None, chunk, cfg.render, self.device)
        if occ is not None and cfg.use_occupancy:
            spr = (int(samples_per_ray) if samples_per_ray is not None
                   else default_samples_per_ray(cfg.render.n_samples))
            fn = batched_redistributed_render_fn(self.field.cfg, cfg.render, cfg.occ, chunk, 1,
                                                 spr, redistribute_v3=cfg.redistribute_v3)
            occ_step = torch.tensor([int(occ[1])], dtype=torch.int32, device=self.device)
            rgb, dep = fn([params], o[None], d[None], ts, [_on_device(occ[0], self.device)],
                          occ_step)
            rgb, dep = rgb[0], dep[0]
        else:
            rgb, dep = eval_render_fn(self.field.cfg, cfg.render, chunk)(params, o, d, ts)
        return (rgb[:n].reshape(h, w, 3).cpu().numpy(),
                dep[:n].reshape(h, w).cpu().numpy())

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


# ---- cohorts: lockstep training of M same-config sessions ----

def _partition_members(trainers, use_occupancy, occ_updates):
    """Each member's (use_bits, budget) step variant -> the ordered
    partition [((use_bits, budget), [member indices])]."""
    part: list[tuple[tuple, list[int]]] = []
    for k, tr in enumerate(trainers):
        use_bits = use_occupancy and occ_updates[k] > 0
        key = (use_bits, tr._current_budget(use_bits))
        grouped = next((g for g in part if g[0] == key), None)
        if grouped is None:
            part.append((key, [k]))
        else:
            grouped[1].append(k)
    return part


def train_cohort(trainers: list, states: list, samplers: list, iters: int | None = None,
                 log_every: int = 50, callback=None, draws: list | None = None):
    """Advance M same-config training sessions in lockstep -> (new states,
    histories), parallel to the inputs.

    All members share (field config, trainer config) and sit at the same
    absolute step.  Each step, the members are partitioned by their step
    variant (use_bits, budget) and every group runs its members through
    the variant's compiled step (`cohort_step_fn`, one after another), and
    a fold through `occ_update_fn`; the partition shifts only at a fold,
    when members' measured
    budgets drift apart, and it changes where the work happens, never the
    numbers.  Each member keeps its own bookkeeping in its trainer (live
    fraction, overflow window), exactly as M sequential `train` calls, and
    `train` is this function at M = 1, so a cohort equals sequential
    training bit for bit.  `draws` is one stream per member (default each
    member's `default_draws(cfg, sampler.n)`); a member of a fold draws its
    occupancy jitter from its own stream."""
    m = len(trainers)
    if not m == len(states) == len(samplers):
        raise ValueError("trainers, states and samplers must align")
    lead = trainers[0]
    cfg, field_cfg = lead.cfg, lead.field.cfg
    for t in trainers[1:]:
        if t.cfg != cfg or t.field.cfg != field_cfg:
            raise ValueError("cohort members must share field and trainer configs")
    step0 = states[0].step
    if any(s.step != step0 for s in states):
        raise ValueError("cohort members must be at the same training step")
    iters = iters if iters is not None else cfg.iters
    draws = list(draws) if draws is not None else [default_draws(cfg, s.n) for s in samplers]
    if len(draws) != m:
        raise ValueError("one draw stream per member")
    interval = cfg.occ.update_interval
    params = [s.params for s in states]
    opts = [s.opt_state for s in states]
    occs = [s.occ_state for s in states]
    occ_updates = [int(s.occ_state.step) if cfg.use_occupancy else 0 for s in states]
    for k, tr in enumerate(trainers):
        if occ_updates[k] == 0:
            tr._live_frac = 1.0         # fresh state: forget any previous run
            tr._overflow_window = []
    hists = [{"step": [], "loss": [], "live_fraction": [], "points_queried": [],
              "overflow": [], "budget": [], "wall_s": [], "occ_folds": []}
             for _ in range(m)]
    overflow_all: list[list] = [[] for _ in range(m)]
    last: list = [None] * m             # member -> (loss, aux, budget) of the step
    t0 = _trace.clock()
    for local_i in range(iters):
        i = step0 + local_i
        freeze_color = (not _branch_update(i, cfg.f_color)) and field_cfg.decomposed
        freeze_density = not _branch_update(i, cfg.f_density)
        groups = _partition_members(trainers, cfg.use_occupancy, occ_updates)
        u_occ: list = [None] * m
        obs_on = _trace.enabled()
        for (use_bits, budget), members in groups:
            batches, ts = [], []
            for k in members:
                ray_idx, u_ts, u_occ[k] = draws[k](i)
                ts.append(rendering.sample_ts(None, cfg.n_rays, cfg.render, trainers[k].device,
                                              u=u_ts))
                batches.append(samplers[k].gather(ray_idx))
            # a variant's first call builds it (captures it on a card): the
            # reference's compile / execute split, probed only while tracing
            fresh = obs_on and not step_variant_cached(
                field_cfg, cfg, freeze_color, freeze_density, budget, use_bits, len(members))
            fn = cohort_step_fn(field_cfg, cfg, freeze_color, freeze_density, budget,
                                use_bits, len(members))
            with _trace.span("trainer/step_compile" if fresh else "trainer/step",
                             cat="trainer",
                             args={"step": int(i), "cohort": len(members),
                                   "budget": budget, "use_bits": use_bits}):
                new_p, new_o, losses_m, auxes = fn(
                    [params[k] for k in members], [opts[k] for k in members], batches, ts,
                    [occs[k].density_ema for k in members])
            for r, k in enumerate(members):
                params[k], opts[k] = new_p[r], new_o[r]
                aux = auxes[r]
                last[k] = (losses_m[r], aux, budget)
                overflow_all[k].append(aux["overflow"])
                trainers[k]._overflow_window.append(aux["overflow"])
                del trainers[k]._overflow_window[:-interval]
        if obs_on:
            _metrics.counter("trainer.steps").inc(m)
            _metrics.gauge("trainer.cohort_size").set(m)
            _metrics.gauge("trainer.cohort_groups").set(len(groups))

        if cfg.use_occupancy and i >= cfg.occ.warmup_steps and (i + 1) % interval == 0:
            for (use_bits, _budget), members in groups:
                fold = occ_update_fn(field_cfg, cfg.occ, len(members))
                with _trace.span("trainer/occ_update", cat="trainer",
                                 args={"step": int(i), "cohort": len(members)}), \
                        torch.no_grad():
                    emas = fold([params[k] for k in members],
                                [occs[k].density_ema for k in members],
                                [(u_occ[k].to(trainers[k].device) - 0.5) / cfg.occ.resolution
                                 for k in members])
                    for r, k in enumerate(members):
                        tr = trainers[k]
                        occs[k] = occupancy.OccupancyState(emas[r], int(occs[k].step) + 1)
                        hists[k]["occ_folds"].append(i)
                        if use_bits:
                            # re-measure the live fraction at the fold (one
                            # host sync); overflow since the last fold means
                            # the live set outgrew the bucket: widen beyond
                            # the measurement
                            measured = float(last[k][1]["live_fraction"])
                            recent = tr._overflow_window[-interval:]
                            if int(sum(int(v) for v in recent)) > 0:
                                measured = min(1.0, measured * 2.0)
                            tr._live_frac = measured
                        occ_updates[k] += 1

        if (local_i + 1) % log_every == 0 or local_i == iters - 1:
            losses_h = [float(last[k][0]) for k in range(m)]
            wall = _trace.clock() - t0
            for k in range(m):
                loss, aux, budget = last[k]
                h = hists[k]
                h["step"].append(i + 1)
                h["loss"].append(losses_h[k])
                h["wall_s"].append(wall)
                h["live_fraction"].append(float(aux["live_fraction"]))
                h["points_queried"].append(int(aux["points_queried"]))
                h["overflow"].append(int(aux["overflow"]))
                h["budget"].append(budget)
                if callback is not None:
                    callback(i + 1, params[k], h)
            if obs_on:
                _metrics.gauge("trainer.loss").set(losses_h[-1])
                _metrics.gauge("trainer.live_fraction").set(hists[-1]["live_fraction"][-1])

    new_states = []
    for k, tr in enumerate(trainers):
        ov = torch.stack([torch.as_tensor(v, device=tr.device) for v in overflow_all[k]]) \
            if overflow_all[k] else torch.zeros((0,), dtype=torch.int64)
        hists[k]["overflow_total"] = int(ov.sum())
        hists[k]["overflow_steps"] = int((ov > 0).sum())
        tr._overflow_window = [int(v) for v in tr._overflow_window]
        new_states.append(TrainState(params[k], opts[k], occs[k], step0 + iters))
    return new_states, hists
