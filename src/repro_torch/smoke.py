"""The phases of ``chip_smoke.py``: build, kernel parity, train (Instant-3D
and the Instant-NGP baseline), serve, the reconstruction service, stage 2b
v3, the async serving plane and the entry points, sessions over two slots
of the card, the field's last two options, half-width hash-grid tables,
compiled (CUDA-graph) steps and compiled renders, the LM substrate's
decoders, its parallel substrate, its dry-run launchers and its example
scripts.

Each phase takes an explicit device, so the CPU tests can rehearse the
paths at a tiny size with ``device="cpu"``; `main` runs them all on the
card and fails on anything wrong -- there is no CPU fallback.

1. build: print the card's name and power limit, turn TF32 off, build the
   kernels (one nvcc per source, all at once) and print the build seconds
   and ptxas's register / spill summary;
2. parity: hold each kernel against its plain PyTorch version at the main
   paths' shapes, with its error and tolerance, the kernel's and the plain
   version's time (CUDA events), the least time the card could take
   (`bound_ms`, from the bytes and operations this run's inputs need) and,
   where one PyTorch call computes the same function, that call's time;
   for the fused encode also its distinct reads per (block, level) against
   the plain count.  The composite runs at the training shape (1024 x 48)
   and both serving chunks, forward and backward (the gradients training
   asks, against the plain autograd and the plain closed form), each the
   same bytes on two launches.  The redesigned kernels also run at their main paths'
   own shapes (hash_encode on a served chunk's ray-ordered points, dense
   and redistributed; both MLPs at the dense serving chunk; the fused step
   forward and backward at a trained Instant-3D step's budget on
   Morton-ordered points, the backward with the color grid live and
   frozen), and each must give the same bytes on two launches (the hash
   encode also exactly zero on sentinel rows); the fused backward's time is
   broken down (kernel launch alone, the wrapper's commit alone and its
   sorts beside torch.sort's, no streams).  The table-gradient sort runs on
   the three streams the training paths sort (the fused backward's of a
   trained step, a dense step's, the fused encode backward's of an NGP
   step) and must give torch.sort's stable permutation exactly.
   Then the fused encode's table gradients must equal the hash encode's
   bit for bit for one fixed upstream gradient;
3. training (slice 2's main path): `Instant3DTrainer(Field(FieldConfig()),
   TrainerConfig()).train(...)` for its 400 steps on the synthetic scene of
   `build_dataset(0)` with 4 views held out, launch counters zeroed just
   before and read just after; loss, ms per dense and per compacted step,
   budgets, live fraction and held-out PSNR; then two short runs from one
   seed must end byte-identical (params, Adam moments, occupancy EMA); then
   one compacted step on the split route (`fused_step=False`: the fused
   encode, then the MLPs) against the one-op step, same params and batch;
3b. training the Instant-NGP baseline (this slice's main path):
   `FieldConfig(decomposed=False)` with `TrainerConfig()`, the same run and
   gates, its compacted steps through the fused encode (kernel #8) and none
   through the fused step; two short runs byte-identical;
4. serving (slice 1's main path): a `RenderService` serves 800x800 requests
   from a snapshot of the trained params and occupancy on the redistributed
   and the dense route plus one level-1 preview, counters zeroed just
   before and read just after; then the same service on a small image
   agrees with the plain versions on the CPU;
5. the reconstruction service (slice 9's main path):
   `ReconstructionService(slice_iters=16, guard=True, persist_dir=...)`
   trains four scenes of `build_dataset(k)` (the NGP baseline on 0,
   alone; the Instant-3D field on 1-3, one cohort of 3) on `TrainerConfig()`,
   answering two renders a scene asked from the run hook mid-training and
   one after, counters zeroed just before and read just after; every
   session DONE, every render a `RenderResult`, cohorts of 3 and 1, every
   kernel launched, held-out PSNR >= 20 dB a scene.  Then the four
   bit-identity contracts over 112 steps, `torch.equal` on params, both
   Adam moments and the occupancy EMA: cohort == sequential, suspend /
   resume through disk, guard rollback of a NaN-params fault, eval ==
   served;
6. stage 2b v3 (slice 10's main path): `TrainerConfig()` at
   `FieldConfig()` under a ceiling of 4096 points a step (1/12 of 1024 x
   48), trained 400 steps with the uniform sampler, v2 and v3, counters
   zeroed around the v3 run (``train_v3``); v3 must not overflow, no step
   with a budget may query more than the ceiling and its held-out PSNR
   must reach 20 dB (the three runs' PSNR is reported, not gated); two
   short v3 runs byte-identical; v3's plan of a step on the card against
   the CPU (rays whose S'_i differ, the budget held, the same bytes twice);
   #4 forward and backward on the ragged training lane grids (budget 4096
   and 8192), #5 and #6 on the step's Morton-packed points at 4096, #4 on
   the served chunk's 4096 x 48 lanes and #1 on its 49,152 compacted
   points; a v3 session serving two 800x800 views (``serve_v3``), its
   `render_image` the served bytes; 32 steps of its compacted points
   through `EncodingReuseCache`, every cached encode the plain hash encode
   bit for bit;
7. the async serving plane and the entry points (slice 11's main paths):
   phase 5's service run with ``async_serving`` off and on, alternating,
   two runs each, counters zeroed around each run (``service_async``: the
   last async run's); every session DONE, every request answered exactly
   once, every session's final params and occupancy EMA the same bytes in
   all four runs, and every async answer the bytes of a sync drain of the
   snapshot it was rendered from (the hook keeps the snapshots); wall,
   scenes/s, median per-slice wall and render p50 / p95 per mode with their
   spread.  Then the training CLI (`examples.train_nerf_instant3d`) to 200
   steps with a checkpoint every 100, resumed to 300 and held byte for
   byte to an uninterrupted 300-step run; the quickstart (PSNR >= 20 dB);
   the service demo with ``--async-serving`` (every scene done, every
   render answered); and `tools/torch_service_profile.py` in its own
   process: one quantum with the serving thread rendering beside it under
   torch.profiler (device busy, idle share, render / slice overlap);
8. sessions across slots and the field's last two options (slice 12's
   main paths): phase 5's service configuration run placement-free, with
   ``devices=1`` and with ``devices=["cuda:0", "cuda:0"]`` and the async
   serving plane (two slot threads, counters zeroed around the run:
   ``service_two_slots``); every session of both placed runs ends on the
   placement-free run's bytes, the two slots hold scenes [0, 1, 0, 1], the
   slices of both ``serve3d-dev`` threads overlap in wall time, every
   kernel is launched, every render answered by a group on its sessions'
   device.  A session suspended, moved to the other slot and resumed ends
   on an unmoved run's bytes; a session trained on the CPU slot of
   ``["cpu", "cuda:0"]``, suspended, moved to the card and resumed holds
   all its state and rays on the card, renders there, and ends on the
   bytes of a session resumed on the card from the CPU run's host tree;
   `session_devices` past the card count raises.  Then
   `FieldConfig(residual_policy="stash")` trained 200 steps ends on the
   default run's bytes -- on the card both policies run the same kernels
   (they recompute), so this shows determinism only; the CPU tests hold
   stash's own plain path to recompute's bytes -- and
   `FieldConfig(merged_backward=False)` (the atomic commit on the dense
   steps) reaches 20 dB held-out PSNR; its two runs' bytes are reported,
   not gated;
9. half-width tables (slice 13's main paths): the kernels that read
   tables -- #1 at N = 1024 x 48, #8 at 32,768 on each grid, #5 at budgets
   8192 and 32,768, #6 at 8192 -- on bf16 tables, and on f16 tables at the
   first shape of each; every case the bytes of the same kernel on the
   tables' f32 copies (for #6 its f32 streams, MLP and SH gradients, and
   table gradients that are the f32 commit cast), within the f32 case's
   tolerance of its plain version on the same 2-byte tables, the same bytes
   on two launches; #7 committing into a nonzero 2-byte table, the plain
   commit exactly.  Then `FieldConfig(grid_dtype="bfloat16")` trained 400
   steps on both fields with phase 3's gates (20 dB held-out, the paths'
   kernels; the tables still bf16, the moments f32), their PSNR beside the
   f32 runs'; four 800x800 views served from the trained bf16 snapshot on
   the redistributed route, eval == served byte for byte; two bf16
   sessions in the service as one cohort for 128 steps, each ending on the
   bytes of its sequential run; phase 5's four bit-identity contracts at
   bf16 (the guard's rollback reads bf16 trees, suspend / resume writes
   them to disk);
10. compiled steps (slice 14's main paths): every phase above trains
   through the compiled-step cache, each step a replay of a CUDA graph
   captured once per variant (each phase prints its graphs, replays and
   capture ms, then empties the cache).  Then each `COMPILED_PATHS` path
   -- FieldConfig() and the NGP baseline for 400 steps, stage 2b v3 at a
   ceiling of 4096 and bf16 tables for 200 -- trains captured and under
   `eager_steps()` from one seed: the same bytes (params, Adam moments and
   step, occupancy grid, history, the trainer's live fraction and overflow
   window), the built keys the variants the run took, every step and fold
   a replay, the captured launches less the warm-ups' the eager ones;
   printed beside capture ms per variant, median step ms per route
   captured and eager, the graphs' memory; then
   `tools/torch_train_profile.py` in its own process profiles each
   route's step eagerly and as a replay (idle share, copy-in, copy-out,
   the graph alone);
11. compiled renders (slice 15's main paths): every phase above serves
   (and evaluates) through the render caches, each chunk of a view a
   replay of a CUDA graph captured once per key (each phase prints its
   render graphs, replays, binds and capture ms per key, then empties the
   caches).  Then each `COMPILED_ROUTES` route -- redistributed (S' = 12)
   and dense (S = 48) from phase 3's snapshot, v3 from phase 6's and
   redistributed from phase 9's bf16 snapshot -- serves 800x800 views, a
   group of 3 (keyed as padded to 4, only its members rendered) and a
   level-1 preview a drain, captured (a drain that captures, then one
   that only replays) and under `eager_steps()`: the same bytes, the
   built keys the groups taken, every chunk a replay, the captured
   launches less the warm-ups' the eager ones; then 12 lone requests each
   way, each its own drain, for p50 / p95; printed beside the group
   drains' ms per view, capture ms per key, the graphs' memory and the
   render pool's bytes;
12. the LM substrate (slice 16's main paths, `smoke_lm.lm_phase`):
   qwen1.5-0.5b at full width -- #7 and `bum_sort` on its vocab-wide
   embedding-gradient rows (F = 1024 and 4096) exactly against their plain
   versions, the 1-D windowed commit; training 30 steps through
   `launch.train.train` with the default and the BUM-merged embedding
   backward (``lm_train``, ``lm_train_dedup``: #7 and `bum_sort` once a
   step), the merged runs byte-identical from one seed and across a stop
   at 20 and a resume; serving 8 requests through `launch.serve.serve`
   (``lm_serve``), prefill and decode against a full forward; an f32
   forward on the card against the CPU's;
13. MLA + MoE (slice 17's main paths, `smoke_moe.moe_phase`): #7 and
   `bum_sort` on deepseek-v2-lite's and deepseek-v3's embedding rows
   (F = 2048 into 102,400 rows, F = 7168 into 129,280) exactly against
   their plain versions; deepseek-v2-lite at full width with its depth cut
   to 3 trained 30 steps with the default and the BUM-merged embedding
   backward (``lm_moe_train``, ``lm_moe_train_dedup``: #7 and `bum_sort`
   once a step), the merged runs byte-identical from one seed; prefill /
   decode against a full forward and the card against the CPU at f32,
   with the routing decisions that differ; deepseek-v3's smoke config
   with its MTP head trained merged (``lm_mtp_train_dedup``: #7 twice a
   step), stopped and resumed byte for byte; deepseek-v2-lite at full
   width and depth (27 layers, 31.4 GB bf16) serving 8 requests
   (``lm_moe_serve``);
14. SSM and hybrid (slice 18's main paths, `smoke_ssm.ssm_phase`): #7 and
   `bum_sort` on zamba2-7b's and falcon-mamba-7b's embedding rows (F =
   3584 into 32,000 rows, F = 4096 into 65,024) exactly against their
   plain versions; falcon-mamba-7b (Mamba-1) with its depth cut to 3 and
   zamba2-7b (Mamba-2 and the weight-shared attention block) cut to 7,
   at full width, each trained 30 steps of 4 x 256 with the default and
   the BUM-merged embedding backward (``lm_ssm_train``,
   ``lm_ssm_train_dedup``, ``lm_hybrid_train``, ``lm_hybrid_train_dedup``:
   #7 and `bum_sort` once a step), the merged runs byte-identical from one
   seed; zamba2 stopped at 20 and resumed at one layer, against an
   uninterrupted run of that depth; prefill / decode of
   a 300-token prompt against a full forward and the card against the CPU
   at f32; both served at full width and depth (``lm_ssm_serve``,
   ``lm_hybrid_serve``);
15. whisper's encoder-decoder (slice 19's main paths,
   `smoke_whisper.whisper_phase`): #7 and `bum_sort` on whisper-medium's
   embedding rows (4 x 448 tokens at F = 1024 into 51,865 rows) exactly
   against their plain versions; whisper-medium at full width and depth
   (24 + 24 layers) trained 30 steps of 4 x 448 tokens beside 4 x 1500
   frame embeddings through `launch.train.train_step` and `TrainDriver`,
   with the default and the BUM-merged embedding backward
   (``lm_encdec_train``, ``lm_encdec_train_dedup``: #7 and `bum_sort` once
   a step), the merged runs byte-identical from one seed; prefill / decode
   against a full forward and the card against the CPU at f32 on 2 + 2
   layers; served at full width and depth (``lm_encdec_serve``);
16. the parallel substrate (slice 20's main paths,
   `smoke_parallel.parallel_phase`) over world-1 NCCL groups: `moe_ep` on
   one deepseek-v2-lite MoE layer at full width against `moe_dense`
   (values and gradients), the CPU (drops exactly) and on decode;
   `compressed_grad_sync` on a depth-3 step's gradients, its int8
   payloads the CPU's bit for bit, and the error-feedback loop; the
   training CLI with ``--compress-grads --coordinator`` stopped and
   resumed byte for byte; `launch.serve` on the host mesh against
   mesh=None (``parallel_moe_ep``, ``parallel_sync``,
   ``parallel_train_cli``, ``parallel_serve``);
17. the LM dry-run launchers (slice 21's main paths,
   `smoke_dryrun.dryrun_phase`): qwen1.5-0.5b's train step at full width
   and 4 x 1024 tokens traced on a fake world of 1 (fake tensors on the
   card, the H100 roofline), then run for real through
   `launch.steps.build_train_step` on a world-1 NCCL mesh, params placed
   as DTensors (first loss == `LM.loss` bit for bit, the args' bytes on
   the card == the dry run's within 512 B a tensor; ``dryrun_step``: #7
   and `bum_sort` through the merged embedding backward), and the
   production cell qwen1.5-0.5b x decode_32k on a fake world of 256 in a
   subprocess, and sixteen mini cells on fake (2, 2, 2) worlds in
   subprocesses beside it (the reference's three, Mamba-1's training, the
   absorbed MLA decode, zamba2's hybrid training and decode, three
   whose residual stream splits along its sequence, and qwen3-8b's TP
   training and prefill at a vocab of 32768, and the TP policy's SSM and
   MLA training and deepseek-v3's MTP head on uneven sequence blocks: each
   traces, shows the collective kind named, and holds JAX's argument bytes
   a device; the last six hold their temp bytes to JAX's, the last four
   their largest storage to the term at its block too);
18. the LM example scripts (slice 22's entry points,
   `smoke_examples.examples_phase`): `examples.lm_pretrain` at its
   defaults (its loss falls) and `examples.serve_lm` at its defaults and
   with whisper-medium (every logit finite, tok/s printed)
   (``example_lm_pretrain``, ``example_serve_lm``);
19. report: one JSON line ``{"kernels": [...]}`` (each kernel's launches
   summed over the main paths, and per path) and, last, the device line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from . import (kernels, smoke_dryrun, smoke_examples, smoke_lm, smoke_moe, smoke_parallel,
               smoke_ssm, smoke_whisper)
from .core import encoding as enc
from .core import occupancy
from .core.field import Field, FieldConfig
from .core.pipeline import RenderPipeline
from .core.rendering import RenderConfig, sample_ts, sphere_poses
from .core import trainer as trainer_lib
from .core.trainer import (Instant3DTrainer, TrainerConfig, _branch_update,
                           clear_render_cache, clear_step_cache, default_draws,
                           default_samples_per_ray, eager_steps, image_rays, train_cohort)
from .data.rays_dataset import RaySampler
from .data.synthetic_scene import build_dataset
from .examples import quickstart, reconstruct_service
from .examples import train_nerf_instant3d as train_cli
from .kernels.fused_mlp import kernel as mlp_kernel
from .kernels.fused_mlp import ref as mlp_ref
from .kernels.fused_path import kernel as fp_kernel
from .kernels.fused_path import ref as fp_ref
from .kernels.fused_path.reuse import EncodingReuseCache
from .kernels.fused_step import kernel as fs_kernel
from .kernels.fused_step import ops as fs_ops
from .kernels.fused_step import ref as fs_ref
from .kernels.grid_update import kernel as gu_kernel
from .kernels.grid_update import ops as gu_ops
from .kernels.grid_update import ref as gu_ref
from .kernels.hash_encode import kernel as he_kernel
from .kernels.hash_encode import ops as he_ops
from .kernels.hash_encode import ref as he_ref
from .kernels.volume_render import kernel as vr_kernel
from .kernels.volume_render import ref as vr_ref
from .obs import metrics as obs_metrics
from .obs import trace as obs_trace
from .optim.adamw import tree_paths
from .launch.mesh import session_devices
from .serve3d import (DONE, DevicePlacement, ReconstructionService, RenderResult,
                      RenderService, SceneSession, SnapshotStore)
from .serve3d.render import _pow2_bucket
from .testing import faults

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM bandwidth, the f32 rate outside the tensor cores and the dense TF32
# rate of the tensor cores.  Each operation counts at the rate of the unit
# that runs it: both MLPs' and the fused backward's layer products run on
# the tensor cores in split TF32 (three TF32 products per multiply-add), the
# rest in f32 on the CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
SPLIT_TF32_PRODUCTS = 3

KERNELS = {
    "hash_encode": {
        "route": "cuda", "source": "src/repro_torch/csrc/hash_encode.cu",
        "replaces": "src/repro/kernels/hash_encode/kernel.py:98"},
    "fused_mlp2": {
        "route": "cuda", "source": "src/repro_torch/csrc/fused_mlp.cu",
        "replaces": "src/repro/kernels/fused_mlp/kernel.py:42"},
    "fused_mlp3": {
        "route": "cuda", "source": "src/repro_torch/csrc/fused_mlp.cu",
        "replaces": "src/repro/kernels/fused_mlp/kernel.py:62"},
    "composite": {
        "route": "cuda", "source": "src/repro_torch/csrc/composite.cu",
        "replaces": "src/repro/kernels/volume_render/kernel.py:35"},
    "composite_bwd": {
        "route": "cuda", "source": "src/repro_torch/csrc/composite.cu",
        "replaces": "src/repro/kernels/volume_render/ops.py:49"},
    "fused_step_fwd": {
        "route": "cuda", "source": "src/repro_torch/csrc/fused_step.cu",
        "replaces": "src/repro/kernels/fused_step/kernel.py:122"},
    "fused_step_bwd": {
        "route": "cuda", "source": "src/repro_torch/csrc/fused_step.cu",
        "replaces": "src/repro/kernels/fused_step/kernel.py:266"},
    "bum_scatter": {
        "route": "cuda", "source": "src/repro_torch/csrc/bum_scatter.cu",
        "replaces": "src/repro/kernels/grid_update/kernel.py:69"},
    "bum_sort": {
        "route": "cuda", "source": "src/repro_torch/csrc/bum_sort.cu",
        "replaces": "src/repro/kernels/fused_step/kernel.py:266"},
    "fused_encode": {
        "route": "cuda", "source": "src/repro_torch/csrc/fused_encode.cu",
        "replaces": "src/repro/kernels/fused_path/kernel.py:66"},
}
# (kernels a path must launch, kernels it must not) per main path
TRAIN_KERNELS = (("fused_step_fwd", "fused_step_bwd", "bum_scatter", "bum_sort", "composite",
                  "composite_bwd"), ("fused_encode",))
NGP_TRAIN_KERNELS = (("fused_encode", "bum_scatter", "bum_sort", "hash_encode", "fused_mlp2",
                      "fused_mlp3", "composite", "composite_bwd"),
                     ("fused_step_fwd", "fused_step_bwd"))
SERVE_KERNELS = ("hash_encode", "fused_mlp2", "fused_mlp3", "composite")

# Error allowed between a kernel and its plain version on the card, in the
# measure each case reports as `err`.  The two sum in different orders and
# the kernels contract multiply-adds into FMAs or, in the MLPs and the
# fused backward, take split-TF32 products on the tensor cores (within about
# 2^-22 of each f32 product).  Max abs error: an 8-corner sum of values in
# [-1, 1] (hash encode) and the MLPs' O(1) outputs stay within 1e-5, the
# fused step's outputs too; the composite's depth sums 48 terms of w * t
# with t up to 6, so its bound is 5e-5.  Its backward (relative, against
# the plain autograd and the plain closed form) sums the suffixes
# S_{>k} of up to 48 terms in another order (1e-4).  The fused backward (relative: max
# abs error over max |value|) sums each table row's updates in the plain
# version's stream order, from feature gradients that its products round
# otherwise (1e-5 of the largest table gradient), and its MLP gradients
# over blocks of 32 points, then over the blocks (1e-4).  bum_scatter sums
# each run in stream order, as the plain version does on the CPU, so each
# case must equal the plain merge bit for bit (`exact`; its relative error
# is printed against 1e-6).  bum_sort moves
# keys and values without arithmetic: it must give torch.sort's stable
# permutation exactly (tolerance 0, every entry equal).  The fused encode
# sums the same 8 corners as the hash encode (1e-5); its distinct-read
# counts must equal the plain count and its block dedup ratio the plain
# `dedup_stats` within 1e-12.
TOLERANCE = {"hash_encode": 1e-5, "fused_mlp2": 1e-5, "fused_mlp3": 1e-5,
             "composite": 5e-5, "composite_bwd": 1e-4, "fused_step_fwd": 1e-5,
             "fused_step_bwd": 1e-4,
             "bum_scatter": 1e-6, "bum_sort": 0.0, "fused_encode": 1e-5}
BWD_TABLE_TOL = 1e-5        # relative, the fused backward's table gradients
DEDUP_RATIO_TOL = 1e-12
# The split route (fused encode, then the MLPs) against the one-op step on
# one compacted step: the fused backward merges table updates per block and
# sums the MLP gradients over blocks of 64 points, the split route per
# stream and in one matmul (relative to the one-op step's largest value).
SPLIT_TABLE_TOL, SPLIT_MLP_TOL = 1e-5, 1e-4

# The training main path: TrainerConfig() on build_dataset(0)'s defaults
# (24 views, 64x64), the first HELD_OUT views held out for the PSNR gate.
HELD_OUT = 4
MIN_PSNR_DB = 20.0
# Two runs from one seed must be byte-identical after each of these step
# counts.  The live fraction is first measured at the fold after step 95, so
# the first compacted step of TrainerConfig() is step 96 at the earliest: at
# the Instant-3D field's live fraction (~0.1) it is, so 104 steps cover both
# routes.  The Instant-NGP field's live fraction stays near 0.5 and its
# first compacted step is 128 (the fold after step 127), so its runs go on
# to 136.
DETERMINISM_STEPS = (104,)
NGP_DETERMINISM_STEPS = (104, 136)
# The composite's training shape (TrainerConfig(): 1024 rays x 48 samples)
# and the inputs whose gradients training asks of it (sigma and rgb).
TRAIN_RAYS = 1024
TRAIN_COMPOSITE_NEEDS = (True, True, False, False)
# The compacted shade's budget at the parity cases (2^15, the bucket of a
# ~0.5 live fraction at 1024 rays x 48 samples) and the dense step's points;
# the fused encode's padded case: a size that is not a multiple of its
# 256-point block, with sentinel rows at the end.
PARITY_BUDGET = 32768
DENSE_POINTS = 1024 * 48
# The main paths' own shapes of the kernels redesigned for Hopper: the
# trained Instant-3D field's compacted budget (live fraction 0.075-0.10 of
# 1024 x 48 points buckets to 8192) for the fused step, and the serving
# chunk (4096 rays x 48 samples dense, x 12 redistributed) for the hash
# encode and the MLPs.
TRAIN_BUDGET = 8192
PADDED_POINTS, SENTINEL_ROWS = 30000, 4

# The served image: NeRF-Synthetic size, 50 degree field of view
# (`repro.data.synthetic_scene`: focal = 0.5 * w / tan(25 deg)).
IMAGE_HW = 800
FOV_DEG = 50.0
EVAL_CHUNK = 4096

# The reconstruction service (slice 9's main path): four scenes of
# build_dataset(k)'s defaults, all on TrainerConfig(), sliced 16 steps a
# quantum: the Instant-NGP baseline on scene 0 (a cohort of 1) and the
# Instant-3D field on scenes 1-3 (one cohort of 3).  128 steps cross the
# warmup (64) into the Instant-3D field's compacted steps (from step 96).
# The NGP field's live fraction stays near 0.5, so its first compacted step
# is 128 at the earliest, and only where the measured fraction is at most
# ~0.51 (scene 0's: 0.497 at the fold after step 127; scene 3's stays at
# 0.53-0.56 through 160 steps, measured on one H100): the NGP session trains
# scene 0 for 160 steps, 32 of them compacted through the fused encode
# (#8).  Two renders a scene are asked mid-training (after the quanta
# ending at these steps) and one after the run.
SERVICE_SCENES = 4
SERVICE_SLICE = 16
SERVICE_ITERS = 128
NGP_SERVICE_ITERS = 160
SERVICE_RENDER_STEPS = (48, 96)
SERVICE_COHORTS = {3, 1}
# The bit-identity contracts on the card: FieldConfig(), TrainerConfig(),
# 112 steps -- folds at 79, 95 and 111, compacted steps from 96.  The
# suspend/resume run goes to disk and back at steps 48 and 96 (the second
# time with a measured live fraction and a full overflow window); the guard
# run's NaN-params fault fires on the slice starting at step 80 and is
# rolled back to the last-good tree of step 64.
IDENTITY_ITERS = 112
SUSPEND_AT = (48, 96)
FAULT_AT = 80

# Stage 2b v3 (this slice's main path) under a hard point ceiling:
# TrainerConfig() with max_budget=4096, 1/12 of 1024 rays x 48 candidates
# (the ceiling of the reference's sampler benchmark, 1024 of 512 x 24),
# trained with the uniform sampler, v2 and v3, 400 steps each on
# build_dataset(0) with 4 views held out; v3 served at 800x800 (12 samples
# a ray: a chunk's budget 4096 x 12 = 49,152 points over a 4096 x 48 lane
# grid) and its encodings replayed through the reuse cache over 32 steps.
# #4 also runs on the training lane grid at budget 8192 (s_cap 32).
V3_MAX_BUDGET = 4096
SAMPLERS = {"uniform": {}, "v2": {"redistribute": True}, "v3": {"redistribute_v3": True}}
V3_LANE_BUDGETS = (V3_MAX_BUDGET, 2 * V3_MAX_BUDGET)
V3_SERVE_REQUESTS = 2
REUSE_STEPS = 32

# The async serving plane and the entry points (this slice's main paths):
# phase 5's service run with the serving thread off and on, alternating
# sync, async, sync, async; the training CLI trained to 200 steps with a
# checkpoint every 100, resumed to 300 and held to an uninterrupted 300;
# the quickstart's 200 steps; the service demo with --async-serving at its
# defaults (4 scenes x 96 steps, slices of 8, 24x24 views).
SERVICE_MODE_RUNS = 2
CLI_ITERS, CLI_RESUME_ITERS, CLI_CKPT_EVERY = 200, 300, 100
QUICKSTART_ITERS = 200
SERVICE_PROFILE_TIMEOUT_S = 420

# Sessions across slots (slice 12's main path): phase 5's service on two
# slots of the one card, with the async serving plane.  The least-loaded
# placement puts scenes 0-3 on slots [0, 1, 0, 1]: the NGP session (scene 0)
# and Instant-3D scene 2 train alone on slot 0 (their configs differ), scenes
# 1 and 3 as a cohort of 2 on slot 1.  The device move goes to the other
# slot at the first suspend step of the contracts.  The move across devices
# trains FieldConfig() on the CPU slot (plain routes) for 24 steps (the
# first fold at 23), then on the card (kernels; compacted steps from 32) to
# 40, at 256 rays on 32x32 views so the CPU leg stays short.  The field's last two
# options train TrainerConfig() for 200 steps (100 dense, then compacted).
PLACEMENT_SLOTS = ("cuda:0", "cuda:0")
PLACEMENT_PLACED = {"scene-000": 0, "scene-001": 1, "scene-002": 0, "scene-003": 1}
PLACEMENT_COHORTS = {1, 2}
CROSS_SLOTS = ("cpu", "cuda:0")
CROSS_DATA = dict(n_views=6, h=32, w=32, gt_samples=48)
# headroom 0.7: at this size's live fraction the budget buckets below the
# dense count, so the card leg's compacted steps shade through the fused step
CROSS_CFG = TrainerConfig(n_rays=256, budget_headroom=0.7,
                          occ=occupancy.OccupancyConfig(update_interval=8, warmup_steps=16))
CROSS_ITERS, CROSS_AT = 40, 24
OPTION_ITERS = 200

# Half-width tables (slice 13's main paths): FieldConfig(grid_dtype=
# "bfloat16") trained on both fields for TrainerConfig()'s 400 steps,
# served at 800x800 (4 views on the redistributed route) and run as a
# cohort of two sessions in the service for 128 steps; the kernel cases on
# bf16 tables, and on f16 tables at the first shape of each kernel.
GRID_DTYPE = "bfloat16"
GRID_DTYPE_CASES = (torch.bfloat16, torch.float16)
GRID_SERVE_REQUESTS = 4

# Compiled steps (slice 14's main paths): every training path runs its
# steps as CUDA-graph replays; phase 10 trains each of these paths twice
# from one seed, captured and under `eager_steps()`, and holds the two to
# the same bytes: FieldConfig() and the NGP baseline for TrainerConfig()'s
# 400 steps (dense, compacted through #5 / #6, and through #8), stage 2b v3
# at a ceiling of 4096 and bf16 tables for 200 (the cut: steps).
COMPILED_PATHS = (
    ("train", FieldConfig(), TrainerConfig(), 400),
    ("train_ngp", FieldConfig(decomposed=False), TrainerConfig(), 400),
    ("train_v3", FieldConfig(), TrainerConfig(max_budget=V3_MAX_BUDGET, redistribute_v3=True),
     200),
    (f"train_{GRID_DTYPE}", FieldConfig(grid_dtype=GRID_DTYPE), TrainerConfig(), 200),
)
COMPILED_HISTORY = ("step", "loss", "live_fraction", "points_queried", "overflow", "budget",
                    "occ_folds", "overflow_total", "overflow_steps")
TRAIN_PROFILE_TIMEOUT_S = 420

# Compiled renders (this slice's main paths): every render runs its chunks
# as CUDA-graph replays; phase 11 serves each of these routes from its
# trained snapshot -- a group of 3 views (keyed as padded to 4) and a
# level-1 preview a drain -- captured and under `eager_steps()`, and holds
# the two to the same bytes: route -> the trained run it serves (phase 3's f32
# Instant-3D run on the redistributed and the dense route, phase 6's v3
# run, phase 9's bf16 run on the redistributed route).
COMPILED_ROUTES = {"redist": "train", "dense": "train", "v3": "train_v3",
                   f"redist_{GRID_DTYPE}": f"train_{GRID_DTYPE}"}
RENDER_GROUP = 3
# phase 11's latency: lone requests a route, each its own drain
LATENCY_REQUESTS = 12

# whole-image agreement of the card's path with the plain versions on the
# CPU (the CPU tests' slice-level tolerance against JAX): rgb in [0, 1],
# depth in [near, far] = [2, 6]
PATH_RGB_TOL = 1e-4
PATH_DEPTH_TOL = 5e-4


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def focal_for(width: int) -> float:
    return 0.5 * width / np.tan(np.deg2rad(FOV_DEG) / 2)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds of one call of fn, by CUDA events over
    `iters` back-to-back calls after `warmup` calls.

    A small kernel finishes before the host has enqueued the next launch, so
    events around a plain loop would time the host.  A spin kernel first
    holds the stream for twice the loop's measured host time (at <= 2 GHz
    SM clock), so every launch is queued before the first one runs and the
    events time the device's work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_flops: float, split_tf32_macs: float = 0) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it): the larger
    of the bytes over the memory rate and the operations over their unit's
    rate -- `n_flops` f32 flops on the CUDA cores, `split_tf32_macs`
    multiply-adds on the tensor cores (3 TF32 products of 2 flops each),
    the two units running side by side."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(n_flops / PEAK_F32_FLOP_PER_S,
                SPLIT_TF32_PRODUCTS * 2 * split_tf32_macs / PEAK_TF32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _uniform(gen, shape, lo, hi, device):
    return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(device)


def _max_err(a, b) -> float:
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return max(float((x - y).detach().abs().max()) for x, y in zip(a, b))


def _rel_err(a, b) -> float:
    """Max abs error over the largest |value| of the plain version."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _same_bits(a, b) -> bool:
    """Whether two tensors, or two equal-length sequences of tensors and
    dicts of tensors, hold the same bytes."""
    flat = lambda x: (list(x.values()) if isinstance(x, dict) else  # noqa: E731
                      [x] if isinstance(x, torch.Tensor) else
                      [t for y in x for t in flat(y)])
    xs, ys = flat(a), flat(b)
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.contiguous().reshape(-1).view(torch.uint8),
                        y.contiguous().reshape(-1).view(torch.uint8))
        for x, y in zip(xs, ys))


def _same_nonzero_rows(a, b) -> bool:
    """Whether two gradient tables have nonzero entries in the same rows."""
    rows = lambda t: t.reshape(-1, t.shape[-1]).ne(0).any(dim=-1)  # noqa: E731
    return bool(torch.equal(rows(a), rows(b)))


# ---- phase 2: kernel parity ---------------------------------------------------

def _hash_encode_case(gen, device, n, enc, label, points=None, dtype=torch.float32):
    """Kernel #1 against its plain version on `points` (uniform in the unit
    cube when None), the first 4 rows made sentinels: error, sentinel rows
    exactly zero, the same bytes on two launches.  The tables are drawn in
    f32 and cast to `dtype`; a 2-byte table's case is also held to the
    kernel on its f32 copy (`_upcast_fields`)."""
    cfg = enc.cfg
    if points is None:
        points = _uniform(gen, (n, 3), 0.0, 1.0 - 1e-6, device)
    points = points.clone()
    points[:4, 0] = -1.0                                # sentinel rows
    tables = _uniform(gen, (cfg.n_levels, cfg.table_size, cfg.n_features),
                      -1.0, 1.0, device).to(dtype)
    res, dense = enc.resolutions, enc.dense_flags
    run = lambda: he_kernel.hash_encode(points, tables, res, dense)  # noqa: E731
    got = run()
    want = he_ref.hash_encode(points, tables, res, dense)
    # table rows this run's points touch: what the gather must read
    rows = torch.cat([
        he_ref.level_indices(points, int(res[lv]), cfg.table_size, bool(dense[lv]))[0]
        .reshape(-1) + lv * cfg.table_size for lv in range(cfg.n_levels)])
    unique_rows = int(torch.unique(rows).numel())
    f = cfg.n_features
    n_bytes = 4 * (n * 3 + n * cfg.n_levels * f) + tables.element_size() * unique_rows * f
    n_flops = n * cfg.n_levels * (25 + 16 * f)
    err = _max_err(got, want)
    sentinel_zero = not got[:4].any()
    deterministic = _same_bits(got, run())
    up = tables.float()
    return {
        "kernel": "hash_encode", "case": label,
        "shape": [n, cfg.n_levels, cfg.table_size, f],
        "max_abs_err": err, "sentinel_rows_zero": sentinel_zero,
        "deterministic": deterministic,
        "ok": err <= TOLERANCE["hash_encode"] and sentinel_zero,
        "ms": cuda_ms(run),
        "plain_ms": cuda_ms(lambda: he_ref.hash_encode(points, tables, res, dense),
                            iters=10),
        "bound": bound(n_bytes, n_flops),
        **_upcast_fields(tables, lambda: _same_bits(got, he_kernel.hash_encode(
            points, up, res, dense)), lambda: he_kernel.hash_encode(points, up, res, dense)),
    }


def _upcast_fields(tables, same_as_upcast, upcast_run) -> dict:
    """A 2-byte table's case: its dtype, whether the kernel gave the bytes of
    the same kernel on the table's f32 copy (bf16 / f16 -> f32 is exact and
    the arithmetic is the f32 kernel's, so any difference is a fault), and
    the f32 kernel's time on that copy.  Nothing for an f32 table."""
    if tables.dtype == torch.float32:
        return {}
    return {"dtype": str(tables.dtype).removeprefix("torch."),
            "upcast_identical": same_as_upcast(), "f32_ms": cuda_ms(upcast_run)}


def serving_points(device, render_cfg: RenderConfig = RenderConfig(),
                   samples_per_ray: int | None = None, hw: int = IMAGE_HW,
                   chunk: int = EVAL_CHUNK) -> torch.Tensor:
    """Unit-cube points of one served chunk in the order the shade stage gets
    them (ray-major: ray i's k-th sample at i*S + k): the chunk of `chunk`
    rays that holds the centre of an hw x hw view of the first served pose,
    sampled by stage 1 at the stratum midpoints.  With `samples_per_ray`,
    stage 2b then re-spends each ray's S samples as that many on its strata
    inside the scene box (the served redistributed route, with the box in
    place of a trained occupancy grid)."""
    pose = sphere_poses(1, seed=0)[0]
    origins, dirs, n, chunk = image_rays(pose, hw, hw, focal_for(hw), chunk, device=device)
    first = (n // 2) // chunk * chunk
    origins, dirs = origins[first:first + chunk], dirs[first:first + chunk]
    pipe = RenderPipeline(Field(FieldConfig()), render_cfg)
    ts = sample_ts(None, chunk, render_cfg, device)
    flat_pts, _, unit = pipe.generate_samples(origins, dirs, ts)
    if samples_per_ray is not None:
        live = pipe.cull(flat_pts, unit).reshape(chunk, -1)
        ts, _ = pipe.redistribute(ts, live, n_out=samples_per_ray)
        _, _, unit = pipe.generate_samples(origins, dirs, ts)
    return unit.contiguous()


def _mlp_case(gen, device, n, dims, label):
    name = "fused_mlp2" if len(dims) == 3 else "fused_mlp3"
    x = _uniform(gen, (n, dims[0]), -1.0, 1.0, device)
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        b = (6.0 / d_in) ** 0.5
        params += [_uniform(gen, (d_in, d_out), -b, b, device),
                   _uniform(gen, (d_out,), -0.1, 0.1, device)]
    kern = mlp_kernel.fused_mlp2 if name == "fused_mlp2" else mlp_kernel.fused_mlp3
    plain = mlp_ref.mlp2 if name == "fused_mlp2" else mlp_ref.mlp3
    n_params = sum(p.numel() for p in params)
    n_bytes = 4 * (n * (dims[0] + dims[-1]) + n_params)
    macs = n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    # products on the tensor cores, bias + ReLU in f32
    least = bound(n_bytes, 2 * n * sum(dims[1:]), split_tf32_macs=macs)
    got = kern(x, *params)
    return {
        "kernel": name, "case": label, "shape": [n, *dims],
        "max_abs_err": _max_err(got, plain(x, *params)),
        "deterministic": _same_bits(got, kern(x, *params)),
        "ms": cuda_ms(lambda: kern(x, *params)),
        "plain_ms": cuda_ms(lambda: plain(x, *params)),
        "bound": least,
    }


def composite_inputs(gen, r, s, device):
    """sigma U(0, 20), rgb U(0, 1), sorted ts in [2, 6] and their widths
    (non-uniform; the last padded by 4 / S)."""
    sigma = _uniform(gen, (r, s), 0.0, 20.0, device)
    rgb = _uniform(gen, (r, s, 3), 0.0, 1.0, device)
    ts = torch.sort(_uniform(gen, (r, s), 2.0, 6.0, device), dim=-1).values
    deltas = torch.diff(ts, dim=-1, append=ts[:, -1:] + 4.0 / s)
    return sigma, rgb, deltas, ts


def _composite_case(gen, device, r, s, label, inputs=None):
    """Kernel #4 against the plain composite on `inputs` (`composite_inputs`
    when None); the same bytes on two launches."""
    if inputs is None:
        inputs = composite_inputs(gen, r, s, device)
    run = lambda: vr_kernel.composite(*inputs)  # noqa: E731
    got = run()
    want = vr_ref.composite(*inputs)
    n_bytes = 4 * (r * s * 6 + r * 5)
    n_flops = 16 * r * s
    return {
        "kernel": "composite", "case": label, "shape": [r, s],
        "max_abs_err": _max_err(got, want[:3]), "deterministic": _same_bits(got, run()),
        "ms": cuda_ms(run),
        "plain_ms": cuda_ms(lambda: vr_ref.composite(*inputs)),
        "bound": bound(n_bytes, n_flops),
    }


def _composite_bwd_case(gen, device, r, s, label, needs=TRAIN_COMPOSITE_NEEDS, inputs=None):
    """The composite's backward kernel for the gradients `needs` asks (the
    training path's by default) against the plain autograd of the
    composite and against the plain closed form (`ref.composite_backward`),
    relative, on `inputs` (`composite_inputs` when None); the same bytes on
    two launches.  The plain time is the autograd's backward alone, its
    graph kept."""
    if inputs is None:
        inputs = composite_inputs(gen, r, s, device)
    grads = (_uniform(gen, (r, 3), -1.0, 1.0, device), _uniform(gen, (r,), -1.0, 1.0, device),
             _uniform(gen, (r,), -1.0, 1.0, device))
    run = lambda: vr_kernel.composite_backward(*inputs, *grads, needs=needs)  # noqa: E731
    got = run()
    leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
    out = vr_ref.composite(*leaves)[:3]
    wanted = [t for t in leaves if t.requires_grad]
    plain = lambda: torch.autograd.grad(out, wanted, grads, retain_graph=True)  # noqa: E731
    want = plain()
    closed = [c for c, need in zip(vr_ref.composite_backward(*inputs, *grads), needs) if need]
    mine = [g for g in got if g is not None]
    err = max(max(_rel_err(g, w), _rel_err(g, c)) for g, w, c in zip(mine, want, closed))
    # inputs and upstream gradients read once, the asked gradients written once
    n_out = sum(k for k, need in zip((1, 3, 1, 1), needs) if need)
    n_bytes = 4 * (r * s * (6 + n_out) + r * 5)
    return {
        "kernel": "composite_bwd", "case": label, "shape": [r, s],
        "needs": list(needs), "max_abs_err": _max_err(mine, want), "err": err,
        "deterministic": _same_bits(mine, [g for g in run() if g is not None]),
        "ms": cuda_ms(run),
        "plain_ms": cuda_ms(plain),
        "bound": bound(n_bytes, 40 * r * s),
    }


def _fused_step_inputs(gen, device, n: int, field: Field, points=None):
    """Morton-sorted points (`points` as given, when given: a compacted
    step's), SH of random unit dirs, tables U(-1, 1) in the field's
    `grid_dtype` and the field's MLPs (He-uniform weights, biases U(-0.1,
    0.1)) at its widths."""
    cfg = field.cfg
    if points is None:
        pts = _uniform(gen, (n, 3), 0.0, 1.0 - 1e-6, device)
        pts = pts[torch.sort(fp_ref.morton_key(pts), stable=True).indices].contiguous()
    else:
        pts = points.clone().contiguous()
    dirs = _uniform(gen, (n, 3), -1.0, 1.0, device)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    sh = enc.sh_encoding(dirs, cfg.sh_degree).contiguous()
    params = field.init(gen, device)
    tables = []
    for key in ("density_grid", "color_grid"):
        tables.append(_uniform(gen, tuple(params[key].shape), -1.0, 1.0, device)
                      .to(cfg.table_dtype))
    for key in ("density_mlp", "color_mlp"):
        for name, t in params[key].items():
            if name.startswith("b"):
                params[key][name] = _uniform(gen, tuple(t.shape), -0.1, 0.1, device)
    geometry = (field.density_enc.resolutions, field.density_enc.dense_flags,
                field.color_enc.dense_flags)
    return pts, sh, tables, params["density_mlp"], params["color_mlp"], geometry


def _fused_counts(pts, tables, mlp_d, mlp_c, geometry):
    """(bytes, encode flops, MLP multiply-adds) of one fused forward on these
    inputs: points read once, each table row the points touch read once (at
    the tables' element size), every MLP parameter read once; encode flops
    as hash_encode's for both grids."""
    n = pts.shape[0]
    res, dense_d, dense_c = geometry
    corners, _ = fp_ref.corner_geometry(pts, res)
    rows = 0
    for t, dense in zip(tables, (dense_d, dense_c)):
        idx = fp_ref.level_indices(corners, res, t.shape[1], dense)
        rows += int(torch.unique(fp_ref.address_stream(idx, t.shape[1])).numel())
    levels, _, f = tables[0].shape
    mlp_params = sum(t.numel() for t in list(mlp_d.values()) + list(mlp_c.values()))
    macs = sum(mlp_d[k].numel() for k in ("w1", "w2")) + \
        sum(mlp_c[k].numel() for k in ("w1", "w2", "w3"))
    n_bytes = 4 * (n * 3 + mlp_params) + tables[0].element_size() * rows * f
    return n_bytes, 2 * n * levels * (25 + 16 * f), n * macs


def _fused_step_fwd_case(gen, device, n: int, field: Field, label: str, points=None):
    """Kernel #5 against the plain step on Morton-sorted points, the last 4
    rows sentinels; the same bytes on two launches (and, at a 2-byte
    `grid_dtype`, those of the kernel on the tables' f32 copies).  Its bound
    counts the heads' layer products at the tensor cores' split-TF32 rate,
    the encode in f32."""
    pts, sh, tables, mlp_d, mlp_c, geometry = _fused_step_inputs(gen, device, n, field, points)
    pts[-4:] = -1.0                                     # sentinel rows
    run = lambda: fs_kernel.fused_step_fwd(pts, sh, *tables, mlp_d, mlp_c,  # noqa: E731
                                           *geometry)
    got = run()
    deterministic = _same_bits(got, run())
    want = list(fs_ref.fused_step_ref(pts[:-4], sh[:-4], *tables, mlp_d, mlp_c, *geometry))
    # a sentinel row reads row 0 at weight 0: its features are exactly zero
    feat = tables[0].shape[0] * tables[0].shape[2]
    zeros = torch.zeros((4, feat), device=device)
    tail = fs_ref.mlp_heads(zeros, zeros, sh[-4:], mlp_d, mlp_c)
    want = [torch.cat([w, t]) for w, t in zip(want, tail)]
    n_bytes, enc_flops, macs = _fused_counts(pts[:-4], tables, mlp_d, mlp_c, geometry)
    n_bytes += 4 * n * (sh.shape[1] + got[0].shape[1] + got[1].shape[1])
    err = _max_err(got, want)
    up = [t.float() for t in tables]
    run_up = lambda: fs_kernel.fused_step_fwd(pts, sh, *up, mlp_d, mlp_c,  # noqa: E731
                                              *geometry)
    return {
        "kernel": "fused_step_fwd", "case": label, "shape": [n, *tables[0].shape],
        "max_abs_err": err, "err": err, "deterministic": deterministic,
        "ms": cuda_ms(run),
        "plain_ms": cuda_ms(lambda: fs_ref.fused_step_ref(pts, sh, *tables, mlp_d, mlp_c,
                                                          *geometry), iters=10),
        "bound": bound(n_bytes, enc_flops, split_tf32_macs=macs),
        **_upcast_fields(tables[0], lambda: _same_bits(got, run_up()), run_up),
    }


def _fused_step_bwd_case(gen, device, n: int, field: Field, label: str,
                         need_color: bool = True, points=None):
    """The backward kernel against the plain backward run on CPU copies (the
    exact stream-order reference); the plain time is the plain backward on
    the card, whose table commits go through bum_scatter.  need_color=False
    is a step with the color grid frozen: no color stream, no color table
    gradient.  At a 2-byte `grid_dtype` the table gradients are held before
    their cast: the kernel's f32 commit (the wrapper on the tables' f32
    copies, whose streams, MLP and SH gradients must be the 2-byte launch's
    bytes, and whose table gradients cast to the dtype must be its output)
    against the plain backward's f32 commit on the same values; the MLP and
    SH gradients against the plain backward on the 2-byte tables."""
    pts, sh, tables, mlp_d, mlp_c, geometry = _fused_step_inputs(gen, device, n, field, points)
    g_d = _uniform(gen, (n, mlp_d["w2"].shape[1]), -1.0, 1.0, device)
    g_c = _uniform(gen, (n, mlp_c["w3"].shape[1]), -1.0, 1.0, device)
    needs = (True, need_color)
    up = [t.float() for t in tables]
    run = lambda: fs_kernel.fused_step_bwd(pts, sh, g_d, g_c, *tables, mlp_d, mlp_c,  # noqa: E731
                                           *geometry, need_color=need_color)
    run_up = lambda: fs_kernel.fused_step_bwd(pts, sh, g_d, g_c, *up, mlp_d, mlp_c,  # noqa: E731
                                              *geometry, need_color=need_color)
    got = run()
    got32 = run_up() if tables[0].dtype != torch.float32 else got
    cpu = lambda t: {k: v.cpu() for k, v in t.items()} if isinstance(t, dict) else t.cpu()  # noqa: E731
    plain_on = lambda ts: fs_ops._plain_backward(  # noqa: E731
        geometry, *(cpu(t) for t in (pts, sh, *ts, mlp_d, mlp_c, g_d, g_c)), needs)
    want = plain_on(tables)
    want32 = plain_on(up) if tables[0].dtype != torch.float32 else want
    grids = [k for k in (0, 1) if needs[k]]
    if not need_color and (got[1] is not None or want[1] is not None):
        raise RuntimeError("fused_step_bwd: a frozen color grid got a gradient")
    table_err = max(_rel_err(got32[k].cpu(), want32[k]) for k in grids)
    rows_same = all(_same_nonzero_rows(got32[k].cpu(), want32[k]) for k in grids)
    mlp_err = max(_rel_err(got[k][name].cpu(), want[k][name])
                  for k in (2, 3) for name in got[k])
    sh_err = _rel_err(got[4].cpu(), want[4])
    abs_err = max([_max_err(got32[k].cpu(), want32[k]) for k in grids] +
                  [_max_err(got[k][name].cpu(), want[k][name])
                   for k in (2, 3) for name in got[k]] + [_max_err(got[4].cpu(), want[4])])
    deterministic = _same_bits([g for g in got if g is not None],
                               [g for g in run() if g is not None])
    n_bytes, enc_flops, macs = _fused_counts(pts, tables, mlp_d, mlp_c, geometry)
    # plus the cotangents and SH read, the gradient tables, MLP gradients and
    # d_sh written once; the backward's work is twice the forward's, on top of
    # the recompute: encode in f32, layer products on the tensor cores
    n_bytes += 4 * (g_d.numel() + g_c.numel() + 2 * sh.numel()
                    + sum(t.numel() for t in list(mlp_d.values()) + list(mlp_c.values())))
    n_bytes += tables[0].element_size() * sum(tables[k].numel() for k in grids)
    plain = lambda: fs_ops._plain_backward(geometry, pts, sh, *tables, mlp_d, mlp_c,  # noqa: E731
                                           g_d, g_c, needs)

    def same_as_upcast():
        """The 2-byte launch's f32 streams, MLP and SH gradients are the f32
        launch's bytes, and its table gradients are the f32 ones cast."""
        launch = lambda ts: fs_kernel.fused_step_bwd_launch(  # noqa: E731
            pts, sh, g_d, g_c, *ts, mlp_d, mlp_c, *geometry, need_color=need_color)
        a, b = launch(tables), launch(up)
        streams = [x for st in a[0].values() if st is not None for x in st]
        streams_up = [x for st in b[0].values() if st is not None for x in st]
        return (_same_bits(streams, streams_up) and _same_bits(a[1:], b[1:])
                and _same_bits(got[2:], got32[2:])
                and all(torch.equal(got[k], got32[k].to(tables[k].dtype)) for k in grids))

    return {
        "kernel": "fused_step_bwd", "case": label, "shape": [n, *tables[0].shape],
        "max_abs_err": abs_err, "err": max(mlp_err, sh_err), "table_rel_err": table_err,
        "nonzero_rows_equal": rows_same, "deterministic": deterministic,
        "ok": rows_same and deterministic and table_err <= BWD_TABLE_TOL
        and max(mlp_err, sh_err) <= TOLERANCE["fused_step_bwd"],
        "ms": cuda_ms(run, iters=20),
        "plain_ms": cuda_ms(plain, iters=5, warmup=2),
        "bound": bound(n_bytes, 3 * enc_flops, split_tf32_macs=3 * macs),
        **_upcast_fields(tables[0], same_as_upcast, run_up),
    }


def _bum_scatter_case(gen, device, n: int, enc, label: str):
    """A dense step's table-gradient stream of one grid: N points x 8 corners
    x L levels, sorted."""
    cfg = enc.cfg
    pts = _uniform(gen, (n, 3), 0.0, 1.0 - 1e-6, device)
    grad = _uniform(gen, (n, cfg.n_levels, cfg.n_features), -1.0, 1.0, device)
    idx, vals = he_ops.corner_updates(pts, enc.resolutions, enc.dense_flags,
                                      cfg.table_size, grad)
    order = torch.sort(idx, stable=True).indices
    return _bum_scatter_stream_case(idx[order].contiguous(), vals[order].contiguous(),
                                    cfg.n_levels * cfg.table_size, label)


def _bum_scatter_stream_case(idx_s, vals_s, rows: int, label: str):
    """Kernel #7 committing a sorted stream into a zero (rows, F) table,
    against the plain merge on CPU copies (exact); `index_add_` of the same
    stream timed beside it (the spill row, if any, clamped into the table)."""
    f = vals_s.shape[1]
    table = torch.zeros((rows, f), device=idx_s.device)
    got = gu_kernel.bum_scatter(table.clone(), idx_s, vals_s)
    want = gu_ref.segment_commit(table.cpu(), idx_s.cpu(), vals_s.cpu())
    exact = bool(torch.equal(got.cpu(), want))
    kept = idx_s < rows
    touched = int(torch.unique(idx_s[kept]).numel())
    m = idx_s.shape[0]
    scratch = table.clone()
    lib_idx = idx_s.clamp(max=rows - 1)
    return {
        "kernel": "bum_scatter", "case": label, "shape": [m, *table.shape],
        "max_abs_err": _max_err(got.cpu(), want), "err": _rel_err(got.cpu(), want),
        "exact": exact, "nonzero_rows_equal": _same_nonzero_rows(got.cpu(), want),
        "ok": exact,
        "ms": cuda_ms(lambda: gu_kernel.bum_scatter(scratch, idx_s, vals_s)),
        "plain_ms": cuda_ms(lambda: gu_ref.segment_commit(table, idx_s, vals_s), iters=10),
        "library_ms": cuda_ms(lambda: scratch.index_add_(0, lib_idx, vals_s)),
        # the stream read once, each touched row read and written once
        "bound": bound(m * (8 + 4 * f) + 2 * 4 * f * touched, int(kept.sum()) * f),
    }


def sort_rows_library(addr, vals):
    """The library calls that compute `bum_sort`'s function: a stable
    `torch.sort` of the keys, then `index_select` of the rows."""
    keys, order = torch.sort(addr, stable=True)
    return keys, vals.index_select(0, order)


def _bum_sort_case(addr, vals, key_bits: int, label: str):
    """The table-gradient sort on one stream against torch.sort's stable
    permutation (exact); the plain radix passes and the library calls
    (`sort_rows_library`: the keys sorted, the rows gathered) timed beside
    it."""
    got = gu_kernel.bum_sort(addr, vals, key_bits)
    order = torch.sort(addr, stable=True).indices
    want = (addr[order], vals[order])
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    m, f = vals.shape
    return {
        "kernel": "bum_sort", "case": label, "shape": [m, f, key_bits],
        "max_abs_err": max(float((got[0] - want[0]).abs().max()), _max_err(got[1], want[1])),
        "exact": exact, "ok": exact,
        "ms": cuda_ms(lambda: gu_kernel.bum_sort(addr, vals, key_bits), iters=20),
        "plain_ms": cuda_ms(lambda: gu_ref.stable_key_sort(addr, vals, key_bits),
                            iters=2, warmup=1),
        "library_ms": cuda_ms(lambda: sort_rows_library(addr, vals), iters=20),
        # the stream read once and written once, sorted
        "bound": bound(2 * m * (8 + 4 * f), 0),
    }


def table_gradient_streams(device, field_cfg: FieldConfig = FieldConfig(),
                           budget: int = TRAIN_BUDGET, dense_points: int = DENSE_POINTS,
                           ngp_points: int = PARITY_BUDGET, seed: int = 0) -> list[tuple]:
    """The three table-gradient streams the training paths sort, as those
    paths make them, each as (label, addr, vals, key_bits): the fused
    backward's streams of a trained Instant-3D step (budget `budget`,
    Morton-ordered points, both grids; keys up to the spill row L*T), a
    dense step's hash-encode backward streams (`dense_points`, both grids)
    and the fused encode's backward stream of an Instant-NGP compacted step
    (`ngp_points`, Morton-ordered)."""
    gen = torch.Generator().manual_seed(seed + 5)
    field = Field(field_cfg)
    levels = field_cfg.n_levels
    pts, sh, tables, mlp_d, mlp_c, geometry = _fused_step_inputs(gen, device, budget, field)
    g_d = _uniform(gen, (budget, mlp_d["w2"].shape[1]), -1.0, 1.0, device)
    g_c = _uniform(gen, (budget, mlp_c["w3"].shape[1]), -1.0, 1.0, device)
    streams, _, _ = fs_kernel.fused_step_bwd_launch(pts, sh, g_d, g_c, *tables, mlp_d, mlp_c,
                                                    *geometry)
    out = [(f"fused_step_bwd {name}, budget {budget}", *streams[name],
            (levels * t.shape[1]).bit_length())
           for name, t in zip(("density", "color"), tables)]
    for name, e in (("density", field.density_enc), ("color", field.color_enc)):
        cfg = e.cfg
        points = _uniform(gen, (dense_points, 3), 0.0, 1.0 - 1e-6, device)
        grad = _uniform(gen, (dense_points, cfg.n_levels, cfg.n_features), -1.0, 1.0, device)
        idx, vals = he_ops.corner_updates(points, e.resolutions, e.dense_flags,
                                          cfg.table_size, grad)
        out.append((f"dense step {name}, N={dense_points}", idx, vals,
                    (cfg.n_levels * cfg.table_size - 1).bit_length()))
    ngp = Field(dataclasses.replace(field_cfg, decomposed=False)).density_enc
    cfg = ngp.cfg
    points = _morton_points(gen, ngp_points, device)
    corners, weights = fp_ref.corner_geometry(points, ngp.resolutions)
    addr = fp_ref.address_stream(
        fp_ref.level_indices(corners, ngp.resolutions, cfg.table_size, ngp.dense_flags),
        cfg.table_size)
    g = _uniform(gen, (ngp_points, cfg.n_levels, cfg.n_features), -1.0, 1.0, device)
    vals = (torch.stack(weights)[:, :, :, None] * g.permute(1, 0, 2)[:, :, None, :]
            ).reshape(-1, cfg.n_features)
    out.append((f"fused_encode bwd NGP, N={ngp_points}", addr, vals,
                (cfg.n_levels * cfg.table_size - 1).bit_length()))
    return out


def _morton_points(gen, n: int, device):
    pts = _uniform(gen, (n, 3), 0.0, 1.0 - 1e-6, device)
    return pts[torch.sort(fp_ref.morton_key(pts), stable=True).indices].contiguous()


def _fused_encode_case(gen, device, n: int, enc, label: str, n_sentinel: int = 0,
                       dtype=torch.float32):
    """Kernel #8 against the plain fused encode on Morton-sorted points, the
    last `n_sentinel` rows sentinels; its distinct reads per (block, level)
    against the plain count on the valid rows, and its block dedup ratio
    against `dedup_stats`; the same bytes on two launches.  The tables are
    drawn in f32 and cast to `dtype` (`_upcast_fields`)."""
    cfg = enc.cfg
    res, dense = enc.resolutions, enc.dense_flags
    pts = _morton_points(gen, n, device)
    if n_sentinel:
        pts[n - n_sentinel:] = -1.0
    tables = _uniform(gen, (cfg.n_levels, cfg.table_size, cfg.n_features), -1.0, 1.0,
                      device).to(dtype)
    run = lambda: fp_kernel.fused_encode(pts, tables, res, dense)  # noqa: E731
    got, reads = run()
    want = fp_ref.fused_encode(pts, tables, res, dense)
    n_valid = n - n_sentinel
    valid = pts[:n_valid]
    corners, _ = fp_ref.corner_geometry(valid, res)
    plain_reads = fp_ref.block_distinct_reads(
        fp_ref.level_indices(corners, res, cfg.table_size, dense)).cpu()
    reads64 = reads.cpu().to(torch.int64)
    nb = plain_reads.shape[0]
    stats = fp_ref.dedup_stats(valid, res, dense, cfg.table_size)
    ratio = fp_ref.unique_ratio_block(reads64[:nb], n_valid)
    dedup = {
        "reads_kernel": int(reads64.sum()), "reads_plain": stats["unique_reads_block"],
        "per_block_equal": bool(torch.equal(reads64[:nb], plain_reads)
                                and not reads64[nb:].any()),
        "unique_ratio_block_kernel": ratio, "unique_ratio_block_plain":
            stats["unique_ratio_block"],
        "unique_ratio_global": stats["unique_ratio_global"],
    }
    dedup["ok"] = (dedup["per_block_equal"]
                   and dedup["reads_kernel"] == dedup["reads_plain"]
                   and abs(ratio - stats["unique_ratio_block"]) <= DEDUP_RATIO_TOL)
    err = _max_err(got, want)
    sentinel_zero = not got[n_valid:].any()
    f = cfg.n_features
    n_bytes = (4 * (n * 3 + n * cfg.n_levels * f)
               + tables.element_size() * stats["unique_reads_global"] * f)
    n_flops = n_valid * cfg.n_levels * 8 * f * 2
    up = tables.float()
    run_up = lambda: fp_kernel.fused_encode(pts, up, res, dense)  # noqa: E731
    return {
        "kernel": "fused_encode", "case": label, "shape": [n, *tables.shape],
        "max_abs_err": err, "dedup": dedup, "sentinel_rows_zero": sentinel_zero,
        "deterministic": _same_bits((got, reads), run()),
        "ok": err <= TOLERANCE["fused_encode"] and dedup["ok"] and sentinel_zero,
        "ms": cuda_ms(run),
        "plain_ms": cuda_ms(lambda: fp_ref.fused_encode(pts, tables, res, dense), iters=10),
        "bound": bound(n_bytes, n_flops),
        **_upcast_fields(tables, lambda: _same_bits((got, reads), run_up()), run_up),
    }


def fused_encode_backward_identity(device, field_cfg: FieldConfig = FieldConfig(),
                                   n: int = PARITY_BUDGET, seed: int = 0) -> dict:
    """For one fixed upstream gradient, the fused encode's table gradients
    (its recompute backward, presorted through bum_scatter) against the
    hash encode's backward: bit for bit, for every grid of the field."""
    gen = torch.Generator().manual_seed(seed + 2)
    field = Field(field_cfg)
    pts = _morton_points(gen, n, device)
    encs = [field.density_enc] + ([field.color_enc] if field_cfg.decomposed else [])
    tables = [_uniform(gen, (e.cfg.n_levels, e.cfg.table_size, e.cfg.n_features), -1.0, 1.0,
                       device).requires_grad_(True) for e in encs]
    g_outs = [_uniform(gen, (n, e.cfg.out_dim), -1.0, 1.0, device) for e in encs]

    def grads(outs):
        loss = sum((o * g).sum() for o, g in zip(outs, g_outs))
        return torch.autograd.grad(loss, tables)

    fused_outs = field._fused_encode(pts, *tables)
    he_outs = [he_ops.hash_encode(pts, t, e.resolutions, e.dense_flags)
               for t, e in zip(tables, encs)]
    got, want = grads(fused_outs), grads(he_outs)
    return {
        "grids": ["density", "color"][:len(encs)], "n": n,
        "bit_identical": [bool(torch.equal(a, b)) for a, b in zip(got, want)],
        "nonzero_rows": [int(b.reshape(-1, b.shape[-1]).ne(0).any(dim=-1).sum())
                         for b in want],
        "forward_max_abs_err": _max_err(fused_outs, he_outs),
    }


def kernel_parity(device, field_cfg: FieldConfig = FieldConfig(),
                  render_cfg: RenderConfig = RenderConfig(), seed: int = 0) -> list[dict]:
    """Every kernel against its plain version at the main path's shapes:
    N = chunk * S' (redistributed) and chunk * S (dense) field points."""
    gen = torch.Generator().manual_seed(seed)
    field = Field(field_cfg)
    s = render_cfg.n_samples
    s_red = default_samples_per_ray(s)
    n_red, n_dense = EVAL_CHUNK * s_red, EVAL_CHUNK * s
    enc_dim = field.density_enc.cfg.out_dim
    cases = []
    for n in (n_red, n_dense):
        cases.append(_hash_encode_case(gen, device, n, field.density_enc,
                                       f"density grid, N={n}"))
        cases.append(_hash_encode_case(gen, device, n, field.color_enc,
                                       f"color grid, N={n}"))
    h = field_cfg.hidden
    cases.append(_mlp_case(gen, device, n_red, (enc_dim, h, 1 + field_cfg.geo_features),
                           f"density head, N={n_red}"))
    cases.append(_mlp_case(gen, device, n_red, (enc_dim + field.sh_dim, h, h, 3),
                           f"color head, N={n_red}"))
    cases.append(_mlp_case(gen, device, PARITY_BUDGET,
                           (field_cfg.geo_features + field.sh_dim, h, h, 3),
                           f"NGP color head, N={PARITY_BUDGET}"))
    for r, spr, label in ((TRAIN_RAYS, s, "training"), (EVAL_CHUNK, s_red, "redistributed"),
                          (EVAL_CHUNK, s, "dense")):
        cases.append(_composite_case(gen, device, r, spr, f"{label}, {r} x {spr}"))
        cases.append(_composite_bwd_case(gen, device, r, spr, f"{label}, {r} x {spr}"))
    cases.extend(train_kernel_parity(device, field_cfg, seed=seed))
    streams = table_gradient_streams(device, field_cfg, seed=seed)
    cases.extend(_bum_sort_case(addr, vals, bits, label) for label, addr, vals, bits in streams)
    cases.extend(commit_stream_parity(streams, field_cfg))
    cases.extend(main_shape_parity(device, field_cfg, render_cfg, seed=seed))
    return cases


def commit_stream_parity(streams, field_cfg: FieldConfig = FieldConfig()) -> list[dict]:
    """Kernel #7 on the commit streams of the training paths' backward
    kernels (`table_gradient_streams`), each sorted as those paths sort it
    (`bum_sort`): #6's two grids' streams of a trained Instant-3D step (into
    L*T_D and L*T_C rows, the spill row L*T dropped) and #8's backward
    stream of an Instant-NGP compacted step (into L*T_D rows).  The dense
    steps' streams are `train_kernel_parity`'s cases."""
    levels = field_cfg.n_levels
    rows = {"density": levels << field_cfg.log2_table_density,
            "color": levels << field_cfg.log2_table_color,
            "NGP": levels << field_cfg.log2_table_density}
    cases = []
    for label, addr, vals, bits in streams:
        if label.startswith("dense step"):
            continue
        grid = next(k for k in rows if k in label)
        idx_s, vals_s = gu_kernel.bum_sort(addr, vals, bits)
        cases.append(_bum_scatter_stream_case(idx_s, vals_s, rows[grid], f"{label}, commit"))
    return cases


def main_shape_parity(device, field_cfg: FieldConfig = FieldConfig(),
                      render_cfg: RenderConfig = RenderConfig(), seed: int = 0,
                      budget: int = TRAIN_BUDGET) -> list[dict]:
    """The redesigned kernels at their main paths' own shapes: hash_encode
    on a served chunk's ray-ordered points (`serving_points`) on both grids,
    dense (chunk x S) and redistributed (chunk x S'); fused_mlp2 and
    fused_mlp3 at the dense serving chunk; the fused step forward and the
    fused backward at a trained Instant-3D step's budget on Morton-ordered
    points, the backward with both grids and with the color grid frozen."""
    gen = torch.Generator().manual_seed(seed + 3)
    field = Field(field_cfg)
    h = field_cfg.hidden
    s, s_red = render_cfg.n_samples, default_samples_per_ray(render_cfg.n_samples)
    n_dense = EVAL_CHUNK * s
    enc_dim = field.density_enc.cfg.out_dim
    cases = []
    for s_chunk, spr in ((s, None), (s_red, s_red)):
        pts = serving_points(device, render_cfg, samples_per_ray=spr)
        for name, e in (("density", field.density_enc), ("color", field.color_enc)):
            cases.append(_hash_encode_case(gen, device, pts.shape[0], e,
                                           f"{name} grid, rays x {s_chunk}", points=pts))
    return cases + [
        _mlp_case(gen, device, n_dense, (enc_dim, h, 1 + field_cfg.geo_features),
                  f"density head, N={n_dense}"),
        _mlp_case(gen, device, n_dense, (enc_dim + field.sh_dim, h, h, 3),
                  f"color head, N={n_dense}"),
        _fused_step_fwd_case(gen, device, budget, field, f"budget {budget}"),
        _fused_step_bwd_case(gen, device, budget, field, f"budget {budget}"),
        _fused_step_bwd_case(gen, device, budget, field, f"budget {budget}, color frozen",
                             need_color=False),
    ]


def fused_step_bwd_breakdown(device, n: int, field_cfg: FieldConfig = FieldConfig(),
                             seed: int = 0) -> dict:
    """Where the fused backward's time goes at N points (Morton-ordered):
    the whole wrapper, the kernel launch alone (pass 1, through ctypes), the
    wrapper's commit alone (bum_sort, zero fill and bum_scatter for both
    grids), of it the two sorts alone (`sort_ms`; torch.sort's stable sort
    of the same keys, the library call, as `library_sort_ms`) and the two
    bum_scatter launches alone, and the wrapper with no table gradient at
    all (no streams), each by CUDA events."""
    gen = torch.Generator().manual_seed(seed + 4)
    field = Field(field_cfg)
    pts, sh, tables, mlp_d, mlp_c, geometry = _fused_step_inputs(gen, device, n, field)
    g_d = _uniform(gen, (n, mlp_d["w2"].shape[1]), -1.0, 1.0, device)
    g_c = _uniform(gen, (n, mlp_c["w3"].shape[1]), -1.0, 1.0, device)
    args = (pts, sh, g_d, g_c, *tables, mlp_d, mlp_c, *geometry)
    launch = lambda: fs_kernel.fused_step_bwd_launch(*args)  # noqa: E731
    streams, _, _ = launch()
    levels, _, f = tables[0].shape
    grids = [(streams[name], (levels * t.shape[1]).bit_length(), t)
             for name, t in zip(("density", "color"), tables)]
    commit = lambda: [fs_kernel._commit(*stream, levels, t.shape[1], f)  # noqa: E731
                      for stream, _, t in grids]
    sort = lambda: [gu_kernel.bum_sort(*stream, bits) for stream, bits, _ in grids]  # noqa: E731
    library_sort = lambda: [torch.sort(stream[0], stable=True)  # noqa: E731
                            for stream, _, _ in grids]
    ordered = [(torch.zeros((levels * t.shape[1], f), device=device),
                *gu_kernel.bum_sort(*stream, bits)) for stream, bits, t in grids]
    scatter = lambda: [gu_kernel.bum_scatter(*o) for o in ordered]  # noqa: E731
    return {
        "n": n, "stream_entries": int(streams["density"][0].numel()),
        "total_ms": cuda_ms(lambda: fs_kernel.fused_step_bwd(*args), iters=20),
        "launch_ms": cuda_ms(launch, iters=20),
        "commit_ms": cuda_ms(commit, iters=20),
        "sort_ms": cuda_ms(sort, iters=20),
        "library_sort_ms": cuda_ms(library_sort, iters=20),
        "scatter_ms": cuda_ms(scatter, iters=20),
        "no_streams_ms": cuda_ms(lambda: fs_kernel.fused_step_bwd(
            *args, need_density=False, need_color=False), iters=20),
    }


def train_kernel_parity(device, field_cfg: FieldConfig = FieldConfig(),
                        budget: int = PARITY_BUDGET, dense_points: int = DENSE_POINTS,
                        seed: int = 0) -> list[dict]:
    """The training slices' kernels at the training paths' shapes: the fused
    encode at a compacted step's budget on each grid and at a padded size,
    the fused step forward and backward at that budget, and bum_scatter on
    a dense step's stream of each grid."""
    gen = torch.Generator().manual_seed(seed + 1)
    field = Field(field_cfg)
    return [
        _fused_encode_case(gen, device, budget, field.density_enc,
                           f"density grid, N={budget}"),
        _fused_encode_case(gen, device, budget, field.color_enc, f"color grid, N={budget}"),
        _fused_encode_case(gen, device, PADDED_POINTS, field.density_enc,
                           f"density, N={PADDED_POINTS} ({SENTINEL_ROWS} sentinel)",
                           n_sentinel=SENTINEL_ROWS),
        _fused_step_fwd_case(gen, device, budget, field, f"budget {budget}"),
        _fused_step_bwd_case(gen, device, budget, field, f"budget {budget}"),
        _bum_scatter_case(gen, device, dense_points, field.density_enc,
                          f"density grid, N={dense_points}"),
        _bum_scatter_case(gen, device, dense_points, field.color_enc,
                          f"color grid, N={dense_points}"),
    ]


# ---- phase 3: the served main path ---------------------------------------------

def make_snapshot_store(device, field_cfg: FieldConfig, occ_cfg, seed: int = 0):
    """A store holding one snapshot for each of the sessions "redist" and
    "dense": `Field.init` params (Generator seed) and one occupancy update."""
    gen = torch.Generator().manual_seed(seed)
    field = Field(field_cfg)
    params = field.init(gen, device)
    state = occupancy.update(field, params, occupancy.init_state(occ_cfg, device),
                             occ_cfg, generator=gen)
    return snapshot_store(params, state)


def make_service(store, device, field_cfg, render_cfg, occ_cfg, hw: int,
                 eval_chunk: int) -> RenderService:
    svc = RenderService(store, device=device)
    focal = focal_for(hw)
    svc.register_session("redist", field_cfg, render_cfg, hw, hw, focal,
                         eval_chunk=eval_chunk, occ_cfg=occ_cfg,
                         samples_per_ray=default_samples_per_ray(render_cfg.n_samples))
    svc.register_session("dense", field_cfg, render_cfg, hw, hw, focal,
                         eval_chunk=eval_chunk)
    return svc


def serve_requests(svc: RenderService, hw: int, n_requests: int, seed: int = 0) -> list:
    """Submit n_requests full-resolution views, alternating sessions, plus
    one level-1 preview; drain and check every answer."""
    poses = sphere_poses(max(n_requests, 1), seed=seed)
    for i in range(n_requests):
        svc.submit(("redist", "dense")[i % 2], poses[i])
    svc.submit("redist", poses[0], level=1)
    results = svc.drain()
    check_results(results, svc, hw, n_requests + 1)
    return results


def check_results(results, svc: RenderService, hw: int, expected: int) -> None:
    """Every answer is a finite hw x hw image at its level (hw >> level),
    with colors in [0, 1] (white background: sum w*rgb + 1 - sum w)."""
    if len(results) != expected or svc.pending:
        raise RuntimeError(f"served {len(results)} of {expected} requests, "
                           f"{svc.pending} pending")
    for r in results:
        if not isinstance(r, RenderResult):
            raise RuntimeError(f"request {r.request_id} failed: {r.error}")
        side = max(1, hw >> r.level)
        shape = (side, side, 3)
        if r.rgb.shape != shape or r.depth.shape != shape[:2]:
            raise RuntimeError(f"request {r.request_id}: rgb {r.rgb.shape}, "
                               f"depth {r.depth.shape}, expected {shape}")
        if not (np.isfinite(r.rgb).all() and np.isfinite(r.depth).all()):
            raise RuntimeError(f"request {r.request_id}: non-finite pixels")
        if r.rgb.min() < -1e-5 or r.rgb.max() > 1 + 1e-5:
            raise RuntimeError(f"request {r.request_id}: rgb outside [0, 1]: "
                               f"[{r.rgb.min()}, {r.rgb.max()}]")


def path_parity(store, device, field_cfg, render_cfg, occ_cfg, hw: int = 32,
                eval_chunk: int = 256) -> dict:
    """The served path on `device` against the same service on the CPU
    (plain versions), both sessions, one small view each."""
    out = {}
    pose = sphere_poses(1, seed=1)[0]
    answers = []
    for dev in (device, "cpu"):
        svc = make_service(store, dev, field_cfg, render_cfg, occ_cfg, hw, eval_chunk)
        for sid in ("redist", "dense"):
            svc.submit(sid, pose)
        answers.append(svc.drain())
        check_results(answers[-1], svc, hw, 2)
    for got, want in zip(*answers):
        out[got.session_id] = {
            "rgb_max_abs_err": float(np.abs(got.rgb - want.rgb).max()),
            "depth_max_abs_err": float(np.abs(got.depth - want.depth).max()),
        }
    return out


# ---- phase 3: the training main path -------------------------------------------

def train_main_path(device, field_cfg: FieldConfig = FieldConfig(),
                    cfg: TrainerConfig = TrainerConfig(), dataset: dict | None = None,
                    held_out: int = HELD_OUT):
    """Build the synthetic scene, train `cfg.iters` steps on all but the first
    `held_out` views, evaluate those.  Launch counters are zeroed just before
    the run and read just after (evaluation included).  Returns a dict with
    the trainer, final state, history (every step logged), held-out PSNR,
    launches and the per-route step times."""
    _, ds = build_dataset(0, device=device, **(dataset or {}))
    views = range(held_out, ds.images.shape[0])
    sampler = RaySampler(ds, views=views, device=device)
    trainer = Instant3DTrainer(Field(field_cfg), cfg, device=device)
    state = trainer.init()
    kernels.reset_launches()
    state, hist = trainer.train(state, sampler, log_every=1)
    evaluation = trainer.evaluate(state.params, ds, views=range(held_out))
    if device != "cpu" and torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # wall_s is read after each step's loss reached the host: its differences
    # are step times
    walls = np.diff(np.asarray([0.0] + hist["wall_s"])) * 1e3
    dense = [w for w, b in zip(walls, hist["budget"]) if b is None]
    compact = [w for w, b in zip(walls, hist["budget"]) if b is not None]
    return {"trainer": trainer, "state": state, "hist": hist, "ds": ds,
            "eval": evaluation, "launches": launches,
            "dense_ms": dense, "compact_ms": compact}


def check_training(run: dict, kernels_of_path=TRAIN_KERNELS,
                   min_psnr: float = MIN_PSNR_DB) -> list[str]:
    """What the training gate refuses: no step of a route, a non-finite
    loss, held-out PSNR under `min_psnr`, a kernel of the path never
    launched, or a kernel that is not on the path launched.
    kernels_of_path = (must launch, must not launch)."""
    hist, problems = run["hist"], []
    if not run["dense_ms"]:
        problems.append("no dense steps")
    if not run["compact_ms"]:
        problems.append("no compacted steps")
    if not all(np.isfinite(hist["loss"])):
        problems.append("non-finite loss")
    if not run["eval"]["psnr_rgb"] >= min_psnr:
        problems.append(f"held-out PSNR {run['eval']['psnr_rgb']:.2f} dB < {min_psnr}")
    must, must_not = kernels_of_path
    missing = [k for k in must if run["launches"].get(k, 0) == 0]
    if missing:
        problems.append(f"training never launched {missing}")
    stray = [k for k in must_not if run["launches"].get(k, 0) != 0]
    if stray:
        problems.append(f"training launched {stray}, which are not on its path")
    return problems


def _bits(tree) -> list[bytes]:
    """Every leaf's raw bytes, in key order."""
    return [t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
            for _, t in tree_paths(tree)]


def determinism(device, field_cfg: FieldConfig = FieldConfig(),
                cfg: TrainerConfig = TrainerConfig(), steps=DETERMINISM_STEPS,
                dataset: dict | None = None, held_out: int = HELD_OUT) -> dict:
    """Two runs from one seed, compared after each step count in `steps`
    (ascending; each run trains on from one count to the next): params,
    Adam moments and occupancy EMA must be byte-identical at every one."""
    _, ds = build_dataset(0, device=device, **(dataset or {}))
    sampler = RaySampler(ds, views=range(held_out, ds.images.shape[0]), device=device)
    trainers = [Instant3DTrainer(Field(field_cfg), cfg, device=device) for _ in range(2)]
    states = [t.init() for t in trainers]
    out = {"steps": list(steps), "params_equal": True, "moments_equal": True,
           "occupancy_equal": True, "compacted_steps": 0}
    for n in steps:
        for k, trainer in enumerate(trainers):
            states[k], hist = trainer.train(states[k], sampler, iters=n - states[k].step,
                                            log_every=1)
        out["compacted_steps"] += sum(b is not None for b in hist["budget"])
        a, b = states
        out["params_equal"] &= _bits(a.params) == _bits(b.params)
        out["moments_equal"] &= (_bits(a.opt_state.m) == _bits(b.opt_state.m)
                                 and _bits(a.opt_state.v) == _bits(b.opt_state.v))
        out["occupancy_equal"] &= _bits({"e": a.occ_state.density_ema}) == _bits(
            {"e": b.occ_state.density_ema})
    return out


def split_route_parity(device, run: dict, held_out: int = HELD_OUT) -> dict:
    """One compacted step on the trained Instant-3D state: the split route
    (`fused_step=False`: the fused encode, then the MLP heads) against the
    one-op fused step, same params, batch, bitfield and budget.  Returns the
    relative errors (max abs error over the one-op step's largest |value|)
    and whether the same table rows carry a nonzero gradient."""
    one_op = run["trainer"]
    cfg, state = one_op.cfg, run["state"]
    split = Instant3DTrainer(Field(one_op.field.cfg),
                             dataclasses.replace(cfg, fused_step=False), device=device)
    sampler = RaySampler(run["ds"], views=range(held_out, run["ds"].images.shape[0]),
                         device=device)
    ray_idx, u_ts, _ = default_draws(cfg, sampler.n)(state.step)
    batch = sampler.gather(ray_idx)
    ts = sample_ts(None, cfg.n_rays, cfg.render, device, u=u_ts)
    budget = one_op._current_budget(use_bits=True)
    if budget is None:
        raise RuntimeError("the trained state's budget is the dense route")
    kw = dict(freeze_color=False, freeze_density=False, budget=budget, use_bits=True)
    ema = state.occ_state.density_ema
    kernels.reset_launches()
    _, want, _ = one_op.loss_and_grads(state.params, batch, ts, ema, **kw)
    one_op_launches = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    _, got, _ = split.loss_and_grads(state.params, batch, ts, ema, **kw)
    split_launches = dict(kernels.LAUNCHES)
    out = {"budget": budget, "table_rel_err": 0.0, "mlp_rel_err": 0.0,
           "nonzero_rows_equal": True,
           "fused_encode_launches": split_launches["fused_encode"],
           "fused_step_launches": [one_op_launches["fused_step_fwd"],
                                   split_launches["fused_step_fwd"]]}
    want = dict(tree_paths(want))
    for path, g in tree_paths(got):
        w = want[path]
        if path[0].endswith("grid"):
            out["table_rel_err"] = max(out["table_rel_err"], _rel_err(g, w))
            out["nonzero_rows_equal"] &= _same_nonzero_rows(g, w)
        else:
            out["mlp_rel_err"] = max(out["mlp_rel_err"], _rel_err(g, w))
    out["ok"] = (out["table_rel_err"] <= SPLIT_TABLE_TOL and out["mlp_rel_err"] <= SPLIT_MLP_TOL
                 and out["nonzero_rows_equal"])
    return out


def snapshot_store(params, occ_state) -> SnapshotStore:
    """A store holding one snapshot of `params` and `occ_state` for each of
    the sessions "redist" and "dense"."""
    store = SnapshotStore()
    for sid in ("redist", "dense"):
        store.publish(sid, params, step=1, occ=occ_state)
    return store


# ---- phase 5: the reconstruction service ---------------------------------------

def service_datasets(device, dataset: dict | None = None, n: int = SERVICE_SCENES) -> list:
    return [build_dataset(k, device=device, **(dataset or {}))[1] for k in range(n)]


def service_main_path(device, datasets: list, persist_dir: str,
                      cfg: TrainerConfig = TrainerConfig(),
                      plan=((FieldConfig(decomposed=False), NGP_SERVICE_ITERS),)
                      + ((FieldConfig(), SERVICE_ITERS),) * 3,
                      slice_iters: int = SERVICE_SLICE,
                      render_steps=SERVICE_RENDER_STEPS, held_out: int = HELD_OUT,
                      async_serving: bool = False, devices=None) -> dict:
    """`ReconstructionService(guard=True, persist_dir=...)` trains one
    session per (field config, steps) of `plan` on `datasets` (all but the
    first `held_out` views), answers renders asked from the run hook after
    the quanta ending at `render_steps` and one a scene after the run, then
    evaluates each scene on its held-out views.  Launch counters are zeroed
    just before the run and read just after the last render.  The run is
    traced (`repro_torch.obs`): `spans` sums each span name's wall time,
    `slice_ms` lists every training slice's.  With `async_serving` the
    renders asked mid-training are served by the serving thread, and
    `snapshots` keeps every full snapshot the hook saw, by (session,
    version) -- the store keeps only the latest.  `asked` maps each request
    id to its (session, pose).  With `devices` the sessions are placed
    (`ReconstructionService(devices=...)`): `loads` are the slot loads once
    every scene is submitted, `slice_spans` every slice's (thread, start,
    end) in microseconds and `render_groups` every render group's span
    arguments (device, sessions)."""
    svc = ReconstructionService(slice_iters=slice_iters, guard=True,
                                persist_dir=persist_dir, async_serving=async_serving,
                                devices=devices, device=device)
    for k, (ds, (field_cfg, iters)) in enumerate(zip(datasets, plan)):
        svc.submit_scene(ds, field_cfg, cfg, target_iters=iters, seed=k,
                         train_views=range(held_out, ds.images.shape[0]))
    loads = svc.placement.loads() if svc.placement is not None else None
    poses = sphere_poses(8, seed=123)
    cohorts, answers, asked, snapshots = [], [], {}, {}

    def hook(s, event):
        # a quantum trains one cohort a slot: count each slot's
        cohorts.extend(Counter(s.sessions[sid].device_slot for sid in event["cohort"]).values())
        if async_serving:
            for sid in s.sessions:
                snap = s.store.latest(sid, level=0)
                if snap is not None:
                    snapshots.setdefault((sid, snap.version), snap)
        for sid in event["cohort"]:
            if s.sessions[sid].step in render_steps:
                pose = poses[len(asked) % len(poses)]
                asked[s.request_render(sid, pose)] = (sid, pose)
        answers.extend(event["results"])

    traced = obs_trace.enabled()
    obs_trace.set_enabled(True)
    obs_trace.clear()
    kernels.reset_launches()
    try:
        telemetry = svc.run(hook=hook)
        spans: dict = {}
        slice_ms, slice_spans, render_groups = [], [], []
        for e in obs_trace.events():
            if e.dur_us is not None:
                tot = spans.setdefault(e.name, {"ms": 0.0, "count": 0})
                tot["ms"] += e.dur_us / 1e3
                tot["count"] += 1
                if e.name == "serve3d/slice":
                    slice_ms.append(e.dur_us / 1e3)
                    slice_spans.append((e.thread_name, e.ts_us, e.ts_us + e.dur_us))
                elif e.name == "serve3d/render_group":
                    render_groups.append(e.args)
    finally:
        obs_trace.set_enabled(traced)
        obs_trace.clear()
    for k, sid in enumerate(svc.sessions):
        asked[svc.request_render(sid, poses[-1 - k])] = (sid, poses[-1 - k])
    answers.extend(svc.renderer.drain())
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    evals = {sid: s.evaluate(views=range(held_out)) for sid, s in svc.sessions.items()}
    return {"service": svc, "telemetry": telemetry, "spans": spans, "slice_ms": slice_ms,
            "slice_spans": slice_spans, "render_groups": render_groups, "loads": loads,
            "render": svc.renderer.latency_stats(), "cohorts": cohorts,
            "answers": answers, "asked": asked, "snapshots": snapshots,
            "launches": launches, "evals": evals,
            "expected_renders": len(svc.sessions) * (len(render_steps) + 1)}


def check_service(run: dict, must_launch=tuple(KERNELS), cohorts=SERVICE_COHORTS,
                  min_psnr: float = MIN_PSNR_DB) -> list[str]:
    """What the service gate refuses: a session not DONE, a render not
    answered with a `RenderResult`, other cohort sizes than `cohorts`, a
    kernel of `must_launch` never launched, held-out PSNR under
    `min_psnr` or a non-finite one."""
    svc, problems = run["service"], []
    not_done = {sid: s.status for sid, s in svc.sessions.items() if s.status != DONE}
    if not_done:
        problems.append(f"sessions not done: {not_done}")
    bad = [r for r in run["answers"] if not isinstance(r, RenderResult)]
    ids = sorted(r.request_id for r in run["answers"])
    if bad or len(ids) != run["expected_renders"] or svc.renderer.pending \
            or ids != sorted(run["asked"]):
        problems.append(f"renders: {len(ids)} answered of {run['expected_renders']} "
                        f"(each asked once: {ids == sorted(run['asked'])}), errors {bad}, "
                        f"{svc.renderer.pending} pending")
    if set(run["cohorts"]) != set(cohorts):
        problems.append(f"cohort sizes {sorted(set(run['cohorts']))}, expected {sorted(cohorts)}")
    missing = [k for k in must_launch if run["launches"].get(k, 0) == 0]
    if missing:
        problems.append(f"the service never launched {missing}")
    low = {sid: e["psnr_rgb"] for sid, e in run["evals"].items()
           if not e["psnr_rgb"] >= min_psnr}
    if low:
        problems.append(f"held-out PSNR under {min_psnr} dB: {low}")
    return problems


def _state_equal(a, b) -> dict:
    """torch.equal on every leaf of params, both Adam moments and the
    occupancy EMA; the steps and fold counts equal too."""
    def same(x, y):
        return all(torch.equal(u, v) for (_, u), (_, v) in zip(tree_paths(x), tree_paths(y)))
    return {"params": same(a.params, b.params),
            "adam_m": same(a.opt_state.m, b.opt_state.m),
            "adam_v": same(a.opt_state.v, b.opt_state.v),
            "occupancy_ema": torch.equal(a.occ_state.density_ema, b.occ_state.density_ema),
            "steps": (a.step, a.occ_state.step, int(a.opt_state.step))
            == (b.step, b.occ_state.step, int(b.opt_state.step))}


def service_identity(device, datasets: list, ckpt_dir: str,
                     field_cfg: FieldConfig = FieldConfig(),
                     cfg: TrainerConfig = TrainerConfig(), iters: int = IDENTITY_ITERS,
                     suspend_at=SUSPEND_AT, fault_at: int = FAULT_AT,
                     slice_iters: int = SERVICE_SLICE, held_out: int = HELD_OUT) -> dict:
    """The four bit-identity contracts on `device`, each against plain
    `train` runs of scenes 0 and 1 (seeds 0 and 1, all but the first
    `held_out` views):

    * cohort == sequential: `train_cohort` of both scenes;
    * suspend / resume: a `SceneSession` of scene 0 suspended to disk at
      each step of `suspend_at` and resumed by a fresh session;
    * guard rollback: a service whose scene-0 session gets NaN params on
      the slice starting at `fault_at` ends equal, with one ``rolled_back``;
    * eval == served: that session's `render_image` on the served
      quadrature equals the service's answer for the same pose."""
    views = range(held_out, datasets[0].images.shape[0])

    def fresh(k):
        tr = Instant3DTrainer(Field(field_cfg), cfg, device=device)
        return (tr, tr.init(torch.Generator().manual_seed(k)),
                RaySampler(datasets[k], views=views, device=device))

    seq = []
    for k in (0, 1):
        tr, st, sampler = fresh(k)
        seq.append(tr.train(st, sampler, iters=iters, log_every=iters))
    trs, sts, samplers = zip(*(fresh(k) for k in (0, 1)))
    cohort, hists = train_cohort(list(trs), list(sts), list(samplers), iters=iters,
                                 log_every=1)
    out = {"iters": iters,
           "compacted_steps": sum(b is not None for b in hists[0]["budget"]),
           "folds": hists[0]["occ_folds"],
           "cohort_vs_sequential": [_state_equal(seq[k][0], cohort[k]) for k in (0, 1)]}

    def session():
        return SceneSession("scene-000", datasets[0], field_cfg, cfg, iters, seed=0,
                            ckpt_dir=ckpt_dir, train_views=views, device=device)

    sess = session()
    sess.start()
    for at in suspend_at:
        sess.run_slice(at - sess.step)
        sess.suspend(block=True)
        sess = session()
        sess.resume()
    sess.run_slice(iters - sess.step)
    out["suspend_resume"] = {"at": list(suspend_at), **_state_equal(seq[0][0], sess.state)}

    faults.configure(enabled=True)
    faults.inject("serve3d.slice", "nan_params", session="scene-000", at_step=fault_at)
    try:
        svc = ReconstructionService(slice_iters=slice_iters, guard=True, device=device)
        svc.submit_scene(datasets[0], field_cfg, cfg, target_iters=iters, seed=0,
                         train_views=views)
        verdicts = []
        svc.run(hook=lambda _s, ev: verdicts.extend(ev["guard"].values()))
        fired = faults.fired_count("nan_params")
    finally:
        faults.reset()
        faults.configure(enabled=False)
    guarded = svc.sessions["scene-000"]
    out["guard_rollback"] = {"fired": fired, "rolled_back": verdicts.count("rolled_back"),
                             "events": svc.guard.session_events("scene-000"),
                             **_state_equal(seq[0][0], guarded.state)}

    pose = sphere_poses(1, seed=7)[0]
    rid = svc.request_render("scene-000", pose)
    served = {r.request_id: r for r in svc.renderer.drain()}[rid]
    rgb, depth = guarded.trainer.render_image(guarded.state.params, pose, datasets[0],
                                              occ=guarded._current_occ(),
                                              samples_per_ray=guarded.render_spr)
    out["eval_vs_served"] = {"samples_per_ray": guarded.render_spr,
                             "rgb": bool(np.array_equal(rgb, served.rgb)),
                             "depth": bool(np.array_equal(depth, served.depth))}
    return out


def identity_holds(ident: dict) -> bool:
    def ok(d):
        return all(v for k, v in d.items() if k in ("params", "adam_m", "adam_v",
                                                     "occupancy_ema", "steps"))
    return (all(ok(d) for d in ident["cohort_vs_sequential"])
            and ok(ident["suspend_resume"])
            and ok(ident["guard_rollback"]) and ident["guard_rollback"]["fired"] == 1
            and ident["guard_rollback"]["rolled_back"] == 1
            and ident["eval_vs_served"]["rgb"] and ident["eval_vs_served"]["depth"]
            and ident["compacted_steps"] > 0 and len(ident["folds"]) >= 2)


def _print_service(run: dict, card: str) -> None:
    tel = run["telemetry"]
    print(f"service: {len(tel['sessions'])} scenes in {tel['wall_s']:.3f} s, "
          f"scenes/s {tel['scenes_per_sec']:.4f}, quanta {len(run['cohorts'])}, "
          f"cohort sizes {dict(sorted(Counter(run['cohorts']).items()))} [{card}]")
    for p in tel["sessions"]:
        slices = len(run["service"].sessions[p["session_id"]].telemetry["step"])
        print(f"  {p['session_id']}: {p['status']} step {p['step']}/{p['target_iters']} "
              f"loss {p['loss']:.6f} train wall {p['train_wall_s']:.3f} s over {slices} "
              f"slices ({p['train_wall_s'] / max(slices, 1) * 1e3:.1f} ms a slice) "
              f"held-out {json.dumps(run['evals'][p['session_id']])} [{card}]")
    print(f"service telemetry [{card}]: " + json.dumps(
        {k: v for k, v in tel.items() if k not in ("sessions", "render")}))
    print(f"service spans (wall ms, count) [{card}]: " + json.dumps(
        {k: {"ms": round(v["ms"], 3), "count": v["count"]}
         for k, v in sorted(run["spans"].items())}))
    print(f"service render latency_stats, the final renders included [{card}]: "
          f"{json.dumps(run['render'])}")
    print(f"service-path launches: {json.dumps(run['launches'])}", flush=True)


# ---- phase 6: stage 2b v3 under a hard point ceiling ---------------------------

def sampler_cfg(name: str, max_budget: int = V3_MAX_BUDGET,
                base: TrainerConfig = TrainerConfig()) -> TrainerConfig:
    return dataclasses.replace(base, max_budget=max_budget, **SAMPLERS[name])


def sampler_runs(device, field_cfg: FieldConfig = FieldConfig(),
                 base: TrainerConfig = TrainerConfig(), max_budget: int = V3_MAX_BUDGET,
                 dataset: dict | None = None, held_out: int = HELD_OUT,
                 names=tuple(SAMPLERS)) -> dict:
    """One `train_main_path` run per sampler of `names` under the ceiling."""
    return {name: train_main_path(device, field_cfg, sampler_cfg(name, max_budget, base),
                                  dataset, held_out) for name in names}


def check_v3_run(run: dict, max_budget: int = V3_MAX_BUDGET, kernels_of_path=TRAIN_KERNELS,
                 min_psnr: float = MIN_PSNR_DB) -> list[str]:
    """`check_training`'s gate, and: no step overflowed, and no step with a
    budget (every step once the bitfield is live) queried more than the
    ceiling."""
    problems = check_training(run, kernels_of_path, min_psnr)
    hist = run["hist"]
    if hist["overflow_total"] != 0 or any(hist["overflow"]):
        problems.append(f"v3 overflowed: {hist['overflow_total']} points")
    over = [(st, p) for st, p, b in zip(hist["step"], hist["points_queried"], hist["budget"])
            if b is not None and p > max_budget]
    if over:
        problems.append(f"steps over the ceiling of {max_budget}: {over[:5]}")
    return problems


def v3_step(pipe: RenderPipeline, origins, dirs, ts, bits, ema, resolution: int,
            budget: int) -> dict:
    """Stages 1 -> 2 -> 2b v3 -> 3 of one ray batch: the candidates' ts,
    liveness and EMA values, the ragged lane grid (ts, deltas, valid) and
    the compacted points (budget, 3), Morton-packed, with their keep mask."""
    b, s = ts.shape
    flat_pts, _, unit = pipe.generate_samples(origins, dirs, ts)
    live = pipe.cull(flat_pts, unit, bitfield=bits).reshape(b, s)
    ema_vals = occupancy.point_density(ema, unit, resolution).reshape(b, s)
    lanes, deltas, valid = pipe.redistribute_v3(ts, live, ema_vals, budget)
    flat2, _, unit2 = pipe.generate_samples(origins, dirs, lanes)
    live2 = valid.reshape(-1) & pipe.cull(flat2, unit2, bitfield=bits)
    plan = pipe.compact(live2, min(budget, live2.numel()), unit2)
    return {"ts": ts, "live": live, "ema_vals": ema_vals, "lanes": lanes.contiguous(),
            "deltas": deltas.contiguous(), "valid": valid,
            "points": unit2[plan.idx].contiguous(), "keep": plan.keep,
            "n_live": int(plan.n_live), "overflow": int(plan.overflow)}


def v3_train_step(device, run: dict, budget: int, held_out: int = HELD_OUT) -> dict:
    """`v3_step` of the trained run's next batch (the draws of its next step)
    on its occupancy, at `budget`."""
    tr, state, ds = run["trainer"], run["state"], run["ds"]
    cfg = tr.cfg
    sampler = RaySampler(ds, views=range(held_out, ds.images.shape[0]), device=device)
    ray_idx, u_ts, _ = default_draws(cfg, sampler.n)(state.step)
    batch = sampler.gather(ray_idx)
    ts = sample_ts(None, cfg.n_rays, cfg.render, device, u=u_ts)
    return v3_step(tr.pipeline, batch.origins, batch.dirs, ts,
                   occupancy.bitfield(state.occ_state, cfg.occ),
                   state.occ_state.density_ema, cfg.occ.resolution, budget)


def v3_serve_step(device, run: dict, hw: int = IMAGE_HW, chunk: int = EVAL_CHUNK) -> dict:
    """`v3_step` of the served chunk holding the centre of the first served
    view, on the trained occupancy, at the chunk's budget chunk x S'."""
    tr, state = run["trainer"], run["state"]
    cfg = tr.cfg
    pose = sphere_poses(1, seed=0)[0]
    origins, dirs, n, chunk = image_rays(pose, hw, hw, focal_for(hw), chunk, device=device)
    first = (n // 2) // chunk * chunk
    return v3_step(tr.pipeline, origins[first:first + chunk], dirs[first:first + chunk],
                   sample_ts(None, chunk, cfg.render, device),
                   occupancy.bitfield(state.occ_state, cfg.occ), state.occ_state.density_ema,
                   cfg.occ.resolution, chunk * default_samples_per_ray(cfg.render.n_samples))


def v3_random_step(device, seed: int, budget: int, n_rays: int = TRAIN_RAYS,
                   render_cfg: RenderConfig = RenderConfig(),
                   occ_cfg: occupancy.OccupancyConfig = occupancy.OccupancyConfig()) -> dict:
    """`v3_step` without a trained state: the rays of a square view of
    n_rays pixels (the first served pose), stratified candidates and an
    occupancy EMA drawn from `seed` (about a third of the cells above the
    threshold), at `budget`."""
    gen = torch.Generator().manual_seed(seed)
    side = int(round(n_rays ** 0.5))
    origins, dirs, n, _ = image_rays(sphere_poses(1, seed=0)[0], side, side, focal_for(side),
                                     n_rays, device=device)
    u = torch.rand((n, render_cfg.n_samples), generator=gen).to(device)
    ts = sample_ts(None, n, render_cfg, device, u=u)
    ema = (torch.rand((occ_cfg.resolution ** 3,), generator=gen) ** 4 * 0.6).to(device)
    bits = occupancy.bitfield(occupancy.OccupancyState(ema, 1), occ_cfg)
    pipe = RenderPipeline(None, render_cfg, redistribute_v3=True)
    return v3_step(pipe, origins, dirs, ts, bits, ema, occ_cfg.resolution, budget)


def ragged_composite_inputs(gen, step: dict, device):
    """sigma U(0, 20) and rgb U(0, 1) on a v3 lane grid's valid lanes, 0 on
    the invalid ones (the scatter leaves them 0), with its deltas (0 on
    invalid lanes) and ts (far there)."""
    r, s = step["lanes"].shape
    valid = step["valid"].to(torch.float32)
    sigma = _uniform(gen, (r, s), 0.0, 20.0, device) * valid
    rgb = _uniform(gen, (r, s, 3), 0.0, 1.0, device) * valid[..., None]
    return sigma, rgb, step["deltas"], step["lanes"]


def v3_parity(device, train_steps: dict, serve_step: dict,
              field_cfg: FieldConfig = FieldConfig(), seed: int = 0) -> list[dict]:
    """The kernels at the shapes stage 2b v3 gives them: #4 forward and
    backward on each training lane grid (budget -> `v3_train_step`), #5 and
    #6 (both grids, and the color grid frozen) on the compacted points of
    the step at the ceiling, #4 on the served chunk's lane grid and #1 on
    its compacted points."""
    gen = torch.Generator().manual_seed(seed + 5)
    field = Field(field_cfg)
    cases = []
    for budget, step in train_steps.items():
        r, s_cap = step["lanes"].shape
        label = f"v3 training lanes {r} x {s_cap}"
        inputs = ragged_composite_inputs(gen, step, device)
        cases.append(_composite_case(gen, device, r, s_cap, label, inputs=inputs))
        cases.append(_composite_bwd_case(gen, device, r, s_cap, label, inputs=inputs))
    pts = train_steps[V3_MAX_BUDGET]["points"]
    n = pts.shape[0]
    label = f"v3 budget {n}, ragged lanes"
    cases += [_fused_step_fwd_case(gen, device, n, field, label, points=pts),
              _fused_step_bwd_case(gen, device, n, field, label, points=pts),
              _fused_step_bwd_case(gen, device, n, field, f"{label}, color frozen",
                                   need_color=False, points=pts)]
    r, s_cap = serve_step["lanes"].shape
    cases.append(_composite_case(gen, device, r, s_cap, f"v3 serving lanes {r} x {s_cap}",
                                 inputs=ragged_composite_inputs(gen, serve_step, device)))
    pts = serve_step["points"]
    for name, e in (("density", field.density_enc), ("color", field.color_enc)):
        cases.append(_hash_encode_case(gen, device, pts.shape[0], e,
                                       f"{name} grid, v3 served {pts.shape[0]}", points=pts))
    return cases


def v3_plan_against_cpu(step: dict, budget: int, render_cfg: RenderConfig = RenderConfig()
                        ) -> dict:
    """v3's plan of one step on its device, twice, against the plain run on
    CPU copies: the rays whose S'_i differ, the budget held, the same bytes
    on two runs."""
    pipe = RenderPipeline(None, render_cfg, redistribute_v3=True)
    args = (step["ts"], step["live"], step["ema_vals"])
    a, b = (pipe.v3_plan(*args, budget) for _ in range(2))
    cpu = pipe.v3_plan(*(t.cpu() for t in args), budget)
    keys = ("pdf", "cdf", "s_ray", "mass", "dead")
    return {"rays": int(a["s_ray"].numel()), "budget": budget, "s_cap": a["s_cap"],
            "sum_s_ray": int(a["s_ray"].sum()),
            "s_ray_differ_from_cpu": int((a["s_ray"].cpu() != cpu["s_ray"]).sum()),
            "cdf_max_abs_err_vs_cpu": _max_err(a["cdf"].cpu(), cpu["cdf"]),
            "two_runs_same_bytes": all(_same_bits(a[k], b[k]) if a[k].is_floating_point()
                                       else torch.equal(a[k], b[k]) for k in keys)}


def serve_trained(device, run: dict, n_requests: int = V3_SERVE_REQUESTS,
                  hw: int = IMAGE_HW, session_id: str = "v3") -> dict:
    """A `RenderService` session on a trained run's snapshot serving
    `n_requests` hw x hw views on the redistributed route the run's trainer
    renders (S' = 12 a ray; stage 2b v3 for a v3 run, v2 otherwise),
    counters zeroed just before and read just after; then `render_image` of
    the same snapshot and pose must be the served bytes (eval == served)."""
    tr, state = run["trainer"], run["state"]
    cfg = tr.cfg
    store = SnapshotStore()
    store.publish(session_id, state.params, step=state.step, occ=state.occ_state)
    svc = RenderService(store, device=device)
    spr = default_samples_per_ray(cfg.render.n_samples)
    svc.register_session(session_id, tr.field.cfg, cfg.render, hw, hw, focal_for(hw),
                         eval_chunk=cfg.eval_chunk, occ_cfg=cfg.occ, samples_per_ray=spr,
                         redistribute_v3=cfg.redistribute_v3)
    poses = sphere_poses(max(n_requests, 1), seed=0)
    kernels.reset_launches()
    t0 = time.perf_counter()
    for pose in poses[:n_requests]:
        svc.submit(session_id, pose)
    results = svc.drain()
    wall = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_results(results, svc, hw, n_requests)
    snap = store.latest(session_id)
    view = dataclasses.make_dataclass("View", ["h", "w", "focal"])(hw, hw, focal_for(hw))
    rgb, depth = tr.render_image(snap.params, poses[0], view, occ=snap.occ,
                                 samples_per_ray=spr)
    return {"results": results, "wall_s": wall, "launches": launches,
            "latency": svc.latency_stats(), "samples_per_ray": spr,
            "eval_vs_served": {"rgb": bool(np.array_equal(rgb, results[0].rgb)),
                               "depth": bool(np.array_equal(depth, results[0].depth))}}


def reuse_replay(device, run: dict, steps: int = REUSE_STEPS, budget: int = V3_MAX_BUDGET,
                 held_out: int = HELD_OUT) -> dict:
    """The v3 run's next `steps` steps' compacted points (its draws, its
    occupancy, `v3_step`) encoded through `EncodingReuseCache` on both grids
    under the trainer's invalidation schedule: the density grid invalidated
    every step, the color grid on its update steps, every entry at a fold.
    Each cached encode must equal the plain `hash_encode` bit for bit."""
    tr, state, ds = run["trainer"], run["state"], run["ds"]
    cfg, field = tr.cfg, tr.field
    encs = {"density": field.density_enc, "color": field.color_enc}
    cache = EncodingReuseCache(field.density_enc.resolutions,
                               {g: e.cfg.table_size for g, e in encs.items()})
    sampler = RaySampler(ds, views=range(held_out, ds.images.shape[0]), device=device)
    draws = default_draws(cfg, sampler.n)
    bits = occupancy.bitfield(state.occ_state, cfg.occ)
    identical, points = True, 0
    for i in range(state.step, state.step + steps):
        ray_idx, u_ts, _ = draws(i)
        batch = sampler.gather(ray_idx)
        ts = sample_ts(None, cfg.n_rays, cfg.render, device, u=u_ts)
        step = v3_step(tr.pipeline, batch.origins, batch.dirs, ts, bits, state.occ_state.density_ema,
                       cfg.occ.resolution, budget)
        pts = step["points"][step["keep"]]
        points += int(pts.shape[0])
        for grid, e in encs.items():
            tables = state.params[f"{grid}_grid"]
            got = cache.encode(grid, pts, tables)
            identical &= torch.equal(got, he_ref.hash_encode(pts, tables, e.resolutions,
                                                             e.dense_flags))
        # a step encodes against the tables its update then overwrites
        cache.note_table_update("density")
        if _branch_update(i, cfg.f_color):
            cache.note_table_update("color")
        if (i + 1) % cfg.occ.update_interval == 0:
            cache.note_fold()
    return {**cache.stats(), "steps": steps, "points": points, "bit_identical": identical}


def _v3_phase(device, card: str) -> dict:
    """Phase 6: the three runs under the ceiling and their gates, v3's
    determinism, its parity cases, its plan on the card against the CPU,
    serving and eval == served, the reuse replay."""
    t0 = time.perf_counter()
    runs = sampler_runs(device)
    print(f"train_v3: {len(runs)} runs x {TrainerConfig().iters} steps + held-out eval in "
          f"{time.perf_counter() - t0:.2f} s, max_budget {V3_MAX_BUDGET} [{card}]")
    for name, run in runs.items():
        hist = run["hist"]
        print(f"sampler {name} [{card}]: " + json.dumps({
            "psnr_rgb": run["eval"]["psnr_rgb"], "psnr_depth": run["eval"]["psnr_depth"],
            "points_queried_last": hist["points_queried"][-1],
            "budgets": dict(sorted(Counter(b for b in hist["budget"] if b).items())),
            "overflow_steps": hist["overflow_steps"], "overflow_total": hist["overflow_total"],
            "dense_steps": len(run["dense_ms"]), "compact_steps": len(run["compact_ms"]),
            "median_dense_ms": _warm_median(run["dense_ms"]),
            "median_compact_ms": _warm_median(run["compact_ms"])}), flush=True)
    v3 = runs["v3"]
    problems = check_v3_run(v3)
    if problems:
        raise RuntimeError(f"train_v3 gate failed: {problems}")
    occ = (v3["state"].occ_state.density_ema, v3["state"].occ_state.step)
    served_eval = v3["trainer"].evaluate(v3["state"].params, v3["ds"], views=range(HELD_OUT),
                                         occ=occ)
    print(f"train_v3 held-out PSNR on the served quadrature (12 samples a ray) [{card}]: "
          f"{json.dumps(served_eval)}")
    print(f"train_v3 PSNR rgb uniform / v2 / v3 (reported, not gated) [{card}]: " + json.dumps(
        {name: run["eval"]["psnr_rgb"] for name, run in runs.items()}))
    print(f"train_v3-path launches: {json.dumps(v3['launches'])}", flush=True)
    det = determinism(device, FieldConfig(), cfg=sampler_cfg("v3"))
    print(f"train_v3 determinism: {json.dumps(det)}", flush=True)
    if not (det["params_equal"] and det["moments_equal"] and det["occupancy_equal"]
            and det["compacted_steps"] > 0):
        raise RuntimeError(f"train_v3: two runs from one seed differ: {det}")

    steps = {b: v3_train_step(device, v3, b) for b in V3_LANE_BUDGETS}
    serve_step = v3_serve_step(device, v3)
    plans = [v3_plan_against_cpu(steps[V3_MAX_BUDGET], V3_MAX_BUDGET),
             v3_plan_against_cpu(serve_step, serve_step["points"].shape[0])]
    for plan in plans:
        print(f"v3 plan on the card vs the CPU [{card}]: {json.dumps(plan)}", flush=True)
        if plan["sum_s_ray"] > plan["budget"] or not plan["two_runs_same_bytes"]:
            raise RuntimeError(f"v3 plan broke its budget or its bytes: {plan}")
    cases = v3_parity(device, steps, serve_step)
    failed = [f"{c['kernel']} {c['case']}" for c in cases if not _print_case(c, card)]
    if failed:
        raise RuntimeError(f"v3 kernel parity failed: {failed}")

    served = serve_trained(device, v3)
    print(f"serve_v3: drained {len(served['results'])} requests in {served['wall_s']:.3f} s, "
          f"{served['samples_per_ray']} samples a ray [{card}]")
    for r in served["results"]:
        print(f"  request {r.request_id} v3 {r.rgb.shape[0]}x{r.rgb.shape[1]} latency "
              f"{r.latency_s * 1e3:.1f} ms rgb [{r.rgb.min():.4f}, {r.rgb.max():.4f}] "
              f"depth mean {r.depth.mean():.4f}")
    print(f"serve_v3 latency_stats [{card}]: {json.dumps(served['latency'])}")
    print(f"serve_v3-path launches: {json.dumps(served['launches'])}")
    print(f"serve_v3 eval == served: {json.dumps(served['eval_vs_served'])}", flush=True)
    missing = [k for k in SERVE_KERNELS if served["launches"].get(k, 0) == 0]
    if missing or not all(served["eval_vs_served"].values()):
        raise RuntimeError(f"serve_v3 failed: never launched {missing}, "
                           f"eval vs served {served['eval_vs_served']}")
    t0 = time.perf_counter()
    reuse = reuse_replay(device, v3)
    print(f"reuse cache over {reuse['steps']} v3 steps ({time.perf_counter() - t0:.2f} s) "
          f"[{card}]: {json.dumps(reuse)}", flush=True)
    if not reuse["bit_identical"]:
        raise RuntimeError("a cached encode differs from the plain hash_encode")
    return {"cases": cases, "train_launches": v3["launches"],
            "serve_launches": served["launches"], "run": v3}


# ---- phase 7: the async serving plane and the entry points --------------------

def replay_sync(device, run: dict, result) -> bool:
    """A sync drain of the snapshot `result` was rendered from (the hook
    kept it), in a fresh `RenderService` on `device` with the session's
    geometry, gives `result`'s bytes."""
    sid, pose = run["asked"][result.request_id]
    snap = run["snapshots"][(sid, result.snapshot_version)]
    store = SnapshotStore()
    store.publish(sid, snap.params, step=snap.step, occ=snap.occ)
    fresh = RenderService(store, device=device)
    geom = run["service"].renderer._geom[sid]
    fresh.register_session(sid, **{f.name: getattr(geom, f.name)
                                   for f in dataclasses.fields(geom)})
    fresh.submit(sid, pose)
    (again,) = fresh.drain()
    return (isinstance(again, RenderResult) and np.array_equal(again.rgb, result.rgb)
            and np.array_equal(again.depth, result.depth))


def service_modes(device, datasets: list, tmp: str, runs: int = SERVICE_MODE_RUNS,
                  **kw) -> dict:
    """`service_main_path` with ``async_serving`` off and on, alternating,
    `runs` times each -> {"sync": [run, ...], "async": [run, ...]}.  Each
    async answer is replayed by `replay_sync` (``replayed``), then the kept
    snapshots are dropped."""
    out = {"sync": [], "async": []}
    for k in range(runs):
        for mode in out:
            run = service_main_path(device, datasets, f"{tmp}/{mode}-{k}",
                                    async_serving=mode == "async", **kw)
            run["replayed"] = ([replay_sync(device, run, r) for r in run["answers"]]
                               if mode == "async" else [])
            run["snapshots"] = {}
            out[mode].append(run)
    return out


def check_service_modes(modes: dict, must_launch=tuple(KERNELS), cohorts=SERVICE_COHORTS,
                        min_psnr: float = MIN_PSNR_DB) -> list[str]:
    """What the sync / async gate refuses: any run failing `check_service`
    (every session DONE, every request answered exactly once, ...), a
    session whose final params or occupancy EMA differ from the first sync
    run's by a byte, an async run not reporting the plane, or an async
    answer that a sync drain of its snapshot does not reproduce."""
    problems = []
    first = modes["sync"][0]["service"].sessions
    for mode, runs in modes.items():
        for k, run in enumerate(runs):
            problems += [f"{mode} run {k}: {p}"
                         for p in check_service(run, must_launch, cohorts, min_psnr)]
            if run["telemetry"]["async_serving"] != (mode == "async"):
                problems.append(f"{mode} run {k}: telemetry async_serving "
                                f"{run['telemetry']['async_serving']}")
            for sid, sess in run["service"].sessions.items():
                a, b = first[sid].state, sess.state
                if _bits(a.params) != _bits(b.params) or _bits(
                        {"e": a.occ_state.density_ema}) != _bits({"e": b.occ_state.density_ema}):
                    problems.append(f"{mode} run {k}: {sid}'s params or occupancy differ "
                                    "from sync run 0's")
    for k, run in enumerate(modes["async"]):
        if not run["replayed"] or not all(run["replayed"]):
            problems.append(f"async run {k}: {run['replayed'].count(False)} of "
                            f"{len(run['replayed'])} answers differ from a sync drain of "
                            "their snapshot")
    return problems


def _spread(values) -> dict:
    v = np.asarray(values, dtype=float)
    return {"runs": [float(x) for x in v], "median": float(np.median(v)),
            "min": float(v.min()), "max": float(v.max())}


def service_mode_summary(runs: list) -> dict:
    """Per mode, over its runs: wall, scenes/s, median per-slice wall and
    the mid-training renders' p50 / p95 / count (`telemetry()["render"]`,
    read at the end of `run`, before the post-run renders)."""
    return {
        "wall_s": _spread([r["telemetry"]["wall_s"] for r in runs]),
        "scenes_per_s": _spread([r["telemetry"]["scenes_per_sec"] for r in runs]),
        "median_slice_ms": _spread([float(np.median(r["slice_ms"])) for r in runs]),
        "render_p50_ms": _spread([r["telemetry"]["render"]["p50_ms"] for r in runs]),
        "render_p95_ms": _spread([r["telemetry"]["render"]["p95_ms"] for r in runs]),
        "render_count": [r["telemetry"]["render"]["count"] for r in runs],
        "launches": runs[-1]["launches"],
    }


def _entry(fn, *args, **kwargs) -> dict:
    """Run an entry point with its stdout captured; its result dict gains
    ``wall_s``, ``stdout`` and ``launches`` (counters zeroed just before,
    read just after)."""
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = dict(kernels.LAUNCHES)
    out["stdout"] = buf.getvalue()
    return out


def entry_points(device, tmp: str, iters: tuple = (CLI_ITERS, CLI_RESUME_ITERS),
                 ckpt_every: int = CLI_CKPT_EVERY, quickstart_iters: int = QUICKSTART_ITERS,
                 service_argv: tuple = ()) -> dict:
    """The three entry points on `device`: the training CLI to iters[0]
    and resumed to iters[1] against an uninterrupted iters[1] run, the
    quickstart, the service demo with --async-serving (plus
    `service_argv`).  The demo switches tracing on; it is restored."""
    dev = ["--device", str(device), "--ckpt-every", str(ckpt_every)]
    first = _entry(train_cli.main, dev + ["--iters", str(iters[0]), "--ckpt-dir", f"{tmp}/a"])
    resumed = _entry(train_cli.main, dev + ["--iters", str(iters[1]), "--ckpt-dir", f"{tmp}/a",
                                            "--auto-resume"])
    whole = _entry(train_cli.main, dev + ["--iters", str(iters[1]), "--ckpt-dir", f"{tmp}/b"])
    a, b = resumed["state"], whole["state"]
    cli = {"first": first, "resumed": resumed, "whole": whole,
           "resumed_line": f"resumed from step {iters[0]}" in resumed["stdout"],
           "params": _bits(a.params) == _bits(b.params),
           "moments": (_bits(a.opt_state.m) == _bits(b.opt_state.m)
                       and _bits(a.opt_state.v) == _bits(b.opt_state.v)),
           "occupancy": _bits({"e": a.occ_state.density_ema})
           == _bits({"e": b.occ_state.density_ema})}
    quick = _entry(quickstart.main, iters=quickstart_iters, device=device)
    traced = obs_trace.enabled()
    try:
        demo = _entry(reconstruct_service.main,
                      ["--device", str(device), "--async-serving", *service_argv])
    finally:
        obs_trace.set_enabled(traced)
        obs_trace.clear()
        obs_metrics.REGISTRY.reset()
    return {"cli": cli, "quickstart": quick, "service": demo}


def check_entry_points(ent: dict, min_psnr: float = MIN_PSNR_DB) -> list[str]:
    """What the entry-point gate refuses: a resumed CLI run not the bytes
    of the uninterrupted one or without its ``resumed from step`` line, a
    quickstart PSNR under `min_psnr`, a demo scene not DONE or a demo
    request not answered exactly once with a `RenderResult`."""
    problems = []
    cli = ent["cli"]
    for k in ("resumed_line", "params", "moments", "occupancy"):
        if not cli[k]:
            problems.append(f"training CLI resume: {k} failed")
    psnr = ent["quickstart"]["eval"]["psnr_rgb"]
    if not psnr >= min_psnr:
        problems.append(f"quickstart PSNR {psnr:.2f} dB < {min_psnr}")
    demo = ent["service"]
    not_done = {sid: s.status for sid, s in demo["service"].sessions.items() if s.status != DONE}
    ids = sorted(r.request_id for r in demo["answered"])
    bad = [r for r in demo["answered"] if not isinstance(r, RenderResult)]
    if not_done or bad or not ids or ids != sorted(demo["asked"]):
        problems.append(f"service demo: not done {not_done}, {len(ids)} answers to "
                        f"{len(demo['asked'])} requests, errors {bad}")
    return problems


def profile_async_quantum(timeout_s: float = SERVICE_PROFILE_TIMEOUT_S) -> dict:
    """`tools/torch_service_profile.py` in its own process (torch.profiler
    stays out of this one) -> its JSON report."""
    tool = Path(__file__).resolve().parents[2] / "tools" / "torch_service_profile.py"
    done = subprocess.run([sys.executable, str(tool)], capture_output=True, text=True,
                          timeout=timeout_s)
    if done.returncode != 0:
        raise RuntimeError(f"{tool.name} exited {done.returncode}:\n"
                           f"{done.stdout[-4000:]}\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def _async_phase(device, card: str) -> dict:
    """Phase 7: the service sync against async and its gates, the entry
    points and theirs, one profile of an async quantum."""
    datasets = service_datasets(device)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        modes = service_modes(device, datasets, tmp)
    print(f"service sync / async: {SERVICE_MODE_RUNS} runs each, alternating, in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    summary = {mode: service_mode_summary(runs) for mode, runs in modes.items()}
    for mode, summ in summary.items():
        print(f"service {mode} [{card}]: " + json.dumps(summ), flush=True)
    problems = check_service_modes(modes)
    replayed = sum(len(r["replayed"]) for r in modes["async"])
    print(f"service sync vs async: every session DONE, every request answered once, final "
          f"params and occupancy equal across {2 * SERVICE_MODE_RUNS} runs, {replayed} async "
          f"answers equal to a sync drain of their snapshot: {not problems}", flush=True)
    if problems:
        raise RuntimeError(f"service sync / async gate failed: {problems}")

    with tempfile.TemporaryDirectory() as tmp:
        ent = entry_points(device, tmp)
    cli = ent["cli"]
    for name in ("first", "resumed", "whole"):
        run = cli[name]
        print(f"train_nerf_instant3d {name}: wall {run['wall_s']:.2f} s, from step "
              f"{run['start']} to {run['state'].step}, s/iter per chunk "
              f"{[round(x, 6) for x in run['step_s']]}, PSNR {json.dumps(run['eval'])} "
              f"[{card}]")
    print(f"train_nerf_instant3d resume vs uninterrupted: " + json.dumps(
        {k: cli[k] for k in ("resumed_line", "params", "moments", "occupancy")}), flush=True)
    quick = ent["quickstart"]
    print(f"quickstart: wall {quick['wall_s']:.2f} s, {QUICKSTART_ITERS} steps in "
          f"{quick['train_s']:.2f} s ({quick['train_s'] / QUICKSTART_ITERS * 1e3:.3f} ms a "
          f"step), PSNR views 0-1 {json.dumps(quick['eval'])}, param_counts "
          f"{json.dumps(quick['param_counts'])} [{card}]")
    demo = ent["service"]
    tel = demo["telemetry"]
    print(f"reconstruct_service --async-serving: wall {demo['wall_s']:.2f} s, "
          f"{tel['scenes_done']} scenes in {tel['wall_s']:.3f} s ({tel['scenes_per_sec']:.4f} "
          f"scenes/s), renders {len(demo['answered'])} of {len(demo['asked'])} asked, "
          f"render {json.dumps({k: v for k, v in tel['render'].items() if k != 'degraded'})}, "
          f"PSNR {json.dumps(demo['evals'])} [{card}]")
    print(f"entry-point launches: " + json.dumps(
        {"train_nerf_instant3d": cli["whole"]["launches"], "quickstart": quick["launches"],
         "reconstruct_service": demo["launches"]}), flush=True)
    problems = check_entry_points(ent)
    if problems:
        raise RuntimeError(f"entry-point gate failed: {problems}")

    t0 = time.perf_counter()
    prof = profile_async_quantum()
    print(f"async quantum profile ({time.perf_counter() - t0:.1f} s, "
          f"tools/torch_service_profile.py) [{card}]: {json.dumps(prof)}", flush=True)
    if not prof["render_kernels"] or not prof["slice_kernels"]:
        raise RuntimeError(f"the profiled quantum ran no render or no slice kernel: {prof}")
    return {"summary": summary, "async_launches": modes["async"][-1]["launches"]}


# ---- phase 8: sessions across slots, the field's last two options -----------

def slice_overlap(spans, prefix: str = "serve3d-dev") -> dict:
    """From a run's (thread, start, end) slice spans: the slot threads
    named `prefix*` that trained slices, their slice counts, and the wall
    time (ms) two of them spent inside a slice at once."""
    by_thread: dict = {}
    for name, t0, t1 in spans:
        if name.startswith(prefix):
            by_thread.setdefault(name, []).append((t0, t1))
    names = sorted(by_thread)
    overlap_us = sum(max(0.0, min(e0, e1) - max(s0, s1))
                     for i, a in enumerate(names) for b in names[i + 1:]
                     for s0, e0 in by_thread[a] for s1, e1 in by_thread[b])
    return {"threads": names, "slices": {t: len(v) for t, v in by_thread.items()},
            "overlap_ms": overlap_us / 1e3}


def same_final_state(a: dict, b: dict) -> dict:
    """Per session of service run `b`: its final step, params and occupancy
    EMA the bytes of the same session in run `a`."""
    out = {}
    for sid, sess in b["service"].sessions.items():
        x, y = a["service"].sessions[sid].state, sess.state
        out[sid] = (x.step == y.step and _bits(x.params) == _bits(y.params)
                    and _bits({"e": x.occ_state.density_ema})
                    == _bits({"e": y.occ_state.density_ema}))
    return out


def groups_on_their_devices(run: dict) -> bool:
    """Every render group of a placed run rendered on the device its
    placement holds each of its sessions on (and there was a group)."""
    placement = run["service"].placement
    return bool(run["render_groups"]) and all(
        g["device"] == str(torch.device(placement.device(sid))) for g in run["render_groups"]
        for sid in g["sessions"])


def placement_runs(device, datasets: list, slots=PLACEMENT_SLOTS, one_slot=1, **kw) -> dict:
    """Phase 5's service configuration (no persisted snapshots; `kw` goes to
    `service_main_path`) run placement-free, with ``devices=one_slot`` and
    over `slots` with the async serving plane, in that order."""
    return {"placement_free": service_main_path(device, datasets, None, **kw),
            "n1": service_main_path(device, datasets, None, devices=one_slot, **kw),
            "two_slots": service_main_path(device, datasets, None, devices=list(slots),
                                           async_serving=True, **kw)}


def check_placement(runs: dict, placed=PLACEMENT_PLACED, cohorts=PLACEMENT_COHORTS,
                    must_launch=tuple(KERNELS), min_psnr: float = MIN_PSNR_DB) -> list[str]:
    """What the placement gate refuses: a run failing `check_service`, a
    placed run's session not on the placement-free run's bytes, the N=1 run
    not all on slot 0, the two-slot run not placed as `placed`, its loads
    not released, its slot threads' slices never overlapping, or a render
    group off its sessions' device."""
    problems = []
    for mode, run in runs.items():
        problems += [f"{mode}: {p}" for p in check_service(
            run, must_launch, cohorts if mode == "two_slots" else SERVICE_COHORTS, min_psnr)]
    for mode in ("n1", "two_slots"):
        same = same_final_state(runs["placement_free"], runs[mode])
        if not all(same.values()):
            problems.append(f"{mode}: sessions off the placement-free bytes: {same}")
    n1 = runs["n1"]["telemetry"]
    if n1["devices"] != 1 or set(n1["placement"]["placed"].values()) != {0}:
        problems.append(f"n1: placement {n1['placement']}")
    two = runs["two_slots"]
    tel = two["telemetry"]
    if tel["placement"]["placed"] != placed or tel["placement"]["loads"] != [0, 0] \
            or two["loads"] != [2, 2] or not tel["async_serving"]:
        problems.append(f"two_slots: placement {tel['placement']}, loads at admission "
                        f"{two['loads']}, async {tel['async_serving']}")
    overlap = slice_overlap(two["slice_spans"])
    if len(overlap["threads"]) < 2 or not overlap["overlap_ms"] > 0:
        problems.append(f"two_slots: the slot threads' slices never overlapped: {overlap}")
    if not groups_on_their_devices(two):
        problems.append(f"two_slots: render groups off their devices: {two['render_groups']}")
    return problems


def device_move(device, datasets: list, field_cfg: FieldConfig = FieldConfig(),
                cfg: TrainerConfig = TrainerConfig(), iters: int = IDENTITY_ITERS,
                move_at: int = SUSPEND_AT[0], slots=PLACEMENT_SLOTS,
                held_out: int = HELD_OUT) -> dict:
    """Scene 1 on a `DevicePlacement` over `slots`: trained to `move_at`,
    suspended, moved to the least-loaded other slot, resumed and trained to
    `iters`; against an unmoved session of the same scene and seed."""
    views = range(held_out, datasets[1].images.shape[0])

    def session(sid):
        return SceneSession(sid, datasets[1], field_cfg, cfg, iters, seed=1,
                            train_views=views, device=device)

    placement = DevicePlacement(list(slots))
    moved = session("moved")
    slot = placement.assign("moved")
    moved.place(placement.device_for_slot(slot), slot)
    moved.start()
    moved.run_slice(move_at)
    moved.suspend()
    new = placement.move("moved")
    moved.place(placement.device_for_slot(new), new)
    moved.resume()
    moved.run_slice(iters - moved.step)
    still = session("still")
    still.start()
    still.run_slice(iters)
    return {"from_slot": slot, "to_slot": new, "at": move_at, "iters": iters,
            **_state_equal(still.state, moved.state)}


def _on(tensors, device) -> bool:
    """Every tensor on `device` (as a tensor made there reports it)."""
    want = torch.empty(0, device=device).device
    return all(t.device == want for t in tensors)


def cross_device_move(dataset, field_cfg: FieldConfig = FieldConfig(),
                      cfg: TrainerConfig = CROSS_CFG, iters: int = CROSS_ITERS,
                      move_at: int = CROSS_AT, slots=CROSS_SLOTS) -> dict:
    """A session on a `DevicePlacement` over `slots` (the CPU, then a card):
    trained on slot 0 to `move_at`, suspended, moved to slot 1, resumed
    (then every state tensor and the sampler's rays must be on slot 1's
    device) and trained to `iters`; against a session trained unplaced on
    slot 0's device to `move_at`, suspended, and resumed on slot 1's device
    from its host tree (`rollback`).  Each is then served once through a
    `RenderService` on slot 0's device -- the moved one placed, so its group
    must render on slot 1's device -- and once unplaced on slot 1's."""
    placement = DevicePlacement(list(slots))
    target = torch.device(placement.device_for_slot(1))

    def session(sid, device):
        return SceneSession(sid, dataset, field_cfg, cfg, iters, seed=1, device=device)

    moved = session("moved", slots[0])
    slot = placement.assign("moved")
    moved.place(placement.device_for_slot(slot), slot)
    moved.start()
    moved.run_slice(move_at)
    moved.suspend()
    new = placement.move("moved")
    moved.place(placement.device_for_slot(new), new)
    moved.resume()
    st = moved.state
    on_new = _on([t for tree in (st.params, st.opt_state.m, st.opt_state.v)
                  for _, t in tree_paths(tree)]
                 + [st.opt_state.step, st.occ_state.density_ema, moved.sampler.origins,
                    moved.sampler.dirs, moved.sampler.rgb], target)
    on_new = on_new and moved.device == moved.sampler.device == target
    moved.run_slice(iters - moved.step)
    cpu_leg = session("still", slots[0])
    cpu_leg.start()
    cpu_leg.run_slice(move_at)
    cpu_leg.suspend()
    still = session("still", target)
    still.rollback(cpu_leg._host_tree)
    still.run_slice(iters - still.step)
    store = SnapshotStore()
    placed = RenderService(store, device=slots[0], placement=placement)
    unplaced = RenderService(store, device=target)
    answers = []
    for svc, sess in ((placed, moved), (unplaced, still)):
        sess.publish(store)
        svc.register_session(sess.session_id, field_cfg, cfg.render, dataset.h, dataset.w,
                             dataset.focal, cfg.eval_chunk)
        svc.submit(sess.session_id, dataset.poses[0])
        answers += svc.drain()
    if target.type == "cuda":
        torch.cuda.synchronize()
    a, b = answers
    return {"slots": list(slots), "from_slot": slot, "to_slot": new, "at": move_at,
            "iters": iters, "on_new_device": on_new,
            "render_on": sorted(str(d) for _, d in placed._resident),
            "render_equal": (isinstance(a, RenderResult) and isinstance(b, RenderResult)
                             and np.array_equal(a.rgb, b.rgb)
                             and np.array_equal(a.depth, b.depth)),
            **_state_equal(still.state, moved.state)}


def cross_move_holds(move: dict) -> bool:
    return (all(move[k] for k in ("on_new_device", "render_equal", "params", "adam_m",
                                  "adam_v", "occupancy_ema", "steps"))
            and move["render_on"] == [str(torch.device(move["slots"][1]))]
            and (move["from_slot"], move["to_slot"]) == (0, 1))


def option_runs(device, iters: int = OPTION_ITERS, field_cfg: FieldConfig = FieldConfig(),
                cfg: TrainerConfig = TrainerConfig(), **kw) -> dict:
    """`train_main_path` (`kw` goes to it) at `iters` steps on `field_cfg`
    (default), with ``residual_policy="stash"``, and twice with
    ``merged_backward=False``."""
    cfg = dataclasses.replace(cfg, iters=iters)
    plan = (("default", {}), ("stash", {"residual_policy": "stash"}),
            ("unmerged", {"merged_backward": False}),
            ("unmerged_again", {"merged_backward": False}))
    return {name: train_main_path(device, dataclasses.replace(field_cfg, **opt), cfg, **kw)
            for name, opt in plan}


def _same_run_bytes(a: dict, b: dict) -> dict:
    x, y = a["state"], b["state"]
    return {"params": _bits(x.params) == _bits(y.params),
            "moments": (_bits(x.opt_state.m) == _bits(y.opt_state.m)
                        and _bits(x.opt_state.v) == _bits(y.opt_state.v)),
            "occupancy": _bits({"e": x.occ_state.density_ema})
            == _bits({"e": y.occ_state.density_ema})}


def check_options(opts: dict, kernels_of_path=TRAIN_KERNELS,
                  min_psnr: float = MIN_PSNR_DB) -> list[str]:
    """What the field-option gate refuses: a run failing `check_training`
    (both routes, finite losses, held-out PSNR, the path's kernels), or the
    "stash" run not on the default run's bytes.  The two unmerged runs may
    differ: their dense steps commit with atomics."""
    problems = [f"{name}: {p}" for name, run in opts.items()
                for p in check_training(run, kernels_of_path, min_psnr)]
    stash = _same_run_bytes(opts["default"], opts["stash"])
    if not all(stash.values()):
        problems.append(f"stash is not the default run's bytes: {stash}")
    return problems


def _placement_phase(device, card: str) -> dict:
    """Phase 8: the service placement-free, on one slot and on two slots of
    the card, and its gate; the device move; session_devices past the card
    count; the field's last two options."""
    datasets = service_datasets(device)
    t0 = time.perf_counter()
    runs = placement_runs(device, datasets)
    summary = {mode: {"wall_s": r["telemetry"]["wall_s"],
                      "scenes_per_s": r["telemetry"]["scenes_per_sec"],
                      "median_slice_ms": float(np.median(r["slice_ms"])),
                      "render_p50_ms": r["telemetry"]["render"].get("p50_ms"),
                      "cohorts": dict(sorted(Counter(r["cohorts"]).items())),
                      "launches": r["launches"]} for mode, r in runs.items()}
    two = runs["two_slots"]
    print(f"placement ({time.perf_counter() - t0:.2f} s for three runs) [{card}]: "
          + json.dumps({**summary, "two_slot_loads_at_admission": two["loads"],
                        "two_slot_placement": two["telemetry"]["placement"],
                        "two_slot_overlap": slice_overlap(two["slice_spans"]),
                        "two_slot_render_groups": len(two["render_groups"])}), flush=True)
    problems = check_placement(runs)
    same = {mode: same_final_state(runs["placement_free"], runs[mode])
            for mode in ("n1", "two_slots")}
    print(f"placement bit identity vs placement-free: {json.dumps(same)}; render groups on "
          f"their devices {groups_on_their_devices(two)}: {not problems}", flush=True)
    if problems:
        raise RuntimeError(f"placement gate failed: {problems}")

    move = device_move(device, datasets)
    print(f"device move (suspend, move, resume): {json.dumps(move)}", flush=True)
    if not all(move[k] for k in ("params", "adam_m", "adam_v", "occupancy_ema", "steps")) \
            or move["from_slot"] == move["to_slot"]:
        raise RuntimeError(f"the device move is not bit-identical: {move}")
    t0 = time.perf_counter()
    cross = cross_device_move(build_dataset(1, device="cpu", **CROSS_DATA)[1])
    print(f"device move across devices ({time.perf_counter() - t0:.2f} s) [{card}]: "
          f"{json.dumps(cross)}", flush=True)
    if not cross_move_holds(cross):
        raise RuntimeError(f"the move from the CPU to the card does not hold: {cross}")
    try:
        session_devices(torch.cuda.device_count() + 1)
    except ValueError as e:
        print(f"session_devices(device_count + 1) raises ValueError: {e}", flush=True)
    else:
        raise RuntimeError("session_devices past the card count did not raise")

    t0 = time.perf_counter()
    opts = option_runs(device)
    print(f"field options: {len(opts)} runs of {OPTION_ITERS} steps in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    for name, run in opts.items():
        print(f"field option {name} [{card}]: " + json.dumps({
            "held_out": run["eval"], "loss": run["hist"]["loss"][-1],
            "dense_ms_median": _warm_median(run["dense_ms"]),
            "compact_ms_median": _warm_median(run["compact_ms"]),
            "launches": run["launches"]}), flush=True)
    stash = _same_run_bytes(opts["default"], opts["stash"])
    atomic = _same_run_bytes(opts["unmerged"], opts["unmerged_again"])
    print(f"field option stash vs default (gate; on the card both policies run the same "
          f"recomputing kernels, so this shows determinism only): {json.dumps(stash)}; "
          f"merged_backward=False "
          f"two runs (index_add_'s atomics on the dense steps, reported, not gated): "
          f"{json.dumps(atomic)}", flush=True)
    problems = check_options(opts)
    if problems:
        raise RuntimeError(f"field-option gate failed: {problems}")
    return {"two_slot_launches": two["launches"]}


# ---- phase 9: half-width hash-grid tables (FieldConfig.grid_dtype) -----------

def _bum_scatter_table_case(gen, device, n: int, enc, label: str, dtype):
    """Kernel #7 committing a dense step's sorted stream of one grid (N points)
    into a NONZERO table of `dtype` through `merged_scatter_add` (a 2-byte
    table goes through an f32 copy and is rounded once), against the plain
    commit on CPU copies (exact)."""
    cfg = enc.cfg
    pts = _uniform(gen, (n, 3), 0.0, 1.0 - 1e-6, device)
    grad = _uniform(gen, (n, cfg.n_levels, cfg.n_features), -1.0, 1.0, device)
    idx, vals = he_ops.corner_updates(pts, enc.resolutions, enc.dense_flags,
                                      cfg.table_size, grad)
    order = torch.sort(idx, stable=True).indices
    idx_s, vals_s = idx[order].contiguous(), vals[order].contiguous()
    rows = cfg.n_levels * cfg.table_size
    table = _uniform(gen, (rows, cfg.n_features), -1.0, 1.0, device).to(dtype)
    run = lambda: gu_ops.merged_scatter_add(table, idx_s, vals_s, presorted=True)  # noqa: E731
    got = run()
    want = gu_ref.segment_commit(table.cpu(), idx_s.cpu(), vals_s.cpu())
    exact = bool(torch.equal(got.cpu(), want))
    m, f = vals_s.shape
    return {
        "kernel": "bum_scatter", "case": label, "shape": [m, rows, f],
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": _max_err(got.cpu().float(), want.float()),
        "err": _rel_err(got.cpu().float(), want.float()), "exact": exact,
        "deterministic": _same_bits(got, run()), "ok": exact,
        "ms": cuda_ms(run),
        "plain_ms": cuda_ms(lambda: gu_ref.segment_commit(table, idx_s, vals_s), iters=10),
        # the stream read once, the table read and the new table written once
        "bound": bound(m * (8 + 4 * f) + 2 * table.element_size() * table.numel(), m * f),
    }


def grid_dtype_parity(device, field_cfg: FieldConfig = FieldConfig(), seed: int = 0,
                      dtypes=GRID_DTYPE_CASES) -> list[dict]:
    """The kernels that read tables, on 2-byte tables at the main paths'
    shapes (bf16), and at the first shape of each (f16): #1 on a dense
    step's N = 1024 x 48 points of the density grid, #8 at an NGP step's
    budget on each grid, #5 at budgets 8192 and 32,768, #6 at 8192, and #7
    committing into a nonzero 2-byte table.  Each case of #1, #5, #6 and #8
    must give the bytes of the same kernel on the tables' f32 copies, agree
    with its plain version on the same 2-byte tables within the f32 case's
    tolerance, and give the same bytes on two launches."""
    cases = []
    for k, dtype in enumerate(dtypes):
        gen = torch.Generator().manual_seed(seed + 6)
        name = str(dtype).removeprefix("torch.")
        field = Field(dataclasses.replace(field_cfg, grid_dtype=name))
        grids = (("density", field.density_enc), ("color", field.color_enc))
        first = k > 0       # f16: the first shape of each kernel
        cases.append(_hash_encode_case(gen, device, DENSE_POINTS, field.density_enc,
                                       f"{name}, density, N={DENSE_POINTS}", dtype=dtype))
        for grid, e in grids[:1 if first else 2]:
            cases.append(_fused_encode_case(gen, device, PARITY_BUDGET, e,
                                            f"{name}, {grid}, N={PARITY_BUDGET}", dtype=dtype))
        for budget in (TRAIN_BUDGET,) if first else (TRAIN_BUDGET, PARITY_BUDGET):
            cases.append(_fused_step_fwd_case(gen, device, budget, field,
                                              f"{name}, budget {budget}"))
        cases.append(_fused_step_bwd_case(gen, device, TRAIN_BUDGET, field,
                                          f"{name}, budget {TRAIN_BUDGET}"))
        cases.append(_bum_scatter_table_case(gen, device, TRAIN_BUDGET, field.color_enc,
                                             f"{name} nonzero table, color", dtype))
    return cases


def tables_keep_their_dtype(run: dict) -> bool:
    """Whether a trained state's tables are still in the field's
    `grid_dtype`, and its MLPs and both Adam moments f32."""
    state, want = run["state"], run["trainer"].field.cfg.table_dtype
    moments = tree_paths(state.opt_state.m) + tree_paths(state.opt_state.v)
    return (all(t.dtype == (want if path[0].endswith("grid") else torch.float32)
                for path, t in tree_paths(state.params))
            and all(t.dtype == torch.float32 for _, t in moments))


def cohort_service(device, datasets: list, persist_dir: str, field_cfg: FieldConfig,
                   cfg: TrainerConfig = TrainerConfig(), iters: int = SERVICE_ITERS,
                   held_out: int = HELD_OUT, **kw) -> dict:
    """`service_main_path` (`kw` goes to it) with one session of `field_cfg`
    per dataset, all one cohort, then each session's final state against a
    plain `train` of its scene from its seed: params, both Adam moments, the
    occupancy EMA and the steps byte for byte (cohort == sequential)."""
    run = service_main_path(device, datasets, persist_dir, cfg,
                            plan=((field_cfg, iters),) * len(datasets), held_out=held_out,
                            **kw)
    views = range(held_out, datasets[0].images.shape[0])
    run["vs_sequential"] = {}
    for k, (sid, sess) in enumerate(run["service"].sessions.items()):
        tr = Instant3DTrainer(Field(field_cfg), cfg, device=device)
        state, _ = tr.train(tr.init(torch.Generator().manual_seed(k)),
                            RaySampler(datasets[k], views=views, device=device), iters=iters,
                            log_every=iters)
        run["vs_sequential"][sid] = _state_equal(state, sess.state)
    return run


def _grid_dtype_phase(device, card: str, f32_runs: dict) -> dict:
    """Phase 9: the 2-byte kernel cases; both fields trained at bf16 (their
    PSNR beside the f32 runs' of `f32_runs`); 800x800 served from the
    trained bf16 snapshot on the redistributed route, eval == served; a
    two-session bf16 cohort in the service, cohort == sequential; the
    service's four bit-identity contracts at bf16 (phase 5's)."""
    t0 = time.perf_counter()
    cases = grid_dtype_parity(device)
    failed = [f"{c['kernel']} {c['case']}" for c in cases if not _print_case(c, card)]
    print(f"grid_dtype parity: {len(cases)} cases in {time.perf_counter() - t0:.2f} s",
          flush=True)
    if failed:
        raise RuntimeError(f"grid_dtype kernel parity failed: {failed}")

    field_cfg = FieldConfig(grid_dtype=GRID_DTYPE)
    runs = {}
    for name, cfg, path in (("train", field_cfg, TRAIN_KERNELS),
                            ("train_ngp", dataclasses.replace(field_cfg, decomposed=False),
                             NGP_TRAIN_KERNELS)):
        t0 = time.perf_counter()
        run = train_main_path(device, cfg)
        label = f"{name}_{GRID_DTYPE}"
        print(f"{label}: {TrainerConfig().iters} steps + held-out eval in "
              f"{time.perf_counter() - t0:.2f} s [{card}]")
        _print_training(run, card, label)
        problems = check_training(run, path)
        if not tables_keep_their_dtype(run):
            problems.append("the trained tables left their dtype or the moments left f32")
        if problems:
            raise RuntimeError(f"{label} gate failed: {problems}")
        runs[name] = run
    print(f"grid_dtype held-out PSNR {GRID_DTYPE} vs float32 [{card}]: " + json.dumps(
        {name: {GRID_DTYPE: run["eval"], "float32": f32_runs[name]["eval"]}
         for name, run in runs.items()}), flush=True)

    served = serve_trained(device, runs["train"], n_requests=GRID_SERVE_REQUESTS,
                           session_id="redist")
    print(f"serve_{GRID_DTYPE}: drained {len(served['results'])} requests in "
          f"{served['wall_s']:.3f} s, {served['samples_per_ray']} samples a ray [{card}]")
    print(f"serve_{GRID_DTYPE} latency_stats [{card}]: {json.dumps(served['latency'])}")
    print(f"serve_{GRID_DTYPE}-path launches: {json.dumps(served['launches'])}")
    print(f"serve_{GRID_DTYPE} eval == served: {json.dumps(served['eval_vs_served'])}",
          flush=True)
    missing = [k for k in SERVE_KERNELS if served["launches"].get(k, 0) == 0]
    if missing or not all(served["eval_vs_served"].values()):
        raise RuntimeError(f"serve_{GRID_DTYPE} failed: never launched {missing}, "
                           f"eval vs served {served['eval_vs_served']}")

    datasets = service_datasets(device, n=2)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        service = cohort_service(device, datasets, f"{tmp}/snapshots", field_cfg)
        wall = time.perf_counter() - t0
        _print_service(service, card)
        print(f"service_{GRID_DTYPE} cohort == sequential ({wall:.2f} s) [{card}]: "
              f"{json.dumps(service['vs_sequential'])}", flush=True)
        problems = check_service(service, must_launch=TRAIN_KERNELS[0] + SERVE_KERNELS,
                                 cohorts={2})
        if not all(all(v.values()) for v in service["vs_sequential"].values()):
            problems.append("a cohort member is not its sequential run's bytes")
        if problems:
            raise RuntimeError(f"service_{GRID_DTYPE} gate failed: {problems}")
        t0 = time.perf_counter()
        ident = service_identity(device, datasets, f"{tmp}/ckpt", field_cfg)
    print(f"service_{GRID_DTYPE} bit identity ({time.perf_counter() - t0:.2f} s) [{card}]: "
          f"{json.dumps(ident)}", flush=True)
    if not identity_holds(ident):
        raise RuntimeError(f"a bit-identity contract failed at {GRID_DTYPE}: {ident}")
    return {"cases": cases, "train_launches": runs["train"]["launches"],
            "train_ngp_launches": runs["train_ngp"]["launches"],
            "serve_launches": served["launches"], "service_launches": service["launches"],
            "run": runs["train"]}


# ---- the script ---------------------------------------------------------------

# ---- phase 10: compiled steps -------------------------------------------------

def graph_stats() -> dict:
    """What the compiled-step and fold caches hold: built step variants,
    graphs (one per variant and device), their replays (a cohort's graph
    replays once a step for all its members), the fold graphs' replays,
    capture ms by variant key (without the configs), the warm-ups'
    launches and the graphs' static bytes."""
    out = {"variants": len(trainer_lib._COHORT_STEP_CACHE), "graphs": 0, "replays": 0,
           "fold_graphs": 0, "fold_replays": 0, "static_bytes": 0, "capture_ms": {},
           "warmup_launches": Counter()}
    for table, kind in ((trainer_lib._COHORT_STEP_CACHE, "step"),
                        (trainer_lib._OCC_UPDATE_CACHE, "fold")):
        for key, entry in table.items():
            for graph in entry.graphs.values():
                out["graphs" if kind == "step" else "fold_graphs"] += 1
                out["replays" if kind == "step" else "fold_replays"] += graph.replays
                out["static_bytes"] += graph.static_bytes
                out["warmup_launches"].update(graph.warmup_launches)
                if kind == "step":
                    out["capture_ms"][str(key[2:])] = round(graph.capture_ms, 3)
    return out


RENDER_CACHES = ("_EVAL_RENDER_CACHE", "_REDIST_RENDER_CACHE", "_BATCH_RENDER_CACHE")
# the caches whose entries hold graphs: a batched entry renders through its
# member render (`trainer._MEMBER_RENDERS`)
GRAPH_HOLDERS = {"eval": "_EVAL_RENDER_CACHE", "redist": "_REDIST_RENDER_CACHE",
                 "member": "_MEMBER_RENDERS"}


def key_tail(key: tuple) -> tuple:
    """A render-cache key without its configs: (chunk,) for
    `eval_render_fn`, (chunk, group) and (chunk, group, spr, v3) for the
    batched entries, (chunk,) and (chunk, spr, v3) for their members."""
    return tuple(k for k in key if isinstance(k, (bool, int)))


def render_graph_stats() -> dict:
    """What the render caches hold: entries (the reference's three
    caches), graphs (one per eval or member key and device), their replays
    (one a chunk of a member's view) and binds (one a member's view),
    capture ms by holder and key tail (summed over the configs that share
    one), the warm-ups' launches and the graphs' static bytes."""
    out = {"entries": sum(len(getattr(trainer_lib, t)) for t in RENDER_CACHES),
           "graphs": 0, "replays": 0, "binds": 0, "static_bytes": 0,
           "capture_ms": {}, "warmup_launches": Counter()}
    for holder, table in GRAPH_HOLDERS.items():
        for key, entry in getattr(trainer_lib, table).items():
            for graph in entry.graphs.values():
                out["graphs"] += 1
                out["replays"] += graph.replays
                out["binds"] += graph.binds
                out["static_bytes"] += graph.static_bytes
                out["warmup_launches"].update(graph.warmup_launches)
                tail = f"{holder} {key_tail(key)}"
                out["capture_ms"][tail] = round(out["capture_ms"].get(tail, 0.0)
                                                + graph.capture_ms, 3)
    return out


def print_graphs(name: str, card: str) -> dict:
    """Print and return `graph_stats` for a phase, with its render graphs'
    (`render_graph_stats`, under "renders"), then drop both caches so the
    next phase holds only its own graphs.  A phase that rendered on the
    card must have replayed a render graph."""
    stats = graph_stats()
    summary = {k: v for k, v in stats.items() if k not in ("capture_ms", "warmup_launches")}
    summary["capture_ms_total"] = round(sum(stats["capture_ms"].values()), 3)
    print(f"{name} compiled steps [{card}]: {json.dumps(summary)}", flush=True)
    stats["renders"] = renders = render_graph_stats()
    summary = {k: v for k, v in renders.items() if k not in ("capture_ms", "warmup_launches")}
    summary["capture_ms"] = renders["capture_ms"]
    print(f"{name} compiled renders [{card}]: {json.dumps(summary)}", flush=True)
    clear_step_cache()
    clear_render_cache()
    if renders["graphs"] and not renders["replays"]:
        raise RuntimeError(f"{name}: a render graph was built and never replayed")
    return stats


def compiled_run(sampler, field_cfg: FieldConfig, cfg: TrainerConfig, iters: int) -> dict:
    """`iters` steps from `cfg.seed` on `sampler`, every step logged, launch
    counters zeroed just before and read just after."""
    device = sampler.device
    trainer = Instant3DTrainer(Field(field_cfg), cfg, device=device)
    state = trainer.init()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, hist = trainer.train(state, sampler, iters=iters, log_every=1)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    walls = np.diff(np.asarray([0.0] + hist["wall_s"])) * 1e3
    return {"trainer": trainer, "state": state, "hist": hist, "wall_s": wall,
            "launches": dict(kernels.LAUNCHES),
            "dense_ms": [w for w, b in zip(walls, hist["budget"]) if b is None],
            "compact_ms": [w for w, b in zip(walls, hist["budget"]) if b is not None]}


def variants_taken(run: dict, field_cfg: FieldConfig, cfg: TrainerConfig) -> set:
    """The step-cache keys (without the configs) of the variants a run's
    steps took, from its history: step i freezes by the schedule, reads the
    bitfield after the first fold before it, and shades at its budget."""
    hist, keys = run["hist"], set()
    for step, budget in zip(hist["step"], hist["budget"]):
        i = step - 1
        keys.add(((not _branch_update(i, cfg.f_color)) and field_cfg.decomposed,
                  not _branch_update(i, cfg.f_density), budget,
                  cfg.use_occupancy and any(f < i for f in hist["occ_folds"]), 1))
    return keys


def same_run(a: dict, b: dict) -> dict:
    """Two runs' final params, Adam moments and step, occupancy grid and
    its fold count, histories (loss, budgets, overflow, live fraction,
    points, folds) and the trainers' live fraction and overflow window:
    equal byte for byte, each."""
    sa, sb = a["state"], b["state"]
    ta, tb = a["trainer"], b["trainer"]
    return {
        "params": _bits(sa.params) == _bits(sb.params),
        "adam": (_bits(sa.opt_state.m) == _bits(sb.opt_state.m)
                 and _bits(sa.opt_state.v) == _bits(sb.opt_state.v)
                 and int(sa.opt_state.step) == int(sb.opt_state.step)),
        "occupancy": (_bits({"e": sa.occ_state.density_ema}) == _bits(
            {"e": sb.occ_state.density_ema}) and sa.occ_state.step == sb.occ_state.step
            and sa.step == sb.step),
        "history": all(a["hist"][k] == b["hist"][k] for k in COMPILED_HISTORY),
        "trainer": (ta._live_frac == tb._live_frac
                    and ta._overflow_window == tb._overflow_window),
    }


def compiled_against_eager(sampler, field_cfg: FieldConfig, cfg: TrainerConfig,
                           iters: int) -> dict:
    """One path trained captured (the cache emptied first) and under
    `eager_steps()`, from one seed: the two runs, whether they end on the
    same bytes, the built keys against the variants taken, the graphs
    (`graph_stats`), the card memory they hold (reserved bytes with the
    graphs alive less without, both after `empty_cache`) and whether the
    captured run's launches less its warm-ups' are the eager run's, kernel
    for kernel."""
    device = torch.device(sampler.device)
    clear_step_cache()
    captured = compiled_run(sampler, field_cfg, cfg, iters)
    stats = graph_stats()
    keys = captured["trainer"].step_cache_keys()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_stats(device)["reserved_bytes.all.current"]
    clear_step_cache()
    gc.collect()
    torch.cuda.empty_cache()
    held -= torch.cuda.memory_stats(device)["reserved_bytes.all.current"]
    with eager_steps():
        eager = compiled_run(sampler, field_cfg, cfg, iters)
    warm = stats["warmup_launches"]
    diff = {k: captured["launches"][k] - warm.get(k, 0) - eager["launches"][k]
            for k in captured["launches"]}
    return {"captured": captured, "eager": eager, "same": same_run(captured, eager),
            "keys": keys, "taken": variants_taken(captured, field_cfg, cfg), "stats": stats,
            "graph_bytes": held, "launch_diff": diff,
            "replayed_steps": stats["replays"] == iters,
            "folds_replayed": stats["fold_replays"] == len(captured["hist"]["occ_folds"])}


def profile_replayed_step(timeout_s: float = TRAIN_PROFILE_TIMEOUT_S) -> dict:
    """`tools/torch_train_profile.py` in its own process -> its JSON report
    (each route's step eagerly and as a replay)."""
    tool = Path(__file__).resolve().parents[2] / "tools" / "torch_train_profile.py"
    done = subprocess.run([sys.executable, str(tool)], capture_output=True, text=True,
                          timeout=timeout_s)
    if done.returncode != 0:
        raise RuntimeError(f"{tool.name} exited {done.returncode}:\n"
                           f"{done.stdout[-4000:]}\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def _compiled_phase(device, card: str) -> dict:
    """Phase 10: each `COMPILED_PATHS` path captured against eager, then one
    profiled replay of each route."""
    _, ds = build_dataset(0, device=device)
    sampler = RaySampler(ds, views=range(HELD_OUT, ds.images.shape[0]), device=device)
    out, problems = {}, []
    for name, field_cfg, cfg, iters in COMPILED_PATHS:
        t0 = time.perf_counter()
        res = compiled_against_eager(sampler, field_cfg, cfg, iters)
        out[name] = res
        cap, eag, stats = res["captured"], res["eager"], res["stats"]
        print(f"compiled {name}: {iters} steps captured and eager in "
              f"{time.perf_counter() - t0:.2f} s [{card}]")
        print(f"compiled {name} same bytes as eager_steps(): {json.dumps(res['same'])}")
        print(f"compiled {name} keys {sorted(map(str, res['keys']))} == variants taken: "
              f"{res['keys'] == res['taken']}")
        print(f"compiled {name} capture ms per variant [{card}]: "
              f"{json.dumps(stats['capture_ms'])}")
        print(f"compiled {name} median step ms captured / eager [{card}]: " + json.dumps(
            {route: [_warm_median(cap[f"{route}_ms"]), _warm_median(eag[f"{route}_ms"])]
             for route in ("dense", "compact")}) + f", wall s {cap['wall_s']:.3f} / "
            f"{eag['wall_s']:.3f}", flush=True)
        print(f"compiled {name} graphs [{card}]: {stats['graphs']} step + "
              f"{stats['fold_graphs']} fold, replays {stats['replays']} + "
              f"{stats['fold_replays']}, memory {res['graph_bytes'] / 2**20:.1f} MiB "
              f"reserved (static buffers {stats['static_bytes'] / 2**20:.1f} MiB), "
              f"warm-up launches {json.dumps(dict(stats['warmup_launches']))}")
        print(f"compiled {name} launches: captured {json.dumps(cap['launches'])}, eager "
              f"{json.dumps(eag['launches'])}, captured - warm-ups - eager "
              f"{json.dumps(res['launch_diff'])}", flush=True)
        if not all(res["same"].values()):
            problems.append(f"{name}: captured and eager runs differ: {res['same']}")
        if res["keys"] != res["taken"]:
            problems.append(f"{name}: keys {res['keys']} != variants taken {res['taken']}")
        if any(res["launch_diff"].values()):
            problems.append(f"{name}: launches differ from eager: {res['launch_diff']}")
        if not (res["replayed_steps"] and res["folds_replayed"]):
            problems.append(f"{name}: a step or fold did not replay: {stats['replays']} "
                            f"replays for {iters} steps")
    clear_step_cache()
    if problems:
        raise RuntimeError(f"compiled-step gate failed: {problems}")
    t0 = time.perf_counter()
    prof = profile_replayed_step()
    routes = ("dense", "compacted", "compacted_color_frozen")
    keys = ("wall_ms", "device_busy_ms", "device_idle_share", "host_wall_ms",
            "device_idle_share_unprofiled", "device_launches")
    print(f"step profile ({time.perf_counter() - t0:.1f} s, tools/torch_train_profile.py) "
          f"[{card}]: " + json.dumps(
              {route: {"eager": {k: prof[route][k] for k in keys},
                       "replayed": {k: prof[route]["replayed"][k] for k in keys}}
               for route in routes}), flush=True)
    print(f"replayed step copies and graph [{card}]: " + json.dumps(
        {route: {k: prof[route]["replayed"][k] for k in ("copy_in_ms", "copy_out_ms",
                                                          "graph_replay_ms", "call_ms",
                                                          "capture_ms")}
         for route in routes}), flush=True)
    return {"paths": out, "profile": prof}


# ---- phase 11: compiled renders -----------------------------------------------

def route_service(device, run: dict, route: str, hw: int = IMAGE_HW) -> RenderService:
    """A `RenderService` with a trained run's snapshot as session `route`:
    dense when the route is "dense", else on the redistributed route its
    trainer renders (S' = 12 a ray; stage 2b v3 for a v3 run)."""
    tr, state = run["trainer"], run["state"]
    cfg = tr.cfg
    store = SnapshotStore()
    store.publish(route, state.params, step=state.step, occ=state.occ_state)
    svc = RenderService(store, device=device)
    spr = None if route == "dense" else default_samples_per_ray(cfg.render.n_samples)
    svc.register_session(route, tr.field.cfg, cfg.render, hw, hw, focal_for(hw),
                         eval_chunk=cfg.eval_chunk, occ_cfg=cfg.occ, samples_per_ray=spr,
                         redistribute_v3=cfg.redistribute_v3)
    return svc


def route_drain(svc: RenderService, route: str, hw: int, group: int = RENDER_GROUP,
                seed: int = 0) -> dict:
    """One drain of `group` full-resolution views of session `route` (one
    group, keyed as padded to a power of two) and one level-1 preview, launch
    counters zeroed just before and read just after: the results, the
    drain's wall and its launches."""
    poses = sphere_poses(group, seed=seed)
    kernels.reset_launches()
    t0 = time.perf_counter()
    for pose in poses:
        svc.submit(route, pose)
    svc.submit(route, poses[0], level=1)
    results = svc.drain()
    if svc.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_results(results, svc, hw, group + 1)
    return {"results": results, "wall_s": wall, "launches": dict(kernels.LAUNCHES)}


def groups_taken(svc: RenderService, results: list) -> tuple[set, int]:
    """The batched-cache key tails a drain's groups took -- per (session
    geometry, level): (chunk, padded group), with (samples per ray, v3) on
    the redistributed route -- and the chunks their real members rendered
    (the padding renders nothing)."""
    sizes, geoms = Counter(), {}
    for r in results:
        geom = svc._geom[r.session_id]
        key = (dataclasses.astuple(geom), r.level)
        sizes[key] += 1
        geoms[key] = geom
    tails, chunks = set(), 0
    for key, g in sizes.items():
        geom, level = geoms[key], key[1]
        n = max(1, geom.h >> level) * max(1, geom.w >> level)
        chunk = min(geom.eval_chunk, n)
        tail = (chunk, _pow2_bucket(g))
        if geom.samples_per_ray is not None:
            tail += (geom.samples_per_ray, geom.redistribute_v3)
        tails.add(tail)
        chunks += g * -(-n // chunk)
    return tails, chunks


def _same_pixels(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x.rgb, y.rgb) and np.array_equal(x.depth, y.depth) for x, y in zip(a, b))


def _pool_bytes(pool) -> int:
    """Bytes of the card's memory segments in graph pool `pool`."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def route_latency(svc: RenderService, route: str, hw: int, n: int = LATENCY_REQUESTS,
                  seed: int = 1) -> dict:
    """`n` lone full-resolution requests of session `route`, each submitted
    once the one before is answered (each its own drain, so no two
    answers land together): p50 / p95 / max of their latencies (ms,
    submit to answer, `RenderResult.latency_s`) and the walls (s)."""
    lat = []
    t0 = time.perf_counter()
    for pose in sphere_poses(n, seed=seed):
        svc.submit(route, pose)
        results = svc.drain()
        check_results(results, svc, hw, 1)
        lat.append(results[0].latency_s * 1e3)
    wall = time.perf_counter() - t0
    return {"n": n, "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)), "max_ms": float(max(lat)),
            "wall_s": wall, "latency_ms": lat}


def compiled_against_eager_renders(device, run: dict, route: str, hw: int = IMAGE_HW,
                                   n_latency: int = LATENCY_REQUESTS) -> dict:
    """One route served captured (the render cache emptied first: a drain
    that captures, then one that only replays, then `n_latency` lone
    requests) and under `eager_steps()` (one drain, then the lone
    requests): the drains and latencies, whether the drains' pixels are
    the same bytes, the built keys against the groups taken, the graphs
    (`render_graph_stats`), whether every chunk was a replay, the card
    memory the graphs hold (reserved bytes with them alive less without)
    and their pool's bytes, and the captured launches less the warm-ups'
    against the eager ones."""
    clear_render_cache()
    svc = route_service(device, run, route, hw)
    captured = [route_drain(svc, route, hw) for _ in range(2)]
    stats = render_graph_stats()
    keys = {key_tail(k) for k in trainer_lib._BATCH_RENDER_CACHE}
    taken = [groups_taken(svc, d["results"]) for d in captured]
    latency = route_latency(svc, route, hw, n_latency)
    after = render_graph_stats()
    n = hw * hw
    chunk = min(run["trainer"].cfg.eval_chunk, n)
    latency_replayed = (after["graphs"] == stats["graphs"]
                        and after["replays"] - stats["replays"] == n_latency * -(-n // chunk))
    on_card = torch.device(device).type == "cuda"
    graphs = [g for entry in trainer_lib._MEMBER_RENDERS.values()
              for g in entry.graphs.values()]
    pool = held = 0
    if on_card:
        pool = _pool_bytes(graphs[0].dev.pool)
        torch.cuda.empty_cache()
        held = torch.cuda.memory_stats(device)["reserved_bytes.all.current"]
    del graphs
    clear_render_cache()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        held -= torch.cuda.memory_stats(device)["reserved_bytes.all.current"]
    with eager_steps():
        eager = route_drain(svc, route, hw)
        eager_latency = route_latency(svc, route, hw, n_latency)
    clear_render_cache()
    warm = stats["warmup_launches"]
    diff = {k: captured[0]["launches"][k] - warm.get(k, 0) - eager["launches"][k]
            for k in eager["launches"]}
    replay_diff = {k: captured[1]["launches"][k] - eager["launches"][k]
                   for k in eager["launches"]}
    return {"captured": captured, "eager": eager, "stats": stats,
            "latency": {"captured": latency, "eager": eager_latency},
            "same": {"capture_drain": _same_pixels(captured[0]["results"], eager["results"]),
                     "replay_drain": _same_pixels(captured[1]["results"], eager["results"])},
            "keys": keys, "taken": taken[0][0] | taken[1][0],
            "every_chunk_replayed": (stats["replays"] == taken[0][1] + taken[1][1]
                                     and latency_replayed),
            "chunks": taken[0][1] + taken[1][1], "graph_bytes": held, "pool_bytes": pool,
            "launch_diff": diff, "replay_launch_diff": replay_diff,
            "launches": {k: captured[0]["launches"][k] + captured[1]["launches"][k]
                         for k in eager["launches"]}}


def _ms_per_view(drain: dict, hw: int = IMAGE_HW) -> float:
    """A drain's wall per 800x800 of pixels served (a level-1 preview is a
    quarter view)."""
    pixels = sum(r.rgb.shape[0] * r.rgb.shape[1] for r in drain["results"])
    return drain["wall_s"] * 1e3 * hw * hw / pixels


def _compiled_render_phase(device, card: str, runs: dict) -> dict:
    """Phase 11: each `COMPILED_ROUTES` route served captured against
    eager from its trained run (`runs`: route -> a `train_main_path`-like
    run)."""
    out, problems = {}, []
    for route, name in COMPILED_ROUTES.items():
        t0 = time.perf_counter()
        res = compiled_against_eager_renders(device, runs[name], route)
        out[route] = res
        stats, cap, eag = res["stats"], res["captured"], res["eager"]
        print(f"compiled render {route}: {RENDER_GROUP} views (a group padded to "
              f"{_pow2_bucket(RENDER_GROUP)}, its members only rendered) + a level-1 preview, "
              f"drained captured twice and eager once, then {LATENCY_REQUESTS} lone requests "
              f"each way, in {time.perf_counter() - t0:.2f} s [{card}]")
        print(f"compiled render {route} same bytes as eager_steps(): {json.dumps(res['same'])}")
        print(f"compiled render {route} keys {sorted(map(str, res['keys']))} == groups taken: "
              f"{res['keys'] == res['taken']}")
        print(f"compiled render {route} capture ms per key [{card}]: "
              f"{json.dumps(stats['capture_ms'])}")
        lat = {mode: {k: v for k, v in res["latency"][mode].items() if k != "latency_ms"}
               for mode in ("captured", "eager")}
        print(f"compiled render {route} latency of {LATENCY_REQUESTS} lone requests, each its "
              f"own drain, captured (replays only) / eager [{card}]: {json.dumps(lat)}",
              flush=True)
        print(f"compiled render {route} group drain ms per view captured (replays only) / "
              f"eager [{card}]: {_ms_per_view(cap[1]):.3f} / {_ms_per_view(eag):.3f}, drain "
              f"wall s {cap[0]['wall_s']:.3f} (captures) / {cap[1]['wall_s']:.3f} / "
              f"{eag['wall_s']:.3f}", flush=True)
        print(f"compiled render {route} graphs [{card}]: {stats['graphs']}, replays "
              f"{stats['replays']} for {res['chunks']} chunks, binds {stats['binds']}, memory "
              f"{res['graph_bytes'] / 2**20:.1f} MiB reserved (static buffers "
              f"{stats['static_bytes'] / 2**20:.1f} MiB, render pool "
              f"{res['pool_bytes'] / 2**20:.1f} MiB), warm-up launches "
              f"{json.dumps(dict(stats['warmup_launches']))}")
        print(f"compiled render {route} launches: captured {json.dumps(cap[0]['launches'])}, "
              f"eager {json.dumps(eag['launches'])}, captured - warm-ups - eager "
              f"{json.dumps(res['launch_diff'])}, replay drain - eager "
              f"{json.dumps(res['replay_launch_diff'])}", flush=True)
        if not all(res["same"].values()):
            problems.append(f"{route}: captured and eager pixels differ: {res['same']}")
        if res["keys"] != res["taken"]:
            problems.append(f"{route}: keys {res['keys']} != groups taken {res['taken']}")
        if any(res["launch_diff"].values()) or any(res["replay_launch_diff"].values()):
            problems.append(f"{route}: launches differ from eager: {res['launch_diff']}, "
                            f"{res['replay_launch_diff']}")
        if not res["every_chunk_replayed"]:
            problems.append(f"{route}: {stats['replays']} replays for {res['chunks']} chunks, "
                            f"or a lone request's chunk was not a replay")
        missing = [k for k in SERVE_KERNELS if res["launches"].get(k, 0) == 0]
        if missing:
            problems.append(f"{route}: never launched {missing}")
    if problems:
        raise RuntimeError(f"compiled-render gate failed: {problems}")
    return out


def _ptxas_summary(logs: dict[str, str]) -> list[str]:
    lines = []
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if re.search(r"Used \d+ registers|spill", line):
                lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


def _print_case(c: dict, card: str) -> bool:
    tol = TOLERANCE[c["kernel"]]
    err = c.get("err", c["max_abs_err"])
    ok = c.get("ok", err <= tol)
    bound_ms, bound_by = c["bound"]
    extra = ""
    if "table_rel_err" in c:
        extra += (f" table_rel_err {c['table_rel_err']:.3e} (tol {BWD_TABLE_TOL:.0e}) "
                  f"nonzero_rows_equal {c['nonzero_rows_equal']}")
    if "exact" in c:
        extra += f" exact {c['exact']}"
        if "nonzero_rows_equal" in c:
            extra += f" nonzero_rows_equal {c['nonzero_rows_equal']}"
    if "deterministic" in c:
        ok = ok and c["deterministic"]
        extra += f" two launches byte-identical {c['deterministic']}"
    if c["kernel"] == "hash_encode":
        extra += f" sentinel rows zero {c['sentinel_rows_zero']}"
    if "dedup" in c:
        d = c["dedup"]
        extra += (f" distinct reads {d['reads_kernel']} (plain {d['reads_plain']}, per block "
                  f"equal {d['per_block_equal']}) unique_ratio_block "
                  f"{d['unique_ratio_block_kernel']:.6f} (plain "
                  f"{d['unique_ratio_block_plain']:.6f}, tol {DEDUP_RATIO_TOL:.0e}) "
                  f"sentinel rows zero {c['sentinel_rows_zero']}")
    if "upcast_identical" in c:
        ok = ok and c["upcast_identical"]
        extra += (f" {c['dtype']}: same bytes as on the f32 copy {c['upcast_identical']} "
                  f"(f32 kernel {c['f32_ms']:.4f} ms)")
    if c.get("library_ms") is not None:
        extra += f"  library {c['library_ms']:.4f} ms"
    print(f"parity {c['kernel']:<14} {c['case']:<28} err {err:.3e} (tol {tol:.0e}) "
          f"max_abs_err {c['max_abs_err']:.3e}{extra} {'ok' if ok else 'FAIL'}  "
          f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  "
          f"bound {bound_ms:.4f} ms ({bound_by})  [{card}]", flush=True)
    return ok


def _print_training(run: dict, card: str, name: str) -> None:
    hist = run["hist"]
    for k in range(49, len(hist["step"]), 50):
        print(f"{name} step {hist['step'][k]:>4} loss {hist['loss'][k]:.6f} "
              f"live_fraction {hist['live_fraction'][k]:.4f} "
              f"budget {hist['budget'][k]}")
    budgets = dict(sorted(Counter(b for b in hist["budget"] if b is not None).items()))
    for route in ("dense", "compact"):
        ms = np.asarray(run[f"{route}_ms"])
        if ms.size:
            print(f"{name} {route} steps {ms.size}: median {_warm_median(ms):.3f} ms, "
                  f"mean {_warm(ms).mean():.3f} ms (after the first 2), first {ms[0]:.1f} ms "
                  f"[{card}]")
    print(f"{name} budgets (steps at each) {budgets} first compacted step "
          f"{next((s - 1 for s, b in zip(hist['step'], hist['budget']) if b), None)} "
          f"occupancy folds {len(hist['occ_folds'])} overflow_total {hist['overflow_total']}")
    print(f"{name} held-out PSNR [{card}]: {json.dumps(run['eval'])}")
    print(f"{name}-path launches: {json.dumps(run['launches'])}", flush=True)


def _warm(ms: np.ndarray) -> np.ndarray:
    return ms[2:] if ms.size > 2 else ms


def _warm_median(ms) -> float:
    ms = np.asarray(ms)
    return float(np.median(_warm(ms))) if ms.size else float("nan")


def _train_phase(device, field_cfg: FieldConfig, name: str, kernels_of_path, card: str,
                 determinism_steps=DETERMINISM_STEPS):
    """One training main path with its gates, then its determinism check."""
    t0 = time.perf_counter()
    run = train_main_path(device, field_cfg)
    print(f"{name}: {TrainerConfig().iters} steps + held-out eval in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    _print_training(run, card, name)
    problems = check_training(run, kernels_of_path)
    if problems:
        raise RuntimeError(f"{name} gate failed: {problems}")
    det = determinism(device, field_cfg, steps=determinism_steps)
    print(f"{name} determinism: {json.dumps(det)}", flush=True)
    if not (det["params_equal"] and det["moments_equal"] and det["occupancy_equal"]
            and det["compacted_steps"] > 0):
        raise RuntimeError(f"{name}: two runs from one seed differ: {det}")
    return run


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    device = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs) or 'nothing'} "
          f"(built in parallel, one nvcc per source)", flush=True)
    for line in _ptxas_summary(logs):
        print(f"ptxas {line}")

    cases = kernel_parity(device)
    failed = [f"{c['kernel']} {c['case']}" for c in cases if not _print_case(c, card)]
    if failed:
        raise RuntimeError(f"kernel parity failed: {failed}")
    breakdown = [fused_step_bwd_breakdown(device, n) for n in (TRAIN_BUDGET, PARITY_BUDGET)]
    for b in breakdown:
        print(f"fused_step_bwd breakdown [{card}]: {json.dumps(b)}", flush=True)
    ident = fused_encode_backward_identity(device)
    print(f"fused_encode backward vs hash_encode backward: {json.dumps(ident)}", flush=True)
    if not all(ident["bit_identical"]) or \
            ident["forward_max_abs_err"] > TOLERANCE["fused_encode"]:
        raise RuntimeError(f"fused encode gradients differ from hash encode's: {ident}")

    # slice 2's main path: training Instant-3D, then its split route
    clear_step_cache()
    clear_render_cache()
    run = _train_phase(device, FieldConfig(), "train", TRAIN_KERNELS, card)
    print_graphs("train", card)
    split = split_route_parity(device, run)
    print(f"split route vs one-op step (compacted, trained state): {json.dumps(split)} "
          f"(tol tables {SPLIT_TABLE_TOL:.0e}, MLP {SPLIT_MLP_TOL:.0e} relative)", flush=True)
    if not split["ok"] or split["fused_encode_launches"] == 0:
        raise RuntimeError(f"the split route disagrees with the one-op step: {split}")
    # this slice's main path: training the Instant-NGP baseline
    ngp = _train_phase(device, FieldConfig(decomposed=False), "train_ngp",
                       NGP_TRAIN_KERNELS, card, NGP_DETERMINISM_STEPS)
    print_graphs("train_ngp", card)
    ratios = {route: _warm_median(run[f"{route}_ms"]) / _warm_median(ngp[f"{route}_ms"])
              for route in ("dense", "compact")}
    print(f"step time Instant-3D / Instant-NGP (median ms ratio): {json.dumps(ratios)} "
          f"[{card}]", flush=True)

    # slice 1's main path: serving, from the trained snapshot
    field_cfg, render_cfg = FieldConfig(), RenderConfig()
    occ_cfg = occupancy.OccupancyConfig()
    n_requests = 4
    store = snapshot_store(run["state"].params, run["state"].occ_state)
    svc = make_service(store, device, field_cfg, render_cfg, occ_cfg, IMAGE_HW, EVAL_CHUNK)
    kernels.reset_launches()
    t0 = time.perf_counter()
    results = serve_requests(svc, IMAGE_HW, n_requests, seed=0)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    serve_launches = dict(kernels.LAUNCHES)
    missing = [k for k in SERVE_KERNELS if serve_launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"serving never launched: {missing} (counts {serve_launches})")
    print(f"serve: drained {len(results)} requests in {wall:.3f} s [{card}]")
    for r in results:
        print(f"  request {r.request_id} {r.session_id:<6} level {r.level} "
              f"{r.rgb.shape[0]}x{r.rgb.shape[1]} latency {r.latency_s * 1e3:.1f} ms "
              f"rgb [{r.rgb.min():.4f}, {r.rgb.max():.4f}] depth mean {r.depth.mean():.4f}")
    print(f"latency_stats [{card}]: {json.dumps(svc.latency_stats())}")
    print(f"serve-path launches: {json.dumps(serve_launches)}")
    agree = path_parity(store, device, field_cfg, render_cfg, occ_cfg)
    print(f"path vs plain versions on the CPU (32x32): {json.dumps(agree)}")
    for sid, e in agree.items():
        if e["rgb_max_abs_err"] > PATH_RGB_TOL or e["depth_max_abs_err"] > PATH_DEPTH_TOL:
            raise RuntimeError(f"served path disagrees with the plain versions on {sid}: {e}")
    if print_graphs("serve", card)["renders"]["replays"] == 0:
        raise RuntimeError("the served views rendered no chunk through a compiled graph")

    # slice 9's main path: the reconstruction service, then its contracts
    datasets = service_datasets(device)
    with tempfile.TemporaryDirectory() as tmp:
        service = service_main_path(device, datasets, f"{tmp}/snapshots")
        _print_service(service, card)
        problems = check_service(service)
        if problems:
            raise RuntimeError(f"service gate failed: {problems}")
        t0 = time.perf_counter()
        ident = service_identity(device, datasets, f"{tmp}/ckpt")
        print(f"service bit identity ({time.perf_counter() - t0:.2f} s) [{card}]: "
              f"{json.dumps(ident)}", flush=True)
        if not identity_holds(ident):
            raise RuntimeError(f"a bit-identity contract failed: {ident}")
    if print_graphs("service", card)["replays"] == 0:
        raise RuntimeError("the service trained no step through a compiled graph")

    # slice 10's main path: stage 2b v3 under a hard point ceiling
    v3 = _v3_phase(device, card)
    cases.extend(v3["cases"])
    print_graphs("v3", card)

    # slice 11's main paths: the async serving plane, the entry points
    plane = _async_phase(device, card)
    print_graphs("async", card)
    # slice 12's main paths: sessions over two slots, the last two options
    placed = _placement_phase(device, card)
    print_graphs("placement", card)
    # slice 13's main paths: half-width tables, trained, served, in a cohort
    half = _grid_dtype_phase(device, card, {"train": run, "train_ngp": ngp})
    cases.extend(half["cases"])
    print_graphs(GRID_DTYPE, card)
    # slice 14's main paths: each training path captured against eager
    compiled = _compiled_phase(device, card)
    # this slice's main paths: each serving route captured against eager
    renders = _compiled_render_phase(device, card, {
        "train": run, "train_v3": v3["run"], f"train_{GRID_DTYPE}": half["run"]})
    # slice 16's main paths: the LM substrate's dense decoders at full width
    clear_step_cache()
    clear_render_cache()
    gc.collect()
    torch.cuda.empty_cache()
    lm = smoke_lm.lm_phase(device, card)
    cases.extend(lm["cases"])
    # slice 17's main paths: MLA + MoE and the MTP head
    gc.collect()
    torch.cuda.empty_cache()
    moe = smoke_moe.moe_phase(device, card)
    cases.extend(moe["cases"])
    # slice 18's main paths: the SSM and hybrid decoders
    gc.collect()
    torch.cuda.empty_cache()
    ssm = smoke_ssm.ssm_phase(device, card)
    cases.extend(ssm["cases"])
    # slice 19's main paths: whisper's encoder-decoder
    gc.collect()
    torch.cuda.empty_cache()
    whisper = smoke_whisper.whisper_phase(device, card)
    cases.extend(whisper["cases"])
    # slice 20's main paths: the parallel substrate over a world-1 NCCL group
    gc.collect()
    torch.cuda.empty_cache()
    par = smoke_parallel.parallel_phase(device, card)
    # slice 21's main paths: the dry-run launchers, a placed step, a production cell
    gc.collect()
    torch.cuda.empty_cache()
    dry = smoke_dryrun.dryrun_phase(device, card)
    # slice 22's main paths: the LM example scripts
    gc.collect()
    torch.cuda.empty_cache()
    examples = smoke_examples.examples_phase(device, card)

    paths = {"train": run["launches"], "train_ngp": ngp["launches"], "serve": serve_launches,
             "service": service["launches"], "train_v3": v3["train_launches"],
             "serve_v3": v3["serve_launches"], "service_async": plane["async_launches"],
             "service_two_slots": placed["two_slot_launches"],
             f"train_{GRID_DTYPE}": half["train_launches"],
             f"train_ngp_{GRID_DTYPE}": half["train_ngp_launches"],
             f"serve_{GRID_DTYPE}": half["serve_launches"],
             f"service_{GRID_DTYPE}": half["service_launches"],
             **{f"compiled_{name}": res["captured"]["launches"]
                for name, res in compiled["paths"].items()},
             **{f"compiled_serve_{route}": res["launches"] for route, res in renders.items()},
             **lm["launches"], **moe["launches"], **ssm["launches"], **whisper["launches"],
             **par["launches"], **dry["launches"], **examples["launches"]}
    report = []
    for name, meta in KERNELS.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = mine[0]   # the main path's default shape (first case of each kernel)
        by_path = {p: counts[name] for p, counts in paths.items()}
        report.append({
            "name": name, **meta,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "err": max(c.get("err", c["max_abs_err"]) for c in mine),
            "tolerance": TOLERANCE[name],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound"][0], "bound_by": head["bound"][1],
            "library_ms": head.get("library_ms"),
            "cases": [{"case": c["case"], "shape": c["shape"],
                       "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                       "plain_ms": c["plain_ms"], "library_ms": c.get("library_ms"),
                       "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
                       **({"deterministic": c["deterministic"]}
                          if "deterministic" in c else {}),
                       **({k: c[k] for k in ("dtype", "upcast_identical", "f32_ms") if k in c}),
                       **({"dedup": c["dedup"]} if "dedup" in c else {})} for c in mine],
            **({"breakdown": breakdown} if name == "fused_step_bwd" else {}),
        })
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    sys.stdout.flush()
    return 0
