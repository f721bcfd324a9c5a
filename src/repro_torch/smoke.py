"""The phases of ``chip_smoke.py``: build, kernel parity, served main path.

Each phase takes an explicit device, so the CPU tests can rehearse the
served path at a tiny size with ``device="cpu"``; `main` runs them all on
the card and fails on anything wrong -- there is no CPU fallback.

1. build: print the card's name and power limit, turn TF32 off, build the
   kernels (one nvcc per source, all at once) and print the build seconds;
2. parity: hold each kernel against its plain PyTorch version at the main
   path's shapes, with the max abs error, its tolerance, the kernel's and
   the plain version's time (CUDA events), and the least time the card could
   take (`bound_ms`, from the bytes and operations this run's inputs need);
3. main path: a `RenderService` serves 800x800 requests from a snapshot of
   a `FieldConfig()` field (random weights from seed 0, occupancy from the
   port's `occupancy.update`) on the redistributed and the dense route, plus
   one level-1 preview, with the launch counters zeroed just before and read
   just after; then the same service on a small image agrees with the plain
   versions on the CPU;
4. report: one JSON line ``{"kernels": [...]}`` and, last, the device line.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from . import kernels
from .core import occupancy
from .core.field import Field, FieldConfig
from .core.rendering import RenderConfig, sphere_poses
from .core.trainer import default_samples_per_ray
from .kernels.fused_mlp import kernel as mlp_kernel
from .kernels.fused_mlp import ref as mlp_ref
from .kernels.hash_encode import kernel as he_kernel
from .kernels.hash_encode import ref as he_ref
from .kernels.volume_render import kernel as vr_kernel
from .kernels.volume_render import ref as vr_ref
from .serve3d import RenderResult, RenderService, SnapshotStore

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM bandwidth, and the f32 rate outside the tensor cores (the kernels use
# plain f32 FMA).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

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
}

# Max abs error allowed between a kernel and its plain version on the card.
# The two sum in different orders and the kernels contract multiply-adds
# into FMAs: an 8-corner sum of values in [-1, 1] (hash encode) and the MLPs'
# O(1) outputs stay within 1e-5; the composite's depth sums 48 terms of
# w * t with t up to 6, so its bound is 5e-5.
TOLERANCE = {"hash_encode": 1e-5, "fused_mlp2": 1e-5, "fused_mlp3": 1e-5,
             "composite": 5e-5}

# The served image: NeRF-Synthetic size, 50 degree field of view
# (`repro.data.synthetic_scene`: focal = 0.5 * w / tan(25 deg)).
IMAGE_HW = 800
FOV_DEG = 50.0
EVAL_CHUNK = 4096

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


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _uniform(gen, shape, lo, hi, device):
    return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(device)


def _max_err(a, b) -> float:
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


# ---- phase 2: kernel parity ---------------------------------------------------

def _hash_encode_case(gen, device, n, enc, label):
    cfg = enc.cfg
    points = _uniform(gen, (n, 3), 0.0, 1.0 - 1e-6, device)
    points[:4, 0] = -1.0                                # sentinel rows
    tables = _uniform(gen, (cfg.n_levels, cfg.table_size, cfg.n_features),
                      -1.0, 1.0, device)
    res, dense = enc.resolutions, enc.dense_flags
    got = he_kernel.hash_encode(points, tables, res, dense)
    want = he_ref.hash_encode(points, tables, res, dense)
    # table rows this run's points touch: what the gather must read
    rows = torch.cat([
        he_ref.level_indices(points, int(res[lv]), cfg.table_size, bool(dense[lv]))[0]
        .reshape(-1) + lv * cfg.table_size for lv in range(cfg.n_levels)])
    unique_rows = int(torch.unique(rows).numel())
    f = cfg.n_features
    n_bytes = 4 * (n * 3 + n * cfg.n_levels * f + unique_rows * f)
    n_flops = n * cfg.n_levels * (25 + 16 * f)
    return {
        "kernel": "hash_encode", "case": label,
        "shape": [n, cfg.n_levels, cfg.table_size, f],
        "max_abs_err": _max_err(got, want),
        "ms": cuda_ms(lambda: he_kernel.hash_encode(points, tables, res, dense)),
        "plain_ms": cuda_ms(lambda: he_ref.hash_encode(points, tables, res, dense),
                            iters=10),
        "bound": bound(n_bytes, n_flops),
    }


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
    n_flops = 2 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return {
        "kernel": name, "case": label, "shape": [n, *dims],
        "max_abs_err": _max_err(kern(x, *params), plain(x, *params)),
        "ms": cuda_ms(lambda: kern(x, *params)),
        "plain_ms": cuda_ms(lambda: plain(x, *params)),
        "bound": bound(n_bytes, n_flops),
    }


def _composite_case(gen, device, r, s, label):
    sigma = _uniform(gen, (r, s), 0.0, 20.0, device)
    rgb = _uniform(gen, (r, s, 3), 0.0, 1.0, device)
    ts = torch.sort(_uniform(gen, (r, s), 2.0, 6.0, device), dim=-1).values
    deltas = torch.diff(ts, dim=-1, append=ts[:, -1:] + 4.0 / s)  # non-uniform
    got = vr_kernel.composite(sigma, rgb, deltas, ts)
    want = vr_ref.composite(sigma, rgb, deltas, ts)
    n_bytes = 4 * (r * s * 6 + r * 5)
    n_flops = 16 * r * s
    return {
        "kernel": "composite", "case": label, "shape": [r, s],
        "max_abs_err": _max_err(got, want[:3]),
        "ms": cuda_ms(lambda: vr_kernel.composite(sigma, rgb, deltas, ts)),
        "plain_ms": cuda_ms(lambda: vr_ref.composite(sigma, rgb, deltas, ts)),
        "bound": bound(n_bytes, n_flops),
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
    cases.append(_composite_case(gen, device, EVAL_CHUNK, s_red,
                                 f"redistributed, S={s_red}"))
    cases.append(_composite_case(gen, device, EVAL_CHUNK, s, f"dense, S={s}"))
    return cases


# ---- phase 3: the served main path ---------------------------------------------

def make_snapshot_store(device, field_cfg: FieldConfig, occ_cfg, seed: int = 0):
    """A store holding one snapshot for each of the sessions "redist" and
    "dense": `Field.init` params (Generator seed) and one occupancy update."""
    gen = torch.Generator().manual_seed(seed)
    field = Field(field_cfg)
    params = field.init(gen, device)
    state = occupancy.update(field, params, occupancy.init_state(occ_cfg, device),
                             occ_cfg, generator=gen)
    store = SnapshotStore()
    for sid in ("redist", "dense"):
        store.publish(sid, params, step=1, occ=state)
    return store


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


# ---- the script ---------------------------------------------------------------

def _ptxas_summary(logs: dict[str, str]) -> list[str]:
    lines = []
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if re.search(r"Used \d+ registers|spill", line):
                lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


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
    failed = []
    for c in cases:
        tol = TOLERANCE[c["kernel"]]
        ok = c["max_abs_err"] <= tol
        bound_ms, bound_by = c["bound"]
        print(f"parity {c['kernel']:<11} {c['case']:<30} max_abs_err {c['max_abs_err']:.3e} "
              f"(tol {tol:.0e}) {'ok' if ok else 'FAIL'}  kernel {c['ms']:.4f} ms  "
              f"plain {c['plain_ms']:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})  "
              f"[{card}]", flush=True)
        if not ok:
            failed.append(f"{c['kernel']} {c['case']}")
    if failed:
        raise RuntimeError(f"kernel parity failed: {failed}")

    field_cfg, render_cfg = FieldConfig(), RenderConfig()
    occ_cfg = occupancy.OccupancyConfig()
    n_requests = 4
    kernels.reset_launches()
    store = make_snapshot_store(device, field_cfg, occ_cfg, seed=0)
    svc = make_service(store, device, field_cfg, render_cfg, occ_cfg, IMAGE_HW, EVAL_CHUNK)
    rounds = []
    for rnd in range(2):
        t0 = time.perf_counter()
        results = serve_requests(svc, IMAGE_HW, n_requests, seed=rnd)
        rounds.append((time.perf_counter() - t0, results))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"main path never launched: {missing} (counts {launches})")
    for rnd, (wall, results) in enumerate(rounds):
        print(f"round {rnd}: drained {len(results)} requests in {wall:.3f} s [{card}]")
        for r in results:
            print(f"  request {r.request_id} {r.session_id:<6} level {r.level} "
                  f"{r.rgb.shape[0]}x{r.rgb.shape[1]} latency {r.latency_s * 1e3:.1f} ms "
                  f"rgb [{r.rgb.min():.4f}, {r.rgb.max():.4f}] "
                  f"depth mean {r.depth.mean():.4f}")
    print(f"latency_stats [{card}]: {json.dumps(svc.latency_stats())}")
    print(f"main-path launches: {json.dumps(launches)}")

    agree = path_parity(store, device, field_cfg, render_cfg, occ_cfg)
    print(f"path vs plain versions on the CPU (32x32): {json.dumps(agree)}")
    for sid, e in agree.items():
        if e["rgb_max_abs_err"] > PATH_RGB_TOL or e["depth_max_abs_err"] > PATH_DEPTH_TOL:
            raise RuntimeError(f"served path disagrees with the plain versions on {sid}: {e}")

    report = []
    for name, meta in KERNELS.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = mine[0]   # the served default: redistributed, S' = S/4, density grid
        report.append({
            "name": name, **meta,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "tolerance": TOLERANCE[name],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound"][0], "bound_by": head["bound"][1],
            "library_ms": None,
            "cases": [{"case": c["case"], "shape": c["shape"],
                       "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                       "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0],
                       "bound_by": c["bound"][1]} for c in mine],
        })
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    sys.stdout.flush()
    return 0
