"""Port kernels (repro_torch) against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function -- its
jnp `ref` and its Pallas kernel in interpret mode -- and through the port's
`ops` (which on a CPU tensor is the plain PyTorch version).  Integer outputs
must match exactly; floats within the stated tolerances:

* hash encode 1e-6 (the JAX package's own Pallas-vs-ref tolerance);
* mlp2 / mlp3 1e-5;
* composite and uniform_deltas 1e-5.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_mlp import ops as j_mlp_ops
from repro.kernels.fused_mlp import ref as j_mlp_ref
from repro.kernels.fused_path import ref as j_fp_ref
from repro.kernels.hash_encode import kernel as j_he_kernel
from repro.kernels.hash_encode import ops as j_he_ops
from repro.kernels.hash_encode import ref as j_he_ref
from repro.kernels.volume_render import ops as j_vr_ops
from repro.kernels.volume_render import ref as j_vr_ref
from repro_torch import kernels as t_kernels
from repro_torch.kernels.fused_mlp import kernel as t_mlp_kernel
from repro_torch.kernels.fused_mlp import ops as t_mlp_ops
from repro_torch.kernels.fused_path import ref as t_fp_ref
from repro_torch.kernels.hash_encode import kernel as t_he_kernel
from repro_torch.kernels.hash_encode import ops as t_he_ops
from repro_torch.kernels.hash_encode import ref as t_he_ref
from repro_torch.kernels.volume_render import kernel as t_vr_kernel
from repro_torch.kernels.volume_render import ops as t_vr_ops
from repro_torch.kernels.volume_render import ref as t_vr_ref

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# ---- hash encode ----

GEOMETRY = [
    # (L, log2_T, base, max)
    (16, 18, 16, 1024),     # the paper's density grid
    (16, 16, 16, 1024),     # the paper's color grid
    (4, 10, 16, 64),
    (3, 8, 8, 64),
    (1, 6, 4, 4),
]


@pytest.mark.parametrize("L,log2_t,rmin,rmax", GEOMETRY)
def test_level_geometry_matches_exactly(L, log2_t, rmin, rmax):
    res_j = j_he_ref.level_resolutions(L, rmin, rmax)
    res_t = t_he_ref.level_resolutions(L, rmin, rmax)
    np.testing.assert_array_equal(res_t, res_j)
    assert res_t.dtype == res_j.dtype
    np.testing.assert_array_equal(t_he_ref.level_is_dense(res_t, 1 << log2_t),
                                  j_he_ref.level_is_dense(res_j, 1 << log2_t))


def test_spatial_hash_matches_uint32_exactly(rng):
    """The int64-emulated hash gives the reference's uint32 bits, also for
    coordinates whose products overflow 32 bits and for negative ones."""
    c = rng.integers(-3000, 3000, size=(3, 4096)).astype(np.int32)
    for t in (1 << 10, 1 << 16, 1 << 18):
        want = np.asarray(j_he_ref.spatial_hash(*(jnp.asarray(v) for v in c), t))
        got = t_he_ref.spatial_hash(*(_t(v).to(torch.int64) for v in c), t)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L,log2_t,rmin,rmax", [GEOMETRY[1], GEOMETRY[3], GEOMETRY[4]])
def test_corner_indices_and_weights_match(L, log2_t, rmin, rmax, rng):
    """Per level: corner coords and table indices exactly, weights to f32
    rounding, against the jnp ref and the Pallas kernel's shared
    `corner_indices_block` (which also pins sentinel rows to row 0)."""
    t = 1 << log2_t
    res = j_he_ref.level_resolutions(L, rmin, rmax)
    dense = j_he_ref.level_is_dense(res, t)
    pts = rng.uniform(0, 1 - 1e-6, size=(300, 3)).astype(np.float32)
    pts[:5, 0] = -1.0                                    # sentinel rows
    for lv in range(L):
        r = int(res[lv])
        corners_j, w_j = j_he_ref._level_corners(jnp.asarray(pts[5:]), r)
        corners_t, w_t = t_he_ref.level_corners(_t(pts[5:]), r)
        np.testing.assert_array_equal(corners_t.numpy(), np.asarray(corners_j))
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-7, rtol=0)
        idx_j = j_he_ref.corner_index(corners_j, r, t, bool(dense[lv]))
        idx_t = t_he_ref.corner_index(corners_t, r, t, bool(dense[lv]))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))

        kidx_j, kw_j = j_he_kernel.corner_indices_block(
            jnp.asarray(pts), jnp.int32(r), jnp.int32(dense[lv]), t)
        kidx_t, kw_t = t_he_ref.level_indices(_t(pts), r, t, bool(dense[lv]))
        np.testing.assert_array_equal(kidx_t.numpy(), np.asarray(kidx_j))
        np.testing.assert_allclose(kw_t.numpy(), np.asarray(kw_j), atol=1e-7, rtol=0)
        assert (kw_t[:5] == 0).all() and (kidx_t[:5] == 0).all()


@pytest.mark.parametrize("L,log2_t,F,n,rmin,rmax", [
    (4, 12, 2, 1000, 16, 256),
    (3, 8, 4, 513, 8, 64),      # F=4, not a block multiple
    (16, 12, 2, 200, 16, 1024),  # the paper's level count, dense and hashed
])
def test_hash_encode_matches_jax(L, log2_t, F, n, rmin, rmax, rng):
    t = 1 << log2_t
    res = j_he_ref.level_resolutions(L, rmin, rmax)
    dense = j_he_ref.level_is_dense(res, t)
    tables = rng.uniform(-1, 1, size=(L, t, F)).astype(np.float32)
    pts = rng.uniform(0, 0.999, size=(n, 3)).astype(np.float32)
    want_ref = np.asarray(j_he_ref.hash_encode(jnp.asarray(pts), jnp.asarray(tables), res))
    want_pal = np.asarray(j_he_ops._forward(jnp.asarray(pts), jnp.asarray(tables),
                                            tuple(res), tuple(dense), "pallas", 256))
    got = t_he_ops.hash_encode(_t(pts), _t(tables), res, dense).numpy()
    np.testing.assert_allclose(got, want_ref, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, want_pal, atol=1e-6, rtol=1e-6)


def test_hash_encode_sentinel_rows_match_pallas(rng):
    """Sentinel rows (x < 0) encode to exactly zero, as in the Pallas kernel."""
    L, t, F = 3, 1 << 10, 2
    res = j_he_ref.level_resolutions(L, 8, 64)
    dense = j_he_ref.level_is_dense(res, t)
    tables = rng.uniform(-1, 1, size=(L, t, F)).astype(np.float32)
    pts = rng.uniform(0, 0.999, size=(256, 3)).astype(np.float32)
    pts[::7] = -1.0
    want = np.asarray(j_he_kernel.hash_encode_pallas(
        jnp.asarray(pts), jnp.asarray(tables), jnp.asarray(res, jnp.int32),
        jnp.asarray(dense, jnp.int32), block_points=256, interpret=True))
    got = t_he_ops.hash_encode(_t(pts), _t(tables), res, dense).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[::7], 0.0)


# ---- Morton keys ----

def test_morton_key_matches_exactly(rng):
    pts = rng.uniform(-0.1, 1.1, size=(5000, 3)).astype(np.float32)   # incl. clamped
    pts[:8] = [[0, 0, 0], [1 - 1e-7, 1 - 1e-7, 1 - 1e-7], [0.5, 0.25, 0.125],
               [1, 1, 1], [0, 1, 0], [1, 0, 1], [0.999, 0, 0], [0, 0, 0.999]]
    want = np.asarray(j_fp_ref.morton_key(jnp.asarray(pts))).astype(np.int64)
    got = t_fp_ref.morton_key(_t(pts))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


# ---- fused MLPs ----

def _mlp_inputs(rng, n, dims):
    x = rng.uniform(-1, 1, size=(n, dims[0])).astype(np.float32)
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        b = (6.0 / d_in) ** 0.5
        params += [rng.uniform(-b, b, size=(d_in, d_out)).astype(np.float32),
                   rng.uniform(-0.1, 0.1, size=(d_out,)).astype(np.float32)]
    return x, params


@pytest.mark.parametrize("n,dims", [(700, (32, 64, 16)), (300, (8, 16, 16)),
                                    (33, (16, 32, 1))])
def test_mlp2_matches_jax(n, dims, rng):
    x, params = _mlp_inputs(rng, n, dims)
    jx = [jnp.asarray(v) for v in (x, *params)]
    got = t_mlp_ops.mlp2(*(_t(v) for v in (x, *params))).numpy()
    np.testing.assert_allclose(got, np.asarray(j_mlp_ref.mlp2(*jx)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(j_mlp_ops.mlp2(*jx, backend="pallas")),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,dims", [(700, (48, 64, 64, 3)), (512, (24, 16, 16, 3)),
                                    (33, (31, 64, 64, 3))])
def test_mlp3_matches_jax(n, dims, rng):
    x, params = _mlp_inputs(rng, n, dims)
    jx = [jnp.asarray(v) for v in (x, *params)]
    got = t_mlp_ops.mlp3(*(_t(v) for v in (x, *params))).numpy()
    np.testing.assert_allclose(got, np.asarray(j_mlp_ref.mlp3(*jx)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(j_mlp_ops.mlp3(*jx, backend="pallas")),
                               atol=1e-5, rtol=1e-5)


# ---- volume rendering ----

@pytest.mark.parametrize("r,s", [(300, 48), (77, 12)])
def test_composite_matches_jax(r, s, rng):
    sigma = rng.uniform(0, 5, size=(r, s)).astype(np.float32)
    rgb = rng.uniform(0, 1, size=(r, s, 3)).astype(np.float32)
    ts = np.sort(rng.uniform(2, 6, size=(r, s)).astype(np.float32), axis=1)
    deltas = np.diff(ts, axis=1, append=ts[:, -1:] + 0.05).astype(np.float32)
    j_in = [jnp.asarray(v) for v in (sigma, rgb, deltas, ts)]
    want_ref = j_vr_ref.composite(*j_in)
    want_pal = j_vr_ops.composite(*j_in, backend="pallas")
    got = t_vr_ops.composite(*(_t(v) for v in (sigma, rgb, deltas, ts)))
    for want in (want_ref, want_pal):
        for field in ("color", "depth", "opacity"):
            np.testing.assert_allclose(getattr(got, field).numpy(),
                                       np.asarray(getattr(want, field)),
                                       atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want_ref.weights),
                               atol=1e-5, rtol=1e-5)


def test_uniform_deltas_matches_jax(rng):
    ts = np.sort(rng.uniform(2, 6, size=(64, 48)).astype(np.float32), axis=1)
    want = np.asarray(j_vr_ref.uniform_deltas(jnp.asarray(ts), 4.0))
    got = t_vr_ref.uniform_deltas(_t(ts), 4.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---- dispatch ----

def test_cpu_tensors_take_the_plain_versions(rng):
    """On CPU tensors the ops compute the plain version and launch nothing."""
    before = dict(t_kernels.LAUNCHES)
    L, t = 2, 1 << 8
    res = t_he_ref.level_resolutions(L, 4, 16)
    dense = t_he_ref.level_is_dense(res, t)
    pts = _t(rng.uniform(0, 0.99, size=(10, 3)).astype(np.float32))
    tables = _t(rng.uniform(-1, 1, size=(L, t, 2)).astype(np.float32))
    torch.testing.assert_close(t_he_ops.hash_encode(pts, tables, res, dense),
                               t_he_ref.hash_encode(pts, tables, res, dense),
                               rtol=0, atol=0)
    x, params = _mlp_inputs(rng, 10, (4, 8, 3))
    t_mlp_ops.mlp2(*(_t(v) for v in (x, *params)))
    s = _t(np.ones((3, 4), np.float32))
    t_vr_ops.composite(s, _t(np.ones((3, 4, 3), np.float32)), s, s)
    assert t_kernels.LAUNCHES == before


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The kernel wrappers take only CUDA f32 tensors: handed CPU tensors
    they raise (no silent fallback), before anything is built."""
    cpu = torch.zeros((8, 3))
    with pytest.raises(ValueError, match="expected"):
        t_he_kernel.hash_encode(cpu, torch.zeros((1, 16, 2)), [4], [True])
    with pytest.raises(ValueError, match="expected"):
        t_mlp_kernel.fused_mlp2(torch.zeros((8, 4)), torch.zeros((4, 8)),
                                torch.zeros(8), torch.zeros((8, 2)), torch.zeros(2))
    with pytest.raises(ValueError, match="expected"):
        t_vr_kernel.composite(torch.zeros((2, 3)), torch.zeros((2, 3, 3)),
                              torch.zeros((2, 3)), torch.zeros((2, 3)))


# ---- isolation ----

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import repro_torch.smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(json.dumps({"imported": names, "bad": bad}))
"""

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.MULTILINE)


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120, check=True)
    report = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.serve3d.render" in report["imported"]
    assert "repro_torch.smoke" in report["imported"]
    assert {"repro_torch.parallel.sharding", "repro_torch.parallel.collectives",
            "repro_torch.smoke_parallel"} <= set(report["imported"])
    assert {"repro_torch.launch.steps", "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline", "repro_torch.launch.report",
            "repro_torch.smoke_dryrun"} <= set(report["imported"])
    assert {"repro_torch.models.shards", "repro_torch.examples.lm_pretrain",
            "repro_torch.examples.serve_lm",
            "repro_torch.smoke_examples"} <= set(report["imported"])
    assert report["bad"] == []

    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"] \
        + sorted((REPO / "tools").glob("torch_*.py"))
    assert len(files) > 10
    for path in files:
        assert not _FORBIDDEN.search(path.read_text()), path
