"""The port's fused encode (kernel #8's path) against the JAX package (CPU).

The same numpy inputs, made from a seed, go through the JAX function (its
`ref` backend, and `fused_encode_pallas` in interpret mode, as
tests/test_fused_path.py runs them) and through the port, whose ops on CPU
tensors run the plain PyTorch versions.  L=4, T=2^12/2^10, hidden 16, N of
a few hundred, not a multiple of 256.  Tolerances:

* the plain fused encode within 1e-6 abs of the Pallas kernel (interpret),
  and bit for bit equal to the port's plain hash encode;
* its table gradients bit for bit equal to the port's hash-encode backward,
  and within 1e-6 of the largest |gradient| of JAX's VJP with the same
  nonzero rows;
* the dedup accounting's integers exactly, its ratios within 1e-12;
* `Field.query_fused` values within 1e-5, and every leaf's gradient within
  1e-5 of that leaf's largest |gradient|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import field as j_field
from repro.kernels.fused_path import kernel as j_fp_kernel
from repro.kernels.fused_path import ops as j_fp_ops
from repro.kernels.fused_path import ref as j_fp_ref
from repro.kernels.hash_encode import ops as j_he_ops
from repro.kernels.hash_encode import ref as j_he_ref
from repro_torch import bridge
from repro_torch import kernels as t_kernels
from repro_torch.core import field as t_field
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core import rendering as t_rendering
from repro_torch.kernels.fused_path import ops as t_fp_ops
from repro_torch.kernels.fused_path import ref as t_fp_ref
from repro_torch.kernels.hash_encode import ops as t_he_ops
from repro_torch.kernels.hash_encode import ref as t_he_ref
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace
from repro_torch.optim.adamw import tree_paths

L, F = 4, 2
TD, TC = 1 << 12, 1 << 10
RES = j_he_ref.level_resolutions(L, 8, 64)
GEOM = dict(n_levels=4, max_resolution=64, log2_table_density=12,
            log2_table_color=10, hidden=16)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x, copy=True))
    return t.requires_grad_(True) if grad else t


def _points(rng, n):
    """Morton-sorted points in [0, 1)^3, as the compact stage delivers them."""
    pts = rng.uniform(0, 0.999, size=(n, 3)).astype(np.float32)
    return pts[np.argsort(np.asarray(j_fp_ref.morton_key(jnp.asarray(pts))), kind="stable")]


def _tables(rng, size):
    return rng.uniform(-1, 1, size=(L, size, F)).astype(np.float32)


def _close_grad(got, want, what, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} vs {tol:.0e} x {scale:.3e}"


def _rows(a):
    a = np.asarray(a)
    return a.reshape(-1, a.shape[-1]).any(axis=-1)


# ---- the plain fused encode ----

@pytest.mark.parametrize("size", [TD, TC])
@pytest.mark.parametrize("n", [300, 513])
def test_plain_fused_encode_matches_the_pallas_kernel(size, n, rng):
    """Against `fused_encode_pallas` in interpret mode on sentinel-padded
    input (the kernel's own contract), sentinel rows included."""
    pts = _points(rng, n)
    pts[::37] = -1.0                                     # sentinel rows
    tables = _tables(rng, size)
    dense = j_he_ref.level_is_dense(RES, size)
    padded, _ = j_he_ops._pad_to(jnp.asarray(pts), 256)
    want = j_fp_kernel.fused_encode_pallas(
        padded, jnp.asarray(tables), jnp.asarray(RES, jnp.int32),
        jnp.asarray(dense, jnp.int32), block_points=256, interpret=True)[:n]
    got = t_fp_ref.fused_encode(_t(pts), _t(tables), RES, dense)
    assert got.shape == (n, L * F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert not got[::37].any()


@pytest.mark.parametrize("block", [256, 64])
def test_plain_fused_encode_is_hash_encode_bit_for_bit(block, rng):
    pts = _points(rng, 450)
    pts[7] = -1.0
    for size in (TD, TC):
        tables = _t(_tables(rng, size))
        dense = t_he_ref.level_is_dense(RES, size)
        got = t_fp_ref.fused_encode(_t(pts), tables, RES, dense, block_points=block)
        want = t_he_ref.hash_encode(_t(pts), tables, RES, dense)
        assert torch.equal(got, want)


# ---- the autograd op ----

def _grads(encode_outs, g_outs, tables):
    loss = sum((o * g).sum() for o, g in zip(encode_outs, g_outs))
    return torch.autograd.grad(loss, tables)


def test_fused_encode_gradients_are_hash_encode_bit_for_bit(rng):
    n = 300
    pts = _t(_points(rng, n))
    tables = [_t(_tables(rng, s), grad=True) for s in (TD, TC)]
    g_outs = [_t(rng.normal(size=(n, L * F)).astype(np.float32)) for _ in range(2)]
    encode = t_fp_ops.make_fused_encode(RES, (TD, TC), F)
    outs = encode(pts, *tables)
    got = _grads(outs, g_outs, tables)
    he_outs = [t_he_ops.hash_encode(pts, t, RES, t_he_ref.level_is_dense(RES, t.shape[1]))
               for t in tables]
    want = _grads(he_outs, g_outs, tables)
    for o, h in zip(outs, he_outs):
        assert torch.equal(o, h)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def test_fused_encode_matches_the_jax_vjp(rng):
    n = 300
    pts = _points(rng, n)
    td, tc = _tables(rng, TD), _tables(rng, TC)
    g_d = rng.normal(size=(n, L * F)).astype(np.float32)
    g_c = rng.normal(size=(n, L * F)).astype(np.float32)
    j_enc = j_fp_ops.make_fused_encode(RES, (TD, TC), F, backend="ref")
    (jd, jc), vjp = jax.vjp(lambda a, b: j_enc(jnp.asarray(pts), a, b),
                            jnp.asarray(td), jnp.asarray(tc))
    want = vjp((jnp.asarray(g_d), jnp.asarray(g_c)))

    t_td, t_tc = _t(td, grad=True), _t(tc, grad=True)
    od, oc = t_fp_ops.make_fused_encode(RES, (TD, TC), F)(_t(pts), t_td, t_tc)
    np.testing.assert_allclose(od.detach().numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(oc.detach().numpy(), np.asarray(jc), atol=1e-6)
    got = _grads((od, oc), (_t(g_d), _t(g_c)), (t_td, t_tc))
    for name, g, w in (("density", got[0], want[0]), ("color", got[1], want[1])):
        _close_grad(g.numpy(), w, f"{name} table", 1e-6)
        np.testing.assert_array_equal(_rows(g.numpy()), _rows(w), err_msg=f"{name} rows")


def test_frozen_tables_commit_nothing(rng, monkeypatch):
    n = 200
    pts = _t(_points(rng, n))
    t_td, t_tc = _t(_tables(rng, TD), grad=True), _t(_tables(rng, TC))
    commits = []
    real = t_fp_ops.gu_ops.merged_scatter_add
    monkeypatch.setattr(t_fp_ops.gu_ops, "merged_scatter_add",
                        lambda *a, **k: commits.append(k) or real(*a, **k))
    od, oc = t_fp_ops.make_fused_encode(RES, (TD, TC), F)(pts, t_td, t_tc)
    (od.sum() + oc.sum()).backward()
    assert commits == [{"presorted": True}]          # the density table only
    assert t_tc.grad is None and t_td.grad.any()
    # the "stash" policy is ported: the same single commit, the same bytes
    commits.clear()
    s_td = t_td.detach().clone().requires_grad_(True)
    od, oc = t_fp_ops.make_fused_encode(RES, (TD, TC), F, residual_policy="stash")(
        pts, s_td, t_tc)
    (od.sum() + oc.sum()).backward()
    assert commits == [{"presorted": True}] and t_tc.grad is None
    assert torch.equal(s_td.grad, t_td.grad)
    with pytest.raises(ValueError, match="residual_policy"):
        t_fp_ops.make_fused_encode(RES, (TD, TC), F, residual_policy="keep")
    with pytest.raises(ValueError, match="grids"):
        t_fp_ops.make_fused_encode(RES, (TD, TC), F)(pts, t_td)
    with pytest.raises(ValueError, match="is not"):
        t_fp_ops.make_fused_encode(RES, (TD, TC), F)(pts, t_tc, t_td)


# ---- dedup accounting ----

@pytest.mark.parametrize("n,block", [(512, 256), (700, 256), (300, 64)])
def test_dedup_stats_match_jax(n, block, rng):
    pts = _points(rng, n)
    for size in (TD, TC):
        dense = j_he_ref.level_is_dense(RES, size)
        want = j_fp_ref.dedup_stats(jnp.asarray(pts), RES, dense, size, block_points=block)
        got = t_fp_ref.dedup_stats(_t(pts), RES, dense, size, block_points=block)
        for key in ("total_reads", "unique_reads_global", "n_blocks"):
            assert got[key] == want[key], key
        for key in ("unique_ratio_global", "unique_ratio_block"):
            assert abs(got[key] - want[key]) <= 1e-12, key
        assert got["unique_ratio_block"] < 1.0


def test_block_distinct_reads_count_each_block(rng):
    """Per (block, level): the distinct addresses of the block's rows, the
    count the kernel writes; a short last block counts its rows only."""
    n, block = 300, 128
    pts = _t(_points(rng, n))
    dense = t_he_ref.level_is_dense(RES, TD)
    corners, _ = t_fp_ref.corner_geometry(pts, RES)
    idx_l = t_fp_ref.level_indices(corners, RES, TD, dense)
    counts = t_fp_ref.block_distinct_reads(idx_l, block)
    assert counts.shape == (3, L)
    for b in range(3):
        for level in range(L):
            rows = idx_l[level][b * block:(b + 1) * block].numpy()
            assert counts[b, level] == np.unique(rows).size
    stats = t_fp_ref.dedup_stats(pts, RES, dense, TD, block_points=block)
    assert stats["unique_reads_block"] == int(counts.sum())
    rows = np.array([128, 128, 44])                       # the short last block
    want = np.mean(counts.numpy().T / (8 * rows))
    assert t_fp_ref.unique_ratio_block(counts, n, block) == stats["unique_ratio_block"] == want


def test_dedup_stats_fold_into_the_ports_obs(rng):
    pts = _t(_points(rng, 256))
    dense = t_he_ref.level_is_dense(RES, TD)
    t_trace.set_enabled(True)
    try:
        stats = t_fp_ref.dedup_stats(pts, RES, dense, TD)
    finally:
        t_trace.set_enabled(False)
    snap = t_metrics.snapshot()
    assert snap["fused_path.dedup.unique_ratio_block"]["value"] == stats["unique_ratio_block"]


# ---- Field.query_fused ----

def _field_params(cfg_j, seed):
    params = jax.tree.map(np.asarray, j_field.Field(cfg_j).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k in ("density_grid", "color_grid"):
        if k in params:
            params[k] = rng.uniform(-1, 1, size=params[k].shape).astype(np.float32)
    return params


@pytest.mark.parametrize("decomposed", [True, False])
def test_query_fused_matches_jax(decomposed, rng):
    cfg_j = j_field.FieldConfig(**GEOM, decomposed=decomposed)
    cfg_t = t_field.FieldConfig(**GEOM, decomposed=decomposed)
    params = _field_params(cfg_j, 3)
    n = 300
    pts = _points(rng, n)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g_s = rng.normal(size=(n,)).astype(np.float32)
    g_rgb = rng.normal(size=(n, 3)).astype(np.float32)

    jf = j_field.Field(cfg_j)

    def j_loss(p):
        s, c = jf.query_fused(p, jnp.asarray(pts), jnp.asarray(dirs))
        return jnp.sum(s * g_s) + jnp.sum(c * g_rgb), (s, c)

    (_, (js, jc)), jg = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))

    tf = t_field.Field(cfg_t)
    tp = bridge.params_to_torch(params, "cpu")
    leaves = [t.requires_grad_(True) for _, t in tree_paths(tp)]
    ts, tc = tf.query_fused(tp, _t(pts), _t(dirs))
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=1e-5)
    grads = torch.autograd.grad((ts * _t(g_s)).sum() + (tc * _t(g_rgb)).sum(), leaves)
    want = dict(tree_paths(jax.tree.map(np.asarray, jg)))
    assert len(want) == len(grads) == (12 if decomposed else 11)
    for (path, _), g in zip(tree_paths(tp), grads):
        _close_grad(g.numpy(), want[path], str(path), 1e-5)
        if path[0].endswith("grid"):
            np.testing.assert_array_equal(_rows(g.numpy()), _rows(want[path]))
    # the port's fused query is its per-grid query, values and gradients
    ts2, tc2 = tf.query(tp, _t(pts), _t(dirs))
    assert torch.equal(ts, ts2) and torch.equal(tc, tc2)
    # the NGP baseline's one-op query is the fused query
    if not decomposed:
        ts3, tc3 = tf.query_step(tp, _t(pts), _t(dirs))
        assert torch.equal(ts, ts3) and torch.equal(tc, tc3)


# ---- the pipeline's routing ----

ROUTES = [
    # (decomposed, fused_path, fused_step) -> the field methods the
    # compacted shade calls, in order
    (True, True, True, ["query_step"]),
    (True, True, False, ["query_fused"]),
    (False, True, True, ["query_step", "query_fused"]),
    (False, True, False, ["query_fused"]),
    (True, False, True, ["query"]),
]


@pytest.mark.parametrize("decomposed,fused_path,fused_step,expect", ROUTES)
def test_pipeline_routes_the_compacted_shade(decomposed, fused_path, fused_step, expect,
                                             rng, monkeypatch):
    cfg = t_field.FieldConfig(**GEOM, decomposed=decomposed)
    field = t_field.Field(cfg)
    params = field.init(torch.Generator().manual_seed(0), "cpu")
    called = []
    for name in ("query", "query_fused", "query_step"):
        real = getattr(field, name)
        monkeypatch.setattr(field, name, lambda *a, _n=name, _r=real, **k:
                            called.append(_n) or _r(*a, **k))
    rcfg = t_rendering.RenderConfig(n_samples=8)
    pipe = t_pipeline.RenderPipeline(field, rcfg, fused_path=fused_path,
                                     fused_step=fused_step)
    b = 32
    o = torch.zeros((b, 3)) + torch.tensor([0.0, 0.0, -4.0])
    d = torch.from_numpy(rng.normal(size=(b, 3)).astype(np.float32) * 0.1
                         + np.array([0, 0, 1], np.float32))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    ts = t_rendering.sample_ts(None, b, rcfg, "cpu")
    before = dict(t_kernels.LAUNCHES)
    out = pipe(params, o, d, ts, budget=128)
    assert called == expect
    assert out["points_queried"] == 128 and torch.isfinite(out["rgb"]).all()
    assert t_kernels.LAUNCHES == before                # the CPU runs no kernel
    # the dense path always takes the per-grid query
    called.clear()
    pipe(params, o, d, ts)
    assert called == ["query"]
