"""The port's training-slice kernels and ops against the JAX package (CPU).

The same numpy inputs, made from a seed, go through the JAX function (its
`ref` backend, and the Pallas kernels in interpret mode where
tests/test_fused_step.py runs them) and through the port's ops, which on CPU
tensors run the plain PyTorch versions.  Tolerances:

* integer outputs (corner coords, indices, address streams, dedup
  addresses, budgets) exactly;
* the merged scatter-add bit for bit (both sum each run in stream order);
* values 1e-5 (f32 matmuls summed in other orders);
* gradients within 1e-5 of the largest |gradient| of each leaf, with the
  same set of table rows carrying a nonzero gradient (with Adam's eps of
  1e-15 any nonzero gradient moves a row by about lr);
* AdamW within 1e-6 relative, masked leaves bit-identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import field as j_field
from repro.core import losses as j_losses
from repro.core.pipeline import suggest_budget as j_suggest_budget
from repro.kernels.fused_path import ref as j_fp_ref
from repro.kernels.fused_step import ops as j_fs_ops
from repro.kernels.fused_step import ref as j_fs_ref
from repro.kernels.grid_update import ops as j_gu_ops
from repro.kernels.grid_update import ref as j_gu_ref
from repro.kernels.hash_encode import ops as j_he_ops
from repro.kernels.hash_encode import ref as j_he_ref
from repro.kernels.fused_mlp import ref as j_mlp_ref
from repro.kernels.volume_render import ref as j_vr_ref
from repro.optim import AdamW as JAdamW
from repro_torch import bridge
from repro_torch.core import field as t_field
from repro_torch.core import losses as t_losses
from repro_torch.core.pipeline import suggest_budget as t_suggest_budget
from repro_torch.kernels.fused_mlp import ops as t_mlp_ops
from repro_torch.kernels.fused_path import kernel as t_fp_kernel
from repro_torch.kernels.fused_path import ref as t_fp_ref
from repro_torch.kernels.fused_step import kernel as t_fs_kernel
from repro_torch.kernels.fused_step import ops as t_fs_ops
from repro_torch.kernels.fused_step import ref as t_fs_ref
from repro_torch.kernels.grid_update import kernel as t_gu_kernel
from repro_torch.kernels.grid_update import ops as t_gu_ops
from repro_torch.kernels.grid_update import ref as t_gu_ref
from repro_torch.kernels.hash_encode import ops as t_he_ops
from repro_torch.kernels.hash_encode import ref as t_he_ref
from repro_torch.kernels.volume_render import ops as t_vr_ops
from repro_torch.optim import AdamW as TAdamW

L, F = 4, 2
TD, TC = 1 << 12, 1 << 10
RES = j_he_ref.level_resolutions(L, 8, 64)
SH, HID, GEO = 16, 16, 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x, copy=True))
    return t.requires_grad_(True) if grad else t


def _close_grad(got, want, what):
    """got within 1e-5 of the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, f"{what}: max err {err:.3e} vs 1e-5 x {scale:.3e}"


def _same_rows(got, want, what):
    rows = lambda a: np.asarray(a).reshape(-1, np.asarray(a).shape[-1]).any(axis=-1)  # noqa: E731
    np.testing.assert_array_equal(rows(got), rows(want), err_msg=f"{what}: nonzero rows")


# ---- trunc_exp: the repaired gradient ----

def test_trunc_exp_gradient_matches_the_reference_vjp():
    """The reference's backward is g * exp(clip(x)) everywhere; a plain
    autograd of exp(clamp(x)) would give 0 at x = -20 and x = 15."""
    x = np.array([-20.0, 0.0, 15.0], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(j_field.trunc_exp(v) * jnp.arange(1.0, 4.0)))(
        jnp.asarray(x)))
    xt = _t(x, grad=True)
    (t_field.trunc_exp(xt) * torch.arange(1.0, 4.0)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6)
    assert (xt.grad.numpy() > 0).all()
    np.testing.assert_allclose(t_field.trunc_exp(_t(x)).numpy(),
                               np.asarray(j_field.trunc_exp(jnp.asarray(x))), rtol=1e-6)


# ---- grid_update: merged and windowed scatter-adds ----

@pytest.mark.parametrize("t,f,m,presorted", [(64, 2, 300, False), (512, 2, 3000, False),
                                             (128, 4, 999, True), (16, 1, 64, False)])
def test_merged_scatter_add_matches_jax_bit_for_bit(t, f, m, presorted, rng):
    table = rng.normal(size=(t, f)).astype(np.float32)
    idx = rng.integers(0, t + 1, size=m).astype(np.int32)      # t = the spill row
    vals = rng.normal(size=(m, f)).astype(np.float32)
    if presorted:
        order = np.argsort(idx, kind="stable")
        idx, vals = idx[order], vals[order]
    want = np.asarray(j_gu_ops.merged_scatter_add(jnp.asarray(table), jnp.asarray(idx),
                                                  jnp.asarray(vals), presorted=presorted))
    got = t_gu_ops.merged_scatter_add(_t(table), _t(idx).long(), _t(vals),
                                      presorted=presorted).numpy()
    np.testing.assert_array_equal(got, want)
    keep = idx < t
    naive = t_gu_ref.scatter_add(_t(table), _t(idx[keep]).long(), _t(vals[keep])).numpy()
    np.testing.assert_allclose(got, naive, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(
        naive, np.asarray(j_gu_ref.scatter_add(jnp.asarray(table), jnp.asarray(idx[keep]),
                                               jnp.asarray(vals[keep]))), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("w", [1, 3])
def test_windowed_scatter_add_stacked_matches_jax(w, rng):
    t, f, m = 256, 2, 500
    idx = np.sort(rng.integers(0, t, size=(w, m)).astype(np.int32), axis=1)
    vals = rng.normal(size=(w, m, f)).astype(np.float32)
    table = np.zeros((t, f), np.float32)
    want = np.asarray(j_gu_ops.windowed_scatter_add(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals), presorted=True))
    got = t_gu_ops.windowed_scatter_add(_t(table), _t(idx).long(), _t(vals), presorted=True)
    np.testing.assert_array_equal(got.numpy(), want)
    # one stream (M,) is cut into windows, as in the reference
    want = np.asarray(j_gu_ops.windowed_scatter_add(
        jnp.asarray(table), jnp.asarray(idx[0]), jnp.asarray(vals[0]), window=128))
    got = t_gu_ops.windowed_scatter_add(_t(table), _t(idx[0]).long(), _t(vals[0]), window=128)
    np.testing.assert_array_equal(got.numpy(), want)


def _tile_walk_commit(table, idx, vals, tile: int):
    """A model of the bum_scatter kernel's walk (float32 numpy): the stream
    in tiles of `tile` entries; in each tile the run starts (the first entry
    compared with the entry before the tile), every run folded from 0 in
    stream order by its start, the tile's last run finished past the tile
    end; entries before a tile's first run start skipped (an earlier tile's
    run); addresses outside [0, T) dropped; each sum added to its row once."""
    out = table.numpy().copy()
    a, v = idx.numpy(), vals.numpy()
    m, t = a.shape[0], out.shape[0]
    for base in range(0, m, tile):
        n = min(tile, m - base)
        starts = [e for e in range(n)
                  if (a[base + e] != a[base + e - 1] if e > 0
                      else base == 0 or a[base] != a[base - 1])] + [n]
        for s, end in zip(starts[:-1], starts[1:]):
            addr = a[base + s]
            if not 0 <= addr < t:
                continue
            acc = np.zeros(v.shape[1], np.float32)
            j = base + s
            while j < base + end or (end == n and j < m and a[j] == addr):
                acc = acc + v[j]
                j += 1
            out[addr] = out[addr] + acc
    return torch.from_numpy(out)


_T_ROWS = 64


def _adversarial_stream(kind: str, tile: int) -> np.ndarray:
    """Sorted address streams that stress a tile walk of `tile` entries."""
    t = _T_ROWS
    if kind == "one address across tiles":
        return np.full(5 * tile + 3, 9)
    if kind == "runs end at tile ends":
        lengths = [tile, tile, 1, tile - 1, 2 * tile, 3, 5, tile - 8]
        return np.repeat(np.arange(len(lengths)) * 3, lengths)
    if kind == "every entry a run start":
        return np.arange(t)
    if kind == "spill only":
        return np.full(3 * tile, t)
    if kind == "m = 1":
        return np.array([t - 1])
    # m not a multiple of the tile, spill entries at the end
    rng = np.random.default_rng(tile)
    return np.sort(rng.integers(0, t + 1, size=4 * tile + 7))


@pytest.mark.parametrize("tile", [16, 2048])
@pytest.mark.parametrize("kind", ["one address across tiles", "runs end at tile ends",
                                  "every entry a run start", "spill only", "m = 1",
                                  "ragged"])
def test_bum_scatter_tile_walk_is_segment_commit_bit_for_bit(kind, tile):
    """The kernel's tile walk (at its own 2048-entry tile and at 16, where
    these streams cross many tiles) sums every run as `segment_commit` does:
    the same bits, on values whose magnitudes span six decades so that any
    other summation order would show."""
    rng = np.random.default_rng(len(kind) + tile)
    idx = torch.from_numpy(_adversarial_stream(kind, tile).astype(np.int64))
    for f in (1, 2):
        vals = torch.from_numpy((rng.normal(size=(idx.shape[0], f))
                                 * 10.0 ** rng.uniform(-3, 3, size=(idx.shape[0], 1))
                                 ).astype(np.float32))
        table = torch.from_numpy(rng.normal(size=(_T_ROWS, f)).astype(np.float32))
        got = _tile_walk_commit(table, idx, vals, tile)
        want = t_gu_ref.segment_commit(table, idx, vals)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("m", [6000, 20011])
def test_segment_commit_matches_jax_on_runs_across_its_blocks(m, rng):
    """The plain commit against the reference's merge on long runs (hundreds
    to thousands of entries each) that cross the TPU kernel's 512-entry
    blocks, spill entries at the end: the same bits."""
    lengths = rng.integers(300, 2000, size=m // 300)
    idx = np.repeat(np.arange(lengths.shape[0]) * 2, lengths)[:m]
    idx = np.concatenate([idx, np.full(m - idx.shape[0], 128)]).astype(np.int32)
    vals = (rng.normal(size=(m, 2)) * 10.0 ** rng.uniform(-3, 3, size=(m, 1))).astype(np.float32)
    table = rng.normal(size=(128, 2)).astype(np.float32)
    assert np.diff(idx).min() >= 0 and any(n > 512 for n in lengths)
    want = np.asarray(j_gu_ops.merged_scatter_add(jnp.asarray(table), jnp.asarray(idx),
                                                  jnp.asarray(vals), presorted=True))
    got = t_gu_ref.segment_commit(_t(table), _t(idx).long(), _t(vals)).numpy()
    np.testing.assert_array_equal(got, want)


# ---- hash_encode's merged backward ----

def test_hash_encode_table_gradient_matches_jax(rng):
    t = 1 << 10
    res = j_he_ref.level_resolutions(L, 4, 64)
    pts = rng.uniform(0, 1 - 1e-6, size=(700, 3)).astype(np.float32)
    tables = rng.uniform(-1, 1, size=(L, t, F)).astype(np.float32)
    g = rng.normal(size=(700, L * F)).astype(np.float32)
    enc = j_he_ops.make_hash_encode(res, t, F, backend="ref")
    want = np.asarray(jax.grad(lambda tb: jnp.sum(enc(jnp.asarray(pts), tb) * g))(
        jnp.asarray(tables)))
    dense = t_he_ref.level_is_dense(res, t)
    tt = _t(tables, grad=True)
    out = t_he_ops.hash_encode(_t(pts), tt, res, dense)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(enc(jnp.asarray(pts), jnp.asarray(tables))), atol=1e-6)
    (out * _t(g)).sum().backward()
    _close_grad(tt.grad.numpy(), want, "hash_encode tables")
    _same_rows(tt.grad.numpy(), want, "hash_encode tables")
    # the update stream is the reference's, entry for entry
    idx_j, vals_j = j_he_ops._corner_updates(jnp.asarray(pts), tuple(res), tuple(dense), t,
                                             jnp.asarray(g.reshape(700, L, F)))
    idx_t, vals_t = t_he_ops.corner_updates(_t(pts), res, dense, t, _t(g.reshape(700, L, F)))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(vals_t.numpy(), np.asarray(vals_j), atol=1e-6)


def test_frozen_tables_get_no_commit(rng, monkeypatch):
    """A table that does not require grad skips the merged commit."""
    calls = []
    monkeypatch.setattr(t_gu_ops, "merged_scatter_add",
                        lambda *a, **k: calls.append(1) or a[0])
    res = j_he_ref.level_resolutions(2, 4, 16)
    pts = _t(rng.uniform(0, 1, size=(20, 3)).astype(np.float32), grad=True)
    tables = _t(rng.uniform(-1, 1, size=(2, 256, 2)).astype(np.float32))
    t_he_ops.hash_encode(pts, tables, res, t_he_ref.level_is_dense(res, 256)).sum().backward()
    assert calls == [] and not pts.grad.any()


# ---- MLP and composite autograd ops ----

@pytest.mark.parametrize("dims", [(8, 16, 5), (24, 16, 16, 3)])
def test_mlp_op_gradients_match_jax(dims, rng):
    x = rng.uniform(-1, 1, size=(300, dims[0])).astype(np.float32)
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        b = (6.0 / d_in) ** 0.5
        params += [rng.uniform(-b, b, size=(d_in, d_out)).astype(np.float32),
                   rng.uniform(-0.1, 0.1, size=(d_out,)).astype(np.float32)]
    params[1][:3] = 0.0
    x[:, :] = np.where(np.arange(dims[0]) < 2, 0.0, x)          # some exact zeros
    g = rng.normal(size=(300, dims[-1])).astype(np.float32)
    j_fn = j_mlp_ref.mlp2 if len(dims) == 3 else j_mlp_ref.mlp3
    t_fn = t_mlp_ops.mlp2 if len(dims) == 3 else t_mlp_ops.mlp3
    want = jax.grad(lambda *a: jnp.sum(j_fn(*a) * g), argnums=tuple(range(len(params) + 1)))(
        jnp.asarray(x), *(jnp.asarray(p) for p in params))
    leaves = [_t(v, grad=True) for v in [x, *params]]
    (t_fn(*leaves) * _t(g)).sum().backward()
    for k, (leaf, w) in enumerate(zip(leaves, want)):
        _close_grad(leaf.grad.numpy(), w, f"mlp input {k}")


def test_composite_op_gradients_match_jax(rng):
    r, s = 40, 12
    sigma = rng.uniform(0, 20, size=(r, s)).astype(np.float32)
    rgb = rng.uniform(0, 1, size=(r, s, 3)).astype(np.float32)
    ts = np.sort(rng.uniform(2, 6, size=(r, s)).astype(np.float32), axis=-1)
    deltas = np.diff(ts, axis=-1, append=ts[:, -1:] + 4.0 / s).astype(np.float32)
    gc, gd, go = (rng.normal(size=sh).astype(np.float32) for sh in [(r, 3), (r,), (r,)])

    def j_loss(si, c):
        o = j_vr_ref.composite(si, c, jnp.asarray(deltas), jnp.asarray(ts))
        return jnp.sum(o.color * gc) + jnp.sum(o.depth * gd) + jnp.sum(o.opacity * go)

    want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(sigma), jnp.asarray(rgb))
    si, c = _t(sigma, grad=True), _t(rgb, grad=True)
    # the autograd op the CUDA route takes, run on CPU tensors
    color, depth, opacity = t_vr_ops.Composite.apply(si, c, _t(deltas), _t(ts))
    ((color * _t(gc)).sum() + (depth * _t(gd)).sum() + (opacity * _t(go)).sum()).backward()
    _close_grad(si.grad.numpy(), want[0], "composite sigma")
    _close_grad(c.grad.numpy(), want[1], "composite rgb")


# ---- fused path geometry and the fused step ----

def _points(rng, n):
    pts = rng.uniform(0, 0.999, (n, 3)).astype(np.float32)
    key = np.asarray(j_fp_ref.morton_key(jnp.asarray(pts)))
    return pts[np.argsort(key, kind="stable")]


def _step_inputs(rng, n):
    pts = _points(rng, n)
    sh = (rng.normal(size=(n, SH)) * 0.3).astype(np.float32)
    td = (rng.normal(size=(L, TD, F)) * 0.1).astype(np.float32)
    tc = (rng.normal(size=(L, TC, F)) * 0.1).astype(np.float32)

    def lin(d_in, d_out):
        return ((rng.normal(size=(d_in, d_out)) * (1.0 / d_in) ** 0.5).astype(np.float32),
                (rng.normal(size=(d_out,)) * 0.01).astype(np.float32))

    mlp_d = dict(zip(("w1", "b1"), lin(L * F, HID)))
    mlp_d.update(zip(("w2", "b2"), lin(HID, 1 + GEO)))
    mlp_c = dict(zip(("w1", "b1"), lin(L * F + SH, HID)))
    mlp_c.update(zip(("w2", "b2"), lin(HID, HID)))
    mlp_c.update(zip(("w3", "b3"), lin(HID, 3)))
    return pts, sh, td, tc, mlp_d, mlp_c


def test_fused_path_geometry_matches_jax_exactly(rng):
    pts = _points(rng, 300)
    dense = j_he_ref.level_is_dense(RES, TD)
    cj, wj = j_fp_ref.corner_geometry(jnp.asarray(pts), RES)
    ct, wt = t_fp_ref.corner_geometry(_t(pts), RES)
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(wt, wj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)
    ij = j_fp_ref.level_indices(cj, RES, TD, dense)
    it = t_fp_ref.level_indices(ct, RES, TD, dense)
    for a, b in zip(it, ij):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(t_fp_ref.address_stream(it, TD).numpy(),
                                  np.asarray(j_fp_ref.address_stream(ij, TD)))
    tables = rng.uniform(-1, 1, size=(L, TD, F)).astype(np.float32)
    np.testing.assert_allclose(
        t_fp_ref.encode_from_indices(_t(tables), it, wt).numpy(),
        np.asarray(j_fp_ref.encode_from_indices(jnp.asarray(tables), ij, wj)), atol=1e-6)


@pytest.mark.parametrize("backend", ["ref", "pallas-interpret"])
def test_fused_step_values_and_gradients_match_jax(backend, rng):
    """The port's plain fused step against the reference's, on its ref
    backend and on its Pallas kernels (interpret mode: the forward and the
    hand-written backward that the CUDA kernels replace)."""
    n = 256
    pts, sh, td, tc, mlp_d, mlp_c = _step_inputs(rng, n)
    g_d = rng.normal(size=(n, 1 + GEO)).astype(np.float32)
    g_c = rng.normal(size=(n, 3)).astype(np.float32)
    j_step = j_fs_ops.make_fused_step(RES, (TD, TC), F, backend=backend, block_points=64)
    jargs = (jnp.asarray(pts), jnp.asarray(sh), jnp.asarray(td), jnp.asarray(tc),
             jax.tree.map(jnp.asarray, mlp_d), jax.tree.map(jnp.asarray, mlp_c))
    j_out = jax.jit(j_step)(*jargs)
    j_grads = jax.jit(jax.grad(
        lambda *a: jnp.sum(j_step(*a)[0] * g_d) + jnp.sum(j_step(*a)[1] * g_c),
        argnums=(1, 2, 3, 4, 5)))(*jargs)

    t_step = t_fs_ops.make_fused_step(RES, (TD, TC), F)
    t_sh, t_td, t_tc = (_t(v, grad=True) for v in (sh, td, tc))
    t_md = {k: _t(v, grad=True) for k, v in mlp_d.items()}
    t_mc = {k: _t(v, grad=True) for k, v in mlp_c.items()}
    out_d, raw_c = t_step(_t(pts), t_sh, t_td, t_tc, t_md, t_mc)
    np.testing.assert_allclose(out_d.detach().numpy(), np.asarray(j_out[0]), atol=1e-5)
    np.testing.assert_allclose(raw_c.detach().numpy(), np.asarray(j_out[1]), atol=1e-5)
    ((out_d * _t(g_d)).sum() + (raw_c * _t(g_c)).sum()).backward()
    g_sh, g_td, g_tc, g_md, g_mc = j_grads
    _close_grad(t_sh.grad.numpy(), g_sh, "d_sh")
    for name, got, want in (("density table", t_td.grad, g_td), ("color table", t_tc.grad, g_tc)):
        _close_grad(got.numpy(), want, name)
        _same_rows(got.numpy(), want, name)
    for k in mlp_d:
        _close_grad(t_md[k].grad.numpy(), g_md[k], f"mlp_d {k}")
    for k in mlp_c:
        _close_grad(t_mc[k].grad.numpy(), g_mc[k], f"mlp_c {k}")
    # the plain forward is the reference's oracle too
    dense_d = t_he_ref.level_is_dense(RES, TD)
    dense_c = t_he_ref.level_is_dense(RES, TC)
    ref_out = t_fs_ref.fused_step_ref(_t(pts), _t(sh), _t(td), _t(tc),
                                      {k: _t(v) for k, v in mlp_d.items()},
                                      {k: _t(v) for k, v in mlp_c.items()}, RES, dense_d, dense_c)
    np.testing.assert_array_equal(ref_out[0].numpy(), out_d.detach().numpy())


def test_fused_step_frozen_table_gets_no_gradient(rng):
    n = 128
    pts, sh, td, tc, mlp_d, mlp_c = _step_inputs(rng, n)
    t_step = t_fs_ops.make_fused_step(RES, (TD, TC), F)
    t_td, t_tc = _t(td, grad=True), _t(tc)
    md = {k: _t(v, grad=True) for k, v in mlp_d.items()}
    mc = {k: _t(v, grad=True) for k, v in mlp_c.items()}
    out_d, raw_c = t_step(_t(pts), _t(sh), t_td, t_tc, md, mc)
    (out_d.sum() + raw_c.sum()).backward()
    assert t_tc.grad is None and t_td.grad is not None and t_td.grad.any()
    # the "stash" policy is ported: the frozen table still gets nothing and
    # the density table the same bytes
    s_td, s_tc = _t(td, grad=True), _t(tc)
    s_md = {k: _t(v, grad=True) for k, v in mlp_d.items()}
    s_mc = {k: _t(v, grad=True) for k, v in mlp_c.items()}
    out_d, raw_c = t_fs_ops.make_fused_step(RES, (TD, TC), F, residual_policy="stash")(
        _t(pts), _t(sh), s_td, s_tc, s_md, s_mc)
    (out_d.sum() + raw_c.sum()).backward()
    assert s_tc.grad is None and torch.equal(s_td.grad, t_td.grad)
    assert all(torch.equal(s_md[k].grad, md[k].grad) for k in md)
    assert all(torch.equal(s_mc[k].grad, mc[k].grad) for k in mc)
    with pytest.raises(ValueError, match="residual_policy"):
        t_fs_ops.make_fused_step(RES, (TD, TC), F, residual_policy="keep")


def test_dedup_oracle_matches_jax(rng):
    n, block = 128, 64
    pts = _points(rng, n)
    tables = rng.uniform(-1, 1, size=(L, TD, F)).astype(np.float32)
    dense = j_he_ref.level_is_dense(RES, TD)
    cj, wj = j_fp_ref.corner_geometry(jnp.asarray(pts), RES)
    ij = j_fp_ref.level_indices(cj, RES, TD, dense)
    for level in range(L):
        wm_j, u_j = j_fs_ref.dedup_weight_matrix(ij[level][:block], wj[level][:block])
        wm_t, u_t = t_fs_ref.dedup_weight_matrix(_t(np.asarray(ij[level][:block])).long(),
                                                 _t(np.asarray(wj[level][:block])))
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
        np.testing.assert_allclose(wm_t.numpy(), np.asarray(wm_j), atol=1e-7)
    got = t_fs_ref.encode_block_dedup(_t(pts), _t(tables), RES, TD, dense, block)
    want = j_fs_ref.encode_block_dedup(jnp.asarray(pts), jnp.asarray(tables), RES, TD,
                                       dense, block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---- optimizer, losses, budget ----

def _param_tree(rng):
    return {"density_grid": rng.normal(size=(2, 64, 2)).astype(np.float32),
            "color_grid": rng.normal(size=(2, 16, 2)).astype(np.float32),
            "density_mlp": {"w1": rng.normal(size=(4, 8)).astype(np.float32),
                            "b1": rng.normal(size=(8,)).astype(np.float32)}}


def test_adamw_matches_jax_and_masks_freeze_params_and_moments(rng):
    def lr_scale(path):
        return 1.0 if any("grid" in p for p in path) else 0.1

    kw = dict(lr=1e-2, b2=0.99, eps=1e-15, lr_scale_fn=lr_scale)
    j_opt, t_opt = JAdamW(weight_decay=0.0, **kw), TAdamW(**kw)
    params = _param_tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_opt.init(jp)
    tp = bridge.params_to_torch(params, "cpu")
    ts = t_opt.init(tp)
    for step in range(4):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                             * (1e-6 if step == 2 else 1.0), params)
        grads["density_grid"][0, :5] = 0.0                     # rows with no update
        mask = jax.tree.map(lambda _: True, params)
        mask["color_grid"] = step % 2 == 0
        jp, js = j_opt.apply(jp, jax.tree.map(jnp.asarray, grads), js, mask=mask)
        before_c = (ts.m["color_grid"].clone(), tp["color_grid"].clone())
        tp, ts = t_opt.apply(tp, bridge.params_to_torch(grads, "cpu"), ts, mask=mask)
        if not mask["color_grid"]:
            assert torch.equal(ts.m["color_grid"], before_c[0])
            assert torch.equal(tp["color_grid"], before_c[1])
    for got, want in zip(jax.tree_util.tree_leaves(bridge.params_to_numpy(tp)),
                         jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-8)
    step, m, v = bridge.opt_to_numpy(ts)
    assert int(step) == int(js.step) == 4
    for got, want in zip(jax.tree_util.tree_leaves((m, v)),
                         jax.tree_util.tree_leaves((js.m, js.v))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-12)
    # the optimizer state converts both ways
    back = bridge.opt_to_torch((np.asarray(js.step), jax.tree.map(np.asarray, js.m),
                                jax.tree.map(np.asarray, js.v)), "cpu")
    assert int(back.step) == 4 and back.step.dtype == torch.int32
    np.testing.assert_array_equal(back.v["density_mlp"]["w1"].numpy(),
                                  np.asarray(js.v["density_mlp"]["w1"]))


def test_losses_match_jax(rng):
    a = rng.uniform(0, 1, size=(50, 3)).astype(np.float32)
    b = rng.uniform(0, 1, size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(float(t_losses.mse(_t(a), _t(b))),
                               float(j_losses.mse(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_allclose(float(t_losses.psnr(_t(a), _t(b))),
                               float(j_losses.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    assert float(t_losses.psnr(_t(a), _t(a))) == float(j_losses.psnr(jnp.asarray(a),
                                                                     jnp.asarray(a))) == 100.0


def test_suggest_budget_matches_jax_exactly():
    for n_total in (1024, 49152):
        for frac in np.linspace(-0.1, 1.2, 53):
            for kw in ({}, {"headroom": 0.5, "min_budget": 64}, {"max_budget": 8192}):
                assert t_suggest_budget(float(frac), n_total, **kw) == \
                    j_suggest_budget(float(frac), n_total, **kw)


# ---- dispatch ----

def test_training_kernel_wrappers_refuse_cpu_tensors():
    """On CPU tensors the new kernel wrappers raise (no silent fallback)."""
    with pytest.raises(ValueError, match="expected"):
        t_gu_kernel.bum_scatter(torch.zeros((8, 2)), torch.zeros(4, dtype=torch.int64),
                                torch.zeros((4, 2)))
    mlp_d = {k: torch.zeros(1) for k in ("w1", "b1", "w2", "b2")}
    mlp_c = {k: torch.zeros(1) for k in ("w1", "b1", "w2", "b2", "w3", "b3")}
    args = (torch.zeros((4, 3)), torch.zeros((4, 16)), torch.zeros((2, 16, 2)),
            torch.zeros((2, 16, 2)), mlp_d, mlp_c, [2, 4], [1, 1], [1, 1])
    with pytest.raises(ValueError, match="expected"):
        t_fs_kernel.fused_step_fwd(*args)
    with pytest.raises(ValueError, match="expected"):
        t_fs_kernel.fused_step_bwd(args[0], args[1], torch.zeros((4, 1)), torch.zeros((4, 1)),
                                   *args[2:])


def test_fused_encode_wrapper_refuses_what_the_kernel_does_not_take():
    """The fused encode's wrapper takes (N, 3) f32 points and (L, T, F)
    tables of f32, bf16 or f16, on the card; anything else raises, before
    anything is built."""
    pts, tables = torch.zeros((8, 3)), torch.zeros((2, 16, 2))
    with pytest.raises(ValueError, match="expected"):
        t_fp_kernel.fused_encode(pts, tables, [2, 4], [1, 1])          # CPU tensors
    with pytest.raises(ValueError, match="float32"):
        t_fp_kernel.fused_encode(pts.double(), tables, [2, 4], [1, 1])
    with pytest.raises(ValueError, match="expected one of"):
        t_fp_kernel.fused_encode(pts, tables.double(), [2, 4], [1, 1])
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        t_fp_kernel.fused_encode(torch.zeros((8, 2)), tables, [2, 4], [1, 1])
    with pytest.raises(ValueError, match=r"\(L, T, F\)"):
        t_fp_kernel.fused_encode(pts, torch.zeros((16, 2)), [2, 4], [1, 1])
    with pytest.raises(ValueError, match="power of two"):
        t_fp_kernel.fused_encode(pts, torch.zeros((2, 12, 2)), [2, 4], [1, 1])
    with pytest.raises(ValueError, match="F=3"):
        t_fp_kernel.fused_encode(pts, torch.zeros((2, 16, 3)), [2, 4], [1, 1])
    with pytest.raises(ValueError, match="levels"):
        t_fp_kernel.fused_encode(pts, tables, [2], [1])
