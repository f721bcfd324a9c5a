"""The port's encoding-reuse cache against the JAX package's (CPU).

The same sequence of encodes, table updates (row-targeted and whole-grid)
and occupancy folds goes to both caches, on a tiny field's geometry.  Held:

* `hits`, `misses` and `stats()` equal after every operation;
* every cached encode equal to the port's plain `hash_encode` bit for bit,
  and within 1e-6 of JAX's cached encode;
* `stream_reuse_mask` exactly JAX's;
* no reuse when every row updates each step, reuse when the tables are
  stable, none across a fold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import field as j_field
from repro.kernels.fused_path import reuse as j_reuse
from repro_torch.core import field as t_field
from repro_torch.kernels.fused_path import reuse as t_reuse
from repro_torch.kernels.hash_encode import ref as he_ref

RES = (4, 8, 16)
T = {"density": 64, "color": 32}
F = 2
# a tiny field: its resolutions and table sizes, dense and hashed levels
GEOM = dict(n_levels=4, max_resolution=64, log2_table_density=14, log2_table_color=10,
            hidden=16)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(pts, tables, res, t):
    return he_ref.hash_encode(torch.from_numpy(pts), torch.from_numpy(tables), res,
                              he_ref.level_is_dense(np.asarray(res), t))


def _replay(seed: int, res, sizes, n_ops: int = 14):
    """One random operation sequence through both caches; every encode and
    the counters checked after each operation."""
    rng = np.random.default_rng(seed)
    jc, tc = j_reuse.EncodingReuseCache(res, sizes), t_reuse.EncodingReuseCache(res, sizes)
    tabs = {g: rng.standard_normal((len(res), t, F)).astype(np.float32)
            for g, t in sizes.items()}
    encodes = 0
    for _ in range(n_ops):
        op = rng.choice(["encode", "encode", "rows", "grid", "fold"])
        g = str(rng.choice(list(sizes)))
        if op == "rows":
            rows = rng.integers(0, len(res) * sizes[g], int(rng.integers(1, 16)))
            tabs[g] = tabs[g].copy()
            np.add.at(tabs[g], (rows // sizes[g], rows % sizes[g]), np.float32(1.0))
            jc.note_table_update(g, touched_rows=rows)
            tc.note_table_update(g, touched_rows=rows)
        elif op == "grid":
            tabs[g] = tabs[g] * np.float32(1.01)
            jc.note_table_update(g)
            tc.note_table_update(g)
        elif op == "fold":
            jc.note_fold()
            tc.note_fold()
        else:
            pts = (rng.random((int(rng.integers(8, 48)), 3), dtype=np.float32)
                   * np.float32(1 - 1e-6))
            for gg, t in sizes.items():
                got = tc.encode(gg, torch.from_numpy(pts), torch.from_numpy(tabs[gg]))
                assert torch.equal(got, _plain(pts, tabs[gg], res, t)), f"stale cache, {gg}"
                want = np.asarray(jc.encode(gg, jnp.asarray(pts), jnp.asarray(tabs[gg])))
                np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
            encodes += 1
        assert (tc.hits, tc.misses) == (jc.hits, jc.misses)
        assert tc.stats() == jc.stats()
    return tc, encodes


@pytest.mark.parametrize("seed", range(4))
def test_operation_sequences_match_jax(seed):
    tc, encodes = _replay(seed, RES, T)
    assert encodes > 0 and tc.lookups > 0


def test_tiny_field_sequence_matches_jax():
    """The same on a field's own geometry (L=4 levels, T=2^14 / 2^10, the
    coarse levels dense, the fine ones hashed)."""
    jf = j_field.Field(j_field.FieldConfig(**GEOM))
    tf = t_field.Field(t_field.FieldConfig(**GEOM))
    res = tuple(int(r) for r in tf.density_enc.resolutions)
    assert res == tuple(int(r) for r in jf.density_enc.resolutions)
    sizes = {"density": 1 << GEOM["log2_table_density"], "color": 1 << GEOM["log2_table_color"]}
    dense = he_ref.level_is_dense(np.asarray(res), sizes["density"])
    assert dense.any() and not dense.all()
    tc, _ = _replay(11, res, sizes, n_ops=10)
    assert tc.misses > 0


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_cached_encodings_never_stale(seed):
    """Any sequence of row updates, grid updates, folds and encodes keeps
    the port's cached encodes equal to its plain encode, bit for bit."""
    rng = np.random.default_rng(seed)
    cache = t_reuse.EncodingReuseCache(RES, T)
    tabs = {g: torch.from_numpy(rng.standard_normal((len(RES), T[g], F)).astype(np.float32))
            for g in T}
    for _ in range(12):
        op = rng.choice(["encode", "rows", "grid", "fold"])
        g = str(rng.choice(list(T)))
        if op == "rows":
            rows = rng.integers(0, len(RES) * T[g], int(rng.integers(1, 16)))
            tabs[g] = tabs[g].clone()
            tabs[g].index_put_((torch.from_numpy(rows // T[g]), torch.from_numpy(rows % T[g])),
                               torch.ones((rows.size, F)), accumulate=True)
            cache.note_table_update(g, touched_rows=rows)
        elif op == "grid":
            tabs[g] = tabs[g] * 1.01
            cache.note_table_update(g)
        elif op == "fold":
            cache.note_fold()
        else:
            pts = rng.random((int(rng.integers(8, 48)), 3), dtype=np.float32) * (1 - 1e-6)
            for gg in T:
                assert torch.equal(cache.encode(gg, pts, tabs[gg]),
                                   _plain(pts.astype(np.float32), tabs[gg].numpy(), RES, T[gg]))


@pytest.mark.parametrize("seed", range(3))
def test_stream_reuse_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rows = 3 * 64
    stamp = rng.integers(0, 6, rows)
    addrs = rng.integers(0, rows, (40, 8))
    for since in range(-1, 7):
        got = t_reuse.stream_reuse_mask(addrs, stamp, since)
        np.testing.assert_array_equal(got, np.asarray(j_reuse.stream_reuse_mask(addrs, stamp,
                                                                                since)))
        assert got.dtype == bool and got.shape == addrs.shape


def _density_tables(rng):
    return torch.from_numpy(rng.standard_normal((len(RES), T["density"], F)).astype(np.float32))


def test_reuse_happens_when_tables_stable():
    rng = np.random.default_rng(0)
    cache = t_reuse.EncodingReuseCache(RES, {"density": T["density"]})
    tabs = _density_tables(rng)
    pts = rng.random((64, 3), dtype=np.float32) * np.float32(1 - 1e-6)
    plain = _plain(pts, tabs.numpy(), RES, T["density"])
    first = cache.encode("density", pts, tabs)
    assert cache.hits == 0 and cache.misses > 0
    second = cache.encode("density", pts, tabs)
    assert cache.hits > 0 and cache.hits == cache.misses
    assert torch.equal(first, plain) and torch.equal(second, plain)
    assert cache.stats()["corner_reads_saved"] == cache.hits * 8


def test_zero_reuse_when_every_row_updates_each_step():
    rng = np.random.default_rng(1)
    cache = t_reuse.EncodingReuseCache(RES, {"density": T["density"]})
    tabs = _density_tables(rng)
    pts = rng.random((64, 3), dtype=np.float32) * np.float32(1 - 1e-6)
    for _ in range(5):
        assert torch.equal(cache.encode("density", pts, tabs),
                           _plain(pts, tabs.numpy(), RES, T["density"]))
        tabs = tabs + 0.1
        cache.note_table_update("density")
    assert cache.hits == 0 and cache.hit_rate() == 0.0


def test_fold_drops_entries_and_cohort_members_share_them():
    """A fold re-misses the same points on unchanged tables; two members
    with equal tables (a cohort's guarantee) hit each other's entries."""
    rng = np.random.default_rng(2)
    cache = t_reuse.EncodingReuseCache(RES, {"density": T["density"]})
    tabs = _density_tables(rng)
    pts = rng.random((16, 3), dtype=np.float32) * np.float32(1 - 1e-6)
    cache.encode("density", pts, tabs)
    cache.note_fold()
    hits = cache.hits
    cache.encode("density", pts, tabs)
    assert cache.hits == hits and cache.fold == 1
    misses = cache.misses
    member = cache.encode("density", pts, tabs.clone())
    assert cache.misses == misses and cache.hits > hits
    assert torch.equal(member, _plain(pts, tabs.numpy(), RES, T["density"]))
