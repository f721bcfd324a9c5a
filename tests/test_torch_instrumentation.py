"""The paper's Fig. 8-10 / 16-18 instrumentation in the port, held against the
JAX package on the CPU, on the same numpy inputs made from a seed.

* `hash_encode.ops.access_stream`: the forward-order corner address stream,
  JAX's integers exactly, over hashed and dense levels;
* `grid_update.ops.num_unique_addresses`: JAX's count exactly;
* `grid_update.ref.unique_fraction`: within 1e-6 of JAX's (an f32 mean of
  per-window fractions; both sum the same integers);
* `grid_update.ops.windowed_scatter_add` on one stream (idx (M,)): cut into
  windows with the spill-row padded tail, each window sorted and committed
  in order -- JAX's table bit for bit (both sum each run in stream order
  from zero in f32 and add once), presorted or not, F = 2 and F = 64;
* `RaySampler.sample` is `gather(sample_idx)` on the same generator state;
* `obs.reset` clears the span buffer and the metrics registry, and the
  port's `obs` re-exports the reference's names.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as j_obs
from repro.kernels.grid_update import ops as j_gu_ops
from repro.kernels.grid_update import ref as j_gu_ref
from repro.kernels.hash_encode import ops as j_he_ops
from repro.kernels.hash_encode import ref as j_he_ref
from repro_torch import obs
from repro_torch.core import rendering
from repro_torch.data.rays_dataset import RaySampler
from repro_torch.data.synthetic_scene import SceneDataset
from repro_torch.kernels.grid_update import ops as t_gu_ops
from repro_torch.kernels.grid_update import ref as t_gu_ref
from repro_torch.kernels.hash_encode import ops as t_he_ops


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_access_stream_is_jax_exactly(rng):
    table_size, n = 1 << 10, 300
    res = j_he_ref.level_resolutions(6, 4, 64)
    dense = tuple(bool(x) for x in j_he_ref.level_is_dense(res, table_size))
    assert any(dense) and not all(dense)
    pts = rng.uniform(0.0, 1.0 - 1e-6, size=(n, 3)).astype(np.float32)
    want = np.asarray(j_he_ops.access_stream(jnp.asarray(pts), res, dense, table_size))
    got = t_he_ops.access_stream(torch.from_numpy(pts), res, dense, table_size)
    assert got.shape == (n * 8 * len(res),)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(t_gu_ops.num_unique_addresses(got)) == int(
        j_gu_ops.num_unique_addresses(jnp.asarray(want)))


@pytest.mark.parametrize("m,hi", [(5000, 2000)])
def test_num_unique_addresses_and_unique_fraction_match_jax(m, hi, rng):
    idx = rng.integers(0, hi, size=m).astype(np.int32)
    t = torch.from_numpy(idx).long()
    assert int(t_gu_ops.num_unique_addresses(t)) == int(
        j_gu_ops.num_unique_addresses(jnp.asarray(idx)))
    for window in (1000, 64):
        want = float(j_gu_ref.unique_fraction(jnp.asarray(idx), window=window))
        got = float(t_gu_ref.unique_fraction(t, window=window))
        assert abs(got - want) <= 1e-6, (window, got, want)


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("m,f,window", [(2500, 2, 1024), (1000, 64, 256), (300, 2, 4096)])
def test_windowed_scatter_add_one_stream_is_jax_bit_for_bit(m, f, window, presorted, rng):
    t = 300
    idx = rng.integers(0, t, size=m).astype(np.int32)
    if presorted:       # every window non-decreasing
        idx = np.concatenate([np.sort(idx[i:i + window]) for i in range(0, m, window)])
    vals = (rng.normal(size=(m, f)) * 10.0 ** rng.uniform(-3, 3, size=(m, 1))).astype(np.float32)
    table = rng.normal(size=(t, f)).astype(np.float32)
    want = np.asarray(j_gu_ops.windowed_scatter_add(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals), window=window,
        presorted=presorted))
    got = t_gu_ops.windowed_scatter_add(torch.from_numpy(table), torch.from_numpy(idx).long(),
                                        torch.from_numpy(vals), window=window,
                                        presorted=presorted)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_ray_sampler_sample_is_gather_of_sample_idx(rng):
    v, h, w = 3, 4, 5
    ds = SceneDataset(rng.uniform(size=(v, h, w, 3)).astype(np.float32),
                      rng.uniform(size=(v, h, w)).astype(np.float32),
                      rendering.sphere_poses(v, seed=0), 5.0, h, w)
    sampler = RaySampler(ds, device="cpu")
    got = sampler.sample(torch.Generator().manual_seed(7), 33)
    idx = sampler.sample_idx(torch.Generator().manual_seed(7), 33)
    want = sampler.gather(idx)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got.origins.shape == (33, 3) and int(idx.max()) < v * h * w


def test_obs_reset_clears_spans_and_metrics():
    assert set(j_obs.__all__) <= set(obs.__all__)
    was = obs.enabled()
    obs.set_enabled(True)
    try:
        with obs.span("test/instrumentation"):
            pass
        obs.REGISTRY.counter("test.instrumentation").inc(3)
        assert obs.trace.events() and obs.REGISTRY.names()
        obs.reset()
        assert obs.trace.events() == [] and obs.REGISTRY.names() == []
    finally:
        obs.set_enabled(was)
        obs.reset()
