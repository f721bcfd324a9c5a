"""The plain version of the table-gradient sort (`grid_update.ref.
stable_key_sort`, the function of the CUDA kernel `bum_sort`) on the CPU.

A stable sort's permutation is unique, so every comparison is exact: the
radix passes over the key's low `key_bits` bits give `torch.sort(stable=
True)`'s order, numpy's `argsort(kind="stable")` and JAX's `jnp.argsort`
on the same numpy keys, made from a seed -- for key widths 1, 8, 17 and 23
(23: the density grid's addresses with the spill row L*T), many equal keys,
M = 0 and M not a multiple of the kernel's 4096-entry tile.  Then kernel
#6's plain table-gradient stream of a small field (`fused_step.ref.
bwd_table_stream`, with sentinel rows and the spill entries of the last
block), sorted by the radix passes and merged by `segment_commit`, is the
`torch.sort` route's table gradient bit for bit, and within 1e-5 of the
largest |gradient| of the JAX package's `fused_step_bwd_pallas` (interpret
mode) on the same inputs, with the same nonzero rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.fused_step import kernel as j_fs_kernel
from repro.kernels.hash_encode import ref as j_he_ref
from repro_torch import kernels as t_kernels
from repro_torch.kernels.fused_step import ref as t_fs_ref
from repro_torch.kernels.grid_update import kernel as t_gu_kernel
from repro_torch.kernels.grid_update import ops as t_gu_ops
from repro_torch.kernels.grid_update import ref as t_gu_ref

L, F = 4, 2
TD, TC = 1 << 12, 1 << 10
RES = j_he_ref.level_resolutions(L, 8, 64)
DENSE = (tuple(bool(x) for x in j_he_ref.level_is_dense(RES, TD)),
         tuple(bool(x) for x in j_he_ref.level_is_dense(RES, TC)))
SH, HID, GEO = 16, 16, 4
BLOCK = 64                  # points per block of the Pallas backward


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(rng, m, bits, pattern):
    hi = 1 << bits
    if pattern == "random":
        return rng.integers(0, hi, size=m)
    if pattern == "few":                   # many equal keys
        return rng.choice(np.array([0, hi // 3, hi - 1]), size=m)
    if pattern == "equal":
        return np.full(m, hi - 1)
    if pattern == "descending":            # distinct where the width allows
        return (np.arange(m)[::-1] % hi)
    if pattern == "spill":                 # addresses of L*T = 2^(bits-1) rows, and L*T
        return np.where(rng.random(m) < 0.1, hi // 2, rng.integers(0, hi // 2, size=m))
    raise ValueError(pattern)


def _check_sort(keys_np, bits):
    """stable_key_sort against torch.sort, numpy and JAX, values carried."""
    m = keys_np.shape[0]
    addr = torch.from_numpy(keys_np.astype(np.int64))
    vals = torch.stack([torch.arange(m, dtype=torch.float32),
                        torch.linspace(-1.0, 1.0, m)], dim=1) if m else torch.zeros((0, 2))
    got_addr, got_vals = t_gu_ref.stable_key_sort(addr, vals, bits)
    order = torch.sort(addr, stable=True).indices
    assert torch.equal(got_addr, addr[order])
    assert torch.equal(got_vals, vals[order])
    perm = got_vals[:, 0].to(torch.int64).numpy()          # the order, read back
    np.testing.assert_array_equal(perm, np.argsort(keys_np, kind="stable"))
    np.testing.assert_array_equal(perm, np.asarray(jnp.argsort(jnp.asarray(keys_np,
                                                                           jnp.int32))))


@pytest.mark.parametrize("bits", [0, 1, 8, 11, 12, 17, 20, 21, 22, 23, 32])
def test_radix_passes_cover_the_key_bits(bits):
    passes = t_gu_ref.radix_passes(bits)
    widths = [w for _, w in passes]
    assert sum(widths) == bits and len(passes) == -(-bits // t_gu_ref.RADIX_MAX_BITS)
    assert all(1 <= w <= t_gu_ref.RADIX_MAX_BITS for w in widths)
    assert max(widths, default=0) - min(widths, default=0) <= 1
    assert [s for s, _ in passes] == [sum(widths[:k]) for k in range(len(widths))]


@pytest.mark.parametrize("pattern", ["random", "few", "equal", "descending", "spill"])
@pytest.mark.parametrize("bits,m", [(1, 4097), (8, 5003), (17, 12289), (23, 8193),
                                    (1, 0), (23, 1), (23, 2)])
def test_stable_key_sort_is_the_stable_permutation(bits, m, pattern):
    rng = np.random.default_rng(bits * 100 + m)
    _check_sort(_keys(rng, m, bits, pattern), bits)


@settings(max_examples=40, deadline=None)
@given(bits=st.integers(0, 23), m=st.integers(0, 9000), seed=st.integers(0, 2**31 - 1),
       distinct=st.integers(1, 64))
def test_stable_key_sort_property(bits, m, seed, distinct):
    """Any width and length; keys drawn from a few values (runs of equal
    keys, the case stability decides) or from the whole range."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << bits, size=distinct)
    keys = pool[rng.integers(0, distinct, size=m)] if seed % 2 else \
        rng.integers(0, 1 << bits, size=m)
    _check_sort(keys, bits)


def test_stable_key_sort_refuses_widths_outside_32_bits():
    with pytest.raises(ValueError, match="key_bits"):
        t_gu_ref.stable_key_sort(torch.zeros(3, dtype=torch.int64), torch.zeros((3, 2)), 33)


def test_cpu_streams_sort_with_torch_sort_and_launch_nothing():
    """`sort_stream` on CPU tensors is the plain route (torch.sort): the
    radix passes' result, and no kernel is counted; the kernel's wrapper
    refuses CPU tensors."""
    rng = np.random.default_rng(7)
    addr = torch.from_numpy(rng.integers(0, 1 << 14, size=6000))
    vals = torch.from_numpy(rng.normal(size=(6000, 2)).astype(np.float32))
    before = dict(t_kernels.LAUNCHES)
    got = t_gu_ops.sort_stream(addr, vals, 14)
    want = t_gu_ref.stable_key_sort(addr, vals, 14)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert t_kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="cpu"):
        t_gu_kernel.bum_sort(addr, vals, 14)


def _he(rng, d_in, d_out):
    b = (6.0 / d_in) ** 0.5
    return (rng.uniform(-b, b, size=(d_in, d_out)).astype(np.float32),
            rng.uniform(-0.1, 0.1, size=d_out).astype(np.float32))


def _inputs(rng, n, n_sentinel):
    pts = rng.uniform(0.0, 1.0 - 1e-6, size=(n, 3)).astype(np.float32)
    pts[n - n_sentinel:] = -1.0
    sh = rng.uniform(-1, 1, size=(n, SH)).astype(np.float32)
    tables = [rng.uniform(-1, 1, size=(L, t, F)).astype(np.float32) for t in (TD, TC)]
    mlp_d = dict(zip(("w1", "b1", "w2", "b2"), _he(rng, L * F, HID) + _he(rng, HID, 1 + GEO)))
    mlp_c = dict(zip(("w1", "b1", "w2", "b2", "w3", "b3"),
                     _he(rng, L * F + SH, HID) + _he(rng, HID, HID) + _he(rng, HID, 3)))
    g_d = rng.uniform(-1, 1, size=(n, 1 + GEO)).astype(np.float32)
    g_c = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    g_d[n - n_sentinel:] = 0.0
    g_c[n - n_sentinel:] = 0.0
    return pts, sh, tables, mlp_d, mlp_c, g_d, g_c


@pytest.mark.parametrize("n", [192, 256])
def test_fused_step_commit_through_the_radix_passes(n):
    """Kernel #6's commit on its plain stream: the radix passes over
    (L*T).bit_length() bits, then the merge, give the torch.sort route's
    table gradients bit for bit and the Pallas backward's within 1e-5."""
    rng = np.random.default_rng(n)
    pts, sh, tables, mlp_d, mlp_c, g_d, g_c = _inputs(rng, n, n_sentinel=5)
    t = lambda x: torch.from_numpy(x.copy())  # noqa: E731
    hd, hc, _, _ = t_fs_ref.encode_both(t(pts), t(tables[0]), t(tables[1]), RES, *DENSE)
    hd, hc = hd.requires_grad_(True), hc.requires_grad_(True)
    outs = t_fs_ref.mlp_heads(hd, hc, t(sh), {k: t(v) for k, v in mlp_d.items()},
                              {k: t(v) for k, v in mlp_c.items()})
    g_feats = torch.autograd.grad(outs, (hd, hc), (t(g_d), t(g_c)))
    want = j_fs_kernel.fused_step_bwd_pallas(
        jnp.asarray(pts), jnp.asarray(sh), jnp.asarray(g_d), jnp.asarray(g_c),
        jnp.asarray(tables[0]), jnp.asarray(tables[1]),
        {k: jnp.asarray(v) for k, v in mlp_d.items()},
        {k: jnp.asarray(v) for k, v in mlp_c.items()},
        jnp.asarray(RES, jnp.int32), jnp.asarray(DENSE[0], jnp.int32),
        jnp.asarray(DENSE[1], jnp.int32), block_points=BLOCK, interpret=True)
    n_pad = -(-n // 32) * 32 + 32                      # spill entries past the points
    for k, (size, dense) in enumerate(zip((TD, TC), DENSE)):
        addr, vals = t_fs_ref.bwd_table_stream(t(pts), g_feats[k], RES, size, dense,
                                               n_pad=n_pad)
        assert int((addr == L * size).sum()) == L * (n_pad - n) * 8
        addr_s, vals_s = t_gu_ref.stable_key_sort(addr, vals, (L * size).bit_length())
        got = t_gu_ref.segment_commit(torch.zeros((L * size, F)), addr_s, vals_s)
        order = torch.sort(addr, stable=True).indices
        plain = t_gu_ref.segment_commit(torch.zeros((L * size, F)), addr[order], vals[order])
        assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
        ref = np.asarray(want[k]).reshape(L * size, F)
        scale = float(np.abs(ref).max())
        assert float(np.abs(got.numpy() - ref).max()) <= 1e-5 * scale
        np.testing.assert_array_equal(got.numpy().any(axis=-1), ref.any(axis=-1))
