"""The arithmetic and the stream layout of the two kernels redesigned for the
tensor cores (CPU; the kernels themselves run in
tests/test_torch_kernels_card.py).

* The stream-order contract of the fused backward (kernel #6): its
  table-gradient stream, laid out as the kernel writes it
  (`ref.bwd_table_stream`: level, point, corner, padded to the kernel's
  32-point blocks with spill entries), stably sorted and merged, is the
  plain backward's table gradient bit for bit -- on both grids, with
  sentinel rows (zero cotangents, as the pipeline pads them) and with a
  frozen grid.
* Split TF32 ("3xTF32", csrc/mlp_tile.cuh): a plain emulation of the
  tensor-core products (operands rounded to TF32 by masking the mantissa,
  round to nearest even; products of TF32 values exact; each 8-deep step
  summed into f32 accumulators, the small terms apart from the large) holds
  mlp3 at 48-64-64-3 and 31-64-64-3 and mlp2 at 32-64-16 and 8-16-16
  within 1e-5 of float64, and the fused
  backward's MLP products within its tolerances (feature gradients 1e-5,
  weight gradients and d_sh 1e-4, relative to the largest value), at the
  input scales of chip_smoke.py; a single TF32 product misses 1e-5.
* The fused step's forward (kernel #5) as its tile kernel computes it: both
  grids' features in f32, then both heads' products in split TF32 in the
  kernel's order, at FieldConfig()'s widths and chip_smoke.py's input
  scales, sentinel rows included: within 1e-5 of the forward in float64.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import encoding as enc
from repro_torch.kernels.fused_path import ref as fp_ref
from repro_torch.kernels.fused_step import kernel as fs_kernel
from repro_torch.kernels.fused_step import ops as fs_ops
from repro_torch.kernels.fused_step import ref as fs_ref
from repro_torch.kernels.grid_update import ops as gu_ops
from repro_torch.kernels.hash_encode import ref as he_ref

L, F = 4, 2
TD, TC = 1 << 10, 1 << 8
RES = he_ref.level_resolutions(L, 4, 32)
DENSE = (tuple(bool(x) for x in he_ref.level_is_dense(RES, TD)),
         tuple(bool(x) for x in he_ref.level_is_dense(RES, TC)))
SH, HID, GEO = 16, 16, 4
F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _he(rng, d_in, d_out):
    b = (6.0 / d_in) ** 0.5
    return _t(rng.uniform(-b, b, size=(d_in, d_out))), _t(rng.uniform(-0.1, 0.1, size=d_out))


def _step_inputs(rng, n, n_sentinel):
    """Unit points (the last n_sentinel rows sentinels, with zero
    cotangents), SH features, tables and MLPs of a small field."""
    pts = rng.uniform(0.0, 1.0 - 1e-6, size=(n, 3))
    pts[n - n_sentinel:] = -1.0
    sh = _t(rng.uniform(-1, 1, size=(n, SH)))
    tables = [_t(rng.uniform(-1, 1, size=(L, t, F))) for t in (TD, TC)]
    w1d, b1d = _he(rng, L * F, HID)
    w2d, b2d = _he(rng, HID, 1 + GEO)
    w1c, b1c = _he(rng, L * F + SH, HID)
    w2c, b2c = _he(rng, HID, HID)
    w3c, b3c = _he(rng, HID, 3)
    mlp_d = {"w1": w1d, "b1": b1d, "w2": w2d, "b2": b2d}
    mlp_c = {"w1": w1c, "b1": b1c, "w2": w2c, "b2": b2c, "w3": w3c, "b3": b3c}
    g_d = _t(rng.uniform(-1, 1, size=(n, 1 + GEO)))
    g_c = _t(rng.uniform(-1, 1, size=(n, 3)))
    g_d[n - n_sentinel:] = 0.0
    g_c[n - n_sentinel:] = 0.0
    return _t(pts), sh, tables, mlp_d, mlp_c, g_d, g_c


def _feature_grads(pts, sh, tables, mlp_d, mlp_c, g_d, g_c):
    """The plain backward's gradients of both grids' features."""
    hd, hc, _, _ = fs_ref.encode_both(pts, *tables, RES, *DENSE)
    hd, hc = hd.requires_grad_(True), hc.requires_grad_(True)
    outs = fs_ref.mlp_heads(hd, hc, sh, mlp_d, mlp_c)
    return torch.autograd.grad(outs, (hd, hc), (g_d, g_c))


@pytest.mark.parametrize("needs", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("n", [1, 77, 300])
def test_kernel_stream_layout_merges_to_the_plain_table_gradients(n, needs):
    rng = np.random.default_rng(n)
    n_sentinel = 3 if n > 3 else 0
    pts, sh, tables, mlp_d, mlp_c, g_d, g_c = _step_inputs(rng, n, n_sentinel)
    want = fs_ops._plain_backward((RES, *DENSE), pts, sh, *tables, mlp_d, mlp_c, g_d, g_c,
                                  needs)
    g_feats = _feature_grads(pts, sh, tables, mlp_d, mlp_c, g_d, g_c)
    blocks = -(-n // fs_kernel.BWD_POINTS)
    n_pad = blocks * fs_kernel.BWD_POINTS
    for k, (table, dense, need) in enumerate(zip(tables, DENSE, needs)):
        if not need:
            assert want[k] is None
            continue
        size = table.shape[1]
        addr, vals = fs_ref.bwd_table_stream(pts, g_feats[k], RES, size, dense, n_pad=n_pad)
        # the length the wrapper allocates for the kernel's stream
        assert addr.shape == (blocks * L * fs_kernel.BWD_POINTS * 8,)
        assert vals.shape == (addr.shape[0], F)
        order = torch.sort(addr, stable=True).indices
        flat = gu_ops.windowed_scatter_add(torch.zeros((L * size, F)), addr[order][None],
                                           vals[order][None], presorted=True)
        got = flat.reshape(L, size, F)
        assert torch.equal(got.view(torch.int32), want[k].view(torch.int32))


@pytest.mark.parametrize("n", [77, 300])
def test_backward_f64_is_the_plain_backward_in_float64(n):
    """The card test's yardstick: `ref.backward_f64` agrees with the f32
    plain backward within the kernel's tolerances (tables 1e-5, MLP
    gradients and d_sh 1e-4, relative to the largest value), with the same
    nonzero table rows and a frozen grid left without a gradient."""
    rng = np.random.default_rng(n + 5)
    pts, sh, tables, mlp_d, mlp_c, g_d, g_c = _step_inputs(rng, n, 3)
    for needs in ((True, True), (True, False)):
        want = fs_ops._plain_backward((RES, *DENSE), pts, sh, *tables, mlp_d, mlp_c, g_d, g_c,
                                      needs)
        got = fs_ref.backward_f64((RES, *DENSE), pts, sh, *tables, mlp_d, mlp_c, g_d, g_c,
                                  needs)
        for k, need in enumerate(needs):
            if not need:
                assert got[k] is None and want[k] is None
                continue
            assert got[k].dtype == F64
            assert _rel(want[k], got[k]) <= 1e-5
            assert torch.equal(got[k].ne(0).any(dim=-1), want[k].ne(0).any(dim=-1))
        for k in (2, 3):
            for name in want[k]:
                assert _rel(want[k][name], got[k][name]) <= 1e-4, name
        assert _rel(want[4], got[4]) <= 1e-4


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest even."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm(a: torch.Tensor, b: torch.Tensor, split: bool = True) -> torch.Tensor:
    """a (M, K) @ b (K, N) as the tensor-core routine computes it: each
    8-deep step's TF32 products summed exactly, then added into an f32
    accumulator, step after step; split=True keeps a_lo b_hi and a_hi b_lo
    in two more accumulators and joins them to a_hi b_hi at the end."""
    ah, al = _split(a.to(torch.float32))
    bh, bl = _split(b.to(torch.float32))
    big = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    lohi, hilo = torch.zeros_like(big), torch.zeros_like(big)
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        big = big + (ah[:, s].to(F64) @ bh[s].to(F64)).to(torch.float32)
        if split:
            lohi = lohi + (al[:, s].to(F64) @ bh[s].to(F64)).to(torch.float32)
            hilo = hilo + (ah[:, s].to(F64) @ bl[s].to(F64)).to(torch.float32)
    return big + (lohi + hilo)


def _relu(z):
    return torch.clamp(z, min=0.0)


def _mlp_emulated(x, *params, split=True):
    """The ReLU MLP of len(params) // 2 layers, each product emulated."""
    h = x
    for k in range(0, len(params), 2):
        z = _mm(h, params[k], split) + params[k + 1]
        h = _relu(z) if k + 2 < len(params) else z
    return h


@pytest.mark.parametrize("dims", [(48, 64, 64, 3), (31, 64, 64, 3), (32, 64, 16), (8, 16, 16)],
                         ids=["48", "31", "mlp2-32-64-16", "mlp2-8-16-16"])
def test_split_tf32_mlp3_meets_the_kernel_tolerance(dims):
    """Both MLP kernels' products (fused_mlp3: 48 and 31 inputs; fused_mlp2
    at the density head's widths and the card test's small ones): split TF32
    within 1e-5 of float64, a single TF32 product not."""
    rng = np.random.default_rng(dims[0])
    x = _t(rng.uniform(-1, 1, size=(4096, dims[0])))
    params = [t for d_in, d_out in zip(dims[:-1], dims[1:]) for t in _he(rng, d_in, d_out)]
    exact = fs_ref.layers_f64(x, *params)
    split_err = float((_mlp_emulated(x, *params).to(F64) - exact).abs().max())
    single_err = float((_mlp_emulated(x, *params, split=False).to(F64) - exact).abs().max())
    assert split_err <= 1e-5
    assert single_err > 1e-5
    assert single_err > 50 * split_err


def _rel(a, b):
    return float((a.to(F64) - b).abs().max()) / float(b.abs().max())


def test_split_tf32_fused_backward_products_meet_the_kernel_tolerances():
    """The fused backward's MLP products at FieldConfig()'s widths (32
    density features, 48 color inputs, hidden 64, heads 16 and 3), weight
    gradients summed per 32-point block and the blocks in order, against
    float64 autograd."""
    rng = np.random.default_rng(7)
    n, feat, cin, hid, block = 2048, 32, 48, 64, fs_kernel.BWD_POINTS
    xd = _t(rng.uniform(-1, 1, size=(n, feat)))
    xc = _t(rng.uniform(-1, 1, size=(n, cin)))
    g_d = _t(rng.uniform(-1, 1, size=(n, 16)))
    g_c = _t(rng.uniform(-1, 1, size=(n, 3)))
    w1d, b1d = _he(rng, feat, hid)
    w2d, b2d = _he(rng, hid, 16)
    w1c, b1c = _he(rng, cin, hid)
    w2c, b2c = _he(rng, hid, hid)
    w3c, b3c = _he(rng, hid, 3)
    params = [w1d, b1d, w2d, b2d, w1c, b1c, w2c, b2c, w3c, b3c]

    # float64 autograd of the two heads
    leaves = [t.to(F64).requires_grad_(True) for t in [xd, xc] + params]
    out_d = fs_ref.layers_f64(leaves[0], *leaves[2:6])
    out_c = fs_ref.layers_f64(leaves[1], *leaves[6:])
    exact = torch.autograd.grad((out_d, out_c), leaves, (g_d.to(F64), g_c.to(F64)))

    def relu_grad(z):
        return torch.where(z > 0, 1.0, torch.where(z == 0, 0.5, 0.0))

    def block_sums(a, g):
        """a^T g per 32-point block, the blocks summed in order (f32)."""
        total = None
        for s in range(0, n, block):
            part = _mm(a[s:s + block].T.contiguous(), g[s:s + block])
            total = part if total is None else total + part
        return total

    def col_sums(g):
        total = None
        for s in range(0, n, block):
            part = torch.zeros(g.shape[1])
            for r in range(s, s + block):
                part = part + g[r]
            total = part if total is None else total + part
        return total

    zd = _mm(xd, w1d) + b1d
    ghd1 = _mm(g_d, w2d.T.contiguous()) * relu_grad(zd)
    ghd = _mm(ghd1, w1d.T.contiguous())
    z1 = _mm(xc, w1c) + b1c
    z2 = _mm(_relu(z1), w2c) + b2c
    gh2 = _mm(g_c, w3c.T.contiguous()) * relu_grad(z2)
    gh1 = _mm(gh2, w2c.T.contiguous()) * relu_grad(z1)
    gcin = _mm(gh1, w1c.T.contiguous())
    emulated = [ghd, gcin[:, :feat], gcin[:, feat:],
                block_sums(xd, ghd1), col_sums(ghd1), block_sums(_relu(zd), g_d), col_sums(g_d),
                block_sums(xc, gh1), col_sums(gh1), block_sums(_relu(z1), gh2), col_sums(gh2),
                block_sums(_relu(z2), g_c), col_sums(g_c)]
    want = [exact[0], exact[1][:, :feat], exact[1][:, feat:], *exact[2:]]
    assert _rel(emulated[0], want[0]) <= 1e-5          # density feature gradients
    assert _rel(emulated[1], want[1]) <= 1e-5          # color feature gradients
    assert _rel(emulated[2], want[2]) <= 1e-4          # d_sh
    for got, w in zip(emulated[3:], want[3:]):         # MLP weight and bias gradients
        assert _rel(got, w) <= 1e-4


def _encode_f64(pts, table, res, dense):
    """One grid's features with the plain version's corners and f32 corner
    weights, each weighted sum taken in float64."""
    corners, weights = fp_ref.corner_geometry(pts, res)
    idx = fp_ref.level_indices(corners, res, table.shape[1], dense)
    return torch.cat([(w.to(F64)[..., None] * table[level][i].to(F64)).sum(dim=1)
                      for level, (i, w) in enumerate(zip(idx, weights))], dim=-1)


@pytest.mark.parametrize("split", [True, False], ids=["split", "single"])
def test_split_tf32_fused_forward_meets_the_kernel_tolerance(split):
    """Kernel #5's forward at FieldConfig()'s widths (16 levels x 2 features
    per grid, 16 SH inputs, hidden 64, heads 16 and 3) on chip_smoke.py's
    inputs (Morton-ordered unit points, the last 4 rows sentinels whose
    features are exactly 0; SH of random unit directions; tables U(-1, 1),
    He-uniform weights, biases U(-0.1, 0.1)): the f32 features, then z =
    x W1 + b1 and relu(z) W2 + b2 for the density head and z1, z2 =
    relu(z1) W2 + b2, relu(z2) W3 + b3 for the color head, every product in
    split TF32, stay within 1e-5 of the whole forward in float64; a single
    TF32 product misses it."""
    rng = np.random.default_rng(23)
    n, n_sent, levels, hid = 4096, 4, 16, 64
    res = he_ref.level_resolutions(levels, 16, 1024)
    sizes = (1 << 12, 1 << 10)
    dense = [tuple(bool(x) for x in he_ref.level_is_dense(res, t)) for t in sizes]
    pts = _t(rng.uniform(0.0, 1.0 - 1e-6, size=(n, 3)))
    pts = pts[torch.sort(fp_ref.morton_key(pts), stable=True).indices]
    dirs = _t(rng.uniform(-1, 1, size=(n, 3)))
    sh = enc.sh_encoding(dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True), 4)
    tables = [_t(rng.uniform(-1, 1, size=(levels, t, F))) for t in sizes]
    layers_d = [(levels * F, hid), (hid, 16)]
    layers_c = [(levels * F + sh.shape[1], hid), (hid, hid), (hid, 3)]
    mlp_d = [t for d_in, d_out in layers_d for t in _he(rng, d_in, d_out)]
    mlp_c = [t for d_in, d_out in layers_c for t in _he(rng, d_in, d_out)]
    for params in (mlp_d, mlp_c):
        for k in range(1, len(params), 2):
            params[k] = _t(rng.uniform(-0.1, 0.1, size=params[k].shape))
    valid = n - n_sent
    feats, feats64 = [], []
    for table, flags in zip(tables, dense):
        x = torch.zeros((n, levels * F))
        x[:valid] = fs_ref.encode_both(pts[:valid], table, table, res, flags, flags)[0]
        x64 = torch.zeros((n, levels * F), dtype=F64)
        x64[:valid] = _encode_f64(pts[:valid], table, res, flags)
        feats.append(x)
        feats64.append(x64)
    assert float((feats[0] - feats64[0]).abs().max()) <= 1e-6
    got = (_mlp_emulated(feats[0], *mlp_d, split=split),
           _mlp_emulated(torch.cat([feats[1], sh], dim=-1), *mlp_c, split=split))
    want = (fs_ref.layers_f64(feats64[0], *mlp_d),
            fs_ref.layers_f64(torch.cat([feats64[1], sh.to(F64)], dim=-1), *mlp_c))
    err = max(float((g.to(F64) - w).abs().max()) for g, w in zip(got, want))
    assert (err <= 1e-5) == split, err
    # the sentinel rows' outputs are the heads of all-zero features
    tail = _mlp_emulated(torch.cat([torch.zeros((n_sent, levels * F)), sh[valid:]], dim=-1),
                         *mlp_c, split=split)
    assert torch.equal(got[1][valid:], tail)
