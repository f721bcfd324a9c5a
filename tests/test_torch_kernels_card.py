"""Port kernels on the card: each CUDA kernel against its plain version.

Marked ``gpu``; each test decides inside itself whether an sm_90 card is
present and skips otherwise, so every pytest worker collects the same tests.
This file imports no JAX, so it runs where only PyTorch and CUDA are
installed.  Run on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_card.py``.

Tolerances (max abs error): hash encode 1e-5 (8-corner sums of table values
in [-1, 1], FMA-contracted in the kernel), MLPs 1e-5 (O(1) outputs; both
MLPs and the fused backward multiply in split TF32 on the tensor cores),
composite 5e-5 (48-term depth sums with t up to 6), the fused step's
forward and the fused encode 1e-5; the fused encode's distinct reads per
(block, level) exactly the plain count, and its table gradients the hash
encode's bit for bit (the same products committed in the same order).  Gradients: within 1e-5 of the largest |value| for table
gradients (the fused backward merges per block, the plain one per stream)
and 1e-4 for MLP gradients (summed over blocks in another order), with the
same nonzero rows; bum_scatter bit for bit against the plain merge on CPU
copies (both sum each run in stream order), also on streams built to break
its tile walk.  The redesigned kernels (the hash encode, both MLPs, the
fused step's forward and backward) give the same bytes on two launches.
Stage 2b v3's shapes: the composite on its ragged lane grids (invalid lanes
with deltas 0 and ts at far) and the fused step on its Morton-packed points
at the ceiling of 4096, with the same tolerances.
"""
import ctypes

import pytest
import torch

from repro_torch import kernels, smoke
from repro_torch.core.field import Field, FieldConfig
from repro_torch.kernels.fused_mlp import kernel as mlp_kernel
from repro_torch.kernels.fused_mlp import ops as mlp_ops
from repro_torch.kernels.fused_mlp import ref as mlp_ref
from repro_torch.kernels.fused_path import kernel as fp_kernel
from repro_torch.kernels.fused_path import ref as fp_ref
from repro_torch.kernels.fused_step import kernel as fs_kernel
from repro_torch.kernels.fused_step import ops as fs_ops
from repro_torch.kernels.fused_step import ref as fs_ref
from repro_torch.kernels.grid_update import kernel as gu_kernel
from repro_torch.kernels.grid_update import ref as gu_ref
from repro_torch.kernels.hash_encode import kernel as he_kernel
from repro_torch.kernels.hash_encode import ops as he_ops
from repro_torch.kernels.hash_encode import ref as he_ref
from repro_torch.kernels.volume_render import kernel as vr_kernel
from repro_torch.kernels.volume_render import ops as vr_ops
from repro_torch.kernels.volume_render import ref as vr_ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90: H100)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _u(gen, shape, lo, hi, device):
    return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("branch", ["density", "color"])
@pytest.mark.parametrize("n", [49152, 1000])
def test_hash_encode_kernel_matches_plain(branch, n, card):
    enc = Field(FieldConfig()).density_enc if branch == "density" \
        else Field(FieldConfig()).color_enc
    gen = torch.Generator().manual_seed(n)
    cfg = enc.cfg
    pts = _u(gen, (n, 3), 0.0, 1.0 - 1e-6, card)
    pts[::97, 0] = -1.0                                   # sentinel rows
    tables = _u(gen, (cfg.n_levels, cfg.table_size, cfg.n_features), -1, 1, card)
    before = kernels.LAUNCHES["hash_encode"]
    got = he_ops.hash_encode(pts, tables, enc.resolutions, enc.dense_flags)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hash_encode"] == before + 1
    want = he_ref.hash_encode(pts, tables, enc.resolutions, enc.dense_flags)
    assert float((got - want).abs().max()) <= 1e-5
    assert not got[::97].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(32, 64, 16), (8, 16, 16), (48, 64, 64, 3),
                                  (24, 16, 16, 3), (31, 64, 64, 3)])
def test_mlp_kernels_match_plain(dims, card):
    gen = torch.Generator().manual_seed(len(dims))
    n = 4099
    x = _u(gen, (n, dims[0]), -1, 1, card)
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        b = (6.0 / d_in) ** 0.5
        params += [_u(gen, (d_in, d_out), -b, b, card), _u(gen, (d_out,), -0.1, 0.1, card)]
    name = "fused_mlp2" if len(dims) == 3 else "fused_mlp3"
    op = mlp_ops.mlp2 if len(dims) == 3 else mlp_ops.mlp3
    plain = mlp_ref.mlp2 if len(dims) == 3 else mlp_ref.mlp3
    before = kernels.LAUNCHES[name]
    got = op(x, *params)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert float((got - plain(x, *params)).abs().max()) <= 1e-5


COMPOSITE_SHAPES = [(1024, 48), (4096, 48), (4096, 12), (77, 5), (33, 1), (5, 200)]


@pytest.mark.gpu
@pytest.mark.parametrize("r,s", COMPOSITE_SHAPES)
def test_composite_kernel_matches_plain(r, s, card):
    """Every group width (S = 1 to S > 32, S not a multiple of the group);
    the same bytes on two launches."""
    gen = torch.Generator().manual_seed(r + s)
    sigma, rgb, deltas, ts = smoke.composite_inputs(gen, r, s, card)
    before = kernels.LAUNCHES["composite"]
    got = vr_ops.composite(sigma, rgb, deltas, ts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["composite"] == before + 1 and got.weights is None
    want = vr_ref.composite(sigma, rgb, deltas, ts)
    for g, w in zip(got[:3], want[:3]):
        assert float((g - w).abs().max()) <= 5e-5
    again = vr_kernel.composite(sigma, rgb, deltas, ts)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got[:3], again))


NEEDS = [tuple(bool(k >> i & 1) for i in range(4)) for k in range(1, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("needs", NEEDS, ids=lambda n: "".join("x" if b else "-" for b in n))
@pytest.mark.parametrize("r,s", COMPOSITE_SHAPES)
def test_composite_bwd_matches_plain(r, s, needs, card):
    """The backward through the op, for every subset of the inputs asking a
    gradient: one composite_bwd launch, within 1e-4 relative of the plain
    closed form (`ref.composite_backward`) on the card and of the autograd
    of the plain composite in f64 (the f32 autograd forms dL/dtau as a
    difference of terms that can be far larger than it, so where every
    gradient is small it is far off its own f64 value), the same bytes on
    two launches."""
    gen = torch.Generator().manual_seed(7 * r + s)
    inputs = smoke.composite_inputs(gen, r, s, card)
    grads = (_u(gen, (r, 3), -1, 1, card), _u(gen, (r,), -1, 1, card),
             _u(gen, (r,), -1, 1, card))
    leaves = [t.clone().requires_grad_(need) for t, need in zip(inputs, needs)]
    before = kernels.LAUNCHES["composite_bwd"]
    out = vr_ops.composite(*leaves)
    sum((o * g).sum() for o, g in zip(out[:3], grads)).backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["composite_bwd"] == before + 1
    closed = vr_ref.composite_backward(*inputs, *grads)
    exact_leaves = [t.double().requires_grad_(True) for t in inputs]
    exact = torch.autograd.grad(vr_ref.composite(*exact_leaves)[:3], exact_leaves,
                                tuple(g.double() for g in grads))
    again = vr_kernel.composite_backward(*inputs, *grads, needs=needs)
    for k, (leaf, need) in enumerate(zip(leaves, needs)):
        if not need:
            assert leaf.grad is None and again[k] is None, k
            continue
        assert _rel(leaf.grad, closed[k]) <= 1e-4, k
        assert _rel(leaf.grad.double(), exact[k]) <= 1e-4, k
        assert torch.equal(_bits(leaf.grad), _bits(again[k])), k


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_what_they_do_not_take(card):
    pts = torch.rand((64, 3), device=card)
    tables = torch.rand((2, 256, 2), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        he_kernel.hash_encode(pts.t().contiguous().t(), tables, [4, 8], [1, 1])
    with pytest.raises(ValueError, match="float32"):
        he_kernel.hash_encode(pts.double(), tables, [4, 8], [1, 1])
    with pytest.raises(ValueError, match="power of two"):
        he_kernel.hash_encode(pts, torch.rand((2, 100, 2), device=card), [4, 8], [1, 1])
    with pytest.raises(ValueError, match="limits"):
        mlp_kernel.fused_mlp2(torch.rand((8, 65), device=card),
                              torch.rand((65, 8), device=card), torch.rand(8, device=card),
                              torch.rand((8, 2), device=card), torch.rand(2, device=card))
    with pytest.raises(ValueError, match="agree"):
        vr_kernel.composite(*(torch.rand(sh, device=card)
                              for sh in [(4, 3), (4, 3, 3), (4, 2), (4, 3)]))
    # a launch the C side refuses (F=3 has no kernel) is reported as an error
    out = torch.empty((64, 6), device=card)
    tables3 = torch.rand((2, 256, 3), device=card)
    levels = (ctypes.c_int * 2)(4, 8)
    status = he_kernel._entry()(kernels.ptr(pts), kernels.ptr(tables3), levels, levels,
                                kernels.ptr(out), 64, 2, 256, 3,
                                kernels.stream_handle(card))
    assert status != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.check_status("hash_encode", status, "hash_encode")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _rows(t):
    return t.reshape(-1, t.shape[-1]).ne(0).any(dim=-1)


@pytest.mark.gpu
@pytest.mark.parametrize("m,t", [(6_291_456, 1 << 22), (1000, 64), (1, 8)])
def test_bum_scatter_kernel_is_the_plain_merge_bit_for_bit(m, t, card):
    gen = torch.Generator().manual_seed(m)
    idx = torch.sort(torch.randint(0, t + 1, (m,), generator=gen)).values  # t = spill row
    vals = torch.rand((m, 2), generator=gen) * 2 - 1
    table = torch.rand((t, 2), generator=gen)
    before = kernels.LAUNCHES["bum_scatter"]
    got = gu_kernel.bum_scatter(table.to(card), idx.to(card), vals.to(card))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bum_scatter"] == before + 1
    assert torch.equal(got.cpu(), gu_ref.segment_commit(table, idx, vals))


def _adversarial_stream(kind, tile, rows, gen):
    """Sorted address streams that stress the kernel's tile walk (`tile`
    entries a block); `rows` is the spill row."""
    if kind == "one address across tiles":
        return torch.full((5 * tile + 3,), 9, dtype=torch.int64)
    if kind == "runs end at tile ends":
        lengths = torch.tensor([tile, tile, 1, tile - 1, 2 * tile, 3, 5, tile - 8])
        return torch.repeat_interleave(torch.arange(lengths.numel()) * 3, lengths)
    if kind == "every entry a run start":
        return torch.arange(rows)
    if kind == "spill only":
        return torch.full((3 * tile,), rows, dtype=torch.int64)
    if kind == "m = 1":
        return torch.tensor([rows - 1])
    # m not a multiple of the tile, spill entries at the end
    return torch.sort(torch.randint(0, rows + 1, (4 * tile + 7,), generator=gen)).values


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["one address across tiles", "runs end at tile ends",
                                  "every entry a run start", "spill only", "m = 1", "ragged"])
def test_bum_scatter_kernel_is_the_plain_merge_on_adversarial_streams(kind, f, card):
    """The tile walk's edge cases at its own tile (2048 entries): a run that
    crosses many tiles, runs that end exactly at a tile's end, a run start
    at every entry, spill entries only, one entry, a ragged last tile; values
    spanning six decades, so that any other summation order would show."""
    gen = torch.Generator().manual_seed(len(kind) + f)
    rows = 4096
    idx = _adversarial_stream(kind, 2048, rows, gen)
    vals = (torch.randn((idx.shape[0], f), generator=gen)
            * 10.0 ** (torch.rand((idx.shape[0], 1), generator=gen) * 6 - 3))
    table = torch.randn((rows, f), generator=gen)
    before = kernels.LAUNCHES["bum_scatter"]
    got = gu_kernel.bum_scatter(table.to(card), idx.to(card), vals.to(card))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bum_scatter"] == before + 1
    assert torch.equal(_bits(got.cpu()), _bits(gu_ref.segment_commit(table, idx, vals)))


@pytest.mark.gpu
def test_bum_scatter_kernel_is_the_plain_merge_on_the_training_streams(card):
    """The three table-gradient streams the training paths commit
    (`smoke.table_gradient_streams`: #6's two grids at budget 8192, a dense
    step's two grids, #8's backward), each sorted by `bum_sort`: the plain
    merge's bits, one launch each."""
    cfg = FieldConfig()
    rows = {"density": cfg.n_levels << cfg.log2_table_density,
            "color": cfg.n_levels << cfg.log2_table_color,
            "NGP": cfg.n_levels << cfg.log2_table_density}
    for name, addr, vals, bits in smoke.table_gradient_streams(card):
        idx_s, vals_s = gu_kernel.bum_sort(addr, vals, bits)
        table = torch.zeros((rows[next(k for k in rows if k in name)], vals.shape[1]))
        before = kernels.LAUNCHES["bum_scatter"]
        got = gu_kernel.bum_scatter(table.to(card), idx_s, vals_s)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["bum_scatter"] == before + 1, name
        want = gu_ref.segment_commit(table, idx_s.cpu(), vals_s.cpu())
        assert torch.equal(_bits(got.cpu()), _bits(want)), name


def _step_inputs(gen, n, card, field):
    pts = _u(gen, (n, 3), 0.0, 1.0 - 1e-6, card)
    sh = _u(gen, (n, 16), -0.5, 0.5, card)
    params = field.init(gen, card)
    tables = [_u(gen, tuple(params[k].shape), -1, 1, card)
              for k in ("density_grid", "color_grid")]
    geometry = (field.density_enc.resolutions, field.density_enc.dense_flags,
                field.color_enc.dense_flags)
    return pts, sh, tables, params["density_mlp"], params["color_mlp"], geometry


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8192, 77])
def test_fused_step_kernels_match_plain(n, card):
    field = Field(FieldConfig())
    gen = torch.Generator().manual_seed(n)
    pts, sh, tables, mlp_d, mlp_c, geometry = _step_inputs(gen, n, card, field)
    got = fs_kernel.fused_step_fwd(pts, sh, *tables, mlp_d, mlp_c, *geometry)
    want = fs_ref.fused_step_ref(pts, sh, *tables, mlp_d, mlp_c, *geometry)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5
    g_d, g_c = _u(gen, got[0].shape, -1, 1, card), _u(gen, got[1].shape, -1, 1, card)
    for need_color in (True, False):
        before = kernels.LAUNCHES["fused_step_bwd"]
        d_td, d_tc, d_md, d_mc, d_sh = fs_kernel.fused_step_bwd(
            pts, sh, g_d, g_c, *tables, mlp_d, mlp_c, *geometry, need_color=need_color)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fused_step_bwd"] == before + 1
        cpu = lambda x: {k: v.cpu() for k, v in x.items()} if isinstance(x, dict) else x.cpu()  # noqa: E731
        w_td, w_tc, w_md, w_mc, w_sh = fs_ops._plain_backward(
            geometry, *(cpu(x) for x in (pts, sh, *tables, mlp_d, mlp_c, g_d, g_c)),
            (True, need_color))
        assert _rel(d_td.cpu(), w_td) <= 1e-5 and torch.equal(_rows(d_td.cpu()), _rows(w_td))
        if need_color:
            assert _rel(d_tc.cpu(), w_tc) <= 1e-5 and torch.equal(_rows(d_tc.cpu()), _rows(w_tc))
        else:
            assert d_tc is None and w_tc is None
        for k in d_md:
            assert _rel(d_md[k].cpu(), w_md[k]) <= 1e-4
        for k in d_mc:
            assert _rel(d_mc[k].cpu(), w_mc[k]) <= 1e-4
        assert _rel(d_sh.cpu(), w_sh) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("f", list(fs_kernel.FEATURE_COUNTS))
@pytest.mark.parametrize("n,n_sentinel", [(8192, 0), (32768, 0), (77, 0), (30000, 4)])
def test_fused_step_fwd_kernel_matches_plain_at_every_feature_count(n, n_sentinel, f, card):
    """Kernel #5 (tiles of 32 points, both heads on the tensor cores) on
    Morton-ordered points at the training budgets, a size below one tile
    and a padded size whose last rows are sentinels: within 1e-5 of the
    plain step (a sentinel row's outputs are the heads of all-zero
    features), the same bytes on two launches, one launch each."""
    field = Field(FieldConfig(n_features=f))
    gen = torch.Generator().manual_seed(n + f)
    pts, sh, tables, mlp_d, mlp_c, geometry = _morton_step_inputs(gen, n, card, field)
    valid = n - n_sentinel
    pts[valid:] = -1.0
    args = (pts, sh, *tables, mlp_d, mlp_c, *geometry)
    before = kernels.LAUNCHES["fused_step_fwd"]
    got = fs_kernel.fused_step_fwd(*args)
    again = fs_kernel.fused_step_fwd(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_step_fwd"] == before + 2
    want = fs_ref.fused_step_ref(pts[:valid], sh[:valid], *tables, mlp_d, mlp_c, *geometry)
    zeros = torch.zeros((n_sentinel, tables[0].shape[0] * f), device=card)
    tail = fs_ref.mlp_heads(zeros, zeros, sh[valid:], mlp_d, mlp_c)
    for g, a, w, t in zip(got, again, want, tail):
        assert torch.equal(_bits(g), _bits(a))
        assert float((g - torch.cat([w, t])).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_dense_route_ops_backward_on_the_card(card):
    """hash_encode (merged backward through bum_scatter), the MLPs and the
    composite differentiate on CUDA tensors as their plain versions do on
    the CPU."""
    enc = Field(FieldConfig()).density_enc
    gen = torch.Generator().manual_seed(3)
    pts = torch.rand((4096, 3), generator=gen) * 0.999
    tables = torch.rand((16, enc.cfg.table_size, 2), generator=gen) * 2 - 1
    g = torch.rand((4096, 32), generator=gen)
    grads = []
    for dev in (card, "cpu"):
        t = tables.to(dev).requires_grad_(True)
        (he_ops.hash_encode(pts.to(dev), t, enc.resolutions, enc.dense_flags)
         * g.to(dev)).sum().backward()
        grads.append(t.grad.cpu())
    assert _rel(grads[0], grads[1]) <= 1e-5 and torch.equal(_rows(grads[0]), _rows(grads[1]))
    x = torch.rand((1000, 48), generator=gen)
    ws = [torch.rand(sh, generator=gen) * 0.2 - 0.1
          for sh in [(48, 64), (64,), (64, 64), (64,), (64, 3), (3,)]]
    out = {}
    for dev in (card, "cpu"):
        leaves = [v.to(dev).requires_grad_(True) for v in (x, *ws)]
        mlp_ops.mlp3(*leaves).square().sum().backward()
        out[str(dev)] = [v.grad.cpu() for v in leaves]
    for a, b in zip(out[str(card)], out["cpu"]):
        assert _rel(a, b) <= 1e-4
    sigma = torch.rand((64, 48), generator=gen) * 10
    rgb = torch.rand((64, 48, 3), generator=gen)
    ts = torch.sort(torch.rand((64, 48), generator=gen) * 4 + 2, dim=-1).values
    deltas = torch.diff(ts, dim=-1, append=ts[:, -1:] + 4.0 / 48)
    res = {}
    for dev in (card, "cpu"):
        s = sigma.to(dev).requires_grad_(True)
        o = vr_ops.composite(s, rgb.to(dev), deltas.to(dev), ts.to(dev))
        (o.color.sum() + o.opacity.sum()).backward()
        res[str(dev)] = s.grad.cpu()
    assert _rel(res[str(card)], res["cpu"]) <= 1e-4


def _morton(pts):
    return pts[torch.sort(fp_ref.morton_key(pts), stable=True).indices].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("branch", ["density", "color"])
@pytest.mark.parametrize("n", [32768, 1000])
def test_fused_encode_kernel_matches_plain(branch, n, card):
    """Kernel #8 against the plain fused encode, with sentinel rows at the
    end; its distinct reads per (block, level) against the plain count."""
    field = Field(FieldConfig())
    enc = field.density_enc if branch == "density" else field.color_enc
    gen = torch.Generator().manual_seed(n + 1)
    cfg = enc.cfg
    pts = _morton(_u(gen, (n, 3), 0.0, 1.0 - 1e-6, card))
    pts[n - 3:] = -1.0                                    # sentinel rows
    tables = _u(gen, (cfg.n_levels, cfg.table_size, cfg.n_features), -1, 1, card)
    before = kernels.LAUNCHES["fused_encode"]
    got, reads = fp_kernel.fused_encode(pts, tables, enc.resolutions, enc.dense_flags)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_encode"] == before + 1
    want = fp_ref.fused_encode(pts, tables, enc.resolutions, enc.dense_flags)
    assert float((got - want).abs().max()) <= 1e-5
    assert not got[n - 3:].any()
    corners, _ = fp_ref.corner_geometry(pts[:n - 3], enc.resolutions)
    plain = fp_ref.block_distinct_reads(
        fp_ref.level_indices(corners, enc.resolutions, cfg.table_size, enc.dense_flags))
    assert reads.shape == (-(-n // 256), cfg.n_levels)
    assert torch.equal(reads.to(torch.int64), plain)
    assert int(reads.sum()) < 8 * cfg.n_levels * (n - 3)      # the dedup happened


@pytest.mark.gpu
@pytest.mark.parametrize("decomposed", [True, False])
def test_fused_encode_gradients_are_hash_encode_bit_for_bit(decomposed, card):
    field = Field(FieldConfig(decomposed=decomposed))
    encs = [field.density_enc] + ([field.color_enc] if decomposed else [])
    gen = torch.Generator().manual_seed(5)
    n = 8192
    pts = _morton(_u(gen, (n, 3), 0.0, 1.0 - 1e-6, card))
    tables = [_u(gen, (16, e.cfg.table_size, 2), -1, 1, card).requires_grad_(True)
              for e in encs]
    g = [_u(gen, (n, 32), -1, 1, card) for _ in encs]
    before = kernels.LAUNCHES["fused_encode"]
    outs = field._fused_encode(pts, *tables)
    assert kernels.LAUNCHES["fused_encode"] == before + len(encs)
    got = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, g)), tables)
    he = [he_ops.hash_encode(pts, t, e.resolutions, e.dense_flags)
          for t, e in zip(tables, encs)]
    want = torch.autograd.grad(sum((o * w).sum() for o, w in zip(he, g)), tables)
    for o, h in zip(outs, he):
        assert float((o - h).detach().abs().max()) <= 1e-5
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _morton_step_inputs(gen, n, card, field):
    pts, sh, tables, mlp_d, mlp_c, geometry = _step_inputs(gen, n, card, field)
    return (_morton(pts), sh, tables, mlp_d, mlp_c, geometry)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("need_density,need_color",
                         [(True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("n", [1, 77, 8192, 32768])
def test_fused_step_bwd_matches_plain_backward(n, need_density, need_color, card):
    """The tensor-core backward against the plain backward's function on CPU
    copies, on Morton-ordered points, for every combination of frozen grids:
    tables within 1e-5 relative with the same nonzero rows, MLP gradients and
    d_sh within 1e-4 relative.  The yardstick is that function in float64
    (`ref.backward_f64`): at N=32,768 one color pre-activation of these
    inputs is 1.9e-8, and the f32 plain version's rounding puts it on the
    wrong side of the ReLU, 1.4e-2 off the exact gradient, where the kernel
    is within 5e-7 of it."""
    field = Field(FieldConfig())
    gen = torch.Generator().manual_seed(n + 11)
    pts, sh, tables, mlp_d, mlp_c, geometry = _morton_step_inputs(gen, n, card, field)
    g_d = _u(gen, (n, mlp_d["w2"].shape[1]), -1, 1, card)
    g_c = _u(gen, (n, mlp_c["w3"].shape[1]), -1, 1, card)
    before = kernels.LAUNCHES["fused_step_bwd"]
    got = fs_kernel.fused_step_bwd(pts, sh, g_d, g_c, *tables, mlp_d, mlp_c, *geometry,
                                   need_density=need_density, need_color=need_color)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_step_bwd"] == before + 1
    cpu = lambda x: {k: v.cpu() for k, v in x.items()} if isinstance(x, dict) else x.cpu()  # noqa: E731
    want = fs_ref.backward_f64(geometry, *(cpu(x) for x in (pts, sh, *tables, mlp_d, mlp_c,
                                                             g_d, g_c)),
                               (need_density, need_color))
    for k, need in enumerate((need_density, need_color)):
        if need:
            assert _rel(got[k].cpu().double(), want[k]) <= 1e-5
            assert torch.equal(_rows(got[k].cpu()), _rows(want[k]))
        else:
            assert got[k] is None and want[k] is None
    for k in (2, 3):
        for name in got[k]:
            assert _rel(got[k][name].cpu().double(), want[k][name]) <= 1e-4, name
    assert _rel(got[4].cpu().double(), want[4]) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("need_density,need_color", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("n", [77, 8192])
def test_fused_step_bwd_stream_is_the_plain_order(n, need_density, need_color, card):
    """The kernel's own table-gradient streams, entry by entry, in the layout
    of `ref.bwd_table_stream` (level, point, corner; padded to whole blocks
    with spill entries of value 0), on Morton-ordered points with sentinel
    rows at the end: the layout whose stable sort sums each table row in the
    plain backward's order.  A frozen grid gets no stream."""
    field = Field(FieldConfig())
    gen = torch.Generator().manual_seed(n + 31)
    pts, sh, tables, mlp_d, mlp_c, geometry = _morton_step_inputs(gen, n, card, field)
    pts[n - 3:] = -1.0                                  # sentinel rows
    g_d = _u(gen, (n, mlp_d["w2"].shape[1]), -1, 1, card)
    g_c = _u(gen, (n, mlp_c["w3"].shape[1]), -1, 1, card)
    streams, _, _ = fs_kernel.fused_step_bwd_launch(
        pts, sh, g_d, g_c, *tables, mlp_d, mlp_c, *geometry,
        need_density=need_density, need_color=need_color)
    torch.cuda.synchronize()
    n_pad = -(-n // fs_kernel.BWD_POINTS) * fs_kernel.BWD_POINTS
    res = geometry[0]
    for name, need, table, dense in zip(("density", "color"), (need_density, need_color),
                                        tables, geometry[1:]):
        if not need:
            assert streams[name] is None
            continue
        levels, size, f = table.shape
        addr, vals = streams[name]
        want, _ = fs_ref.bwd_table_stream(pts.cpu(), torch.zeros((n, levels * f)), res, size,
                                          dense, n_pad=n_pad)
        assert torch.equal(addr.cpu(), want)
        spill = want == levels * size
        assert int(spill.sum()) == levels * (n_pad - n) * 8
        assert not vals.cpu()[spill].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(48, 64, 64, 3), (31, 64, 64, 3)])
@pytest.mark.parametrize("n", [1, 77, 49152, 196608])
def test_fused_mlp3_matches_plain_at_serving_sizes(n, dims, card):
    gen = torch.Generator().manual_seed(n + dims[0])
    x = _u(gen, (n, dims[0]), -1, 1, card)
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        b = (6.0 / d_in) ** 0.5
        params += [_u(gen, (d_in, d_out), -b, b, card), _u(gen, (d_out,), -0.1, 0.1, card)]
    before = kernels.LAUNCHES["fused_mlp3"]
    got = mlp_kernel.fused_mlp3(x, *params)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_mlp3"] == before + 1
    assert got.shape == (n, 3)
    assert float((got - mlp_ref.mlp3(x, *params)).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("samples", [48, 12])
@pytest.mark.parametrize("branch", ["density", "color"])
def test_hash_encode_kernel_matches_plain_on_ray_ordered_points(branch, samples, card):
    """Kernel #1 on a served chunk's ray-ordered points (4096 rays x 48
    samples, the dense route, and x 12, the redistributed one), with
    sentinel rows: within 1e-5 of the plain version, sentinel rows exactly
    0."""
    enc = getattr(Field(FieldConfig()), f"{branch}_enc")
    cfg = enc.cfg
    pts = smoke.serving_points(card, samples_per_ray=None if samples == 48 else samples)
    assert pts.shape == (4096 * samples, 3)
    pts[::997, 0] = -1.0                                  # sentinel rows
    gen = torch.Generator().manual_seed(samples)
    tables = _u(gen, (cfg.n_levels, cfg.table_size, cfg.n_features), -1, 1, card)
    before = kernels.LAUNCHES["hash_encode"]
    got = he_ops.hash_encode(pts, tables, enc.resolutions, enc.dense_flags)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hash_encode"] == before + 1
    want = he_ref.hash_encode(pts, tables, enc.resolutions, enc.dense_flags)
    assert float((got - want).abs().max()) <= 1e-5
    assert not got[::997].any()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [49152, 196608])
def test_fused_mlp2_matches_plain_at_path_sizes(n, card):
    """Kernel #2 at the density head's widths (32 -> 64 -> 16) at a dense
    step's and a dense serving chunk's points."""
    gen = torch.Generator().manual_seed(n + 2)
    x = _u(gen, (n, 32), -1, 1, card)
    params = []
    for d_in, d_out in ((32, 64), (64, 16)):
        b = (6.0 / d_in) ** 0.5
        params += [_u(gen, (d_in, d_out), -b, b, card), _u(gen, (d_out,), -0.1, 0.1, card)]
    before = kernels.LAUNCHES["fused_mlp2"]
    got = mlp_kernel.fused_mlp2(x, *params)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_mlp2"] == before + 1
    assert got.shape == (n, 16)
    assert float((got - mlp_ref.mlp2(x, *params)).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("chain", [
    [(20, 24, 40, 5), (64, 64, 64, 16)],                  # mlp3, 16-byte input rows
    [(21, 24, 40, 5), (63, 64, 64, 16)],                  # mlp3, 4-byte input rows
    [(12, 20, 6), (64, 64, 16)],                          # mlp2
])
def test_fused_mlps_match_plain_across_alternating_widths(chain, card):
    """The MLP kernels' launches remember the shared memory each width was
    allowed and its block count: narrow, wide, narrow, wide launches of one
    kernel (widths no other test uses, so each is that kernel's first launch
    at them) each run and match the plain version."""
    gen = torch.Generator().manual_seed(len(chain[0]) + chain[0][0])
    for dims in chain + chain:
        x = _u(gen, (3000, dims[0]), -1, 1, card)
        params = []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            b = (6.0 / d_in) ** 0.5
            params += [_u(gen, (d_in, d_out), -b, b, card), _u(gen, (d_out,), -0.1, 0.1, card)]
        if len(dims) == 3:
            got, want = mlp_kernel.fused_mlp2(x, *params), mlp_ref.mlp2(x, *params)
        else:
            got, want = mlp_kernel.fused_mlp3(x, *params), mlp_ref.mlp3(x, *params)
        assert float((got - want).abs().max()) <= 1e-5, dims


@pytest.mark.gpu
def test_redesigned_kernels_give_the_same_bytes_twice(card):
    """Two launches on the same inputs: byte-identical outputs, all five of
    the fused backward's, mlp3's, mlp2's and the hash encode's (on a served
    chunk's ray-ordered points)."""
    field = Field(FieldConfig())
    gen = torch.Generator().manual_seed(21)
    n = 8192
    pts, sh, tables, mlp_d, mlp_c, geometry = _morton_step_inputs(gen, n, card, field)
    g_d = _u(gen, (n, mlp_d["w2"].shape[1]), -1, 1, card)
    g_c = _u(gen, (n, mlp_c["w3"].shape[1]), -1, 1, card)
    runs = [fs_kernel.fused_step_bwd(pts, sh, g_d, g_c, *tables, mlp_d, mlp_c, *geometry)
            for _ in range(2)]
    for a, b in zip(*runs):
        pairs = zip(a.values(), b.values()) if isinstance(a, dict) else [(a, b)]
        for x, y in pairs:
            assert torch.equal(_bits(x), _bits(y))
    x = _u(gen, (49152, 48), -1, 1, card)
    params = [_u(gen, sh_, -0.3, 0.3, card)
              for sh_ in [(48, 64), (64,), (64, 64), (64,), (64, 3), (3,)]]
    assert torch.equal(_bits(mlp_kernel.fused_mlp3(x, *params)),
                       _bits(mlp_kernel.fused_mlp3(x, *params)))
    params = [_u(gen, sh_, -0.3, 0.3, card) for sh_ in [(32, 64), (64,), (64, 16), (16,)]]
    assert torch.equal(_bits(mlp_kernel.fused_mlp2(x[:, :32].contiguous(), *params)),
                       _bits(mlp_kernel.fused_mlp2(x[:, :32].contiguous(), *params)))
    ray = smoke.serving_points(card)
    enc = field.density_enc
    grid = _u(gen, (enc.cfg.n_levels, enc.cfg.table_size, enc.cfg.n_features), -1, 1, card)
    assert torch.equal(_bits(he_kernel.hash_encode(ray, grid, enc.resolutions, enc.dense_flags)),
                       _bits(he_kernel.hash_encode(ray, grid, enc.resolutions, enc.dense_flags)))


def _stable(addr, vals):
    order = torch.sort(addr, stable=True).indices
    return addr[order], vals[order]


@pytest.mark.gpu
def test_bum_sort_is_torch_sorts_stable_permutation_on_the_training_streams(card):
    """The three streams the training paths sort, at their main-path sizes
    (`smoke.table_gradient_streams`): exactly torch.sort's stable order,
    one launch each."""
    for name, addr, vals, bits in smoke.table_gradient_streams(card):
        before = kernels.LAUNCHES["bum_sort"]
        got = gu_kernel.bum_sort(addr, vals, bits)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["bum_sort"] == before + 1, name
        want = _stable(addr, vals)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name


@pytest.mark.gpu
@pytest.mark.parametrize("keys", ["equal", "descending", "random", "few"])
@pytest.mark.parametrize("m,bits,f", [(1 << 20, 23, 2), (4097, 17, 1), (70001, 21, 4),
                                      (2049, 9, 8), (1, 8, 2), (5000, 0, 2)])
def test_bum_sort_is_torch_sorts_stable_permutation_on_adversarial_keys(m, bits, f, keys,
                                                                        card):
    """All keys equal, all distinct and descending (as far as the width
    allows), uniform, and a few values in long runs; stream lengths that are
    not a multiple of any tile, every value width."""
    gen = torch.Generator().manual_seed(m + bits)
    hi = 1 << bits
    addr = {"equal": torch.full((m,), hi - 1, dtype=torch.int64),
            "descending": torch.arange(m - 1, -1, -1) % hi,
            "random": torch.randint(0, hi, (m,), generator=gen),
            "few": torch.randint(0, 3, (m,), generator=gen) * ((hi - 1) // 2)}[keys]
    vals = torch.rand((m, f), generator=gen)
    got = gu_kernel.bum_sort(addr.to(card), vals.to(card), bits)
    want = _stable(addr, vals)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
def test_bum_sort_clears_its_look_back_state_between_sorts(card):
    """Sorts of different lengths, key widths and value widths, enqueued back
    to back on one stream with no synchronisation between them, then each
    held to torch.sort's stable permutation: each sort starts from cleared
    histograms, tile counters and status words."""
    gen = torch.Generator().manual_seed(11)
    cases = [(1 << 20, 23, 2), (4097, 9, 1), (3 * 4096, 17, 8), (1 << 20, 21, 2),
             (70001, 12, 4), (1, 8, 2), (1 << 18, 23, 2), (4095, 23, 1)]
    inputs, results = [], []
    for m, bits, f in cases:
        addr = torch.randint(0, 1 << bits, (m,), generator=gen).to(card)
        vals = torch.rand((m, f), generator=gen).to(card)
        inputs.append((addr, vals))
    for (addr, vals), (_, bits, _) in zip(inputs, cases):
        results.append(gu_kernel.bum_sort(addr, vals, bits))
    torch.cuda.synchronize()
    for (addr, vals), got, case in zip(inputs, results, cases):
        want = _stable(addr, vals)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), case


@pytest.mark.gpu
def test_bum_sort_is_exact_on_a_long_stream(card):
    """2^24 + 3 entries (4097 tiles, the last holding 3), 23-bit keys."""
    gen = torch.Generator().manual_seed(24)
    m = (1 << 24) + 3
    addr = torch.randint(0, 1 << 23, (m,), generator=gen).to(card)
    vals = torch.rand((m, 2), generator=gen).to(card)
    got = gu_kernel.bum_sort(addr, vals, 23)
    want = _stable(addr, vals)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_bum_sort_refuses_what_it_does_not_take(card):
    addr = torch.zeros(16, dtype=torch.int64, device=card)
    vals = torch.zeros((16, 2), device=card)
    with pytest.raises(ValueError, match="key_bits"):
        gu_kernel.bum_sort(addr, vals, 33)
    with pytest.raises(ValueError, match="int64"):
        gu_kernel.bum_sort(addr.to(torch.int32), vals, 8)
    with pytest.raises(ValueError, match="contiguous"):
        gu_kernel.bum_sort(torch.zeros((16, 2), dtype=torch.int64, device=card)[:, 0], vals, 8)
    with pytest.raises(ValueError, match="contiguous"):
        gu_kernel.bum_sort(addr, torch.zeros((2, 16), device=card).t(), 8)
    with pytest.raises(ValueError, match="F in"):
        gu_kernel.bum_sort(addr, torch.zeros((16, 3), device=card), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8192, 32768])
def test_fused_step_table_gradients_are_the_torch_sort_route_byte_for_byte(n, card):
    """#6's commit through bum_sort (two launches, one per grid) against the
    route before it, torch.sort's stable order and two gathers, then the
    same bum_scatter: the same bytes."""
    field = Field(FieldConfig())
    gen = torch.Generator().manual_seed(n + 41)
    pts, sh, tables, mlp_d, mlp_c, geometry = _morton_step_inputs(gen, n, card, field)
    g_d = _u(gen, (n, mlp_d["w2"].shape[1]), -1, 1, card)
    g_c = _u(gen, (n, mlp_c["w3"].shape[1]), -1, 1, card)
    args = (pts, sh, g_d, g_c, *tables, mlp_d, mlp_c, *geometry)
    before = kernels.LAUNCHES["bum_sort"]
    got = fs_kernel.fused_step_bwd(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bum_sort"] == before + 2
    streams, _, _ = fs_kernel.fused_step_bwd_launch(*args)
    levels, _, f = tables[0].shape
    for k, (name, table) in enumerate(zip(("density", "color"), tables)):
        addr, vals = _stable(*streams[name])
        want = torch.zeros((levels * table.shape[1], f), device=card)
        gu_kernel.bum_scatter(want, addr, vals.contiguous())
        assert torch.equal(_bits(got[k]), _bits(want.reshape(table.shape))), name


@pytest.mark.gpu
@pytest.mark.parametrize("branch", ["density", "color"])
def test_dense_hash_encode_backward_is_the_torch_sort_route_byte_for_byte(branch, card):
    """The dense step's table gradient (hash_encode's backward: bum_sort,
    then bum_scatter) against torch.sort's stable order and two gathers,
    then bum_scatter: the same bytes, at a dense step's 49,152 points."""
    enc = getattr(Field(FieldConfig()), f"{branch}_enc")
    cfg = enc.cfg
    gen = torch.Generator().manual_seed(17)
    n = 49152
    pts = _u(gen, (n, 3), 0.0, 1.0 - 1e-6, card)
    tables = _u(gen, (cfg.n_levels, cfg.table_size, cfg.n_features), -1, 1,
                card).requires_grad_(True)
    g = _u(gen, (n, cfg.out_dim), -1, 1, card)
    before = kernels.LAUNCHES["bum_sort"]
    (got,) = torch.autograd.grad((he_ops.hash_encode(pts, tables, enc.resolutions,
                                                     enc.dense_flags) * g).sum(), tables)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bum_sort"] == before + 1
    idx, vals = he_ops.corner_updates(pts, enc.resolutions, enc.dense_flags, cfg.table_size,
                                      g.reshape(n, cfg.n_levels, cfg.n_features))
    idx, vals = _stable(idx, vals)
    want = torch.zeros((cfg.n_levels * cfg.table_size, cfg.n_features), device=card)
    gu_kernel.bum_scatter(want, idx, vals.contiguous())
    assert torch.equal(_bits(got), _bits(want.reshape(tables.shape)))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [30000, 257])
def test_fused_encode_kernel_matches_plain_at_every_feature_count(n, f, card):
    """Kernel #8 (the hash-set dedup) at every F it takes, N not a multiple
    of its 256-point block, sentinel rows at the end: within 1e-5 of the
    plain version, sentinel rows exactly 0, distinct reads per (block,
    level) the plain count, one launch."""
    enc = Field(FieldConfig()).density_enc
    cfg = enc.cfg
    gen = torch.Generator().manual_seed(n + f)
    pts = _morton(_u(gen, (n, 3), 0.0, 1.0 - 1e-6, card))
    pts[n - 5:] = -1.0
    tables = _u(gen, (cfg.n_levels, cfg.table_size, f), -1, 1, card)
    before = kernels.LAUNCHES["fused_encode"]
    got, reads = fp_kernel.fused_encode(pts, tables, enc.resolutions, enc.dense_flags)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_encode"] == before + 1
    want = fp_ref.fused_encode(pts, tables, enc.resolutions, enc.dense_flags)
    assert float((got - want).abs().max()) <= 1e-5
    assert not got[n - 5:].any()
    corners, _ = fp_ref.corner_geometry(pts[:n - 5], enc.resolutions)
    plain = fp_ref.block_distinct_reads(
        fp_ref.level_indices(corners, enc.resolutions, cfg.table_size, enc.dense_flags))
    nb = plain.shape[0]                   # blocks holding valid rows
    assert reads.shape == (-(-n // 256), cfg.n_levels)
    assert torch.equal(reads[:nb].to(torch.int64), plain) and not reads[nb:].any()


# stage 2b v3's shapes: (rays, budget) -> the lane grid's s_cap; the training
# grids at the ceiling of 4096 and at 8192, the served chunk at 4096 x 12
V3_LANES = {(1024, 4096): 16, (1024, 8192): 32, (4096, 49152): 48}


@pytest.mark.gpu
@pytest.mark.parametrize("rays,budget", list(V3_LANES))
def test_composite_matches_plain_on_v3_lane_grids(rays, budget, card):
    """#4 forward and its backward (the training path's gradients) on a
    ragged v3 lane grid: invalid lanes carry deltas 0, ts at far and zero
    sigma / rgb; tolerances as on the uniform grids, the same bytes twice."""
    step = smoke.v3_random_step(card, budget, budget, n_rays=rays)
    assert step["lanes"].shape == (rays, V3_LANES[(rays, budget)])
    assert not bool(step["valid"].all()) and step["overflow"] == 0
    gen = torch.Generator().manual_seed(budget)
    inputs = smoke.ragged_composite_inputs(gen, step, card)
    got = vr_kernel.composite(*inputs)
    want = vr_ref.composite(*inputs)
    for g, w in zip(got, want[:3]):
        assert float((g - w).abs().max()) <= 5e-5
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, vr_kernel.composite(*inputs)))
    grads = (_u(gen, (rays, 3), -1, 1, card), _u(gen, (rays,), -1, 1, card),
             _u(gen, (rays,), -1, 1, card))
    needs = smoke.TRAIN_COMPOSITE_NEEDS
    back = vr_kernel.composite_backward(*inputs, *grads, needs=needs)
    closed = vr_ref.composite_backward(*inputs, *grads)
    for k, need in enumerate(needs):
        if need:
            assert _rel(back[k], closed[k]) <= 1e-4, k
    again = vr_kernel.composite_backward(*inputs, *grads, needs=needs)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(back, again) if a is not None)


@pytest.mark.gpu
@pytest.mark.parametrize("need_color", [True, False])
def test_fused_step_kernels_match_plain_on_v3_packed_points(need_color, card):
    """#5 and #6 (its commit through bum_sort and #7) at the v3 ceiling of
    4096 points, on a step's Morton-packed ragged lanes (dead padding lanes
    included): the forward within 1e-5, the backward against its function
    in float64 as on uniform points."""
    field = Field(FieldConfig())
    step = smoke.v3_random_step(card, 7, 4096)
    gen = torch.Generator().manual_seed(4096)
    _, sh, tables, mlp_d, mlp_c, geometry = _step_inputs(gen, 4096, card, field)
    pts = step["points"]
    got = fs_kernel.fused_step_fwd(pts, sh, *tables, mlp_d, mlp_c, *geometry)
    want = fs_ref.fused_step_ref(pts, sh, *tables, mlp_d, mlp_c, *geometry)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5
    g_d, g_c = _u(gen, got[0].shape, -1, 1, card), _u(gen, got[1].shape, -1, 1, card)
    before = kernels.LAUNCHES["fused_step_bwd"]
    back = fs_kernel.fused_step_bwd(pts, sh, g_d, g_c, *tables, mlp_d, mlp_c, *geometry,
                                    need_color=need_color)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_step_bwd"] == before + 1
    cpu = lambda x: {k: v.cpu() for k, v in x.items()} if isinstance(x, dict) else x.cpu()  # noqa: E731
    exact = fs_ref.backward_f64(geometry, *(cpu(x) for x in (pts, sh, *tables, mlp_d, mlp_c,
                                                              g_d, g_c)), (True, need_color))
    for k, need in enumerate((True, need_color)):
        if need:
            assert _rel(back[k].cpu().double(), exact[k]) <= 1e-5
            assert torch.equal(_rows(back[k].cpu()), _rows(exact[k]))
        else:
            assert back[k] is None
    for k in (2, 3):
        for name in back[k]:
            assert _rel(back[k][name].cpu().double(), exact[k][name]) <= 1e-4, name
    assert _rel(back[4].cpu().double(), exact[4]) <= 1e-4


@pytest.mark.gpu
def test_two_slots_on_one_card_end_on_the_placement_free_bytes(card):
    """The multi-device quantum on the card: two slots that are both
    ``cuda:0`` (two slot threads launching every training kernel at
    once, renders on the render stream) against the placement-free
    service, three Instant-3D scenes on FieldConfig() at a small image
    size; every session's final params and occupancy the same bytes, every
    render answered, and the unmerged commit (index_add_ on the card) within
    1e-5 of the merged one on one dense step's table gradients."""
    from repro_torch.core import occupancy
    from repro_torch.core.rendering import RenderConfig
    from repro_torch.core.trainer import TrainerConfig
    from repro_torch.data.synthetic_scene import build_dataset
    from repro_torch.optim.adamw import tree_paths
    from repro_torch.serve3d import DONE, ReconstructionService, RenderResult
    rcfg = RenderConfig()
    # headroom 0.7: at this size's live fraction (~0.56) the budget buckets
    # to 8192 of 12,288 points, so steps 32-39 shade through the fused step
    cfg = TrainerConfig(n_rays=256, budget_headroom=0.7,
                        occ=occupancy.OccupancyConfig(update_interval=8, warmup_steps=16))
    datasets = [build_dataset(k, n_views=6, h=32, w=32, cfg=rcfg, gt_samples=48,
                              device=card)[1] for k in range(3)]
    runs = {}
    for devices in (None, ["cuda:0", "cuda:0"]):
        svc = ReconstructionService(slice_iters=8, devices=devices, device=card,
                                    async_serving=devices is not None)
        for k, ds in enumerate(datasets):
            svc.submit_scene(ds, FieldConfig(), cfg, target_iters=40, seed=k)
        answers = []

        def hook(s, ev):
            answers.extend(ev["results"])
            for sid in ev["cohort"]:
                if s.sessions[sid].step == 24:
                    s.request_render(sid, datasets[0].poses[1])

        kernels.reset_launches()
        tel = svc.run(hook=hook)
        torch.cuda.synchronize()
        assert all(s.status == DONE for s in svc.sessions.values())
        assert len(answers) == 3 and all(isinstance(r, RenderResult) for r in answers)
        runs[devices is not None] = (svc, dict(kernels.LAUNCHES), tel)
    (free, _, _), (two, launches, tel) = runs[False], runs[True]
    assert tel["placement"]["placed"] == {"scene-000": 0, "scene-001": 1, "scene-002": 0}
    missing = [k for k in ("hash_encode", "fused_mlp2", "fused_mlp3", "composite",
                           "composite_bwd", "fused_step_fwd", "fused_step_bwd", "bum_sort",
                           "bum_scatter") if launches[k] == 0]
    assert missing == [], launches
    for sid, sess in two.sessions.items():
        a, b = free.sessions[sid].state, sess.state
        assert all(torch.equal(_bits(x), _bits(y)) for (_, x), (_, y)
                   in zip(tree_paths(a.params), tree_paths(b.params))), sid
        assert torch.equal(a.occ_state.density_ema, b.occ_state.density_ema), sid
    # merged_backward=False on the card: index_add_'s sum, to rounding
    enc = Field(FieldConfig()).density_enc
    gen = torch.Generator().manual_seed(5)
    pts = _u(gen, (49152, 3), 0.0, 1.0 - 1e-6, card)
    tables = _u(gen, (16, 1 << 18, 2), -1e-4, 1e-4, card)
    g = _u(gen, (49152, 32), -1, 1, card)
    grads = []
    for merged in (True, False):
        t = tables.clone().requires_grad_(True)
        (he_ops.hash_encode(pts, t, enc.resolutions, enc.dense_flags, merged_backward=merged)
         * g).sum().backward()
        grads.append(t.grad)
    assert _rel(grads[1], grads[0]) <= 1e-5


@pytest.mark.gpu
def test_session_moves_from_the_cpu_to_the_card(card):
    """A session on DevicePlacement(["cpu", "cuda:0"]): trained on the CPU
    slot (plain routes) to step 24, suspended, moved to the card, resumed
    and trained to 40 through the kernels.  After the resume every state
    tensor and the sampler's rays are on cuda:0; a placed render service on
    the CPU renders the session on cuda:0; and the params, both Adam
    moments and the occupancy EMA are the bytes of a session trained
    unplaced on the CPU to 24 and resumed on the card from its host tree."""
    from repro_torch.data.synthetic_scene import build_dataset
    kernels.reset_launches()
    move = smoke.cross_device_move(build_dataset(1, device="cpu", **smoke.CROSS_DATA)[1])
    assert move["on_new_device"] and move["render_on"] == ["cuda:0"], move
    assert move["render_equal"], move
    assert all(move[k] for k in ("params", "adam_m", "adam_v", "occupancy_ema", "steps")), move
    assert smoke.cross_move_holds(move)
    # the card leg trained through the kernels, compacted steps included
    assert all(kernels.LAUNCHES[k] > 0 for k in ("hash_encode", "fused_step_fwd",
                                                  "fused_step_bwd", "bum_scatter")), \
        dict(kernels.LAUNCHES)
