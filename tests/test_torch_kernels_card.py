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
at the ceiling of 4096, with the same tolerances.  Half-width tables
(`FieldConfig.grid_dtype`): #1, #5, #6 and #8 on bf16 and f16 tables give
the bytes of the same kernel on the tables' f32 copies (the widening is
exact) and meet the f32 tolerances against their plain versions on the
2-byte tables; #7 commits into a nonzero 2-byte table as the plain commit,
exactly.  Compiled steps: a replayed training step (the dense route,
Instant-3D's compacted step at 8192, the NGP baseline's through the fused
encode, v3 at 4096, bf16 tables) is the eager step's bytes, a replay counts
the eager step's launches, and a capture beside the async serving thread
changes neither thread's bytes.  Compiled renders: on each route
(redistributed, dense, v3, bf16 tables) a replayed view is the eager
view's bytes; a graph captured before any occupancy fold serves a folded
snapshot's bytes; a render replay takes neither the training graphs'
lock nor their pool; a render capture on the serving thread beside
training replays keeps both sides' bytes.  Vocab-wide rows (the LM's
embedding backward, any F outside {1, 2, 4, 8}): `bum_sort` is torch.sort's
stable permutation exactly and #7 the plain merge bit for bit at F = 3, 64,
1024 and 4096, on heavily duplicated token streams with a run across the
wide commit's tiles, each the same bytes on two launches; the 1-D windowed
commit gives the plain version's bytes.
"""
import ctypes
import threading

import numpy as np
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
from repro_torch.kernels.grid_update import ops as gu_ops
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
                                kernels.ptr(out), 64, 2, 256, 3, 0,
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
    with pytest.raises(ValueError, match="F >= 1"):
        gu_kernel.bum_sort(addr, torch.zeros((16, 0), device=card), 8)


def _wide_stream(m: int, rows: int, gen):
    """Token ids as the LM's embedding backward sees them: a few ids
    repeated many times (the stream's heavy duplication), the rest uniform
    over the vocabulary, one id repeated past the wide commit's 8-entry
    tile, and a spill-row (rows) entry -- unsorted."""
    ids = torch.randint(0, rows, (m,), generator=gen)
    hot = torch.randint(0, rows, (8,), generator=gen)
    pick = torch.rand((m,), generator=gen) < 0.5
    ids = torch.where(pick, hot[torch.randint(0, 8, (m,), generator=gen)], ids)
    ids[: min(m, 40)] = 7                 # one run of 40 entries across 5 tiles
    ids[-1] = rows
    return ids


@pytest.mark.gpu
@pytest.mark.parametrize("m,f,rows", [(1024, 1024, 151_936), (16_384, 1024, 151_936),
                                      (1024, 4096, 65_024), (1000, 64, 256), (333, 3, 97),
                                      (1, 1024, 16)])
def test_bum_sort_and_commit_on_vocab_wide_rows(m, f, rows, card):
    """The wide route of both kernels (any F outside {1, 2, 4, 8}: the LM's
    vocab-embedding rows, F = d_model): `bum_sort` is torch.sort's stable
    permutation exactly (keys over the table's bits, spill row included),
    `bum_scatter` commits the sorted stream into a nonzero table as the
    plain merge, bit for bit; each one launch, each the same bytes on two
    launches."""
    gen = torch.Generator().manual_seed(m + f)
    ids = _wide_stream(m, rows, gen)
    vals = (torch.randn((m, f), generator=gen)
            * 10.0 ** (torch.rand((m, 1), generator=gen) * 6 - 3))
    bits = rows.bit_length()
    addr, v = ids.to(card), vals.to(card)
    before = dict(kernels.LAUNCHES)
    got = gu_kernel.bum_sort(addr, v, bits)
    again = gu_kernel.bum_sort(addr, v, bits)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bum_sort"] == before["bum_sort"] + 2
    want = _stable(ids, vals)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert torch.equal(_bits(got[1]), _bits(again[1]))
    table = torch.randn((rows, f), generator=gen)
    out = gu_kernel.bum_scatter(table.to(card), got[0], got[1])
    out2 = gu_kernel.bum_scatter(table.to(card), got[0], got[1])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bum_scatter"] == before["bum_scatter"] + 2
    commit = gu_ref.segment_commit(table, want[0], want[1])
    assert torch.equal(_bits(out.cpu()), _bits(commit))
    assert torch.equal(_bits(out), _bits(out2))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 2, 4, 8, 64, 1024])
def test_windowed_scatter_add_one_stream_runs_on_the_card(f, card):
    """The 1-D windowed form (one stream cut into windows, the tail padded
    with spill-row entries) on the card: each window through bum_sort and
    bum_scatter, the plain version's bytes."""
    gen = torch.Generator().manual_seed(f + 3)
    rows, m, window = 512, 2500, 1024
    ids = _wide_stream(m, rows, gen)[:-1]
    vals = torch.randn((m - 1, f), generator=gen)
    table = torch.zeros((rows, f))
    before = dict(kernels.LAUNCHES)
    got = gu_ops.windowed_scatter_add(table.to(card), ids.to(card), vals.to(card),
                                      window=window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bum_sort"] == before["bum_sort"] + 3
    assert kernels.LAUNCHES["bum_scatter"] == before["bum_scatter"] + 3
    want = gu_ops.windowed_scatter_add(table, ids, vals, window=window)
    assert torch.equal(_bits(got.cpu()), _bits(want))


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


# ---- half-width tables (FieldConfig.grid_dtype) ----

HALF_DTYPES = [torch.bfloat16, torch.float16]


def _same(a, b):
    """The same dtype, shape and bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=str)
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [49152, 77])
def test_hash_encode_on_half_width_tables(n, f, dtype, card):
    """#1 on a bf16 / f16 table: the bytes of the same kernel on the table's
    f32 copy (the widening is exact and the arithmetic the f32 kernel's),
    within 1e-5 of the plain version on the same 2-byte table, the same
    bytes on two launches, sentinel rows exactly zero."""
    enc = Field(FieldConfig(n_features=f)).density_enc
    gen = torch.Generator().manual_seed(n + f)
    pts = _u(gen, (n, 3), 0.0, 1.0 - 1e-6, card)
    pts[:3, 0] = -1.0
    tables = _u(gen, (enc.cfg.n_levels, enc.cfg.table_size, f), -1, 1, card).to(dtype)
    args = (enc.resolutions, enc.dense_flags)
    got = he_kernel.hash_encode(pts, tables, *args)
    assert got.dtype == torch.float32
    assert _same(got, he_kernel.hash_encode(pts, tables.float(), *args))
    assert _same(got, he_kernel.hash_encode(pts, tables, *args))
    assert float((got - he_ref.hash_encode(pts, tables, *args)).abs().max()) <= 1e-5
    assert not got[:3].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=str)
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [32768, 257])
def test_fused_encode_on_half_width_tables(n, f, dtype, card):
    """#8 on a bf16 / f16 table: features and distinct reads the bytes of
    the kernel on the f32 copy, within 1e-5 of the plain version on the
    2-byte table, the same bytes on two launches."""
    enc = Field(FieldConfig(n_features=f)).density_enc
    gen = torch.Generator().manual_seed(n + f)
    pts = _morton(_u(gen, (n, 3), 0.0, 1.0 - 1e-6, card))
    pts[n - 5:] = -1.0
    tables = _u(gen, (enc.cfg.n_levels, enc.cfg.table_size, f), -1, 1, card).to(dtype)
    args = (enc.resolutions, enc.dense_flags)
    got, reads = fp_kernel.fused_encode(pts, tables, *args)
    up, up_reads = fp_kernel.fused_encode(pts, tables.float(), *args)
    again, again_reads = fp_kernel.fused_encode(pts, tables, *args)
    assert _same(got, up) and _same(reads, up_reads)
    assert _same(got, again) and _same(reads, again_reads)
    assert float((got - fp_ref.fused_encode(pts, tables, *args)).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=str)
@pytest.mark.parametrize("f", list(fs_kernel.FEATURE_COUNTS))
@pytest.mark.parametrize("n", [8192, 32768, 77])
def test_fused_step_fwd_on_half_width_tables(n, f, dtype, card):
    """#5 on bf16 / f16 tables (both grids one dtype): the bytes of the
    kernel on the f32 copies, within 1e-5 of the plain step on the 2-byte
    tables, the same bytes on two launches."""
    field = Field(FieldConfig(n_features=f))
    gen = torch.Generator().manual_seed(n + f)
    pts, sh, tables, mlp_d, mlp_c, geometry = _morton_step_inputs(gen, n, card, field)
    half = [t.to(dtype) for t in tables]
    got = fs_kernel.fused_step_fwd(pts, sh, *half, mlp_d, mlp_c, *geometry)
    up = fs_kernel.fused_step_fwd(pts, sh, *(t.float() for t in half), mlp_d, mlp_c,
                                  *geometry)
    again = fs_kernel.fused_step_fwd(pts, sh, *half, mlp_d, mlp_c, *geometry)
    want = fs_ref.fused_step_ref(pts, sh, *half, mlp_d, mlp_c, *geometry)
    for g, u, a, w in zip(got, up, again, want):
        assert _same(g, u) and _same(g, a)
        assert float((g - w).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=str)
@pytest.mark.parametrize("need_color", [True, False])
@pytest.mark.parametrize("n", [8192, 77])
def test_fused_step_bwd_on_half_width_tables(n, need_color, dtype, card):
    """#6 on bf16 / f16 tables: its f32 streams, MLP and SH gradients the
    bytes of the kernel on the f32 copies, its table gradients in the
    tables' dtype and the f32 commit cast; the f32 commit within 1e-5 of the
    plain backward's (the same nonzero rows), MLP and SH gradients within
    1e-4 of the plain backward on the 2-byte tables; the same bytes twice."""
    field = Field(FieldConfig())
    gen = torch.Generator().manual_seed(n + 13)
    pts, sh, tables, mlp_d, mlp_c, geometry = _morton_step_inputs(gen, n, card, field)
    half = [t.to(dtype) for t in tables]
    up = [t.float() for t in half]
    g_d = _u(gen, (n, mlp_d["w2"].shape[1]), -1, 1, card)
    g_c = _u(gen, (n, mlp_c["w3"].shape[1]), -1, 1, card)
    args = (mlp_d, mlp_c, *geometry)
    launch = lambda ts: fs_kernel.fused_step_bwd_launch(  # noqa: E731
        pts, sh, g_d, g_c, *ts, *args, need_color=need_color)
    (s_half, m_half, sh_half), (s_up, m_up, sh_up) = launch(half), launch(up)
    for name in ("density", "color"):
        assert (s_half[name] is None) == (s_up[name] is None)
        if s_half[name] is not None:
            assert all(_same(a, b) for a, b in zip(s_half[name], s_up[name]))
    assert _same(m_half, m_up) and _same(sh_half, sh_up)
    bwd = lambda ts: fs_kernel.fused_step_bwd(  # noqa: E731
        pts, sh, g_d, g_c, *ts, *args, need_color=need_color)
    got, got32, again = bwd(half), bwd(up), bwd(half)
    cpu = lambda x: {k: v.cpu() for k, v in x.items()} if isinstance(x, dict) else x.cpu()  # noqa: E731
    plain = lambda ts: fs_ops._plain_backward(  # noqa: E731
        geometry, *(cpu(x) for x in (pts, sh, *ts, mlp_d, mlp_c, g_d, g_c)), (True, need_color))
    want, want32 = plain(half), plain(up)
    for k in (0, 1):
        if k == 1 and not need_color:
            assert got[1] is None and want[1] is None
            continue
        assert got[k].dtype == dtype and _same(got[k], got32[k].to(dtype))
        assert _same(got[k], again[k])
        assert _rel(got32[k].cpu(), want32[k]) <= 1e-5
        assert torch.equal(_rows(got32[k].cpu()), _rows(want32[k]))
    for k in (2, 3):
        for name in got[k]:
            assert _same(got[k][name], got32[k][name])
            assert _rel(got[k][name].cpu(), want[k][name]) <= 1e-4
    assert _same(got[4], got32[4]) and _rel(got[4].cpu(), want[4]) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=str)
@pytest.mark.parametrize("m,t,f", [(1_048_576, 1 << 20, 2), (1000, 64, 1), (4097, 256, 8)])
def test_bum_scatter_commits_into_a_nonzero_half_width_table(m, t, f, dtype, card):
    """#7 through `merged_scatter_add` into a nonzero bf16 / f16 table: an
    f32 working copy, each row's f32 value plus its run's sum rounded once,
    the plain commit on CPU copies exactly; the table keeps its dtype."""
    from repro_torch.kernels.grid_update import ops as gu_ops
    gen = torch.Generator().manual_seed(m + f)
    idx = torch.sort(torch.randint(0, t + 1, (m,), generator=gen)).values.to(card)
    vals = _u(gen, (m, f), -1, 1, card)
    table = _u(gen, (t, f), -1, 1, card).to(dtype)
    got = gu_ops.merged_scatter_add(table, idx, vals, presorted=True)
    assert got.dtype == dtype
    assert torch.equal(got.cpu(), gu_ref.segment_commit(table.cpu(), idx.cpu(), vals.cpu()))
    assert _same(got, gu_ops.merged_scatter_add(table, idx, vals, presorted=True))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=str)
def test_table_gradients_leave_in_the_tables_dtype_on_the_card(dtype, card):
    """The dense route's hash-encode backward and the fused encode's backward
    on 2-byte tables: the gradient in the tables' dtype, the f32 route's
    gradient cast; a table of any other dtype raises."""
    field = Field(FieldConfig())
    gen = torch.Generator().manual_seed(17)
    pts = _morton(_u(gen, (4096, 3), 0.0, 1.0 - 1e-6, card))
    encs = (field.density_enc, field.color_enc)
    half = [_u(gen, (e.cfg.n_levels, e.cfg.table_size, 2), -1, 1, card).to(dtype)
            for e in encs]
    g = [_u(gen, (4096, e.cfg.out_dim), -1, 1, card) for e in encs]

    def grads(tables, fused):
        leaves = [t.clone().requires_grad_(True) for t in tables]
        outs = (field._fused_encode(pts, *leaves) if fused else
                [he_ops.hash_encode(pts, t, e.resolutions, e.dense_flags)
                 for t, e in zip(leaves, encs)])
        sum((o * gg).sum() for o, gg in zip(outs, g)).backward()
        return [t.grad for t in leaves]

    for fused in (False, True):
        got, want = grads(half, fused), grads([t.float() for t in half], fused)
        for a, b in zip(got, want):
            assert a.dtype == dtype and _same(a, b.to(dtype))
    with pytest.raises(ValueError, match="expected one of"):
        he_kernel.hash_encode(pts, half[0].double(), *(encs[0].resolutions,
                                                       encs[0].dense_flags))


# ---- compiled steps: CUDA-graph replays of the training step ----

# (field, TrainerConfig overrides, budget): the dense step, Instant-3D's
# compacted step through the fused step (#5, #6), the NGP baseline's through
# the fused encode (#8), stage 2b v3 at its ceiling and bf16 tables
REPLAY_CASES = {
    "dense": (FieldConfig(), {}, None),
    "compacted_8192": (FieldConfig(), {}, 8192),
    "ngp_query_fused": (FieldConfig(decomposed=False), {}, 32768),
    "v3_4096": (FieldConfig(), {"max_budget": 4096, "redistribute_v3": True}, 4096),
    "bfloat16": (FieldConfig(grid_dtype="bfloat16"), {}, 8192),
}
REPLAY_DATA = dict(n_views=6, h=32, w=32, gt_samples=48)


def _replay_inputs(card, cfg, n_steps: int):
    from repro_torch.core import rendering
    from repro_torch.core.trainer import default_draws
    from repro_torch.data.rays_dataset import RaySampler
    from repro_torch.data.synthetic_scene import build_dataset
    sampler = RaySampler(build_dataset(0, device=card, **REPLAY_DATA)[1], device=card)
    draws = default_draws(cfg, sampler.n)
    return [(sampler.gather(ray_idx), rendering.sample_ts(None, cfg.n_rays, cfg.render, card,
                                                          u=u_ts))
            for ray_idx, u_ts, _ in (draws(i) for i in range(n_steps))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(REPLAY_CASES))
def test_replayed_steps_are_the_eager_bytes(case, card):
    """Four steps of each variant pair (color live, frozen) from a folded
    state at TrainerConfig()'s shapes (1024 rays x 48): the replayed chain
    ends every step on the eager chain's params, moments, loss and aux
    byte for byte; after the captures, LAUNCHES over n replays equals n
    eager steps' counts, kernel for kernel."""
    from repro_torch.core import occupancy
    from repro_torch.core.trainer import Instant3DTrainer, TrainerConfig
    from repro_torch.optim.adamw import tree_paths
    field_cfg, over, budget = REPLAY_CASES[case]
    cfg = TrainerConfig(**over)
    tr = Instant3DTrainer(Field(field_cfg), cfg, device=card)
    state = tr.init()
    ema = occupancy.update(tr.field, state.params, state.occ_state, cfg.occ,
                           generator=torch.Generator().manual_seed(3)).density_ema
    inputs = _replay_inputs(card, cfg, 8)
    flags = [dict(freeze_color=bool(k % 2) and field_cfg.decomposed, budget=budget,
                  use_bits=budget is not None) for k in range(len(inputs))]
    fns = {f["freeze_color"]: tr.step_fn(**f) for f in flags}

    def leaves(p, o, loss, aux):
        return ([t for _, t in tree_paths(p)] + [o.step] + [t for _, t in tree_paths(o.m)]
                + [t for _, t in tree_paths(o.v)] + [loss]
                + [aux[k] for k in ("live_fraction", "overflow")])

    def chain(replay: bool, steps):
        p, o, out = state.params, state.opt_state, []
        for (batch, ts), f in steps:
            if replay:
                p, o, loss, aux = fns[f["freeze_color"]](p, o, batch, ts, ema)
            else:
                p, o, loss, aux = tr.step(p, o, batch, ts, ema, **f)
            out.append(leaves(p, o, loss, aux))
        torch.cuda.synchronize()
        return out

    steps = list(zip(inputs, flags))
    for a, b in zip(chain(False, steps[:4]), chain(True, steps[:4])):   # captures here
        assert all(_same(x, y) for x, y in zip(a, b))
    assert all(len(fn.graphs) == 1 for fn in fns.values())
    counts = {}
    for replay in (True, False):
        kernels.reset_launches()
        chain(replay, steps[4:])
        counts[replay] = dict(kernels.LAUNCHES)
    assert counts[True] == counts[False] and sum(counts[True].values()) > 0, counts
    assert sum(g.replays for fn in fns.values() for g in fn.graphs.values()) == 8


@pytest.mark.gpu
def test_capture_beside_the_async_serving_thread(card):
    """The async serving thread drains 800x800-sized work on its render
    stream while a trainer captures its variants (the cache emptied first):
    every async answer is the bytes of a sync drain of the same snapshot,
    and the captured run ends on the bytes of the same run under
    `eager_steps()`."""
    from repro_torch.core import occupancy
    from repro_torch.core.rendering import RenderConfig, sphere_poses
    from repro_torch.core.trainer import (Instant3DTrainer, TrainerConfig, clear_step_cache,
                                          eager_steps)
    from repro_torch.data.rays_dataset import RaySampler
    from repro_torch.data.synthetic_scene import build_dataset
    from repro_torch.optim.adamw import tree_paths
    field_cfg, rcfg, ocfg = FieldConfig(), RenderConfig(), occupancy.OccupancyConfig()
    store = smoke.make_snapshot_store(card, field_cfg, ocfg)
    svc = smoke.make_service(store, card, field_cfg, rcfg, ocfg, 256, 4096)
    poses = sphere_poses(6, seed=1)
    for i, pose in enumerate(poses):
        svc.submit(("redist", "dense")[i % 2], pose)
    want = {(r.session_id, i): r for i, r in enumerate(svc.drain())}
    cfg = TrainerConfig(occ=occupancy.OccupancyConfig(update_interval=8, warmup_steps=16))
    sampler = RaySampler(build_dataset(0, device=card, **REPLAY_DATA)[1], device=card)

    def train():
        tr = Instant3DTrainer(Field(field_cfg), cfg, device=card)
        state, hist = tr.train(tr.init(), sampler, iters=48, log_every=48)
        return state

    with eager_steps():
        eager = train()
    clear_step_cache()
    svc.start_async()
    try:
        for i, pose in enumerate(poses):
            svc.submit(("redist", "dense")[i % 2], pose)
        captured = train()
        got = []
        for _ in range(600):
            got += svc.poll_results()
            if len(got) == len(poses):
                break
            threading.Event().wait(0.1)
    finally:
        svc.stop_async()
    torch.cuda.synchronize()
    assert len(got) == len(poses)
    for k, r in enumerate(sorted(got, key=lambda r: r.request_id)):
        w = want[(r.session_id, k)]
        assert np.array_equal(r.rgb, w.rgb) and np.array_equal(r.depth, w.depth), k
    for (_, a), (_, b) in zip(tree_paths(eager.params), tree_paths(captured.params)):
        assert _same(a, b)
    assert torch.equal(eager.occ_state.density_ema, captured.occ_state.density_ema)
    clear_step_cache()


@pytest.mark.gpu
def test_replays_beside_another_threads_captures_keep_their_bytes(card):
    """One thread replays the NGP baseline's compacted step (its MLP
    backward through cuBLAS) on fixed inputs while another builds fresh
    Instant-3D variants -- each a warm-up on the capture stream and a
    capture -- as two slot threads of one card do: every replay gives the
    first replay's bytes and neither thread raises."""
    from repro_torch.core import occupancy, step_graph
    from repro_torch.core.trainer import Instant3DTrainer, TrainerConfig
    from repro_torch.optim.adamw import tree_paths
    cfg = TrainerConfig()
    ((batch, ts),) = _replay_inputs(card, cfg, 1)

    def setup(field_cfg):
        tr = Instant3DTrainer(Field(field_cfg), cfg, device=card)
        state = tr.init()
        ema = occupancy.update(tr.field, state.params, state.occ_state, cfg.occ,
                               generator=torch.Generator().manual_seed(3)).density_ema
        return tr, state, ema

    ngp, n_state, n_ema = setup(FieldConfig(decomposed=False))
    i3d, i_state, i_ema = setup(FieldConfig())
    replay = ngp.step_fn(False, budget=32768, use_bits=True)

    def leaves():
        p, _, loss, _ = replay(n_state.params, n_state.opt_state, batch, ts, n_ema)
        float(loss)                                  # the training loop's read
        return [t for _, t in tree_paths(p)] + [loss]

    want, errors, differ = leaves(), [], []
    done = threading.Event()

    def replays():
        try:
            while not done.is_set():
                differ.append(not all(_same(a, b) for a, b in zip(leaves(), want)))
        except Exception as e:   # noqa: BLE001 -- re-raised in the test's thread
            errors.append(e)

    worker = threading.Thread(target=replays)
    worker.start()
    try:
        for k in range(24):
            fc = bool(k % 2)
            fresh = step_graph.CompiledStep(lambda *a, fc=fc: i3d.step(
                *a, freeze_color=fc, budget=None, use_bits=True))
            fresh(i_state.params, i_state.opt_state, batch, ts, i_ema)
    finally:
        done.set()
        worker.join(timeout=120)
    assert not worker.is_alive() and not errors, errors
    assert len(differ) > 0 and not any(differ), (sum(differ), len(differ))


# ---- compiled renders ----

RENDER_ROUTES = {
    "redist": (FieldConfig(), {}),
    "dense": (FieldConfig(), {}),
    "v3": (FieldConfig(), {"max_budget": 4096, "redistribute_v3": True}),
    "redist_bfloat16": (FieldConfig(grid_dtype="bfloat16"), {}),
}
RENDER_HW = 256


def _render_run(card, route: str) -> dict:
    """A run-like dict for `smoke.route_service`: a fresh trainer of the
    route's configs and its initial params with one occupancy fold."""
    from repro_torch.core import occupancy
    from repro_torch.core.trainer import Instant3DTrainer, TrainerConfig, TrainState
    field_cfg, over = RENDER_ROUTES[route]
    tr = Instant3DTrainer(Field(field_cfg), TrainerConfig(**over), device=card)
    state = tr.init()
    occ = occupancy.update(tr.field, state.params, state.occ_state, tr.cfg.occ,
                           generator=torch.Generator().manual_seed(3))
    return {"trainer": tr, "state": TrainState(state.params, state.opt_state, occ, 16)}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(RENDER_ROUTES))
def test_replayed_renders_are_the_eager_bytes(route, card):
    """A group of 3 views (keyed as 4) and a level-1 preview at 256x256:
    the drain that captures and the one that only replays give the pixels
    of the same drain under `eager_steps()` byte for byte; the replay
    drain's launches are the eager drain's, and every chunk a replay."""
    from repro_torch.core.trainer import clear_render_cache, eager_steps
    clear_render_cache()
    run = _render_run(card, route)
    svc = smoke.route_service(card, run, route, hw=RENDER_HW)
    captured = [smoke.route_drain(svc, route, RENDER_HW) for _ in range(2)]
    stats = smoke.render_graph_stats()
    with eager_steps():
        eager = smoke.route_drain(svc, route, RENDER_HW)
    for d in captured:
        assert smoke._same_pixels(d["results"], eager["results"])
    assert captured[1]["launches"] == eager["launches"] and sum(eager["launches"].values())
    chunks = sum(smoke.groups_taken(svc, d["results"])[1] for d in captured)
    assert stats["graphs"] == 1 and stats["replays"] == chunks
    clear_render_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["redist", "v3"])
def test_a_render_captured_before_any_fold_serves_folded_snapshots(route, card):
    """The route's render graph captured on a snapshot with no fold yet
    (all cells occupied), then a folded snapshot of the same params
    published and served through it with no new capture: the bytes of the
    folded snapshot drained under `eager_steps()`, unlike the unfolded
    view's."""
    from repro_torch.core import occupancy
    from repro_torch.core.trainer import clear_render_cache, eager_steps
    clear_render_cache()
    run = _render_run(card, route)
    tr, state = run["trainer"], run["state"]
    unfolded = tr.init().occ_state
    ema = state.occ_state.density_ema.clone()
    ema[ema.numel() // 2:] = 0.0                 # half the grid culled for certain
    folded = occupancy.OccupancyState(ema, state.occ_state.step)
    assert int(unfolded.step) == 0 and int(folded.step) == 1
    svc = smoke.route_service(card, {"trainer": tr, "state": state._replace(
        occ_state=unfolded)}, route, hw=RENDER_HW)
    first = smoke.route_drain(svc, route, RENDER_HW)                    # captures
    captures = smoke.render_graph_stats()
    svc.store.publish(route, state.params, step=state.step + 1, occ=folded)
    replayed = smoke.route_drain(svc, route, RENDER_HW)
    stats = smoke.render_graph_stats()
    with eager_steps():
        eager = smoke.route_drain(svc, route, RENDER_HW)
    assert captures["graphs"] == stats["graphs"] == 1
    assert stats["replays"] - captures["replays"] == \
        smoke.groups_taken(svc, replayed["results"])[1]
    assert smoke._same_pixels(replayed["results"], eager["results"])
    assert not smoke._same_pixels(first["results"], replayed["results"])
    clear_render_cache()


@pytest.mark.gpu
def test_render_replays_take_neither_the_training_lock_nor_pool(card):
    """A render entry's graph lives in the device's render pool, apart from
    the training graphs', and a view renders through it while another
    thread holds the training graphs' lock."""
    from repro_torch.core import step_graph
    from repro_torch.core.trainer import clear_render_cache
    clear_render_cache()
    svc = smoke.route_service(card, _render_run(card, "redist"), "redist", hw=RENDER_HW)
    want = smoke.route_drain(svc, "redist", RENDER_HW)                  # captures
    (entry,) = smoke.trainer_lib._MEMBER_RENDERS.values()
    (graph,) = entry.graphs.values()
    train_dev = step_graph.device_graphs(graph.dev.device)
    assert graph.dev is step_graph.device_graphs(graph.dev.device, "render")
    assert graph.dev is not train_dev and graph.dev.lock is not train_dev.lock
    assert tuple(graph.dev.pool) != tuple(train_dev.pool)
    out_ptr = graph.static_out[0].data_ptr()
    (seg,) = [s for s in torch.cuda.memory_snapshot()
              if s["address"] <= out_ptr < s["address"] + s["total_size"]]
    assert tuple(seg["segment_pool_id"]) == tuple(graph.dev.pool)
    replays, got, errors = graph.replays, [], []

    def render():
        try:
            got.append(smoke.route_drain(svc, "redist", RENDER_HW))
        except Exception as e:   # noqa: BLE001 -- re-raised in the test's thread
            errors.append(e)

    with train_dev.lock:
        worker = threading.Thread(target=render)
        worker.start()
        worker.join(timeout=300)
        assert not worker.is_alive()
    assert not errors, errors
    assert graph.replays > replays
    assert smoke._same_pixels(got[0]["results"], want["results"])
    clear_render_cache()


@pytest.mark.gpu
def test_render_captures_on_the_serving_thread_beside_training_replays(card):
    """The async serving thread captures its render graphs (the render
    cache emptied first) while the trainer replays its captured steps:
    every async answer is the bytes of the same requests drained under
    `eager_steps()`, and the replayed run ends on the eager run's bytes."""
    from repro_torch.core import occupancy
    from repro_torch.core.rendering import RenderConfig, sphere_poses
    from repro_torch.core.trainer import (Instant3DTrainer, TrainerConfig, clear_render_cache,
                                          clear_step_cache, eager_steps)
    from repro_torch.data.rays_dataset import RaySampler
    from repro_torch.data.synthetic_scene import build_dataset
    from repro_torch.optim.adamw import tree_paths
    field_cfg, rcfg, ocfg = FieldConfig(), RenderConfig(), occupancy.OccupancyConfig()
    store = smoke.make_snapshot_store(card, field_cfg, ocfg)
    svc = smoke.make_service(store, card, field_cfg, rcfg, ocfg, RENDER_HW, 4096)
    poses = sphere_poses(6, seed=1)
    with eager_steps():
        for i, pose in enumerate(poses):
            svc.submit(("redist", "dense")[i % 2], pose)
        want = svc.drain()
    cfg = TrainerConfig(occ=occupancy.OccupancyConfig(update_interval=8, warmup_steps=16))
    sampler = RaySampler(build_dataset(0, device=card, **REPLAY_DATA)[1], device=card)

    def train():
        tr = Instant3DTrainer(Field(field_cfg), cfg, device=card)
        return tr.train(tr.init(), sampler, iters=48, log_every=48)[0]

    with eager_steps():
        eager = train()
    clear_step_cache()
    train()                                  # captures every variant of the run
    clear_render_cache()
    svc.start_async()
    try:
        for i, pose in enumerate(poses):
            svc.submit(("redist", "dense")[i % 2], pose)
        replayed = train()
        got = []
        for _ in range(600):
            got += svc.poll_results()
            if len(got) == len(poses):
                break
            threading.Event().wait(0.1)
    finally:
        svc.stop_async()
    torch.cuda.synchronize()
    assert len(got) == len(poses)
    for r, w in zip(sorted(got, key=lambda r: r.request_id), want):
        assert r.session_id == w.session_id
        assert np.array_equal(r.rgb, w.rgb) and np.array_equal(r.depth, w.depth)
    for (_, a), (_, b) in zip(tree_paths(eager.params), tree_paths(replayed.params)):
        assert _same(a, b)
    assert torch.equal(eager.occ_state.density_ema, replayed.occ_state.density_ema)
    assert smoke.render_graph_stats()["replays"] > 0
    clear_step_cache()
    clear_render_cache()
