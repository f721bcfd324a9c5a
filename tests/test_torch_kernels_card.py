"""Port kernels on the card: each CUDA kernel against its plain version.

Marked ``gpu``; each test decides inside itself whether an sm_90 card is
present and skips otherwise, so every pytest worker collects the same tests.
This file imports no JAX, so it runs where only PyTorch and CUDA are
installed.  Run on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_card.py``.

Tolerances (max abs error): hash encode 1e-5 (8-corner sums of table values
in [-1, 1], FMA-contracted in the kernel), MLPs 1e-5 (O(1) outputs),
composite 5e-5 (48-term depth sums with t up to 6).
"""
import ctypes

import pytest
import torch

from repro_torch import kernels
from repro_torch.core.field import Field, FieldConfig
from repro_torch.kernels.fused_mlp import kernel as mlp_kernel
from repro_torch.kernels.fused_mlp import ops as mlp_ops
from repro_torch.kernels.fused_mlp import ref as mlp_ref
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


@pytest.mark.gpu
@pytest.mark.parametrize("r,s", [(4096, 48), (4096, 12), (77, 5)])
def test_composite_kernel_matches_plain(r, s, card):
    gen = torch.Generator().manual_seed(r + s)
    sigma = _u(gen, (r, s), 0, 20, card)
    rgb = _u(gen, (r, s, 3), 0, 1, card)
    ts = torch.sort(_u(gen, (r, s), 2, 6, card), dim=-1).values
    deltas = torch.diff(ts, dim=-1, append=ts[:, -1:] + 4.0 / s)
    before = kernels.LAUNCHES["composite"]
    got = vr_ops.composite(sigma, rgb, deltas, ts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["composite"] == before + 1 and got.weights is None
    want = vr_ref.composite(sigma, rgb, deltas, ts)
    for g, w in zip(got[:3], want[:3]):
        assert float((g - w).abs().max()) <= 5e-5


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
