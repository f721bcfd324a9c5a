"""Kernel #1's corner-index arithmetic in 32 bits (csrc/hash_encode.cu).

The kernel computes each corner's table row in 32-bit integers: the spatial
hash in uint32, the dense index in uint32 then cast to int32 and clamped
into [0, T-1], as the TPU kernel does (`corner_indices_block`).  This file
writes that arithmetic out in torch int32 ops (an int32 multiply wraps as a
uint32 one does; pi2 is taken as its int32 bit pattern) and holds it equal,
index for index, to the JAX reference's `corner_index` (clamped as JAX's
gather clamps) and to the port's int64 plain version (`ref.level_indices`),
at every level of `FieldConfig()` (both grids) and of
`FieldConfig(decomposed=False)`, on uniform points, points at 1 - 1e-6 in
each coordinate, the cube's corners and sentinel rows (x < 0: row 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hash_encode import ref as jax_ref
from repro_torch.core.field import Field, FieldConfig
from repro_torch.kernels.hash_encode import ref as he_ref

PI2_I32 = 2654435761 - (1 << 32)
PI3_I32 = 805459861


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel_indices(points: torch.Tensor, resolution: int, table_size: int,
                    dense: bool) -> torch.Tensor:
    """(N, 8) int32 rows as the kernel computes them."""
    scaled = points.to(torch.float32) * resolution
    base = torch.floor(scaled).to(torch.int32)
    cid = torch.arange(8, dtype=torch.int32)
    offs = torch.stack([cid & 1, (cid >> 1) & 1, (cid >> 2) & 1], dim=-1)
    c = base[:, None, :] + offs[None]
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    if dense:
        stride = torch.tensor(resolution + 1, dtype=torch.int32)
        idx = torch.clamp(cx + cy * stride + cz * (stride * stride), 0, table_size - 1)
    else:
        idx = (cx ^ (cy * PI2_I32) ^ (cz * PI3_I32)) & (table_size - 1)
    assert idx.dtype == torch.int32
    return torch.where((points[:, 0] >= 0.0)[:, None], idx, torch.zeros_like(idx))


def _points() -> torch.Tensor:
    rng = np.random.default_rng(0)
    edge = 1.0 - 1e-6
    pts = [rng.uniform(0.0, edge, size=(2000, 3)),
           [[edge, 0.3, 0.7], [0.2, edge, 0.4], [0.6, 0.1, edge], [edge, edge, edge],
            [0.0, 0.0, 0.0], [0.0, edge, 0.0], [-1.0, -1.0, -1.0], [-1.0, 0.5, 0.5]]]
    return torch.from_numpy(np.concatenate(pts).astype(np.float32))


def _grids():
    out = []
    for cfg in (FieldConfig(), FieldConfig(decomposed=False)):
        field = Field(cfg)
        encs = [field.density_enc] + ([field.color_enc] if cfg.decomposed else [])
        out += [(f"{'I3D' if cfg.decomposed else 'NGP'} {name}", e)
                for name, e in zip(("density", "color"), encs)]
    return out


@pytest.mark.parametrize("name,enc", _grids(), ids=[g[0] for g in _grids()])
def test_32bit_corner_index_is_the_reference_index(name, enc):
    pts = _points()
    valid = (pts[:, 0] >= 0.0)[:, None]
    size = enc.cfg.table_size
    for res, dense in zip(enc.resolutions, enc.dense_flags):
        res, dense = int(res), bool(dense)
        got = _kernel_indices(pts, res, size, dense)
        corners, _ = jax_ref._level_corners(jnp.asarray(pts.numpy()), res)
        want_jax = np.clip(np.asarray(jax_ref.corner_index(corners, res, size, dense)), 0, size - 1)
        want_jax = torch.where(valid, torch.from_numpy(want_jax.astype(np.int64)), 0)
        want_port, _ = he_ref.level_indices(pts, res, size, dense)
        assert torch.equal(got.to(torch.int64), want_jax), (name, res)
        assert torch.equal(got.to(torch.int64), want_port), (name, res)
        assert int(got.min()) >= 0 and int(got.max()) < size
