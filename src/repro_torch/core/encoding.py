"""Hash-grid encoding module + spherical-harmonics direction encoding.

The port of `repro.core.encoding`.  `HashEncoding` holds the level geometry
and routes the encode through `repro_torch.kernels.hash_encode.ops`;
Instant-3D uses two instances, a density grid and a smaller color grid,
built by `repro_torch.core.field`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.hash_encode import ops as he_ops
from ..kernels.hash_encode import ref as he_ref


@dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features: int = 2
    log2_table_size: int = 19       # T = 2^19 (Instant-NGP default)
    base_resolution: int = 16
    max_resolution: int = 2048
    merged_backward: bool = True    # BUM merge in the backward (False: index_add_)

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


class HashEncoding:
    """Multiresolution hash-grid encoding with learned tables."""

    def __init__(self, cfg: HashGridConfig):
        self.cfg = cfg
        self.resolutions = he_ref.level_resolutions(
            cfg.n_levels, cfg.base_resolution, cfg.max_resolution)
        self.dense_flags = he_ref.level_is_dense(self.resolutions, cfg.table_size)

    def init(self, generator: torch.Generator, device="cuda",
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Tables ~ U(-1e-4, 1e-4) as in Instant-NGP, drawn in f32 on the
        generator's device, cast to `dtype` (the reference's draw-then-cast)
        and moved to `device`."""
        cfg = self.cfg
        u = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_features),
                       generator=generator, device=generator.device)
        return (u * 2e-4 - 1e-4).to(dtype).to(device)

    def __call__(self, points: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
        """points (N, 3) in [0, 1) -> (N, L*F) f32."""
        return he_ops.hash_encode(points, tables, self.resolutions, self.dense_flags,
                                  merged_backward=self.cfg.merged_backward)

    @property
    def param_bytes(self) -> int:
        """Bytes of the tables (L, T, F) counted at 4 a value, whatever their
        dtype, as the reference counts them."""
        c = self.cfg
        return c.n_levels * c.table_size * c.n_features * 4


# --- spherical harmonics (degree 4 = 16 coeffs, Instant-NGP's dir encoding) ---

def sh_encoding(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real SH basis evaluated at unit directions (N, 3) -> (N, degree^2)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree > 2:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
        ]
    if degree > 3:
        out += [
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def sh_dim(degree: int) -> int:
    return degree * degree
