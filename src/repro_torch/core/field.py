"""Radiance fields: the Instant-3D decomposition and the Instant-NGP baseline.

The port of `repro.core.field`.  Instant-3D (paper section 3, Fig. 6)
splits the grid into a density grid (density MLP -> sigma) and a smaller
color grid (color grid + SH(dir) -> color MLP -> rgb); with
``decomposed=False`` one grid feeds both heads (Instant-NGP).  `init` builds
a plain dict of tensors with the JAX package's keys and layout; `query`
maps (params, points, dirs) -> (sigma, rgb), differentiable in the params;
`query_fused` encodes every grid in one fused pass (kernel #8, in-block
deduplicated reads) before the MLP heads; `query_step` runs the whole shade
stage as the one-op fused step, and falls back to `query_fused` for the
Instant-NGP baseline.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import encoding as enc
from ..kernels.fused_mlp import ops as mlp_ops
from ..kernels.fused_path import ops as fp_ops
from ..kernels.fused_step import ops as fs_ops
from ..optim.adamw import tree_paths


class _TruncExp(torch.autograd.Function):
    """exp(clip(x, -15, 11)) whose gradient is g * exp(clip(x, -15, 11))
    everywhere -- the reference's custom VJP, not the clip's zero gradient
    outside [-15, 11]."""

    @staticmethod
    def forward(ctx, x):
        out = torch.exp(torch.clamp(x, -15.0, 11.0))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g * out


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """Density activation: exp of x clipped to [-15, 11]."""
    return _TruncExp.apply(x)


# The tables' element types the kernels take, by `FieldConfig.grid_dtype`
# (the float dtypes of the reference's jnp.dtype(cfg.grid_dtype) cast).
GRID_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}


@dataclass(frozen=True)
class FieldConfig:
    # grid geometry (shared by both branches; table sizes differ)
    n_levels: int = 16
    n_features: int = 2
    base_resolution: int = 16
    max_resolution: int = 1024
    # Instant-3D: S_D : S_C = 1 : 0.25 -> color table 4x smaller (section 5.1)
    log2_table_density: int = 18
    log2_table_color: int = 16
    decomposed: bool = True         # False => Instant-NGP baseline
    # MLPs (Instant-NGP sizes: <= 3 layers, 64 hidden)
    hidden: int = 64
    geo_features: int = 15          # density MLP extra outputs
    sh_degree: int = 4
    # the table-gradient commit: merged (BUM, deterministic) or the flagged
    # unmerged path (index_add_, atomics on a card)
    merged_backward: bool = True
    # the hash tables' element type: "float32", "bfloat16" or "float16" (the
    # kernels read the 2-byte rows themselves; table gradients leave in it;
    # the MLPs and the optimizer's moments stay f32)
    grid_dtype: str = "float32"
    # what the fused ops and the MLP heads keep between forward and backward
    # on the plain route: "recompute" re-derives it in the backward, "stash"
    # keeps it (bit-identical gradients); the card's kernels recompute
    residual_policy: str = "recompute"

    def __post_init__(self):
        if self.grid_dtype not in GRID_DTYPES:
            raise ValueError(f"grid_dtype must be one of {tuple(GRID_DTYPES)}, "
                             f"got {self.grid_dtype!r}")

    @property
    def table_dtype(self) -> torch.dtype:
        return GRID_DTYPES[self.grid_dtype]

    def grid_cfg(self, branch: str) -> enc.HashGridConfig:
        log2_t = self.log2_table_density if branch == "density" else self.log2_table_color
        return enc.HashGridConfig(
            n_levels=self.n_levels,
            n_features=self.n_features,
            log2_table_size=log2_t,
            base_resolution=self.base_resolution,
            max_resolution=self.max_resolution,
            merged_backward=self.merged_backward,
        )


def _init_linear(generator: torch.Generator, d_in: int, d_out: int, device):
    """He-uniform weights (d_in, d_out) and zero biases, as tiny-cuda-nn."""
    bound = (6.0 / d_in) ** 0.5
    u = torch.rand((d_in, d_out), generator=generator, device=generator.device)
    w = (u * (2.0 * bound) - bound).to(device)
    return w, torch.zeros((d_out,), dtype=torch.float32, device=device)


class Field:
    """Shared machinery; `decomposed` switches NGP <-> Instant-3D."""

    def __init__(self, cfg: FieldConfig):
        self.cfg = cfg
        self.density_enc = enc.HashEncoding(cfg.grid_cfg("density"))
        self.color_enc = enc.HashEncoding(cfg.grid_cfg("color")) if cfg.decomposed else None
        self.sh_dim = enc.sh_dim(cfg.sh_degree)
        # the fused compacted-path encoder: every grid in one pass (shared
        # corner geometry, presorted BUM backward)
        sizes = [cfg.grid_cfg("density").table_size]
        if cfg.decomposed:
            sizes.append(cfg.grid_cfg("color").table_size)
        self._fused_encode = fp_ops.make_fused_encode(
            self.density_enc.resolutions, tuple(sizes), cfg.n_features,
            residual_policy=cfg.residual_policy, merged_backward=cfg.merged_backward)
        # the one-op training step (encode both grids + both MLP heads);
        # decomposed fields only, as in the reference
        self._fused_step = fs_ops.make_fused_step(
            self.density_enc.resolutions, tuple(sizes), cfg.n_features,
            residual_policy=cfg.residual_policy, merged_backward=cfg.merged_backward,
        ) if cfg.decomposed else None

    # ---- params ----

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """Same distributions and keys as the reference's `Field.init`; the
        draws come from `generator` (a different stream than jax.random, so
        the values differ -- `repro_torch.bridge` carries JAX params over)."""
        cfg = self.cfg
        dtype = cfg.table_dtype
        enc_dim = self.density_enc.cfg.out_dim
        params = {"density_grid": self.density_enc.init(generator, device, dtype)}
        w1, b1 = _init_linear(generator, enc_dim, cfg.hidden, device)
        w2, b2 = _init_linear(generator, cfg.hidden, 1 + cfg.geo_features, device)
        params["density_mlp"] = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
        if cfg.decomposed:
            params["color_grid"] = self.color_enc.init(generator, device, dtype)
            color_in = self.color_enc.cfg.out_dim + self.sh_dim
        else:
            color_in = cfg.geo_features + self.sh_dim
        w1, b1 = _init_linear(generator, color_in, cfg.hidden, device)
        w2, b2 = _init_linear(generator, cfg.hidden, cfg.hidden, device)
        w3, b3 = _init_linear(generator, cfg.hidden, 3, device)
        params["color_mlp"] = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
        return params

    # ---- queries ----

    def density(self, params: dict, points: torch.Tensor):
        """points (N, 3) in [0, 1) -> (sigma (N,), geo (N, geo_features))."""
        h = self.density_enc(points, params["density_grid"])
        m = params["density_mlp"]
        out = mlp_ops.mlp2(h, m["w1"], m["b1"], m["w2"], m["b2"])
        return trunc_exp(out[..., 0]), out[..., 1:]

    def _mlp_heads(self, params: dict, hd: torch.Tensor, hc, dirs: torch.Tensor):
        """Encodings -> (sigma, rgb).  hd: density features (N, L*F); hc:
        color-grid features, or None for the NGP baseline (the color MLP then
        eats the density head's geo features)."""
        m = params["density_mlp"]
        policy = self.cfg.residual_policy
        out = mlp_ops.mlp2(hd, m["w1"], m["b1"], m["w2"], m["b2"], residual_policy=policy)
        sigma, geo = trunc_exp(out[..., 0]), out[..., 1:]
        cin = torch.cat([hc if hc is not None else geo,
                         enc.sh_encoding(dirs, self.cfg.sh_degree)], dim=-1)
        m = params["color_mlp"]
        raw = mlp_ops.mlp3(cin, m["w1"], m["b1"], m["w2"], m["b2"], m["w3"], m["b3"],
                           residual_policy=policy)
        return sigma, torch.sigmoid(raw)

    def query(self, params: dict, points: torch.Tensor, dirs: torch.Tensor):
        """-> (sigma (N,), rgb (N, 3)).  dirs must be unit-norm."""
        hd = self.density_enc(points, params["density_grid"])
        hc = (self.color_enc(points, params["color_grid"]) if self.cfg.decomposed
              else None)
        return self._mlp_heads(params, hd, hc, dirs)

    def query_fused(self, params: dict, points: torch.Tensor, dirs: torch.Tensor):
        """Fused compacted-path query: every grid encoded in one pass with
        shared corner geometry (kernel #8 on the card, one launch per grid),
        whose backward commits each table gradient presorted, then the MLP
        heads.  The same values and gradients as `query`; callers feed
        Morton-ordered points for the kernel's dedup."""
        if self.cfg.decomposed:
            hd, hc = self._fused_encode(points, params["density_grid"],
                                        params["color_grid"])
        else:
            (hd,) = self._fused_encode(points, params["density_grid"])
            hc = None
        return self._mlp_heads(params, hd, hc, dirs)

    def query_step(self, params: dict, points: torch.Tensor, dirs: torch.Tensor):
        """One-op query: SH(dirs), then encode(both grids) + both MLP heads in
        the fused step, then the activations -> (sigma (N,), rgb (N, 3)).
        Falls back to `query_fused` for the NGP baseline (one grid: the color
        MLP eats the density head's geo features, which only the split path
        wires), as the reference does."""
        if self._fused_step is None:
            return self.query_fused(params, points, dirs)
        sh = enc.sh_encoding(dirs, self.cfg.sh_degree)
        out, raw = self._fused_step(points, sh, params["density_grid"],
                                    params["color_grid"], params["density_mlp"],
                                    params["color_mlp"])
        return trunc_exp(out[..., 0]), torch.sigmoid(raw)

    # ---- bookkeeping ----

    def param_counts(self, params: dict) -> dict:
        """Scalars per top-level key of `params` (grids and MLPs)."""
        return {k: sum(t.numel() for _, t in tree_paths(v)) for k, v in params.items()}
