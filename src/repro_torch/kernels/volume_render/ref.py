"""Plain PyTorch version of volume-rendering composition (paper Eq. 1).

Given per-sample densities sigma_k, colors c_k and segment widths delta_k:

    alpha_k = 1 - exp(-sigma_k * delta_k)
    T_k     = exp(-sum_{j<k} sigma_j * delta_j)      (transmittance)
    w_k     = T_k * alpha_k,   C = sum_k w_k c_k

plus depth (sum w_k t_k) and opacity (sum w_k).  delta_k is per sample, so
the redistributed sampler's variable widths go through the same function.

`composite_backward` is the plain version of the CUDA backward kernel: the
closed form of the composite's vector-Jacobian product.  With upstream
gradients g_color, g_depth, g_opacity and v_k = g_color . c_k + g_depth t_k
+ g_opacity, tau_k = sigma_k delta_k and S_{>k} = sum_{j>k} w_j v_j:

    dL/dtau_k = v_k T_k exp(-tau_k) - S_{>k}
    d_sigma = delta dL/dtau,  d_delta = sigma dL/dtau,
    d_rgb = w g_color,        d_t = w g_depth

(w_k depends on tau_k through alpha_k, and every later w_j through T_j).
S_{>k} is a reversed cumulative sum shifted by one sample, not a total less
a prefix, which would cancel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RenderOut(NamedTuple):
    color: torch.Tensor            # (R, 3)
    depth: torch.Tensor            # (R,)
    opacity: torch.Tensor          # (R,)
    weights: torch.Tensor | None   # (R, S); None from the CUDA kernel


def uniform_deltas(ts: torch.Tensor, span: float) -> torch.Tensor:
    """Uniform-sampler segment widths: diff(ts), the last sample padded with
    the mean stratum width span/S.  ts (R, S), span = far - near."""
    s = ts.shape[-1]
    return torch.diff(ts, dim=-1, append=ts[..., -1:] + span / s)


def composite(sigma: torch.Tensor, rgb: torch.Tensor, deltas: torch.Tensor,
              ts: torch.Tensor) -> RenderOut:
    """sigma (R, S), rgb (R, S, 3), deltas (R, S), ts (R, S) -> RenderOut,
    in f32 (in f64 where sigma is f64: the tests' exact reference)."""
    dtype = torch.promote_types(sigma.dtype, torch.float32)
    tau = sigma.to(dtype) * deltas.to(dtype)
    cum = torch.cumsum(tau, dim=-1)
    transmittance = torch.exp(-(cum - tau))     # exclusive cumsum: T_k
    alpha = 1.0 - torch.exp(-tau)
    weights = transmittance * alpha
    color = torch.sum(weights[..., None] * rgb.to(dtype), dim=-2)
    depth = torch.sum(weights * ts.to(dtype), dim=-1)
    opacity = torch.sum(weights, dim=-1)
    return RenderOut(color, depth, opacity, weights)


def composite_backward(sigma: torch.Tensor, rgb: torch.Tensor, deltas: torch.Tensor,
                       ts: torch.Tensor, g_color: torch.Tensor, g_depth: torch.Tensor,
                       g_opacity: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The composite's inputs and upstream gradients g_color (R, 3), g_depth
    and g_opacity (R,) -> (d_sigma (R, S), d_rgb (R, S, 3), d_deltas (R, S),
    d_ts (R, S)), in the dtype `composite` computes in."""
    dtype = torch.promote_types(sigma.dtype, torch.float32)
    sigma, deltas = sigma.to(dtype), deltas.to(dtype)
    tau = sigma * deltas
    cum = torch.cumsum(tau, dim=-1)
    transmittance = torch.exp(-(cum - tau))
    e = torch.exp(-tau)
    weights = transmittance * (1.0 - e)
    v = (torch.sum(rgb.to(dtype) * g_color[:, None, :], dim=-1)
         + ts.to(dtype) * g_depth[:, None] + g_opacity[:, None])
    suffix = torch.flip(torch.cumsum(torch.flip(weights * v, (-1,)), dim=-1), (-1,))
    later = torch.cat([suffix[:, 1:], torch.zeros_like(suffix[:, :1])], dim=-1)
    g_tau = v * transmittance * e - later
    return (deltas * g_tau, weights[..., None] * g_color[:, None, :], sigma * g_tau,
            weights * g_depth[:, None])
