"""Plain PyTorch version of volume-rendering composition (paper Eq. 1).

Given per-sample densities sigma_k, colors c_k and segment widths delta_k:

    alpha_k = 1 - exp(-sigma_k * delta_k)
    T_k     = exp(-sum_{j<k} sigma_j * delta_j)      (transmittance)
    w_k     = T_k * alpha_k,   C = sum_k w_k c_k

plus depth (sum w_k t_k) and opacity (sum w_k).  delta_k is per sample, so
the redistributed sampler's variable widths go through the same function.
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
    """sigma (R, S), rgb (R, S, 3), deltas (R, S), ts (R, S) -> RenderOut."""
    tau = sigma.to(torch.float32) * deltas.to(torch.float32)
    cum = torch.cumsum(tau, dim=-1)
    transmittance = torch.exp(-(cum - tau))     # exclusive cumsum: T_k
    alpha = 1.0 - torch.exp(-tau)
    weights = transmittance * alpha
    color = torch.sum(weights[..., None] * rgb.to(torch.float32), dim=-2)
    depth = torch.sum(weights * ts.to(torch.float32), dim=-1)
    opacity = torch.sum(weights, dim=-1)
    return RenderOut(color, depth, opacity, weights)
