"""Reconstruction loss (paper Eq. 2) and PSNR: the port of `repro.core.losses`."""
from __future__ import annotations

import torch


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.to(torch.float32) - gt.to(torch.float32)))


def psnr_from_mse(m: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(m, min=1e-10))


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return psnr_from_mse(mse(pred, gt))
