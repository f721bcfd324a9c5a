"""Plain PyTorch version of the small NeRF MLPs (Instant-NGP step 3-2).

The density head is one hidden ReLU layer (L*F -> 64 -> 16, output 0 is the
density logit); the color head two hidden layers (L*F + 16 -> 64 -> 64 -> 3).
Weights are in the reference's (d_in, d_out) layout: ``x @ W + b``.  The
ReLU is the reference's ``maximum(z, 0)``, whose gradient at z == 0 is 1/2
in both frameworks (torch.relu's would be 0).
"""
from __future__ import annotations

import torch


def _relu(z):
    return torch.maximum(z, z.new_zeros(()))


def mlp2(x, w1, b1, w2, b2):
    """x (N, Din) -> relu(x @ w1 + b1) @ w2 + b2, f32."""
    h = _relu(x.to(torch.float32) @ w1.to(torch.float32) + b1)
    return h @ w2.to(torch.float32) + b2


def mlp3(x, w1, b1, w2, b2, w3, b3):
    """Two hidden ReLU layers, then a linear head."""
    h1 = _relu(x.to(torch.float32) @ w1.to(torch.float32) + b1)
    h2 = _relu(h1 @ w2.to(torch.float32) + b2)
    return h2 @ w3.to(torch.float32) + b3
