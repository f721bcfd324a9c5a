"""Public fused MLPs: device dispatch between kernels and plain versions.

A CUDA tensor goes to the CUDA kernel, a CPU tensor to the plain PyTorch
version; forward only (the training slice adds the backward).
"""
from __future__ import annotations

from . import kernel, ref


def _route(x, what: str) -> bool:
    """True for the kernel, False for the plain version."""
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{what}: no route for device {x.device}")
    return False


def mlp2(x, w1, b1, w2, b2):
    """x (N, Din) -> relu(x @ w1 + b1) @ w2 + b2."""
    if _route(x, "mlp2"):
        return kernel.fused_mlp2(x, w1, b1, w2, b2)
    return ref.mlp2(x, w1, b1, w2, b2)


def mlp3(x, w1, b1, w2, b2, w3, b3):
    """Two hidden ReLU layers, then a linear head."""
    if _route(x, "mlp3"):
        return kernel.fused_mlp3(x, w1, b1, w2, b2, w3, b3)
    return ref.mlp3(x, w1, b1, w2, b2, w3, b3)
