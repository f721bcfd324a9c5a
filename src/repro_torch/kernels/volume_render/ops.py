"""Public volume-rendering composite: device dispatch.

A CUDA tensor goes to the CUDA kernel, which returns `RenderOut` with
``weights=None`` (the kernel never materialises them, as the Pallas kernel
did not); a CPU tensor goes to the plain version, which returns the weights
too.  Forward only.
"""
from __future__ import annotations

from . import kernel, ref


def composite(sigma, rgb, deltas, ts) -> ref.RenderOut:
    if sigma.device.type == "cuda":
        color, depth, opacity = kernel.composite(sigma, rgb, deltas, ts)
        return ref.RenderOut(color, depth, opacity, None)
    if sigma.device.type != "cpu":
        raise ValueError(f"composite: no route for device {sigma.device}")
    return ref.composite(sigma, rgb, deltas, ts)
