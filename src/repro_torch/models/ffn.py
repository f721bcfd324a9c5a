"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper).

The port of `repro.models.ffn`, with its f32 casts: the gate and up
projections leave the matmul in the activations' dtype and are activated
in f32; the product goes back to that dtype before the down projection.
A DTensor x split along its sequence runs on each rank's local tokens
(`shards.tokens`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers, shards


def init_ffn(generator, d_model: int, d_ff: int, act: str, dtype, device=None) -> dict:
    init = lambda shape: layers.normal_init(generator, shape, dtype=dtype, device=device)  # noqa: E731
    if act == "swiglu":
        return {"w_gate": init((d_model, d_ff)), "w_up": init((d_model, d_ff)),
                "w_down": init((d_ff, d_model))}
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)  # noqa: E731
    return {"w_up": init((d_model, d_ff)), "b_up": zeros(d_ff),
            "w_down": init((d_ff, d_model)), "b_down": zeros(d_model)}


def ffn(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    ranks = shards.tokens(x)
    x = shards.enter(ranks, x)
    mm = lambda a, w: shards.mm(ranks, a, params[w])  # noqa: E731
    if act == "swiglu":
        g = F.silu(mm(x, "w_gate").to(torch.float32))
        u = mm(x, "w_up").to(torch.float32)
        return shards.leave(ranks, mm((g * u).to(x.dtype), "w_down"))
    h = F.gelu((mm(x, "w_up") + shards.param(ranks, params["b_up"])).to(torch.float32),
               approximate="tanh")
    return shards.leave(ranks, mm(h.to(x.dtype), "w_down") + shards.param(ranks, params["b_down"]))
