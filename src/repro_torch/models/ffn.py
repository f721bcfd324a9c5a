"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper).

The port of `repro.models.ffn`, with its f32 casts: the gate and up
projections leave the matmul in the activations' dtype and are activated
in f32; the product goes back to that dtype before the down projection.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers


def init_ffn(generator, d_model: int, d_ff: int, act: str, dtype, device=None) -> dict:
    init = lambda shape: layers.normal_init(generator, shape, dtype=dtype, device=device)  # noqa: E731
    if act == "swiglu":
        return {"w_gate": init((d_model, d_ff)), "w_up": init((d_model, d_ff)),
                "w_down": init((d_ff, d_model))}
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)  # noqa: E731
    return {"w_up": init((d_model, d_ff)), "b_up": zeros(d_ff),
            "w_down": init((d_ff, d_model)), "b_down": zeros(d_model)}


def ffn(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        g = F.silu((x @ params["w_gate"]).to(torch.float32))
        u = (x @ params["w_up"]).to(torch.float32)
        return (g * u).to(x.dtype) @ params["w_down"]
    h = F.gelu((x @ params["w_up"] + params["b_up"]).to(torch.float32), approximate="tanh")
    return h.to(x.dtype) @ params["w_down"] + params["b_down"]
