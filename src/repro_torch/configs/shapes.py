"""The four input-shape suites and `input_specs()`: the port of
`repro.configs.shapes`, with meta-device tensors where the reference has
`jax.ShapeDtypeStruct`s (shapes and dtypes only, nothing allocated).

    train_4k      seq 4096,    global_batch 256   -> train_step
    prefill_32k   seq 32768,   global_batch 32    -> prefill (serve)
    decode_32k    seq 32768,   global_batch 128   -> decode_step (1 new token,
                                                     KV cache of seq_len)
    long_500k     seq 524288,  global_batch 1     -> decode_step; SSM/hybrid only

long_500k is skipped for the pure full-attention archs; every arch here
has a decode step.  Whisper's audio stub feeds `encoder_embeds` (B,
encoder_seq, d_model) bf16 beside the tokens to train and prefill, and
`encoder_out` of that shape beside the caches to decode.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import ModelConfig
from ..models.lm import LM


@dataclass(frozen=True)
class Shape:
    name: str
    seq: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 0.5M-token dense KV decode is "
                       "quadratic-cost; skipped per assignment rules (DESIGN.md §5)")
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    """The meta-device batch for the step function of `shape.kind`."""
    b, s = shape.global_batch, shape.seq
    d = cfg.d_model
    if shape.kind == "train":
        batch = {"tokens": _spec((b, s), torch.int32)}
        if cfg.frontend == "vision_stub":
            batch["embeds"] = _spec((b, s, d), torch.bfloat16)
            batch["positions"] = _spec((3, b, s), torch.int32)
        elif cfg.frontend == "audio_stub":
            batch["encoder_embeds"] = _spec((b, cfg.encoder_seq, d), torch.bfloat16)
        return batch
    if shape.kind == "prefill":
        batch = {}
        if cfg.frontend == "vision_stub":
            batch["embeds"] = _spec((b, s, d), torch.bfloat16)
            batch["positions"] = _spec((3, b, s), torch.int32)
        else:
            batch["tokens"] = _spec((b, s), torch.int32)
        if cfg.frontend == "audio_stub":
            batch["encoder_embeds"] = _spec((b, cfg.encoder_seq, d), torch.bfloat16)
        return batch
    # decode: one token + caches sized seq
    batch = {
        "tokens": _spec((b, 1), torch.int32),
        "pos": _spec((b, 1), torch.int32),
        "caches": LM(cfg, device="meta").init_caches(b, s),
    }
    if cfg.enc_dec:
        batch["encoder_out"] = _spec((b, cfg.encoder_seq, d), torch.bfloat16)
    return batch
