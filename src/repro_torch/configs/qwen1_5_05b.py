"""qwen1.5-0.5b [dense] — 24L d1024 16H (kv 16) ff2816 vocab 151936, QKV bias.
[hf:Qwen/Qwen1.5-0.5B]"""
import dataclasses
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1_5-0_5b", family="dense",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=2816, vocab=151936, qkv_bias=True, tie_embeddings=True,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, dtype="float32", remat=False,
    )
