"""chatglm3-6b [dense] — 28L d4096 32H (GQA kv 2) ff13696 vocab 65024, 2D RoPE.
[arXiv:2406.12793]"""
import dataclasses
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=65024, rope="rope2d", qkv_bias=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, dtype="float32", remat=False,
    )
