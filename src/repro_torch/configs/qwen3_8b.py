"""qwen3-8b [dense] — 36L d4096 32H (GQA kv 8) ff12288 vocab 151936, qk_norm.
[hf:Qwen/Qwen3-8B]"""
import dataclasses
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=12288, vocab=151936, qk_norm=True, rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, dtype="float32", remat=False,
    )
