"""yi-9b [dense] — 48L d4096 32H (GQA kv 4) ff11008 vocab 64000, llama arch.
[arXiv:2403.04652]"""
import dataclasses
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b", family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab=64000,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, dtype="float32", remat=False,
    )
