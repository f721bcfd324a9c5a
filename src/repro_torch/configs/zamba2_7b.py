"""zamba2-7b [hybrid] — 81 Mamba-2 layers d3584 + weight-shared full-attention
block (32H) every 6 layers, ff14336 shared-block MLP, ssm_state 64,
vocab 32000. [arXiv:2411.15242]"""
import dataclasses
from ..models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab=32000,
        ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2, headdim=64),
        hybrid_attn_every=6, supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, dtype="float32", remat=False,
        ssm=SSMConfig(kind="mamba2", d_state=16, d_conv=4, expand=2, headdim=16, chunk=8),
        hybrid_attn_every=2,
    )
