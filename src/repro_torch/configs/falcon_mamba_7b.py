"""falcon-mamba-7b [ssm] — 64 Mamba-1 layers d4096 (attention-free),
ssm_state 16, vocab 65024. [arXiv:2410.05355]"""
import dataclasses
from ..models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=65024,
        ssm=SSMConfig(kind="mamba1", d_state=16, d_conv=4, expand=2),
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=3, d_model=64, vocab=256, dtype="float32", remat=False,
        ssm=SSMConfig(kind="mamba1", d_state=8, d_conv=4, expand=2, chunk=8),
    )
