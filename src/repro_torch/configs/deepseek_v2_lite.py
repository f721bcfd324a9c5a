"""deepseek-v2-lite-16b [moe] — 27L d2048 16H, MLA kv_lora 512,
64 routed + 2 shared top-6 experts (d_ff_expert 1408), first layer dense
(d_ff 10944), vocab 102400.  [arXiv:2405.04434]

Note: assignment line also says "160 routed" — that is DeepSeek-V2 (236B);
the Lite config per the HF release is 64 routed, which matches the primary
"MoE 64e top-6" spec.  See DESIGN.md §5.
"""
import dataclasses
from ..models.config import ModelConfig, MoEConfig, MLAConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=102400,
        mla=MLAConfig(kv_lora=512, q_lora=0, d_nope=128, d_rope=64, d_v=128),
        moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert_ff=1408,
                      n_dense_layers=1, dense_d_ff=10944),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab=256, dtype="float32", remat=False,
        mla=MLAConfig(kv_lora=32, q_lora=0, d_nope=16, d_rope=8, d_v=16),
        moe=MoEConfig(n_routed=8, n_shared=2, top_k=2, d_expert_ff=96,
                      n_dense_layers=1, dense_d_ff=256),
    )
