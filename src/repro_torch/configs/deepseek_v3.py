"""deepseek-v3-671b [moe] — 61L d7168 128H, MLA (kv_lora 512, q_lora 1536),
1 shared + 256 routed top-8 (d_ff_expert 2048), first 3 layers dense
(d_ff 18432), sigmoid scoring, MTP depth 1, vocab 129280. [arXiv:2412.19437]"""
import dataclasses
from ..models.config import ModelConfig, MoEConfig, MLAConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=2048, vocab=129280,
        mla=MLAConfig(kv_lora=512, q_lora=1536, d_nope=128, d_rope=64, d_v=128),
        moe=MoEConfig(n_routed=256, n_shared=1, top_k=8, d_expert_ff=2048,
                      n_dense_layers=3, dense_d_ff=18432, score="sigmoid",
                      route_scale=2.5,
                      # 256-way EP over (data x model): one expert per device,
                      # expert weights never gathered (EXPERIMENTS.md §Perf)
                      ep_axes=("data", "model")),
        mtp_depth=1,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab=256, dtype="float32", remat=False,
        mla=MLAConfig(kv_lora=32, q_lora=48, d_nope=16, d_rope=8, d_v=16),
        moe=MoEConfig(n_routed=8, n_shared=1, top_k=2, d_expert_ff=96,
                      n_dense_layers=1, dense_d_ff=256, score="sigmoid",
                      route_scale=2.5),
        mtp_depth=1,
    )
