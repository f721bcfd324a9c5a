"""qwen2-vl-2b [vlm] — 28L d1536 12H (GQA kv 2) ff8960 vocab 151936, M-RoPE,
vision frontend stubbed (input_specs provides patch embeddings + 3D position
ids for dynamic resolution). [arXiv:2409.12191]"""
import dataclasses
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, qkv_bias=True, rope="mrope",
        mrope_sections=(16, 24, 24), rope_theta=1e6, tie_embeddings=True,
        frontend="vision_stub",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, mrope_sections=(4, 2, 2), dtype="float32", remat=False,
    )
