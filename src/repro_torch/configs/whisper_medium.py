"""whisper-medium [audio] — enc-dec 24+24L d1024 16H ff4096 vocab 51865,
GELU + LayerNorm, conv frontend stubbed (input_specs provides frame
embeddings). [arXiv:2212.04356]"""
import dataclasses
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=51865, norm="layernorm", act="gelu", rope="none",
        qkv_bias=True, enc_dec=True, n_encoder_layers=24, encoder_seq=1500,
        frontend="audio_stub",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, encoder_seq=32,
        dtype="float32", remat=False,
    )
