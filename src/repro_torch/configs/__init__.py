"""Architecture registry: `get_config(name)`, `get_smoke_config(name)`,
`list_archs()` -- the port's copy of `repro.configs`, pure data; the shape
suites and their meta-device batches are `configs.shapes`."""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = [
    "qwen1_5-0_5b", "qwen3-8b", "yi-9b", "chatglm3-6b",
    "deepseek-v2-lite-16b", "deepseek-v3-671b",
    "whisper-medium", "qwen2-vl-2b", "zamba2-7b", "falcon-mamba-7b",
]

_ALIASES = {
    "qwen1.5-0.5b": "qwen1_5-0_5b",
}

_MODULES = {
    "qwen1_5-0_5b": "qwen1_5_05b",
    "qwen3-8b": "qwen3_8b",
    "yi-9b": "yi_9b",
    "chatglm3-6b": "chatglm3_6b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "deepseek-v3-671b": "deepseek_v3",
    "whisper-medium": "whisper_medium",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "zamba2-7b": "zamba2_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}


def get_config(name: str, **overrides) -> ModelConfig:
    name = _ALIASES.get(name, name)
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    cfg: ModelConfig = mod.config()
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    name = _ALIASES.get(name, name)
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.smoke_config()


def list_archs():
    return list(ARCHS)
