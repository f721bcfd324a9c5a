"""Model configuration dataclasses for the architecture zoo (the port's copy of
`repro.models.config`, field for field)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert_ff: int
    n_dense_layers: int = 0          # leading layers with a dense FFN
    dense_d_ff: int = 0              # their hidden size (0 = use model d_ff)
    score: str = "softmax"           # softmax | sigmoid (deepseek-v3)
    route_scale: float = 1.0
    ep_axis: Optional[str] = "model" # expert-parallel mesh axis (None = dense path)
    # EP may span multiple mesh axes (deepseek-v3: ('data','model') = 256-way,
    # one expert per device — kills the FSDP all-gather of expert weights)
    ep_axes: tuple = ("model",)


@dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 0                  # 0 => direct q projection (v2-lite)
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba1"             # mamba1 | mamba2
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64                # mamba2 head dim
    dt_rank: int = 0                 # mamba1: 0 => d_model // 16
    chunk: int = 128                 # chunked-scan block length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 => d_model // n_heads
    # attention flavor
    qkv_bias: bool = False
    qk_norm: bool = False
    rope: str = "standard"           # standard | rope2d | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    # block flavor
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0       # zamba2: shared attn block every k layers
    mtp_depth: int = 0               # deepseek-v3 multi-token prediction heads
    # encoder-decoder
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper audio frames after conv stub
    frontend: str = "none"           # none | audio_stub | vision_stub
    # numerics / training
    dtype: str = "bfloat16"
    remat: bool = True
    # BUM-merged vocab-embedding gradients.  Off by default for LMs, as in
    # the reference: under data parallelism the global sort in the merge
    # must see every token's (tokens x d_model) f32 update.  In the port
    # the merge is also the exact, run-to-run identical route on a card
    # (the naive index_add_ uses float atomics there).
    dedup_embed_grad: bool = False
    # the reference's switch to python-loop its layer stack instead of
    # lax.scan (its dry-run's per-layer cost probes); the port always loops
    unroll_layers: bool = False
    # which shape suites apply (assignment rules)
    supports_long_context: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6·N·D)."""
        from . import counting
        return counting.param_count(self)

    def active_param_count(self) -> int:
        from . import counting
        return counting.active_param_count(self)
