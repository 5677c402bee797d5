"""Model configuration dataclasses (the port's own copy of
``repro/configs/base.py``, model part only).

Every field keeps the reference's name and default so a config built here
describes the same model as the reference's.  Training, shape and mesh
configs and the TPU roofline constants are not copied: the serving slice
does not read them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    expert_ffn_dim: int = 0
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3
    aux_loss_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # 'dense' | 'moe' | 'hybrid' | 'ssm' | 'audio' | 'vlm'
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    max_seq_len: int = 8192

    attention: str = "gqa"           # 'mha' | 'gqa' | 'mla' | 'none'
    activation: str = "swiglu"       # 'gelu' | 'swiglu'
    norm: str = "rmsnorm"            # 'layernorm' | 'rmsnorm'
    position: str = "rope"           # 'absolute' | 'rope' | 'mrope' | 'none'
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qk_norm: bool = False

    # Cyclic sliding-window sizes over layers; 0 = global attention.
    window_pattern: Tuple[int, ...] = (0,)

    moe: Optional[MoEConfig] = None
    moe_pattern: Tuple[bool, ...] = (True,)

    block_pattern: Tuple[str, ...] = ("attn",)
    ssm: Optional[SSMConfig] = None

    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    frontend: str = "none"
    num_frontend_embeds: int = 0

    mla_kv_lora_rank: int = 0
    mla_q_lora_rank: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm is None and any(b == "mamba" for b in self.block_pattern):
            object.__setattr__(self, "ssm", SSMConfig())

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_window(self, layer_idx: int) -> int:
        return self.window_pattern[layer_idx % len(self.window_pattern)]

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return self.moe_pattern[layer_idx % len(self.moe_pattern)]

    def layer_kind(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    @property
    def pattern_period(self) -> int:
        """Length of the cyclic layer pattern — the stacked unit
        ('super-block')."""
        p = 1
        for n in (len(self.window_pattern), len(self.moe_pattern),
                  len(self.block_pattern)):
            p = p * n // math.gcd(p, n)
        return p

    def with_depth(self, num_layers: int) -> "ModelConfig":
        """Same architecture at a different depth (progressive training)."""
        if num_layers % self.pattern_period and num_layers > 0:
            raise ValueError(
                f"{self.name}: depth {num_layers} not a multiple of the "
                f"layer-pattern period {self.pattern_period}")
        return dataclasses.replace(self, num_layers=num_layers)
