"""Model and training configuration dataclasses (the port's own copy of
``repro/configs/base.py``: the model, optimizer, schedule, expansion and
training configs).

Every field keeps the reference's name and default so a config built here
describes the same model and run as the reference's.  The dry run's shape
cells (``ShapeConfig``, ``SHAPES``) are the reference's; the hardware
constants are the H100's, where the reference's are a TPU v5e's.
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

    def param_count(self, active_only: bool = False) -> int:
        """The reference's analytic count (``repro/configs/base.py``), in
        its terms: eq (1.1)'s N (``core.mixing.compute_savings``).  RWKV6
        layers are counted coarsely there and here alike."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        embed = V * D
        head = 0 if self.tie_embeddings else V * D
        per_layer_attn = (D * self.q_dim + 2 * D * self.kv_dim
                          + self.q_dim * D)
        if self.attention == "mla" and self.mla_kv_lora_rank:
            r = self.mla_kv_lora_rank
            per_layer_attn = (D * r + r * 2 * self.kv_dim + D * self.q_dim
                              + self.q_dim * D)
        n_ff_mats = 3 if self.activation == "swiglu" else 2
        dense_mlp = n_ff_mats * D * F

        total = embed + head
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                total += per_layer_attn
            else:  # mamba
                s = self.ssm
                d_inner = s.expand * D
                dt_rank = s.dt_rank or -(-D // 16)
                total += (2 * D * d_inner + s.d_conv * d_inner
                          + d_inner * (dt_rank + 2 * s.d_state)
                          + dt_rank * d_inner + d_inner * D)
            if self.layer_is_moe(i):
                m = self.moe
                ef = m.expert_ffn_dim or F
                n_e = m.num_experts if not active_only else m.top_k
                total += n_e * n_ff_mats * D * ef
                total += m.num_shared_experts * n_ff_mats * D * ef
                total += D * m.num_experts  # router
            elif kind == "attn":
                total += dense_mlp
            total += 2 * D  # norms
        if self.is_encoder_decoder:
            total += self.num_encoder_layers * (per_layer_attn * 2
                                                + dense_mlp + 3 * D)
        return total


# ---------------------------------------------------------------------------
# Training / progressive-plan configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "muon_nsgd"          # 'muon_nsgd' | 'adamw' | 'nsgd' | 'sgd'
    learning_rate: float = 0.01
    weight_decay: float = 0.01
    momentum: float = 0.95
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    ns_steps: int = 5
    mup: bool = True                 # muP-scale per-tensor LRs
    grad_clip: float = 0.0           # 0 disables (paper: no clipping)


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    name: str = "wsd"                # 'wsd' | 'cosine' | 'constant'
    warmup_frac: float = 0.02
    decay_frac: float = 0.2          # WSD decay tail (paper default 20%)
    min_lr_frac: float = 0.0


@dataclasses.dataclass(frozen=True)
class ExpansionConfig:
    """One expansion event in a progressive plan."""
    at_frac: float                   # τ/T
    target_layers: int
    init: str = "random"             # 'random' | 'copying_stack' | 'copying_inter'
                                     # | 'copying_last' | 'zero' | 'copying_zeroL'
                                     # | 'copying_zeroN'
    insert_at: str = "bottom"        # 'bottom' | 'top'  (paper A.3: bottom best)
    opt_state_policy: str = "inherit"  # 'inherit' | 'copy' | 'reset'


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 1000
    seq_len: int = 1024
    global_batch: int = 512
    grad_accum: int = 1              # microbatches per step: global_batch is
                                     # split into grad_accum microbatches and
                                     # gradients averaged
    source_layers: int = 1           # zero/one-layer source model
    expansions: Tuple[ExpansionConfig, ...] = ()
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    eval_every: int = 50
    eval_batches: int = 4
    seed: int = 0
    dtype: str = "float32"           # compute dtype
    # Activation checkpointing per super-block: False (off), True /
    # 'nothing' (recompute everything) or 'dots' (keep matmul outputs).
    remat: "bool | str" = False
    log_every: int = 10


# ---------------------------------------------------------------------------
# Input shapes (the reference's shape set for the LM family)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# H100 hardware model (roofline constants): NVIDIA's H100 SXM5 data sheet,
# at its 700 W power limit, dense rates (no sparsity).
HW_PEAK_F32_FLOPS = 67e12     # FLOP/s, float32 on the CUDA cores
HW_PEAK_TF32_FLOPS = 495e12   # FLOP/s, TF32 on the tensor cores
HW_PEAK_BF16_FLOPS = 989e12   # FLOP/s, bf16/fp16 on the tensor cores
HW_HBM_BW = 3.35e12           # bytes/s of HBM3
HW_HBM_BYTES = 80e9           # HBM capacity, bytes
# bytes/s of one card's link off its node: the 400 Gb/s NDR InfiniBand
# port of each card in a DGX H100.  At the 16x16 and 2x16x16 meshes every
# axis spans nodes of 8 cards, so the slowest link sets each collective.
HW_LINK_BW = 50e9
