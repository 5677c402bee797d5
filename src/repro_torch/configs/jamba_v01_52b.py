"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave (attention at
offset 4 of each 8-layer block), MoE 16e top-2 on every other layer.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=65536,
    attention="gqa", activation="swiglu", norm="rmsnorm", position="none",
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe=MoEConfig(num_experts=16, top_k=2, expert_ffn_dim=14336),
    moe_pattern=(False, True),           # MoE every other layer
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    max_seq_len=524288,
)
