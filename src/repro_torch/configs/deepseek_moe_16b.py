"""deepseek-moe-16b [moe] — 2 shared + 64 routed experts top-6, fine-grained.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=1408, vocab_size=102400,
    attention="mha", activation="swiglu", norm="rmsnorm", position="rope",
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  expert_ffn_dim=1408),
    max_seq_len=16384,
)
