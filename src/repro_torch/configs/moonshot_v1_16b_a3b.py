"""moonshot-v1-16b-a3b (Moonlight) [moe] — fine-grained MoE, 64 experts
top-6 (+2 shared, deepseek-moe lineage).
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=1408, vocab_size=163840,
    attention="mha", activation="swiglu", norm="rmsnorm", position="rope",
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  expert_ffn_dim=1408),
    max_seq_len=16384,
)
