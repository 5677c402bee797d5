"""yi-34b [dense] — llama-architecture GQA. [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=20480, vocab_size=64000,
    attention="gqa", activation="swiglu", norm="rmsnorm", position="rope",
    rope_theta=5_000_000.0,
    max_seq_len=32768,
)
