"""gemma3-12b [dense]: 5:1 local (window 1024) : global attention, 128k
context, qk-norm, RoPE θ 1e6 (``repro/configs/gemma3_12b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    head_dim=256, d_ff=15360, vocab_size=262144,
    attention="gqa", activation="gelu", norm="rmsnorm", position="rope",
    rope_theta=1_000_000.0, tie_embeddings=True, qk_norm=True,
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),  # 5 local : 1 global
    max_seq_len=131072,
)
