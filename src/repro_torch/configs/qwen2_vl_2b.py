"""qwen2-vl-2b [vlm]: M-RoPE over (temporal, height, width) position ids;
the vision frontend is a stub, its patch embeddings supplied precomputed
and prepended to the text (``repro/configs/qwen2_vl_2b.py``;
arXiv:2409.12191)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    head_dim=128, d_ff=8960, vocab_size=151936,
    attention="gqa", activation="swiglu", norm="rmsnorm", position="mrope",
    rope_theta=1_000_000.0, tie_embeddings=True,
    frontend="vision", num_frontend_embeds=256,
    max_seq_len=32768,
)
