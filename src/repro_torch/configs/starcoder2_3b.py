"""starcoder2-3b [dense] — GQA(kv=2), RoPE, LayerNorm + GeLU MLP.
[arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    head_dim=128, d_ff=12288, vocab_size=49152,
    attention="gqa", activation="gelu", norm="layernorm", position="rope",
    tie_embeddings=True,
    max_seq_len=16384,
)
