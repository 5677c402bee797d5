"""gemma2-9b [dense]: local and global attention alternating 1:1 (window
4096), attention logit softcap 50, final logit softcap 30 (``repro/configs/
gemma2_9b.py``; arXiv:2408.00118)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8,
    head_dim=256, d_ff=14336, vocab_size=256000,
    attention="gqa", activation="gelu", norm="rmsnorm", position="rope",
    tie_embeddings=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    window_pattern=(4096, 0),            # 1:1 local(4096):global
    max_seq_len=8192,
)
