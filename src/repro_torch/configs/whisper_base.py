"""whisper-base [audio]: the encoder-decoder backbone; the conv audio
frontend is a stub, its frame embeddings supplied precomputed
(``repro/configs/whisper_base.py``; arXiv:2212.04356)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    head_dim=64, d_ff=2048, vocab_size=51865,
    attention="mha", activation="gelu", norm="layernorm", position="absolute",
    tie_embeddings=True,
    is_encoder_decoder=True, num_encoder_layers=6, encoder_seq_len=1500,
    frontend="audio",
    max_seq_len=32768,       # decoder backbone at the registry's shapes
)
