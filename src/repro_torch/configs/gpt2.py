"""GPT2 family — the paper's own testbed (Radford et al. 2019; paper §B:
n_embd/n_head = 64; 12L->12H, 24L->16H, 36L->20H, 60L->48H ~7B)."""
from repro_torch.configs.base import ModelConfig

_HEADS = {12: 12, 24: 16, 36: 20, 60: 48}


def gpt2(num_layers: int = 12, vocab_size: int = 50304) -> ModelConfig:
    heads = _HEADS.get(num_layers, max(4, num_layers))
    d = 64 * heads
    return ModelConfig(
        name=f"gpt2-{num_layers}l", family="dense",
        num_layers=num_layers, d_model=d, num_heads=heads,
        num_kv_heads=heads, head_dim=64, d_ff=4 * d, vocab_size=vocab_size,
        attention="mha", activation="gelu", norm="layernorm",
        position="absolute", tie_embeddings=True, max_seq_len=1024,
    )
