"""The paper's own §2/§B testbed models (0.3B-class variants, exact §B
hyperparameters), beyond the assigned-architecture pool:

  llama3-0.3b    dense, GQA, RoPE, RMSNorm, SwiGLU, no tying
  qwen3-0.3b     dense, GQA, weight tying, qk-norm
  mixtral-0.3b   MoE 8e top-2, GQA
  deepseekv3-0.3b MoE + MLA (multi-head latent attention)

The port's own copy of ``repro/configs/paper_testbeds.py``: all four run
the paper's Figure 3 sweep through the same ``--arch`` flags.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

LLAMA3_03B = ModelConfig(
    name="llama3-0.3b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    head_dim=64, d_ff=2048, vocab_size=50304,
    attention="gqa", activation="swiglu", norm="rmsnorm", position="rope",
    max_seq_len=1024,
)

QWEN3_03B = ModelConfig(
    name="qwen3-0.3b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    head_dim=64, d_ff=2048, vocab_size=50304,
    attention="gqa", activation="swiglu", norm="rmsnorm", position="rope",
    tie_embeddings=True, qk_norm=True,
    max_seq_len=1024,
)

MIXTRAL_03B = ModelConfig(
    name="mixtral-0.3b", family="moe",
    num_layers=24, d_model=512, num_heads=8, num_kv_heads=4,
    head_dim=64, d_ff=1024, vocab_size=50304,
    attention="gqa", activation="swiglu", norm="rmsnorm", position="rope",
    moe=MoEConfig(num_experts=8, top_k=2, expert_ffn_dim=1024),
    max_seq_len=1024,
)

DEEPSEEKV3_03B = ModelConfig(
    name="deepseekv3-0.3b", family="moe",
    num_layers=24, d_model=512, num_heads=8, num_kv_heads=4,
    head_dim=64, d_ff=1024, vocab_size=50304,
    attention="mla", mla_kv_lora_rank=128,
    activation="swiglu", norm="rmsnorm", position="rope",
    moe=MoEConfig(num_experts=8, top_k=2, num_shared_experts=1,
                  expert_ffn_dim=1024),
    max_seq_len=1024,
)

PAPER_TESTBEDS = {c.name: c for c in
                  (LLAMA3_03B, QWEN3_03B, MIXTRAL_03B, DEEPSEEKV3_03B)}
