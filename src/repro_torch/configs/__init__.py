"""Config registry of the port: the paper's GPT2 family, ``rwkv6-7b`` and
``jamba-v0.1-52b``.

``get_config(name)`` returns the full-scale config; ``get_smoke_config``
the reduced same-family config the CPU tests run (the reference's
``repro.configs`` reduction rules).  The other architectures of the
reference registry come with their ROADMAP slices and raise until then,
each naming what it waits for.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

# What each architecture of the reference registry still waits for.
_WAITS_FOR = {
    "gemma2-9b": "RoPE (queue A items 2-3), sliding-window and softcapped "
                 "attention (item 12)",
    "gemma3-12b": "RoPE and qk-norm (queue A items 2-3), sliding-window "
                  "layers (item 12)",
    "yi-34b": "RoPE (queue A items 2-3)",
    "starcoder2-3b": "RoPE (queue A items 2-3)",
    "whisper-base": "the encoder-decoder model and its audio frontend "
                    "(queue A item 12)",
    "qwen2-vl-2b": "M-RoPE and frontend embeds (queue A item 12)",
    "moonshot-v1-16b-a3b": "RoPE (queue A items 2-3) under its MoE "
                           "feed-forward",
    "deepseek-moe-16b": "RoPE (queue A items 2-3) under its MoE "
                        "feed-forward",
    "llama3-0.3b": "RoPE (queue A items 2-3)",
    "qwen3-0.3b": "RoPE and qk-norm (queue A items 2-3)",
    "mixtral-0.3b": "RoPE (queue A items 2-3) under its MoE feed-forward",
    "deepseekv3-0.3b": "MLA (queue A item 12) and RoPE (items 2-3) under "
                       "its MoE feed-forward",
}


def get_config(name: str) -> ModelConfig:
    if name.startswith("gpt2"):
        from repro_torch.configs.gpt2 import gpt2
        layers = int(name.split("-")[1][:-1]) if "-" in name else 12
        return gpt2(layers)
    if name == "rwkv6-7b":
        from repro_torch.configs.rwkv6_7b import CONFIG
        return CONFIG
    if name == "jamba-v0.1-52b":
        from repro_torch.configs.jamba_v01_52b import CONFIG
        return CONFIG
    raise NotImplementedError(
        f"ROADMAP: {name} is not ported yet; it waits for "
        f"{_WAITS_FOR.get(name, 'its queue A item')}")


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: 1-2 pattern periods deep, d_model 64,
    vocab 256, 8 experts of width 32 (RWKV6 heads of 16) — runs a forward
    on the CPU in milliseconds."""
    cfg = get_config(name)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, num_experts=8, top_k=min(moe.top_k, 2),
            num_shared_experts=min(moe.num_shared_experts, 1),
            expert_ffn_dim=32 if moe.expert_ffn_dim else 0)
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(
            ssm, d_state=4,
            head_dim=16 if ssm.kind == "rwkv6" else ssm.head_dim)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    while heads % kv:
        kv -= 1
    period = cfg.pattern_period
    window = tuple(min(w, 8) for w in cfg.window_pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=2 * period if period <= 4 else period,
        d_model=64, num_heads=heads, num_kv_heads=kv, head_dim=16,
        d_ff=128, vocab_size=256, moe=moe, ssm=ssm, window_pattern=window,
        max_seq_len=128,
    )
