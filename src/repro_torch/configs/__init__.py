"""Config registry of the port: the paper's GPT2 family and its RoPE
testbeds (``llama3-0.3b``, ``qwen3-0.3b``, ``mixtral-0.3b``), ``yi-34b``,
``starcoder2-3b``, ``deepseek-moe-16b``, ``moonshot-v1-16b-a3b``,
``rwkv6-7b``, ``jamba-v0.1-52b``, ``gemma2-9b`` and ``gemma3-12b``, and the
reference's per-architecture remat policies (``REMAT_DEFAULTS``).

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
    "whisper-base": "the encoder-decoder model and its audio frontend "
                    "(queue A item 12)",
    "qwen2-vl-2b": "M-RoPE and frontend embeds (queue A item 12)",
    "deepseekv3-0.3b": "MLA latent attention (queue A item 12)",
}

# The registry modules the port carries, by architecture name.
_MODULES = {
    "rwkv6-7b": "rwkv6_7b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "yi-34b": "yi_34b",
    "starcoder2-3b": "starcoder2_3b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "gemma2-9b": "gemma2_9b",
    "gemma3-12b": "gemma3_12b",
}

# Checkpoint policy to use when remat is on (the reference's
# ``REMAT_DEFAULTS``, which it measured on its host mesh): 'dots' (keep
# matmul outputs) only where it beat full recompute by >= 5%; the rest
# recompute everything, which also keeps the least memory live.
REMAT_DEFAULTS = {
    "gemma2-9b": "nothing",
    "gemma3-12b": "dots",
    "yi-34b": "dots",
    "starcoder2-3b": "nothing",
    "jamba-v0.1-52b": "nothing",
    "whisper-base": "nothing",
    "rwkv6-7b": "nothing",
    "qwen2-vl-2b": "dots",
    "moonshot-v1-16b-a3b": "nothing",
    "deepseek-moe-16b": "dots",
}


def default_remat(name: str) -> str:
    """The checkpoint policy for ``name`` when remat is on
    (``REMAT_DEFAULTS``); other configs recompute everything."""
    return REMAT_DEFAULTS.get(name, "nothing")

# Every name ``get_config`` takes besides ``gpt2-*``: the registry
# architectures above and the paper's testbeds.
PORTED_ARCHS = tuple(_MODULES) + ("llama3-0.3b", "qwen3-0.3b",
                                  "mixtral-0.3b")
# The launchers' --arch help.
ARCH_HELP = ("gpt2-*, " + ", ".join(PORTED_ARCHS) + "; not yet: "
             + "; ".join(f"{name}, waiting for {what}"
                         for name, what in _WAITS_FOR.items()))


def get_config(name: str) -> ModelConfig:
    if name.startswith("gpt2"):
        from repro_torch.configs.gpt2 import gpt2
        layers = int(name.split("-")[1][:-1]) if "-" in name else 12
        return gpt2(layers)
    if name not in _WAITS_FOR:
        from repro_torch.configs.paper_testbeds import PAPER_TESTBEDS
        if name in PAPER_TESTBEDS:
            return PAPER_TESTBEDS[name]
        if name in _MODULES:
            import importlib
            return importlib.import_module(
                f"repro_torch.configs.{_MODULES[name]}").CONFIG
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
