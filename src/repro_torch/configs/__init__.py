"""Config registry of the port: the paper's GPT2 family and its §B
testbeds (``llama3-0.3b``, ``qwen3-0.3b``, ``mixtral-0.3b``,
``deepseekv3-0.3b``), ``yi-34b``, ``starcoder2-3b``, ``deepseek-moe-16b``,
``moonshot-v1-16b-a3b``, ``rwkv6-7b``, ``jamba-v0.1-52b``, ``gemma2-9b``,
``gemma3-12b``, ``qwen2-vl-2b`` and ``whisper-base`` (every architecture of
the reference registry), and the reference's per-architecture remat
policies (``REMAT_DEFAULTS``).

``get_config(name)`` returns the full-scale config; ``get_smoke_config``
the reduced same-family config the CPU tests run (the reference's
``repro.configs`` reduction rules).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import SHAPES, ModelConfig

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
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-base": "whisper_base",
}

# The reference's ten assigned architectures: the dry run's cells.
ASSIGNED_ARCHS = ("gemma2-9b", "gemma3-12b", "yi-34b", "starcoder2-3b",
                  "jamba-v0.1-52b", "whisper-base", "rwkv6-7b",
                  "qwen2-vl-2b", "moonshot-v1-16b-a3b", "deepseek-moe-16b")

# long_500k applicability (the reference's): sub-quadratic and
# local-attention archs run it; pure full-attention archs (and whisper)
# skip it.
LONG_CONTEXT_ARCHS = ("rwkv6-7b", "jamba-v0.1-52b", "gemma2-9b", "gemma3-12b")

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
                                  "mixtral-0.3b", "deepseekv3-0.3b")
# The launchers' --arch help.
ARCH_HELP = "gpt2-*, " + ", ".join(PORTED_ARCHS)


def get_config(name: str) -> ModelConfig:
    if name.startswith("gpt2"):
        from repro_torch.configs.gpt2 import gpt2
        layers = int(name.split("-")[1][:-1]) if "-" in name else 12
        return gpt2(layers)
    from repro_torch.configs.paper_testbeds import PAPER_TESTBEDS
    if name in PAPER_TESTBEDS:
        return PAPER_TESTBEDS[name]
    if name in _MODULES:
        import importlib
        return importlib.import_module(
            f"repro_torch.configs.{_MODULES[name]}").CONFIG
    raise KeyError(f"unknown architecture {name!r} (known: {ARCH_HELP})")


def applicable_shapes(name: str) -> list:
    """Shape cells for this arch; long_500k only for sub-quadratic archs."""
    return [shape for shape in SHAPES.values()
            if shape.name != "long_500k" or name in LONG_CONTEXT_ARCHS]


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: 1-2 pattern periods deep, d_model 64,
    vocab 256, 8 experts of width 32 (RWKV6 heads of 16), an encoder of 2
    layers over 16 frames, 8 frontend embeds — runs a forward on the CPU in
    milliseconds."""
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
        num_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        encoder_seq_len=16 if cfg.is_encoder_decoder else cfg.encoder_seq_len,
        num_frontend_embeds=8 if cfg.frontend != "none" else 0,
        max_seq_len=128,
    )
