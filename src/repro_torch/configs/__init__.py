"""Config registry of the port: the paper's GPT2 family.

``get_config(name)`` returns the full-scale config; ``get_smoke_config``
the reduced same-family config the CPU tests run (the reference's
``repro.configs`` reduction rules, applied to GPT2).  The other registry
architectures come with their ROADMAP slices and raise until then.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

# Where each architecture of the reference registry gets ported.
_NOT_YET = ("ROADMAP queue A item 12 (remaining architectures): {name} is "
            "not ported yet; the port serves the GPT2 family")


def get_config(name: str) -> ModelConfig:
    if name.startswith("gpt2"):
        from repro_torch.configs.gpt2 import gpt2
        layers = int(name.split("-")[1][:-1]) if "-" in name else 12
        return gpt2(layers)
    raise NotImplementedError(_NOT_YET.format(name=name))


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: 2 layers, d_model 64, vocab 256 —
    runs a forward on the CPU in milliseconds."""
    cfg = get_config(name)
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
        d_ff=128, vocab_size=256, window_pattern=window,
        max_seq_len=128,
    )
