"""Dense feed-forward layer (GeLU / SwiGLU) — ``repro/models/mlp.py``'s
``mlp_init``/``mlp_apply``.  The Mixture-of-Experts layer comes with ROADMAP
queue A item 12."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activate, dense_init


def mlp_init(generator, cfg: ModelConfig, dtype=torch.float32,
             d_ff: Optional[int] = None, device="cuda"):
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    if cfg.activation == "swiglu":
        return {"w_gate": dense_init(generator, D, Fd, dtype, device=device),
                "w_up": dense_init(generator, D, Fd, dtype, device=device),
                "w_down": dense_init(generator, Fd, D, dtype, device=device)}
    return {"w_up": dense_init(generator, D, Fd, dtype, device=device),
            "w_down": dense_init(generator, Fd, D, dtype, device=device)}


def mlp_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = activate(x @ p["w_up"], "gelu")
    return h @ p["w_down"]
