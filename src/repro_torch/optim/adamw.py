"""AdamW, the paper's baseline optimizer (``repro/optim/adamw.py``; Fig 18:
WSD lr 0.0005, cosine 0.001).

Moments are float32 zeros of each param's shape; the bias corrections
``1 - b**step`` are float32, as the reference computes them.  The update
writes params and moments in place under ``torch.no_grad()`` (the reference
returns new trees), with the reference's arithmetic in float32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim.base import Optimizer, clip_by_global_norm
from repro_torch.tree import leaves_with_path, tree_map


def adamw(cfg: OptimizerConfig) -> Optimizer:
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay

    def init(params):
        dev = next(iter(leaves_with_path(params)))[1].device
        zeros = lambda: tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": zeros(), "v": zeros()}

    @torch.no_grad()
    def update(grads, state, params, lr):
        grads = clip_by_global_norm(grads, cfg.grad_clip)
        step = state["step"] + 1
        for (_, m), (_, v), (_, g) in zip(leaves_with_path(state["m"]),
                                          leaves_with_path(state["v"]),
                                          leaves_with_path(grads)):
            g = g.float()
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
        sf = step.float()
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=sf.device), sf)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=sf.device), sf)
        lr = torch.as_tensor(lr, dtype=torch.float32)
        for (_, p), (_, m), (_, v) in zip(leaves_with_path(params),
                                          leaves_with_path(state["m"]),
                                          leaves_with_path(state["v"])):
            lr_d = lr.to(p.device)
            upd = (m / c1.to(p.device)) / (torch.sqrt(v / c2.to(p.device))
                                           + eps)
            p.copy_(((1.0 - lr_d * wd) * p.float() - lr_d * upd).to(p.dtype))
        return params, {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer("adamw", init, update)
