"""SGD and normalized SGD (``repro/optim/sgd.py``): the paper's ablation
optimizers; NSGD is also the non-matrix half of Muon-NSGD and the cheap
pre-expansion optimizer of §C.3.

Momenta take each param's dtype (``zeros_like``).  NSGD normalizes each
leaf's momentum by its whole-leaf L2 norm, stacked super-block leaves
included (Muon-NSGD normalizes those per layer).  Params and momenta are
written in place under ``torch.no_grad()``; the update is float32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim.base import Optimizer, clip_by_global_norm, leaf_norm
from repro_torch.tree import leaves_with_path, tree_map


def _momentum_init(params):
    dev = next(iter(leaves_with_path(params)))[1].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(torch.zeros_like, params)}


def _momentum(grads, state, beta: float):
    for (_, m), (_, g) in zip(leaves_with_path(state["m"]),
                              leaves_with_path(grads)):
        m.copy_(beta * m + g.to(m.dtype))


def sgd(cfg: OptimizerConfig) -> Optimizer:
    beta, wd = cfg.momentum, cfg.weight_decay

    @torch.no_grad()
    def update(grads, state, params, lr):
        grads = clip_by_global_norm(grads, cfg.grad_clip)
        _momentum(grads, state, beta)
        lr = torch.as_tensor(lr, dtype=torch.float32)
        for (_, p), (_, m) in zip(leaves_with_path(params),
                                  leaves_with_path(state["m"])):
            lr_d = lr.to(p.device)
            p.copy_(((1.0 - lr_d * wd) * p.float()
                     - lr_d * m.float()).to(p.dtype))
        return params, {"step": state["step"] + 1, "m": state["m"]}

    return Optimizer("sgd", _momentum_init, update)


def nsgd(cfg: OptimizerConfig) -> Optimizer:
    beta, wd = cfg.momentum, cfg.weight_decay

    @torch.no_grad()
    def update(grads, state, params, lr):
        grads = clip_by_global_norm(grads, cfg.grad_clip)
        _momentum(grads, state, beta)
        lr = torch.as_tensor(lr, dtype=torch.float32)
        for (path, p), (_, m) in zip(leaves_with_path(params),
                                     leaves_with_path(state["m"])):
            lr_d = lr.to(p.device)
            mf = m.float()
            upd = mf / (leaf_norm(path, mf.reshape(-1)) + 1e-9)
            p.copy_(((1.0 - lr_d * wd) * p.float() - lr_d * upd).to(p.dtype))
        return params, {"step": state["step"] + 1, "m": state["m"]}

    return Optimizer("nsgd", _momentum_init, update)
