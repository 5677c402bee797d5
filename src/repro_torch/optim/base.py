"""Minimal optimizer library (``repro/optim/base.py``).

Contract (required by ``repro_torch.core.expansion.expand_opt_state``):
  * ``init(params) -> state`` where state is a dict with 'step' plus
    params-like moment trees under 'm' (and 'v' for AdamW);
  * ``update(grads, state, params, lr) -> (params, state)``: ``lr`` is the
    scheduled float32 scalar for this step; schedules live outside the
    optimizer so progressive training can share one schedule across
    expansions.

Where the reference returns new trees (its step donates the old buffers),
the port's update writes params and moments in place under
``torch.no_grad()`` and returns the same trees.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.tree import tree_leaves, tree_map

@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    if max_norm <= 0:
        return grads
    g = global_norm(grads)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale, grads)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    """The optimizer ``cfg.name`` names; an unknown name raises KeyError."""
    from repro_torch.optim import adamw, muon, sgd
    builders = {"muon_nsgd": muon.muon_nsgd, "adamw": adamw.adamw,
                "nsgd": sgd.nsgd, "sgd": sgd.sgd}
    return builders[cfg.name](cfg)
