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

On a mesh (``distributed.context.mesh_scope``) the trees hold the rank's
shards: elementwise updates act on them as they are, norms sum each leaf's
squares over the ranks that split it (``leaf_norm``, ``global_norm``), and
Muon orthogonalizes each matrix whole (``muon.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.distributed.context import leaf_sq_sum, split_over_mesh
from repro_torch.tree import leaves_with_path, tree_map

@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in order, of float32 squared sums; on a
    mesh each leaf's sum covers its whole (every element once)."""
    total = sum(leaf_sq_sum(path, torch.sum(torch.square(x.float())))
                for path, x in leaves_with_path(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def leaf_norm(path, x: torch.Tensor, dim=None) -> torch.Tensor:
    """The L2 norm of the whole leaf at ``path`` (over ``dim`` of its
    held 2-D view when given), summed over the ranks that split it; on
    one rank ``torch.linalg.norm`` itself."""
    if not split_over_mesh(path):
        return torch.linalg.norm(x, dim=dim)
    sq = torch.sum(torch.square(x), dim=dim)
    return torch.sqrt(leaf_sq_sum(path, sq))


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
