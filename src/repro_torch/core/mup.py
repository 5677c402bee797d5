"""muP / spectral-scaling rules (``repro/core/mup.py``, paper §3.2).

Feature learning needs a consistent per-element activation scale across
layers: for A_{l+1} = A_l W_l that is the spectral condition
||W_l||_* ~ sqrt(n_out / n_in).  Muon enforces it dynamically (its
orthogonalized updates have unit spectral norm, scaled by
sqrt(n_out / n_in)); AdamW and SGD scale per-tensor learning rates.  This is
what lets one learning rate serve the 0/1-layer source and the deep target.
"""
from __future__ import annotations

import math

import torch

from repro_torch.tree import leaves_with_path


def spectral_lr_scale(shape) -> float:
    """Per-tensor LR multiplier: sqrt(n_out / n_in) for matrices, 1
    otherwise (Muon applies it to the orthogonalized update).  The square
    root is taken in float32, as the reference takes it."""
    if len(shape) < 2:
        return 1.0
    n_in, n_out = shape[-2], shape[-1]
    return float(torch.sqrt(torch.tensor(max(n_out / n_in, 1e-12),
                                         dtype=torch.float32)))


def spectral_norm_estimate(w: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Power-iteration estimate of ||W||_* (float32, 0-d) for 2-D and
    stacked leaves, which are folded to (-1, n_out); the L2 norm of a
    vector.  The reference's start vector, ones / sqrt(n_out), and its
    ``iters`` steps."""
    if w.ndim < 2:
        return torch.linalg.norm(w)
    m = w.reshape(-1, w.shape[-1]).float()
    v = torch.ones(m.shape[1], dtype=torch.float32,
                   device=m.device) / math.sqrt(m.shape[1])
    sigma = None
    for _ in range(iters):
        u = m @ v
        u = u / (torch.linalg.norm(u) + 1e-9)
        v = m.T @ u
        sigma = torch.linalg.norm(v)
        v = v / (sigma + 1e-9)
    return sigma


def check_spectral_condition(params, atol_factor: float = 50.0) -> dict:
    """||W||_* / sqrt(n_out / n_in) of every leaf whose two trailing dims
    are both >= 2, by '/'-joined path: {"sigma", "target", "ratio"}.  Used
    to confirm that expansion preserved muP."""
    del atol_factor
    report = {}
    for path, leaf in leaves_with_path(params):
        if leaf.ndim < 2 or leaf.shape[-1] < 2 or leaf.shape[-2] < 2:
            continue
        target = spectral_lr_scale(tuple(leaf.shape))
        sigma = float(spectral_norm_estimate(leaf))
        report["/".join(path)] = {"sigma": sigma, "target": target,
                                  "ratio": sigma / max(target, 1e-9)}
    return report


def activation_scale_probe(activations: torch.Tensor) -> torch.Tensor:
    """||A||_2 / sqrt(n), averaged over rows: ~O(1) and the same across
    layers under muP (§3.2)."""
    a = activations.float()
    return torch.sqrt(torch.mean(torch.square(a), dim=-1)).mean()
