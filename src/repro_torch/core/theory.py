"""Convergence-theory calculator (``repro/core/theory.py``; paper §4).

Evaluates the progressive-training loss upper bound and the progressive-vs-
fixed gap (4.4) for a given learning-rate schedule, exposing the two levers
the paper derives: (i) initialization quality of the teleported layers x_τ,
(ii) the schedule ratio Ση_{t≤τ} / Ση_t (small under WSD, large under cosine
decay — hence WSD's advantage).

``lr_fn`` maps an array of steps to learning rates: one of the port's
schedules (``core/schedules.py``, which return a float32 tensor) or any
numpy function; the sums run in float64.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass
class BoundInputs:
    total_steps: int
    tau: int
    lipschitz_g: float = 1.0
    loss_small_star: float = 3.5     # L(w*)
    loss_large_star: float = 3.0     # L(W*)
    dist_w0: float = 1.0             # ||w_0 - w*||
    dist_x_tau: float = 1.0          # ||x_τ - x*||  (init quality of new layers)
    dist_x0: float = 1.0             # ||x_0 - x*||  (random-init reference)


def schedule_ratio(lrs: np.ndarray, tau: int) -> float:
    """Ση_{t≤τ} / Ση_t — the paper wants this SMALL (WSD keeps post-τ LR high)."""
    return float(lrs[:tau].sum() / lrs.sum())


def progressive_bound(inp: BoundInputs,
                      lr_fn: Callable[[np.ndarray], np.ndarray]) -> dict:
    """Last-iterate bound for progressive training (§4.1) and the fixed-size
    bound (4.3); returns both plus the decomposed gap (4.4)."""
    t = np.arange(inp.total_steps)
    eta = np.asarray(lr_fn(t), dtype=np.float64)
    S = eta.sum()
    G2 = inp.lipschitz_g ** 2

    ratio = schedule_ratio(eta, inp.tau)
    min_mix = ratio * inp.loss_small_star + (1 - ratio) * inp.loss_large_star
    noise = G2 * (eta ** 2).sum() / (2 * S)

    # last-iterate correction term (Defazio et al. 2023, Cor. 11)
    last_iter = 0.0
    suffix = np.cumsum(eta[::-1])[::-1]          # Σ_{t=k}^{T} η_t
    for k in range(1, inp.total_steps):
        tail = suffix[k] if k < inp.total_steps else eta[-1]
        last_iter += eta[k - 1] / max(tail, 1e-12) * \
            ((eta[k - 1:] ** 2).sum() * G2 / max(suffix[k - 1], 1e-12))
    last_iter *= 0.5

    dist_prog = (inp.dist_w0 ** 2 + inp.dist_x_tau ** 2) / (2 * S)
    bound_prog = min_mix + noise + dist_prog + last_iter

    dist_fixed = (inp.dist_w0 ** 2 + inp.dist_x0 ** 2) / (2 * S)
    bound_fixed = inp.loss_large_star + noise + dist_fixed + last_iter

    gap = (ratio * (inp.loss_small_star - inp.loss_large_star)
           + (inp.dist_x_tau ** 2 - inp.dist_x0 ** 2) / (2 * S))   # eq (4.4)
    return {"bound_progressive": bound_prog, "bound_fixed": bound_fixed,
            "gap": gap, "schedule_ratio": ratio, "noise_term": noise,
            "last_iterate_term": last_iter}
