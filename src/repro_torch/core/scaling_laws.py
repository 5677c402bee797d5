"""Scaling-law fits (``repro/core/scaling_laws.py``; paper Fig 2):
loss(C) = a·C^(−b) + c on (FLOPs, loss) points, comparing fixed-size vs
progressive exponents.

The paper's claim: progressive training "consistently has a better
exponent"; ``compare_exponents`` quantifies that on any two run families.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class PowerLawFit:
    a: float
    b: float                 # exponent (positive = loss falls with compute)
    c: float                 # irreducible loss
    residual: float

    def predict(self, flops):
        return self.a * np.asarray(flops, dtype=np.float64) ** (-self.b) + self.c


def fit_power_law(flops: Sequence[float], losses: Sequence[float],
                  c_grid: int = 64) -> PowerLawFit:
    """Fit loss = a·C^-b + c by grid search over c + linear fit in log space."""
    f = np.asarray(flops, dtype=np.float64)
    l = np.asarray(losses, dtype=np.float64)  # noqa: E741
    if not len(f) == len(l) >= 3:
        raise ValueError(f"{len(f)} FLOPs and {len(l)} losses: at least 3 "
                         "pairs")
    best = None
    for c in np.linspace(0.0, l.min() * 0.999, c_grid):
        y = np.log(l - c)
        x = np.log(f)
        A = np.stack([np.ones_like(x), x], axis=1)
        coef, res, *_ = np.linalg.lstsq(A, y, rcond=None)
        r = float(res[0]) if len(res) else float(((A @ coef - y) ** 2).sum())
        if best is None or r < best[0]:
            best = (r, coef, c)
    r, (log_a, slope), c = best
    return PowerLawFit(a=float(np.exp(log_a)), b=float(-slope), c=float(c),
                       residual=r)


def compare_exponents(fixed_pts, progressive_pts) -> dict:
    """pts: sequences of (flops, loss).  Returns both fits + the compute
    multiplier at matched loss (the paper's 3–5x claim)."""
    ff = fit_power_law(*zip(*fixed_pts))
    fp = fit_power_law(*zip(*progressive_pts))
    # compute needed to reach the fixed family's midpoint loss
    mid_loss = float(np.median([l for _, l in fixed_pts]))

    def flops_at(fit, loss):
        if loss <= fit.c:
            return float("inf")
        return (fit.a / (loss - fit.c)) ** (1.0 / fit.b)
    ratio = flops_at(ff, mid_loss) / max(flops_at(fp, mid_loss), 1e-30)
    return {"fixed": ff, "progressive": fp,
            "compute_multiplier_at_matched_loss": ratio,
            "progressive_better_exponent": fp.b > ff.b}
