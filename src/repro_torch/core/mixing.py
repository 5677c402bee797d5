"""Mixing-time machinery (``repro/core/mixing.py``; paper §5, §C.4).

t_mix is the time until the progressive run's loss matches the fixed-size
run's loss at the same step.  Key empirical facts encoded here:
  * t_mix is measured in *data* (tokens), not iterations (Fig 20);
  * during the WSD stable phase, t_mix is insensitive to τ (Takeaway 6),
    so it *transfers*: measure it once with two cheap early-stopped runs
    (recipe step 4) and schedule τ = stable_end − t_mix.

Plain numpy and Python, as in the reference; ``stable_phase_end`` is the
port's (``core/schedules.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import ScheduleConfig
from repro_torch.core.schedules import stable_phase_end


@dataclasses.dataclass
class MixingReport:
    mixed: bool
    mix_step: Optional[int]          # step at which losses first mix
    mix_tokens: Optional[int]        # tokens processed after expansion
    tolerance: float


def detect_mixing(prog_losses: Sequence[float], fixed_losses: Sequence[float],
                  expansion_step: int, tokens_per_step: int,
                  tolerance: float = 0.005, patience: int = 5) -> MixingReport:
    """First step >= expansion_step where the progressive loss stays within
    `tolerance` (relative) of the fixed-size loss for `patience` evals."""
    prog = np.asarray(prog_losses, dtype=np.float64)
    fixed = np.asarray(fixed_losses, dtype=np.float64)
    n = min(len(prog), len(fixed))
    ok = np.abs(prog[:n] - fixed[:n]) <= tolerance * np.abs(fixed[:n])
    run = 0
    for t in range(expansion_step, n):
        run = run + 1 if ok[t] else 0
        if run >= patience:
            step = t - patience + 1
            return MixingReport(True, step,
                                (step - expansion_step) * tokens_per_step,
                                tolerance)
    return MixingReport(False, None, None, tolerance)


def plan_expansion_step(schedule: ScheduleConfig, total_steps: int,
                        mix_steps: int) -> int:
    """Recipe step 4: expand at (end of stable phase) − (transferred t_mix).

    `mix_steps` comes from two cheap early-stopped runs (one fixed-size, one
    progressive expanding right after warmup; ``core.recipe.calibrate_tau``).
    t_mix transfers across τ during the WSD stable phase, so this is valid
    even though it was measured early.
    """
    stable_end = stable_phase_end(schedule, total_steps)
    tau = stable_end - mix_steps
    warmup = int(total_steps * schedule.warmup_frac)
    return max(warmup + 1, tau)


def transfer_mix_steps(mix_tokens: int, tokens_per_step: int) -> int:
    """Mixing needs data, not iterations (§C.4): transfer by token count."""
    return -(-mix_tokens // tokens_per_step)


def compute_savings(total_steps: int, tau: int, n_small: int, n_large: int,
                    batch_tokens: int) -> dict:
    """Eq (1.1): progressive FLOPs = 6B(τ·N_small + (T−τ)·N_large)."""
    fixed = 6 * batch_tokens * total_steps * n_large
    prog = 6 * batch_tokens * (tau * n_small + (total_steps - tau) * n_large)
    return {"fixed_flops": float(fixed), "progressive_flops": float(prog),
            "savings": 1.0 - prog / fixed, "speedup": fixed / prog}
