"""Learning-rate schedules (``repro/core/schedules.py``).  The paper's key
schedule is WSD (warmup–stable–decay): expansion during the stable phase
makes the mixing time insensitive to τ.

Each schedule maps a step to a float32 0-d tensor computed in float32, as
the reference computes it inside its jitted step, so the two frameworks
hand the optimizer the same learning rate.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.configs.base import ScheduleConfig

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def wsd(peak_lr: float, total_steps: int, warmup_frac: float = 0.02,
        decay_frac: float = 0.2, min_lr_frac: float = 0.0) -> Callable:
    """Warmup-stable-decay: linear warmup, constant plateau, linear decay."""
    warmup = max(1, int(total_steps * warmup_frac))
    decay = max(1, int(total_steps * decay_frac))
    stable_end = total_steps - decay

    def fn(step):
        step = _f32(step)
        warm = peak_lr * (step + 1) / warmup
        tail = peak_lr * (1.0 - (1.0 - min_lr_frac)
                          * torch.clamp((step - stable_end) / decay, 0.0, 1.0))
        return torch.where(step < warmup, torch.minimum(warm, _f32(peak_lr)),
                           torch.where(step < stable_end, _f32(peak_lr), tail))
    return fn


def cosine(peak_lr: float, total_steps: int, warmup_frac: float = 0.02,
           min_lr_frac: float = 0.0, **_) -> Callable:
    warmup = max(1, int(total_steps * warmup_frac))

    def fn(step):
        step = _f32(step)
        warm = peak_lr * (step + 1) / warmup
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (min_lr_frac + (1 - min_lr_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, torch.minimum(warm, _f32(peak_lr)),
                           cos)
    return fn


def constant(peak_lr: float, total_steps: int, warmup_frac: float = 0.02,
             **_) -> Callable:
    warmup = max(1, int(total_steps * warmup_frac))

    def fn(step):
        step = _f32(step)
        return torch.minimum(peak_lr * (step + 1) / warmup, _f32(peak_lr))
    return fn


def make_schedule(cfg: ScheduleConfig, peak_lr: float,
                  total_steps: int) -> Callable:
    builders = {"wsd": wsd, "cosine": cosine, "constant": constant}
    return builders[cfg.name](peak_lr, total_steps,
                              warmup_frac=cfg.warmup_frac,
                              decay_frac=cfg.decay_frac,
                              min_lr_frac=cfg.min_lr_frac)


def stable_phase_end(cfg: ScheduleConfig, total_steps: int) -> int:
    """Last step of the WSD plateau — the latest admissible expansion time."""
    if cfg.name == "wsd":
        return total_steps - max(1, int(total_steps * cfg.decay_frac))
    return total_steps
