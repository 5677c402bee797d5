"""Step-time watermarks for straggler detection
(``repro/distributed/collectives.py``: ``StragglerMonitor``).

The rest of the reference module, int8 gradient compression with error
feedback for the cross-pod axis, comes with ROADMAP queue A item 13.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Optional, Tuple

from repro_torch.train import faults as faults_lib


class StragglerMonitor:
    """Tracks per-step wall time; flags steps slower than ``threshold`` x the
    rolling median.

    ``hang_deadline_s`` adds a hard ceiling: a step that exceeds it raises
    ``train.faults.HangError`` (a ``train.step`` FaultError) from ``stop``
    instead of silently counting as slow, so a stuck step surfaces as a
    fault the trainer's containment can log and move past.  The measured
    ``dt`` is recorded in ``last_dt`` before raising.  The caller stops the
    clock after the step's device work has finished (a synchronize): a
    step only queued on the card would never trip the deadline."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 hang_deadline_s: Optional[float] = None):
        self.times: Deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.hang_deadline_s = hang_deadline_s
        self._t0: Optional[float] = None
        self.flagged = 0
        self.hangs = 0
        self.last_dt = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> Tuple[float, bool]:
        dt = time.perf_counter() - self._t0
        self.last_dt = dt
        slow = False
        if len(self.times) >= 10:
            med = sorted(self.times)[len(self.times) // 2]
            slow = dt > self.threshold * med
            self.flagged += int(slow)
        self.times.append(dt)
        if self.hang_deadline_s is not None and dt > self.hang_deadline_s:
            self.hangs += 1
            raise faults_lib.HangError("train.step", self.hangs, dt,
                                       self.hang_deadline_s)
        return dt, slow
