"""Deterministic fault injection for the train **and** serve stacks
(``repro/train/faults.py``, whole: the same sites, grammar and seeded
draws).

A production system dies in ways a clean benchmark never shows: an
allocation fails mid-iteration, a table upload is interrupted, a train
step produces a NaN, a checkpoint write is torn by preemption, the
process is killed mid-expansion.  The robustness contracts ("one failing
request never takes down the batch", "a crash loses no admitted
request", "a preempted training run resumes byte-identically") are only
testable if those faults can be *produced on demand, deterministically*
— so this module gives every fragile operation in both stacks a named
**fault site** and routes it through one ``FaultPlane``:

  ============================ ============================================
  serving sites
  ============================ ============================================
  ``pool.alloc``               KVBlockPool page allocation (free-list pop)
  ``pool.evict``               KVBlockPool eviction callback into the radix
  ``radix.publish``            RadixCache prefix publish after prefill
  ``radix.match``              RadixCache prefix lookup at admission
  ``engine.prefill_chunk``     ServeEngine chunked-prefill dispatch
  ``engine.decode``            ServeEngine masked-decode / spec dispatch
  ``engine.table_upload``      ServeEngine block-table H2D re-upload
  ``engine.draft_prefill``     ServeEngine speculative draft B=1 prefill
  ``sched.iter``               ContinuousScheduler iteration boundary
                               (scheduled crash point, see below)
  ============================ ============================================
  training sites (``ProgressiveTrainer``)
  ============================ ============================================
  ``train.batch``              host batch generation + device placement
  ``train.step``               train-step dispatch (params/opt written
                               only after the site passes, so retry-safe);
                               also fired by ``StragglerMonitor`` when a
                               step exceeds its hang deadline
  ``train.eval``               held-out eval sweep dispatch
  ``train.expand``             depth expansion at τ (after the boundary
                               checkpoint, before params mutate)
  ``train.iter``               training-loop iteration boundary
                               (scheduled crash point)
  ============================ ============================================
  shared checkpointer sites
  ============================ ============================================
  ``ckpt.write``               torn write (arrays written, manifest not —
                               the preemption window)
  ``ckpt.restore``             checkpoint read at resume/rollback
  ============================ ============================================

Sites **fire before the operation mutates any state**, so an injected
fault leaves the pool/tree/engine/params exactly as they were and a
bounded retry is always safe.  Two failure kinds are modeled:

  * ``fault`` — raises :class:`FaultError`, a *transient* error the
    scheduler/trainer is expected to contain (retry with backoff; the
    scheduler then fails only the affected request, the trainer keeps
    training through failed checkpoint writes);
  * ``crash`` — raises :class:`CrashError`, which containment must NOT
    catch: it models the process dying (SIGKILL, preemption).  Recovery
    is ``ContinuousScheduler.snapshot()``/``restore`` on the serve side
    and checkpoint resume on the train side — a restarted
    ``ProgressiveTrainer`` replays from the last completed checkpoint to
    a byte-identical stream of losses and params (the data stream is
    step-indexed, so the replay is exact).

Two drivers, both deterministic:

  * an explicit **tape** — ``[(site, nth, kind), ...]``: the ``nth`` time
    (1-based) ``site`` fires, raise.  ``FaultPlane.parse`` accepts the
    compact CLI form ``"site:nth[:kind]"`` joined by commas, e.g.
    ``--faults pool.alloc:3,train.iter:40:crash`` — the same grammar on
    ``launch/serve.py --faults`` and ``launch/train.py --faults``;
  * a seeded **schedule** — ``FaultPlane.seeded(rate, seed)`` draws one
    reproducible Bernoulli per site hit (a "fault storm" for benchmarks
    and fuzz).  The iteration-boundary sites (``sched.iter``,
    ``train.iter``) are excluded by default — crash points only make
    sense as explicit tape entries.

Numerical faults (a NaN loss, an exploding gradient) are not exceptions
and do not go through ``fire``; they are injected *into the train step's
math* via :func:`parse_nan_inject` and detected by the step's sentinel
metrics (see ``train.steps.make_train_step``).

When disabled (the default ``NULL`` plane) every site is a single no-op
method call: the hot paths pay one attribute lookup and nothing else, and
no RNG state exists to perturb determinism.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SITES = (
    "pool.alloc",
    "pool.evict",
    "radix.publish",
    "radix.match",
    "engine.prefill_chunk",
    "engine.decode",
    "engine.table_upload",
    "engine.draft_prefill",
    "train.batch",
    "train.step",
    "train.eval",
    "train.expand",
    "train.iter",
    "ckpt.write",
    "ckpt.restore",
    "sched.iter",
)

# Iteration-boundary sites: scheduled-crash points, excluded from seeded
# storms by default (a storm faulting the loop boundary itself models
# nothing a retry could contain).
ITER_SITES = frozenset({"sched.iter", "train.iter"})


class _Injected(RuntimeError):
    """Base of both injected failure kinds (records where it fired)."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected {self.kind} at {site} (hit {hit})")
        self.site = site
        self.hit = hit


class FaultError(_Injected):
    """A transient injected fault at a named site.  The scheduler contract:
    contain it — retry with backoff where the operation is batch-wide,
    fail the one affected request where it is per-row — and never let it
    escape the serving loop."""
    kind = "fault"


class CrashError(_Injected):
    """An injected process death.  Deliberately NOT a ``FaultError``
    subclass — containment code catching transient faults must never
    swallow it: it unwinds the serving loop like a kill -9 would, and the
    recovery path is snapshot/restore, not retry."""
    kind = "crash"


class HangError(FaultError):
    """A step exceeded its hang deadline (``StragglerMonitor``).  Raised
    as a ``train.step`` fault so the trainer's containment/telemetry see
    a stuck collective instead of the loop stalling forever.  Unlike a
    pre-dispatch fault the hung step HAS run (params updated), so the
    trainer records it and moves on rather than retrying."""
    kind = "hang"

    def __init__(self, site: str, hit: int, dt: float, deadline_s: float):
        RuntimeError.__init__(
            self, f"step hang at {site}: {dt:.3f}s exceeded the "
                  f"{deadline_s:.3f}s deadline (hit {hit})")
        self.site = site
        self.hit = hit
        self.dt = dt
        self.deadline_s = deadline_s


class FaultPlane:
    """Named-site fault injector (see module docstring).

    ``counts`` records every site hit whether or not a fault fired, so
    tests can assert a site was actually exercised — a fault plan against
    a site the workload never reaches is a vacuous test."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self._tape: Dict[Tuple[str, int], str] = {}
        self._rate = 0.0
        self._rng: Optional[np.random.Generator] = None
        self._sites: Optional[frozenset] = None
        self.fired: List[Tuple[str, int, str]] = []

    # -- construction --------------------------------------------------------

    @classmethod
    def from_tape(cls, tape: Sequence[Tuple[str, int, str]]) -> "FaultPlane":
        """``tape`` entries are ``(site, nth_hit, kind)`` (or 2-tuples with
        kind defaulting to 'fault')."""
        plane = cls()
        for entry in tape:
            site, nth = entry[0], int(entry[1])
            kind = entry[2] if len(entry) > 2 else "fault"
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r} "
                                 f"(sites: {', '.join(SITES)})")
            if nth < 1:
                raise ValueError(f"fault tape hit {nth} < 1 (1-based)")
            if kind not in ("fault", "crash"):
                raise ValueError(f"unknown fault kind {kind!r}")
            plane._tape[(site, nth)] = kind
        return plane

    @classmethod
    def seeded(cls, rate: float, seed: int = 0,
               sites: Optional[Sequence[str]] = None) -> "FaultPlane":
        """Bernoulli(rate) per site hit from one seeded stream — the same
        (workload, seed) always faults at the same hits.  ``sites``
        restricts the storm (default: every site except the
        iteration-boundary crash points ``sched.iter``/``train.iter``)."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate {rate} outside [0, 1]")
        plane = cls()
        plane._rate = rate
        plane._rng = np.random.default_rng(seed)
        plane._sites = frozenset(sites if sites is not None
                                 else set(SITES) - ITER_SITES)
        for s in plane._sites:
            if s not in SITES:
                raise ValueError(f"unknown fault site {s!r}")
        return plane

    @classmethod
    def parse(cls, spec: str) -> "FaultPlane":
        """CLI form: ``"site:nth[:kind],site:nth[:kind],..."`` or
        ``"storm:rate[:seed]"`` for a seeded schedule."""
        spec = spec.strip()
        if spec.startswith("storm:"):
            parts = spec.split(":")
            rate = float(parts[1])
            seed = int(parts[2]) if len(parts) > 2 else 0
            return cls.seeded(rate, seed)
        tape = []
        for item in spec.split(","):
            parts = item.strip().split(":")
            if len(parts) < 2:
                raise ValueError(f"bad fault spec {item!r} "
                                 "(want site:nth[:kind])")
            tape.append((parts[0], int(parts[1]),
                         parts[2] if len(parts) > 2 else "fault"))
        return cls.from_tape(tape)

    # -- firing --------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return True

    def fire(self, site: str) -> None:
        """Record a hit at ``site``; raise if the plan says so.  Always
        called BEFORE the instrumented operation mutates state."""
        hit = self.counts.get(site, 0) + 1
        self.counts[site] = hit
        kind = self._tape.get((site, hit))
        if kind is None and self._rng is not None and site in self._sites:
            if self._rng.random() < self._rate:
                kind = "fault"
        if kind is None:
            return
        self.fired.append((site, hit, kind))
        if kind == "crash":
            raise CrashError(site, hit)
        raise FaultError(site, hit)


class _NullPlane:
    """Disabled fault plane: ``fire`` is a no-op, shared process-wide.
    Instrumented call sites cost one method call and no branches."""

    enabled = False
    counts: Dict[str, int] = {}

    def fire(self, site: str) -> None:
        return


NULL = _NullPlane()


def resolve(faults) -> object:
    """Normalize a constructor argument: None -> the NULL plane, a spec
    string -> ``FaultPlane.parse``, a plane -> itself."""
    if faults is None:
        return NULL
    if isinstance(faults, str):
        return FaultPlane.parse(faults)
    return faults


# -- numerical fault injection (train-step sentinels) ------------------------

NAN_INJECT_KINDS = ("nan", "spike")


def parse_nan_inject(spec) -> Tuple[Tuple[str, int, Optional[int]], ...]:
    """Parse a numerical-injection spec for the train step's sentinels.

    Grammar: ``"kind:step[@attempt],..."`` where ``kind`` is ``nan``
    (loss and grads become NaN at that step) or ``spike`` (grads are
    scaled by 1e4 — a divergence, not an invalid value).  The optional
    ``@attempt`` scopes the injection to one expansion-guard attempt, so
    a post-expansion divergence can be injected on attempt 0 and absent
    after the guard rolls back and retries.  Returns
    ``((kind, step, attempt_or_None), ...)``; accepts ``None``/empty and
    already-parsed tuples.
    """
    if not spec:
        return ()
    if not isinstance(spec, str):
        return tuple((k, int(s), None if a is None else int(a))
                     for (k, s, a) in spec)
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        head, _, attempt = item.partition("@")
        kind, sep, step = head.partition(":")
        if kind not in NAN_INJECT_KINDS or not sep:
            raise ValueError(f"bad nan-inject spec {item!r} "
                             "(want kind:step[@attempt], kind in "
                             f"{'|'.join(NAN_INJECT_KINDS)})")
        out.append((kind, int(step), int(attempt) if attempt else None))
    return tuple(out)


def active_inject(entries, attempt: int) -> Dict[int, str]:
    """Filter parsed injections down to those live for ``attempt``
    (entries with no @attempt scope are live for every attempt); returns
    ``{step: kind}`` for the train step."""
    return {int(s): k for (k, s, a) in parse_nan_inject(entries)
            if a is None or a == attempt}
