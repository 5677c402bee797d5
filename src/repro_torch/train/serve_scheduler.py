"""Continuous-batching request scheduler (``repro/train/serve_scheduler.py``:
``Request``, ``RequestResult``, ``ContinuousScheduler`` and ``summarize``).

Iteration-level scheduling over ``ServeEngine``'s per-row-cursor decode:
the decode batch is ``max_batch`` *slots*.

  * Each arriving request is prefilled alone and scattered into a freed
    slot without perturbing live rows.  On a contiguous engine that is one
    B=1 forward at the exact prompt length; on a **paged** engine the
    prompt is prefilled in power-of-two chunks, one chunk per prefilling
    row per iteration, written straight into the shared page pool through
    the request's block table, and admission is gated on the pool
    (``kv_pool``: commitment admission, first fit over the arrived queue,
    alloc-on-advance with one page of lookahead, free-on-EOS).  With the
    engine's prefix cache, admission is match-aware: a radix hit is
    charged its tail only (``can_admit_prefix``), and an inadmissible
    hit is re-clamped shallower until it fits, so a fully cached head
    never deadlocks admission.
  * Every iteration runs ONE masked decode step across all slots; each row
    samples and writes its cache at its own cursor and stops itself on EOS
    or its token budget, while free slots are exact no-ops.
  * Finished sequences are streamed out (``on_finish``) and their slot
    (and pages) reclaimed as soon as the host sees them finish.

Host/device overlap (``overlap=True``): the scheduler dispatches decode step
k+1 BEFORE fetching step k's sampled tokens and active mask, so host
bookkeeping runs under the next device step.  Termination is observed one
iteration late; the extra step is a no-op for the finished row (its active
flag flipped on the device), so no token stream changes.

Speculative decoding (``ServeEngine(spec_decode=True)``): every iteration
is one speculation round, a draft loop and one multi-token verify, that
emits 1..γ+1 tokens per live row.  Before the round each row's pages are
backed up to ``min(cursor + γ + 1, limit)``; after it the fetched
accepted length moves the host cursor and ``KVBlockPool.truncate_row``
releases the pages past it, so rollback is host bookkeeping and no page
data moves.  Spec rounds fetch every round (``overlap`` does not apply):
the next round's pages depend on this round's accepted lengths.  The
accepted lengths land in ``RequestResult.spec_rounds`` /
``mean_accepted_len`` and ``spec_stats()``.

Admission aging (``admission_age_s``): once the oldest arrived request has
waited longer than this, later arrivals stop jumping it and admission
blocks until its worst-case pages fit (commitments drain as live requests
finish, so it then admits).  The aging preflight is prefix-aware: a head
whose full-depth hit cannot fit falls back to a shallower (or cold)
admission rather than block forever on a need no drain can satisfy.

Greedy decoding is deterministic per request: a request's tokens are
byte-identical to running it alone through ``ServeEngine.generate``.
Temperature sampling draws from one generator shared across slots, so
sampled streams depend on scheduling order.

Fault tolerance (the request lifecycle; ``train.faults`` injects):

  * **Finish reasons**: every request ends with exactly one of ``eos``,
    ``limit`` (its token budget), ``deadline`` (``deadline_s`` elapsed,
    queued or mid-decode), ``cancelled`` (:meth:`ContinuousScheduler.
    cancel`), ``failed`` (a fault outlived its retries) or ``shed`` (the
    bounded arrival queue was full), on its ``RequestResult``; the tokens
    a deadline, cancel or failure cut short are returned.
  * **Containment**: a transient ``FaultError`` or ``PoolExhausted`` in
    admission or chunked prefill retries with exponential backoff up to
    ``max_retries`` and then fails THAT request (pages freed, slot
    reclaimed, radix references dropped through ``pool.free``) while the
    batch serves on; a batch-wide decode or table-upload fault retries in
    place (every site fires before state moves).  Injected faults never
    escape :meth:`ContinuousScheduler.run`; a ``CrashError`` always does.
  * **Shedding**: ``queue_limit`` bounds the arrived-but-unadmitted queue;
    an arrival past it is rejected at once with a ``shed`` result.
  * **Crash-resume**: ``snapshot_every`` serializes the host-side state
    (queue, each request's prompt + emitted tokens, budgets) into
    ``last_snapshot`` at iteration boundaries; :meth:`restore` re-admits
    the interrupted requests by re-prefilling prompt + emitted through the
    chunked prefill (and the radix tree), so resumed greedy streams equal
    an uninterrupted run's (byte for byte where the prefill's chunking
    does not change the arithmetic: see ROADMAP's chunk-split rule).
  * **Invariant watchdog**: ``invariant_every`` audits the pool, and the
    radix tree's pins, every N iterations.

On a mesh (``ServeEngine(mesh=)``) every rank runs this loop over the
same host state and must take every decision alike, or the ranks enter
different collectives.  Each iteration's decode or speculation round
ends in the engine's ``exchange``: ONE all-gather that makes the slot
blocks' sampled tokens, active flags and accepted counts whole on every
rank and carries rank 0's clock reading, which the next iteration's
arrivals, deadlines and aging read.  An iteration that decoded nothing
exchanges the clock alone at its start, and a request's first-token time
is one more clock exchange at its admission; every other reading within
an iteration is the last agreed one.  ``kv_stats``, ``prefix_stats`` and
``spec_stats`` are then equal on every rank.

Every exchange also carries the cancels each rank has pending (a bit a
request of the run, OR'd over the ranks), and the cancellation sweep
reads the agreed set: a cancel called on any one rank takes effect on
every rank at the same iteration boundary.  After a request has
finished (and its ``on_finish`` callback run, on whichever ranks set
one), the next iteration boundary exchanges afresh, so a cancel made from
``on_finish`` lands at the boundary where it lands on one device.  The
engine's fault plane is agreed over the ranks (``ServeEngine.faults``):
a transient fault is retried, contained or fails its row on every rank
alike, and a ``CrashError`` unwinds every rank.  ``snapshot_every`` snapshots every rank at the same boundary (the
host state and the agreed clock readings it records are equal on every
rank), :func:`save_snapshot` with ``mesh=`` writes rank 0's copy, and
:meth:`ContinuousScheduler.restore` re-prefills on every rank, each
rank rebuilding its own share of the caches and recurrent carries.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.train import faults as faults_lib
from repro_torch.train.faults import CrashError, FaultError
from repro_torch.train.kv_pool import PoolExhausted
from repro_torch.train.serve_engine import ServeEngine

FINISH_REASONS = ("eos", "limit", "deadline", "cancelled", "failed", "shed")

# Reasons that mean the request was served to completion: only these count
# toward throughput and TTFT (see :func:`summarize`).
COMPLETED_REASONS = ("eos", "limit")


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request.  ``arrival_s`` is relative to scheduler
    start; 0 means already queued.  ``deadline_s`` (relative to arrival)
    overrides the scheduler-wide default: past it the request finishes
    ``deadline`` wherever it is, with the tokens it has.  ``eq=False``:
    requests compare by identity (a generated ``__eq__`` over a numpy
    prompt is ambiguous)."""
    prompt: np.ndarray                # (P,) int32
    max_new_tokens: int
    arrival_s: float = 0.0
    uid: Optional[int] = None         # assigned by the scheduler if None
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class RequestResult:
    uid: int
    prompt: np.ndarray                # (P,) int32
    new_tokens: np.ndarray            # (G,) int32 generated tokens (EOS incl.;
                                      # partial for deadline/cancel/failed)
    finish_reason: str                # one of FINISH_REASONS
    slot: int                         # cache row served in (-1: never slotted)
    arrival_s: float
    admitted_s: float                 # prefill completion (= first token;
                                      # NaN when never admitted)
    finished_s: float
    spec_rounds: int = 0              # speculation rounds this request saw
    prefix_tokens: int = 0            # prompt tokens served from shared
                                      # pages (prefix-cache hit; 0 = cold)
    error: Optional[str] = None       # failure detail (failed/shed)

    @property
    def completed(self) -> bool:
        """True iff the request ran to its natural end (eos / budget)."""
        return self.finish_reason in COMPLETED_REASONS

    @property
    def tokens(self) -> np.ndarray:
        return np.concatenate([self.prompt, self.new_tokens])

    @property
    def ttft_s(self) -> float:
        """Time to first token: arrival -> first sampled token (prefill)."""
        return self.admitted_s - self.arrival_s

    @property
    def mean_accepted_len(self) -> float:
        """Mean tokens emitted per speculation round (1 + accepted drafts;
        the prefill's token is not a round's).  0.0 when not spec-decoded."""
        if not self.spec_rounds:
            return 0.0
        return max(len(self.new_tokens) - 1, 0) / self.spec_rounds


class ContinuousScheduler:
    """Request queue + slot allocator over a ``ServeEngine`` (see module
    docstring).

    ``chunk_len`` caps the prefill chunk width on paged engines (None: the
    prompt's binary decomposition, one chunk per iteration).
    ``num_blocks`` overrides the engine's pool size per run.
    ``overlap=False`` fetches each step before dispatching the next (the
    token streams are identical either way).

    Robustness knobs: ``deadline_s`` (default per-request deadline),
    ``queue_limit`` (arrived-queue bound; overflow sheds),
    ``max_retries`` / ``retry_backoff_s`` (transient-fault containment),
    ``invariant_every`` (pool and radix audit every N iterations),
    ``snapshot_every`` (host-state snapshot at every Nth iteration boundary
    into ``last_snapshot``: the crash-recovery input)."""

    def __init__(self, engine: ServeEngine, max_batch: int = 4,
                 temperature: float = 0.0, eos_id: int = -1, seed: int = 0,
                 time_fn: Callable[[], float] = time.perf_counter,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 poll_s: float = 1e-3, chunk_len: Optional[int] = None,
                 overlap: bool = True, num_blocks: Optional[int] = None,
                 admission_age_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 queue_limit: Optional[int] = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.02,
                 invariant_every: int = 0, snapshot_every: int = 0):
        if max_batch < 1:
            raise ValueError(f"max_batch {max_batch} < 1")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue_limit {queue_limit} < 1")
        if max_retries < 0:
            raise ValueError(f"max_retries {max_retries} < 0")
        self.engine = engine
        self.max_batch = max_batch
        self.temperature = temperature
        self.eos_id = eos_id if eos_id is not None else -1
        self.seed = seed
        self.time_fn = time_fn                 # virtual clocks: pair with a
        self.sleep_fn = sleep_fn               # matching sleep_fn
        self.poll_s = poll_s
        self.chunk_len = chunk_len
        self.overlap = overlap
        self.num_blocks = num_blocks
        self.admission_age_s = admission_age_s
        self.deadline_s = deadline_s
        self.queue_limit = queue_limit
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.invariant_every = invariant_every
        self.snapshot_every = snapshot_every
        self.peak_concurrency = 0              # max in flight (live+prefill)
        self.spec_rounds = 0                   # speculation telemetry:
        self.spec_proposed = 0                 #   rounds / draft tokens in
        self.spec_accepted = 0                 #   play / accepted
        self.last_state = None                 # the last run's final state
        self.prefix_requests = 0               # prefix-cache telemetry:
        self.prefix_hits = 0                   #   admissions / tree hits /
        self.prefix_skipped_tokens = 0         #   prompt tokens not prefilled
        self.retries = 0                       # fault telemetry: transient
        self.shed = 0                          #   retries / reason counters
        self.failed = 0
        self.deadline_hits = 0
        self.cancelled = 0
        self.last_snapshot: Optional[dict] = None
        self._cancel_uids: set = set()
        self._ctx: Optional[dict] = None       # run() internals, for snapshot

    @property
    def acceptance_rate(self) -> float:
        """Accepted over proposed draft tokens in the last run (0.0 when
        not spec-decoding)."""
        return self.spec_accepted / max(self.spec_proposed, 1)

    def spec_stats(self) -> dict:
        return {"spec_rounds": self.spec_rounds,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "acceptance_rate": self.acceptance_rate}

    def prefix_stats(self) -> dict:
        """Prefix-cache telemetry of the last run (all zero when the engine
        serves without a radix cache)."""
        return {"prefix_requests": self.prefix_requests,
                "prefix_hits": self.prefix_hits,
                "prefix_hit_rate": (self.prefix_hits
                                    / max(self.prefix_requests, 1)),
                "prefix_skipped_tokens": self.prefix_skipped_tokens}

    def fault_stats(self) -> dict:
        """Lifecycle and fault telemetry of the last run.  ``fault_sites``
        is the fault plane's hit count per site (empty on the NULL plane):
        the receipt that a fault schedule exercised the sites it names."""
        return {"retries": self.retries, "shed": self.shed,
                "failed": self.failed, "deadline": self.deadline_hits,
                "cancelled": self.cancelled,
                "fault_sites": dict(self.engine.faults.counts)}

    def kv_stats(self) -> dict:
        """The pool's bytes per cached token, scale leaves included, and
        its ratio to an f32 pool.  Quantization changes no page count, so
        the ratio is the capacity win at fixed cache bytes (int8 or fp8
        pages with f32 scales: (hd + 4) / (4 hd)).  Degenerate on
        contiguous engines, which have no pool, and on models with no
        paged attention layer (``rwkv6-7b``, Mamba stacks): their pool
        holds 0 bytes a token in every dtype, and the ratio is 1.0 where
        the reference divides 0 by 0 and raises."""
        eng = self.engine
        if not eng.paged:
            return {"kv_dtype": None, "kv_bytes_per_token": 0.0,
                    "kv_bytes_per_token_f32": 0.0, "kv_bytes_ratio": 1.0}
        bpt = eng.kv_bytes_per_token()
        f32 = eng.kv_bytes_per_token(kv_dtype="f32")
        dtype = eng.kv_dtype if eng.kv_dtype is not None else eng.cache_dtype
        return {"kv_dtype": str(dtype).replace("torch.", ""),
                "kv_bytes_per_token": bpt, "kv_bytes_per_token_f32": f32,
                "kv_bytes_ratio": bpt / f32 if f32 else 1.0}

    def cancel(self, uid: int) -> None:
        """Ask for ``uid`` to be cancelled at the next iteration boundary,
        wherever it is (queued: no tokens; prefilling or live: the tokens
        so far, pages freed, slot reclaimed).  Unknown or finished uids are
        ignored.  Callable from ``on_finish`` or another thread (a set add
        is atomic under the GIL).  On a mesh, from any one rank: the next
        exchange takes it to every rank (module docstring)."""
        self._cancel_uids.add(uid)

    def warmup(self, requests: Sequence[Request]):
        """Run every prompt length the workload holds once, two tokens
        each, outside the timed run (builds the kernels and warms the
        allocator and the card).  The fault plane is suspended meanwhile:
        site hit counts, and so fault tapes, index the measured run only."""
        seen = {len(np.asarray(r.prompt).ravel()): r.prompt
                for r in requests}
        eng = self.engine
        saved, eng.faults = eng.faults, faults_lib.NULL
        try:
            self.run([Request(prompt=p, max_new_tokens=2)
                      for p in seen.values()])
        finally:
            eng.faults = saved

    def _validate(self, reqs):
        engine = self.engine
        if len({r.uid for r in reqs}) != len(reqs):
            raise ValueError("duplicate request uids")
        for r in reqs:
            if r.max_new_tokens < 1:
                raise ValueError(f"request {r.uid}: max_new_tokens < 1")
            engine.check_lengths(len(r.prompt), r.max_new_tokens)
            if engine.paged:
                need = max(1, -(-(len(r.prompt) + r.max_new_tokens - 1)
                                // engine.block_size))
                cap = self.num_blocks if self.num_blocks is not None \
                    else engine._resolved_num_blocks(self.max_batch)
                if need > min(cap, engine.max_blocks):
                    raise ValueError(
                        f"request {r.uid}: needs {need} pages, pool holds "
                        f"{min(cap, engine.max_blocks)} per row")

    def run(self, requests: Sequence[Request],
            on_finish: Optional[Callable[[RequestResult], None]] = None
            ) -> List[RequestResult]:
        """Serve all requests; returns results in submission order.

        Transient injected faults (``FaultError`` / ``PoolExhausted``)
        never escape this loop; ``CrashError`` always does (it models the
        process dying: recover through ``last_snapshot`` and
        :meth:`restore` on a fresh scheduler)."""
        engine, paged = self.engine, self.engine.paged
        faults = engine.faults
        reqs = [dataclasses.replace(
                    r, uid=r.uid if r.uid is not None else i,
                    prompt=np.asarray(r.prompt, np.int32).ravel())
                for i, r in enumerate(requests)]
        self._validate(reqs)
        spec = paged and engine.spec_decode
        self.peak_concurrency = 0
        self.spec_rounds = self.spec_proposed = self.spec_accepted = 0
        self.prefix_requests = self.prefix_hits = 0
        self.prefix_skipped_tokens = 0
        self.retries = self.shed = self.failed = 0
        self.deadline_hits = self.cancelled = 0
        self.last_snapshot = None
        self._cancel_uids = set()
        rounds_by_uid: dict = {}  # uid -> speculation rounds seen
        prefix_by_uid: dict = {}  # uid -> prompt tokens served by a hit
        pending = deque(sorted(reqs, key=lambda r: r.arrival_s))
        waiting: deque = deque()  # arrived, not yet admitted (bounded)
        state = engine.continuous_state(
            self.max_batch, temperature=self.temperature, seed=self.seed,
            num_blocks=self.num_blocks)
        free = list(range(self.max_batch))[::-1]   # pop() -> row 0 first
        live: dict = {}           # row -> (req, [tokens], t_first)
        prefilling: dict = {}     # row -> (req, PrefillJob)   (paged only)
        cursors: dict = {}        # row -> host mirror of the decode cursor
        done: dict = {}
        # Retry bookkeeping for transient faults: per slot for in-flight
        # prefill and admit, per uid for queued admission.  Attempts reset
        # on any progress; the backoff doubles per consecutive failure.
        row_attempts: dict = {}   # row -> consecutive failed attempts
        row_retry_at: dict = {}   # row -> earliest next attempt (rel. t0)
        adm_attempts: dict = {}   # uid -> consecutive failed admissions
        adm_retry_at: dict = {}
        # Dispatch-then-fetch double buffering: device tensors of steps
        # whose host bookkeeping is pending, with (row, uid) of every row
        # live at dispatch; the uid guards against crediting a stale step's
        # token to a request readmitted into a just-freed slot.  A spec
        # round's entry also holds its accepted lengths.
        fetch_q: deque = deque()  # (tokens_dev, active_dev, ((row, uid),..)
                                  #  [, acc_dev])
        t0 = self.time_fn()
        on_mesh = engine.mesh is not None
        agreed = None             # on a mesh: the last exchange's clock
        carried = False           # this iteration's exchange carried it
        # On a mesh: the cancels every rank applies (the last exchange's),
        # and whether a request finished since (its on_finish may cancel).
        uids = [r.uid for r in reqs]
        bit_of = {uid: i for i, uid in enumerate(uids)}
        agreed_cancels: set = set()
        finished_since = False

        def cancel_words():
            """This rank's pending cancels, a bit per request of the run."""
            words = [0] * (-(-len(uids) // 63))
            for uid in list(self._cancel_uids):
                i = bit_of.get(uid)
                if i is not None:
                    words[i // 63] |= 1 << (i % 63)
            return words

        def agree(words):
            nonlocal agreed_cancels, finished_since
            agreed_cancels = {uid for i, uid in enumerate(uids)
                              if words[i // 63] >> (i % 63) & 1}
            finished_since = False

        def clock(fresh: bool = True) -> float:
            """Seconds since t0.  On a mesh every rank reads rank 0's
            clock: a clock-only exchange (``fresh``), which carries the
            pending cancels too, else the last exchange's reading."""
            nonlocal agreed
            if not on_mesh:
                return self.time_fn() - t0
            if fresh:
                _, agreed, words = engine.exchange(
                    state, (), self.time_fn() - t0, cancel_words())
                agree(words)
            return agreed

        def gathered(*blocks):
            """A dispatched step's slot blocks made whole: on a mesh the
            iteration's exchange, whose clock the next iteration reads."""
            nonlocal agreed, carried
            if not on_mesh:
                return blocks
            blocks, agreed, words = engine.exchange(
                state, blocks, self.time_fn() - t0, cancel_words())
            agree(words)
            carried = True
            return blocks

        def deadline_of(req) -> Optional[float]:
            return req.deadline_s if req.deadline_s is not None \
                else self.deadline_s

        def finish(req, tokens, slot, t_first, now, reason=None, error=None):
            nonlocal finished_since
            if reason is None:
                reason = ("eos" if self.eos_id >= 0 and tokens
                          and tokens[-1] == self.eos_id else "limit")
            if reason == "shed":
                self.shed += 1
            elif reason == "failed":
                self.failed += 1
            elif reason == "deadline":
                self.deadline_hits += 1
            elif reason == "cancelled":
                self.cancelled += 1
            res = RequestResult(
                uid=req.uid, prompt=req.prompt,
                new_tokens=np.asarray(tokens, np.int32),
                finish_reason=reason, slot=slot, arrival_s=req.arrival_s,
                admitted_s=t_first, finished_s=now,
                spec_rounds=rounds_by_uid.pop(req.uid, 0),
                prefix_tokens=prefix_by_uid.pop(req.uid, 0), error=error)
            adm_attempts.pop(req.uid, None)
            adm_retry_at.pop(req.uid, None)
            self._cancel_uids.discard(req.uid)
            agreed_cancels.discard(req.uid)
            done[req.uid] = res
            # On a mesh every rank marks it, whether or not its own
            # on_finish is set (the ranks' callbacks may differ).
            finished_since = on_mesh
            if on_finish is not None:
                on_finish(res)

        def drain(keep: int):
            """Apply host bookkeeping for dispatched steps beyond `keep`."""
            nonlocal state
            while len(fetch_q) > keep:
                entry = fetch_q.popleft()
                rows = entry[2]
                toks, act = entry[0].cpu().numpy(), entry[1].cpu().numpy()
                acc = entry[3].cpu().numpy() if len(entry) > 3 else None
                now = clock(fresh=False)
                for row, uid in rows:
                    if row not in live or live[row][0].uid != uid:
                        continue     # slot readmitted since this dispatch
                    req, out, t_first = live[row]
                    if acc is None:  # masked decode: cursor moved at dispatch
                        out.append(int(toks[row, 0]))
                    else:            # speculation round: 1..γ+1 tokens
                        a = int(acc[row])
                        out.extend(int(t) for t in toks[row, :a])
                        # Proposals in play only: the limit caps a round's
                        # emissions at limit - cursor (bonus included), so
                        # a perfect draft reads exactly 1.0 also on the
                        # round that ends a row at its budget.
                        limit = len(req.prompt) + req.max_new_tokens - 1
                        self.spec_proposed += max(
                            min(engine.gamma, limit - cursors[row] - 1), 0)
                        self.spec_accepted += max(a - 1, 0)
                        rounds_by_uid[uid] = rounds_by_uid.get(uid, 0) + 1
                        cursors[row] += a
                    if not act[row]:   # terminated: stream out, free slot
                        finish(req, out, row, t_first, now)
                        del live[row]
                        cursors.pop(row, None)
                        if paged:
                            state = engine.free_slot(state, row)
                        free.append(row)
                    elif acc is not None:
                        # Rollback: release the pages past the accepted
                        # cursor (the round backed all γ+1 positions).
                        state.pool.truncate_row(row, cursors[row])

        def fail_row(row, reason, now, error=None):
            """Terminate ONE in-flight row (fault containment, deadline or
            cancel) without touching the rest of the batch: flush pending
            fetches, flip the row inactive on the device, return its pages
            to the pool (dropping any shared-prefix references), reclaim
            the slot and emit its (possibly partial) result."""
            nonlocal state
            drain(0)
            if row not in live and row not in prefilling:
                return               # drain observed its natural finish
            if row in prefilling:
                req, _job = prefilling.pop(row)
                out, t_first = [], float("nan")
            else:
                req, out, t_first = live.pop(row)
                state = engine.deactivate_row(state, row)
            cursors.pop(row, None)
            row_attempts.pop(row, None)
            row_retry_at.pop(row, None)
            if paged and row in state.pool._commit:
                state = engine.free_slot(state, row)
            free.append(row)
            finish(req, out, row, t_first, now, reason=reason, error=error)

        def pool_advance(row, num_tokens) -> bool:
            """``pool.advance`` with an inline bounded retry (its alloc and
            evict sites fire before state moves, and allocation resumes
            where it stopped, so an immediate retry is exact).  Returns
            False after failing the row on exhausted retries."""
            err = None
            for _ in range(self.max_retries + 1):
                try:
                    state.pool.advance(row, num_tokens)
                    return True
                except CrashError:
                    raise
                except (FaultError, PoolExhausted) as e:
                    self.retries += 1
                    err = e
            fail_row(row, "failed", clock(fresh=False), error=str(err))
            return False

        def retry_batch(fn):
            """A batch-wide step with in-place retries; on exhaustion every
            live row fails (state is untouched by the faulted calls, and
            the queue behind them still serves).  Returns fn's result or
            None."""
            err = None
            for _ in range(self.max_retries + 1):
                try:
                    return fn()
                except CrashError:
                    raise
                except FaultError as e:
                    self.retries += 1
                    err = e
            for row in list(live):
                fail_row(row, "failed", clock(fresh=False), error=str(err))
            return None

        self._ctx = {"live": live, "prefilling": prefilling,
                     "waiting": waiting, "pending": pending, "done": done,
                     "order": [r.uid for r in reqs], "drain": drain}
        it = 0
        while pending or waiting or live or prefilling or fetch_q:
            it += 1
            now = clock(fresh=not carried or finished_since)
            carried = False
            # ---- snapshot at the iteration boundary (crash recovery) ------
            # Taken BEFORE this iteration's site can crash: a crash anywhere
            # in the iteration loses at most the iteration's own work, which
            # restore() re-derives.
            if self.snapshot_every and (it - 1) % self.snapshot_every == 0:
                drain(0)
                self.last_snapshot = self.snapshot()
                if finished_since:     # on a mesh: the drain's callbacks
                    now = clock()      # may have cancelled
            try:
                faults.fire("sched.iter")
            except CrashError:
                raise                # models kill -9: escape uncontained
            except FaultError:
                pass                 # boundary fault: nothing in flight
            # ---- invariant watchdog ---------------------------------------
            if self.invariant_every and it % self.invariant_every == 0 \
                    and paged:
                state.pool.check_invariants()
                if state.radix is not None:
                    state.radix.check_invariants()
            # ---- arrivals into the bounded waiting queue (shed overflow) --
            while pending and pending[0].arrival_s <= now:
                req = pending.popleft()
                if self.queue_limit is not None \
                        and len(waiting) >= self.queue_limit:
                    finish(req, [], -1, float("nan"), now, reason="shed",
                           error=f"arrival queue full "
                                 f"(queue_limit={self.queue_limit})")
                    continue
                waiting.append(req)
            # ---- cancellation and deadline sweeps -------------------------
            cancels = agreed_cancels if on_mesh else self._cancel_uids
            if cancels:
                for q in (waiting, pending):
                    for req in [r for r in q if r.uid in cancels]:
                        q.remove(req)
                        finish(req, [], -1, float("nan"), now,
                               reason="cancelled")
                for row in list(prefilling) + list(live):
                    holder = prefilling.get(row) or live.get(row)
                    if holder and holder[0].uid in cancels:
                        fail_row(row, "cancelled", now)
            for req in [r for r in waiting
                        if deadline_of(r) is not None
                        and now - r.arrival_s > deadline_of(r)]:
                waiting.remove(req)
                finish(req, [], -1, float("nan"), now, reason="deadline")
            for row in list(prefilling) + list(live):
                holder = prefilling.get(row) or live.get(row)
                if holder is None:
                    continue
                dl = deadline_of(holder[0])
                if dl is not None and now - holder[0].arrival_s > dl:
                    fail_row(row, "deadline", now)
            # ---- admit waiting requests into free slots -------------------
            # Paged admission is FIRST FIT over the arrived queue: a request
            # whose worst-case pages do not fit yet must not idle pages a
            # later short request could use.  ``admission_age_s`` bounds
            # how long later arrivals may keep jumping it.
            skip = 0
            while free and skip < len(waiting):
                req = waiting[skip]
                retry_at = adm_retry_at.get(req.uid)
                if retry_at is not None and now < retry_at:
                    skip += 1        # backing off a faulted admission
                    continue
                if not paged:
                    del waiting[skip]
                    state, tok, row_cache = engine.prefill_request(
                        state, req.prompt, temperature=self.temperature)
                    first = int(tok[0, 0].item())
                    t_first = clock()
                    if req.max_new_tokens == 1 or \
                            (self.eos_id >= 0 and first == self.eos_id):
                        finish(req, [first], -1, t_first, t_first)
                        continue
                    row = free.pop()
                    state = engine.admit_request(
                        state, row, tok, row_cache, len(req.prompt),
                        req.max_new_tokens, temperature=self.temperature)
                    live[row] = (req, [first], t_first)
                    cursors[row] = len(req.prompt)
                    continue
                row = None
                try:
                    # Match-aware admission: a prefix-cache hit references
                    # its matched pages instead of allocating them, so it is
                    # charged the unmatched tail (+ the COW clone, + any
                    # matched page that stops being evictable).
                    match = engine.prefix_match(state, req.prompt) \
                        if engine.prefix_cache else None
                    need = state.pool.blocks_needed(len(req.prompt),
                                                    req.max_new_tokens)
                    ok = state.pool.can_admit(need) if match is None else \
                        state.pool.can_admit_prefix(need, match.pages,
                                                    match.cow_last)
                    # A deep hit can charge MORE than a cold admission
                    # (matched pinned-only pages stop being evictable), so
                    # a fully cached request in a tight pool may not fit at
                    # full depth while a shallower match, or a cold
                    # admission with the evictor reclaiming pins, fits now.
                    # Re-clamp until it fits, or an aged head would block
                    # admission forever.
                    while not ok and match is not None:
                        match = engine.prefix_match(
                            state, req.prompt,
                            max_pages=len(match.pages) - 1)
                        ok = state.pool.can_admit(need) if match is None \
                            else state.pool.can_admit_prefix(
                                need, match.pages, match.cow_last)
                    if not ok:
                        if skip == 0 and self.admission_age_s is not None \
                                and now - req.arrival_s \
                                > self.admission_age_s:
                            break  # aged head: no one admits past it
                        skip += 1      # try later arrivals that fit
                        continue
                    row = free.pop()
                    state, job = engine.begin_prefill(
                        state, row, req.prompt, req.max_new_tokens,
                        chunk_len=self.chunk_len,
                        temperature=self.temperature, match=match)
                except CrashError:
                    raise
                except (FaultError, PoolExhausted) as e:
                    # Containment: undo the half-admission (the pool's
                    # sites fire before allocation moves state, so freeing
                    # the committed row restores it exactly), then retry
                    # with backoff or fail just this request.
                    if row is not None:
                        if row in state.pool._commit:
                            state.pool.free(row)
                        free.append(row)
                    self.retries += 1
                    attempts = adm_attempts.get(req.uid, 0) + 1
                    if attempts > self.max_retries:
                        del waiting[skip]
                        finish(req, [], -1, float("nan"),
                               clock(fresh=False), reason="failed",
                               error=str(e))
                    else:
                        adm_attempts[req.uid] = attempts
                        adm_retry_at[req.uid] = now + self.retry_backoff_s \
                            * (2 ** (attempts - 1))
                        skip += 1
                    continue
                del waiting[skip]
                adm_attempts.pop(req.uid, None)
                adm_retry_at.pop(req.uid, None)
                if engine.prefix_cache:
                    self.prefix_requests += 1
                    if match is not None:
                        self.prefix_hits += 1
                        self.prefix_skipped_tokens += job.prefix_tokens
                        prefix_by_uid[req.uid] = job.prefix_tokens
                prefilling[row] = (req, job)
            # ---- chunked prefill: one chunk per prefilling row ------------
            for row in list(prefilling):
                if row not in prefilling:
                    continue
                retry_at = row_retry_at.get(row)
                if retry_at is not None and now < retry_at:
                    continue
                req, job = prefilling[row]
                try:
                    if not job.done:
                        state, tok = engine.prefill_chunk(
                            state, job, temperature=self.temperature)
                        if tok is not None:
                            # Parked on the job across an admit retry: the
                            # prefill must not rerun to resample it.
                            job.first_token = tok
                    if not job.done:
                        row_attempts.pop(row, None)   # progress: reset
                        row_retry_at.pop(row, None)
                        continue
                    first = int(job.first_token[0, 0].item())
                    t_first = clock()
                    if req.max_new_tokens == 1 or \
                            (self.eos_id >= 0 and first == self.eos_id):
                        del prefilling[row]
                        finish(req, [first], row, t_first, t_first)
                        state = engine.free_slot(state, row)
                        free.append(row)
                    else:
                        state = engine.admit_paged(
                            state, job, job.first_token,
                            temperature=self.temperature)
                        del prefilling[row]
                        live[row] = (req, [first], t_first)
                        cursors[row] = len(req.prompt)
                    row_attempts.pop(row, None)
                    row_retry_at.pop(row, None)
                except CrashError:
                    raise
                except (FaultError, PoolExhausted) as e:
                    # prefill_chunk is transactional and admit_paged flips
                    # the row live only AFTER its fault-prone host steps,
                    # so the job is exactly where it was: retry in a later
                    # iteration, or fail this one row.
                    self.retries += 1
                    attempts = row_attempts.get(row, 0) + 1
                    if attempts > self.max_retries:
                        fail_row(row, "failed", clock(fresh=False),
                                 error=str(e))
                    else:
                        row_attempts[row] = attempts
                        row_retry_at[row] = now + self.retry_backoff_s \
                            * (2 ** (attempts - 1))
            self.peak_concurrency = max(self.peak_concurrency,
                                        len(live) + len(prefilling))
            if not live:
                drain(0)
                if not (live or prefilling):
                    if pending and not waiting:
                        wait = pending[0].arrival_s - clock(fresh=False)
                        if wait > 0:       # idle until the next arrival
                            self.sleep_fn(min(wait, self.poll_s))
                    elif waiting:
                        # blocked admission (capacity or retry backoff):
                        # nothing to decode, so idle one poll tick
                        self.sleep_fn(self.poll_s)
                continue
            # ---- one speculation round across all slots -------------------
            if spec:
                # The verify writes positions cursor..cursor+γ, those short
                # of the row's limit: back them all before the dispatch.
                for row in list(live):
                    if row not in live:
                        continue
                    req = live[row][0]
                    limit = len(req.prompt) + req.max_new_tokens - 1
                    pool_advance(row, min(cursors[row] + engine.gamma + 1,
                                          limit))
                if not live:
                    continue
                out = retry_batch(lambda: engine.decode_spec(
                    state, temperature=self.temperature, eos_id=self.eos_id))
                if out is None:
                    continue
                state, out_d, acc_d = out
                self.spec_rounds += 1
                out_d, act_d, acc_d = gathered(out_d, state.active, acc_d)
                fetch_q.append((out_d, act_d,
                                tuple((row, live[row][0].uid)
                                      for row in live), acc_d))
                drain(0)
                continue
            # ---- one masked decode iteration across all slots -------------
            if paged:
                # alloc-on-advance: back the slot each live row writes next,
                # plus one page of lookahead.  Admission is commitment-
                # gated, so an early page costs nothing, and the table
                # re-uploads once per page of tokens, not at every boundary.
                bs = engine.block_size
                for row in list(live):
                    if row not in live:
                        continue
                    req = live[row][0]
                    limit = len(req.prompt) + req.max_new_tokens - 1
                    pool_advance(row, min(cursors[row] + 1 + bs, limit))
                if not live:
                    continue
            new_state = retry_batch(lambda: engine.decode_masked(
                state, temperature=self.temperature, eos_id=self.eos_id))
            if new_state is None:
                continue
            state = new_state
            fetch_q.append(tuple(gathered(state.tokens, state.active))
                           + (tuple((row, live[row][0].uid)
                                    for row in live),))
            for row in live:           # host mirror (clamped in advance)
                cursors[row] += 1
            drain(1 if self.overlap else 0)
        self.last_state = state
        return [done[r.uid] for r in reqs]

    # -- crash-resume ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Serialize the host-side serving state at an iteration boundary:
        queued requests, each in-flight request's prompt + emitted tokens +
        budget, and the results already finished.  JSON-compatible
        (:func:`save_snapshot`), in the reference's layout.  Device state
        is left out: K/V at a position depends only on the token prefix,
        so :meth:`restore` rebuilds it by re-prefilling."""
        ctx = self._ctx
        if ctx is None:
            raise RuntimeError("snapshot(): no run in progress or recorded")
        ctx["drain"](0)          # flush dispatched steps: tokens are final

        def pack_req(req, emitted):
            return {"uid": int(req.uid),
                    "prompt": [int(t) for t in req.prompt],
                    "emitted": [int(t) for t in emitted],
                    "max_new_tokens": int(req.max_new_tokens),
                    "arrival_s": float(req.arrival_s),
                    "deadline_s": (None if req.deadline_s is None
                                   else float(req.deadline_s))}

        inflight = [pack_req(req, []) for req, _job
                    in ctx["prefilling"].values()]
        inflight += [pack_req(req, out) for req, out, _t
                     in ctx["live"].values()]
        queued = [pack_req(r, []) for r in
                  list(ctx["waiting"]) + list(ctx["pending"])]
        finished = [{
            "uid": int(r.uid), "prompt": [int(t) for t in r.prompt],
            "new_tokens": [int(t) for t in r.new_tokens],
            "finish_reason": r.finish_reason, "slot": int(r.slot),
            "arrival_s": float(r.arrival_s),
            "admitted_s": float(r.admitted_s),
            "finished_s": float(r.finished_s),
            "spec_rounds": int(r.spec_rounds),
            "prefix_tokens": int(r.prefix_tokens), "error": r.error,
        } for r in ctx["done"].values()]
        return {"order": list(ctx["order"]), "inflight": inflight,
                "queued": queued, "done": finished}

    def restore(self, snap: dict,
                on_finish: Optional[Callable[[RequestResult], None]] = None
                ) -> List[RequestResult]:
        """Resume a :meth:`snapshot` on THIS scheduler (typically over a
        fresh engine after a crash): every interrupted request re-enters
        admission with ``prompt + emitted`` as its prompt and its remaining
        budget, so the chunked prefill (and radix tree) rebuilds the
        device state it lost, and the merged results splice the
        snapshot's emitted tokens back in front.  Deadlines restart at
        resume (the dead process's wall time is not charged).  Returns the
        whole workload's results, snapshot-finished and resumed, in
        submission order."""
        emitted = {}
        reqs = []
        for item in snap["inflight"] + snap["queued"]:
            e = [int(t) for t in item["emitted"]]
            emitted[item["uid"]] = e
            reqs.append(Request(
                prompt=np.asarray(list(item["prompt"]) + e, np.int32),
                max_new_tokens=item["max_new_tokens"] - len(e),
                arrival_s=0.0, uid=item["uid"],
                deadline_s=item.get("deadline_s")))
        merged = {}
        if reqs:
            for r in self.run(reqs, on_finish=on_finish):
                e = emitted[r.uid]
                if e:
                    orig_p = len(r.prompt) - len(e)
                    r = dataclasses.replace(
                        r, prompt=r.prompt[:orig_p],
                        new_tokens=np.concatenate(
                            [np.asarray(e, np.int32), r.new_tokens]))
                merged[r.uid] = r
        for item in snap["done"]:
            merged[item["uid"]] = RequestResult(
                uid=item["uid"],
                prompt=np.asarray(item["prompt"], np.int32),
                new_tokens=np.asarray(item["new_tokens"], np.int32),
                finish_reason=item["finish_reason"], slot=item["slot"],
                arrival_s=item["arrival_s"], admitted_s=item["admitted_s"],
                finished_s=item["finished_s"],
                spec_rounds=item["spec_rounds"],
                prefix_tokens=item["prefix_tokens"],
                error=item.get("error"))
        return [merged[uid] for uid in snap["order"] if uid in merged]


def save_snapshot(snap: dict, path, mesh=None) -> None:
    """Write a :meth:`ContinuousScheduler.snapshot` as plain JSON (host
    lists and ints only).  With ``mesh`` (every rank calls it, with the
    same snapshot) rank 0 writes and every rank returns once the file is
    written, so every rank may :func:`load_snapshot` it."""
    if mesh is None or mesh.rank == 0:
        with open(path, "w") as f:
            json.dump(snap, f)
    if mesh is not None:
        from repro_torch.distributed import collectives as coll
        coll.agree_code(mesh, 0)                       # a barrier


def load_snapshot(path) -> dict:
    with open(path) as f:
        return json.load(f)


def summarize(results: Sequence[RequestResult], wall_s: float) -> dict:
    """Aggregate serving metrics, grouped by finish reason.

    Throughput and TTFT percentiles count COMPLETED requests only (``eos``
    / ``limit``): a shed rejection or a half-served deadline must not
    pollute the latency tail or inflate tokens/s.  ``goodput`` is the
    completed-token rate (= ``tokens_per_s``); the ``*_all`` variants
    include the partial tokens of failed, deadline and cancelled requests.
    An empty completed set reports NaN percentiles, not 0."""
    by_reason: dict = {}
    for r in results:
        by_reason[r.finish_reason] = by_reason.get(r.finish_reason, 0) + 1
    completed = [r for r in results if r.completed]
    gen = int(sum(len(r.new_tokens) for r in completed))
    gen_all = int(sum(len(r.new_tokens) for r in results))
    if completed:
        ttft = np.sort([r.ttft_s for r in completed])
        p50, p95 = (float(np.percentile(ttft, 50)),
                    float(np.percentile(ttft, 95)))
    else:
        p50 = p95 = float("nan")
    return {
        "requests": len(results),
        "completed": len(completed),
        "finish_reasons": by_reason,
        "generated_tokens": gen,
        "generated_tokens_all": gen_all,
        "wall_s": wall_s,
        "tokens_per_s": gen / max(wall_s, 1e-9),
        "tokens_per_s_all": gen_all / max(wall_s, 1e-9),
        "goodput": gen / max(wall_s, 1e-9),
        "ttft_p50_s": p50,
        "ttft_p95_s": p95,
    }
