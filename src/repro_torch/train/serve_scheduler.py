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
    alloc-on-advance with one page of lookahead, free-on-EOS).
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

Admission aging (``admission_age_s``): once the oldest arrived request has
waited longer than this, later arrivals stop jumping it and admission
blocks until its worst-case pages fit (commitments drain as live requests
finish, so it then admits).

Greedy decoding is deterministic per request: a request's tokens are
byte-identical to running it alone through ``ServeEngine.generate``.
Temperature sampling draws from one generator shared across slots, so
sampled streams depend on scheduling order.

Deadlines, cancellation, shedding, retries, fault containment and
snapshot/restore come with ROADMAP queue A item 11; speculative decoding
with item 9; prefix sharing with item 10.  So the only finish reasons here
are ``eos`` and ``limit``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.train.serve_engine import ServeEngine

FINISH_REASONS = ("eos", "limit")


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request.  ``arrival_s`` is relative to scheduler
    start; 0 means already queued.  ``eq=False``: requests compare by
    identity (a generated ``__eq__`` over a numpy prompt is ambiguous)."""
    prompt: np.ndarray                # (P,) int32
    max_new_tokens: int
    arrival_s: float = 0.0
    uid: Optional[int] = None         # assigned by the scheduler if None


@dataclasses.dataclass
class RequestResult:
    uid: int
    prompt: np.ndarray                # (P,) int32
    new_tokens: np.ndarray            # (G,) int32 generated tokens (EOS incl.)
    finish_reason: str                # one of FINISH_REASONS
    slot: int                         # cache row served in (-1: never slotted)
    arrival_s: float
    admitted_s: float                 # prefill completion (= first token)
    finished_s: float

    @property
    def completed(self) -> bool:
        return self.finish_reason in FINISH_REASONS

    @property
    def tokens(self) -> np.ndarray:
        return np.concatenate([self.prompt, self.new_tokens])

    @property
    def ttft_s(self) -> float:
        """Time to first token: arrival -> first sampled token (prefill)."""
        return self.admitted_s - self.arrival_s


class ContinuousScheduler:
    """Request queue + slot allocator over a ``ServeEngine`` (see module
    docstring).

    ``chunk_len`` caps the prefill chunk width on paged engines (None: the
    prompt's binary decomposition, one chunk per iteration).
    ``num_blocks`` overrides the engine's pool size per run.
    ``overlap=False`` fetches each step before dispatching the next (the
    token streams are identical either way).  ``invariant_every`` audits
    the pool every N iterations."""

    def __init__(self, engine: ServeEngine, max_batch: int = 4,
                 temperature: float = 0.0, eos_id: int = -1, seed: int = 0,
                 time_fn: Callable[[], float] = time.perf_counter,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 poll_s: float = 1e-3, chunk_len: Optional[int] = None,
                 overlap: bool = True, num_blocks: Optional[int] = None,
                 admission_age_s: Optional[float] = None,
                 invariant_every: int = 0):
        if max_batch < 1:
            raise ValueError(f"max_batch {max_batch} < 1")
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
        self.invariant_every = invariant_every
        self.peak_concurrency = 0              # max in flight (live+prefill)
        self.last_state = None                 # the last run's final state

    def kv_stats(self) -> dict:
        """The pool's bytes per cached token and its ratio to an f32 pool
        (degenerate on contiguous engines, which have no pool)."""
        eng = self.engine
        if not eng.paged:
            return {"kv_dtype": None, "kv_bytes_per_token": 0.0,
                    "kv_bytes_per_token_f32": 0.0, "kv_bytes_ratio": 1.0}
        bpt = eng.kv_bytes_per_token()
        f32 = eng.kv_bytes_per_token(kv_dtype="f32")
        dtype = eng.kv_dtype if eng.kv_dtype is not None else eng.cache_dtype
        return {"kv_dtype": str(dtype).replace("torch.", ""),
                "kv_bytes_per_token": bpt, "kv_bytes_per_token_f32": f32,
                "kv_bytes_ratio": bpt / f32}

    def warmup(self, requests: Sequence[Request]):
        """Run every prompt length the workload holds once, two tokens
        each, outside the timed run (builds the kernels and warms the
        allocator and the card)."""
        seen = {len(np.asarray(r.prompt).ravel()): r.prompt
                for r in requests}
        self.run([Request(prompt=p, max_new_tokens=2)
                  for p in seen.values()])

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
        """Serve all requests; returns results in submission order."""
        engine, paged = self.engine, self.engine.paged
        reqs = [dataclasses.replace(
                    r, uid=r.uid if r.uid is not None else i,
                    prompt=np.asarray(r.prompt, np.int32).ravel())
                for i, r in enumerate(requests)]
        self._validate(reqs)
        self.peak_concurrency = 0
        pending = deque(sorted(reqs, key=lambda r: r.arrival_s))
        waiting: deque = deque()  # arrived, not yet admitted
        state = engine.continuous_state(
            self.max_batch, temperature=self.temperature, seed=self.seed,
            num_blocks=self.num_blocks)
        free = list(range(self.max_batch))[::-1]   # pop() -> row 0 first
        live: dict = {}           # row -> (req, [tokens], t_first)
        prefilling: dict = {}     # row -> (req, PrefillJob)   (paged only)
        cursors: dict = {}        # row -> host mirror of the decode cursor
        done: dict = {}
        # Dispatch-then-fetch double buffering: device tensors of steps
        # whose host bookkeeping is pending, with (row, uid) of every row
        # live at dispatch; the uid guards against crediting a stale step's
        # token to a request readmitted into a just-freed slot.
        fetch_q: deque = deque()  # (tokens_dev, active_dev, ((row, uid),..))
        t0 = self.time_fn()

        def finish(req, tokens, slot, t_first, now):
            reason = ("eos" if self.eos_id >= 0 and tokens
                      and tokens[-1] == self.eos_id else "limit")
            res = RequestResult(
                uid=req.uid, prompt=req.prompt,
                new_tokens=np.asarray(tokens, np.int32),
                finish_reason=reason, slot=slot, arrival_s=req.arrival_s,
                admitted_s=t_first, finished_s=now)
            done[req.uid] = res
            if on_finish is not None:
                on_finish(res)

        def drain(keep: int):
            """Apply host bookkeeping for dispatched steps beyond `keep`."""
            nonlocal state
            while len(fetch_q) > keep:
                toks_d, act_d, rows = fetch_q.popleft()
                toks, act = toks_d.cpu().numpy(), act_d.cpu().numpy()
                now = self.time_fn() - t0
                for row, uid in rows:
                    if row not in live or live[row][0].uid != uid:
                        continue     # slot readmitted since this dispatch
                    req, out, t_first = live[row]
                    out.append(int(toks[row, 0]))
                    if not act[row]:   # terminated: stream out, free slot
                        finish(req, out, row, t_first, now)
                        del live[row]
                        cursors.pop(row, None)
                        if paged:
                            state = engine.free_slot(state, row)
                        free.append(row)

        it = 0
        while pending or waiting or live or prefilling or fetch_q:
            it += 1
            now = self.time_fn() - t0
            if self.invariant_every and it % self.invariant_every == 0 \
                    and paged:
                state.pool.check_invariants()
            while pending and pending[0].arrival_s <= now:
                waiting.append(pending.popleft())
            # ---- admit waiting requests into free slots -------------------
            # Paged admission is FIRST FIT over the arrived queue: a request
            # whose worst-case pages do not fit yet must not idle pages a
            # later short request could use.  ``admission_age_s`` bounds
            # how long later arrivals may keep jumping it.
            skip = 0
            while free and skip < len(waiting):
                req = waiting[skip]
                if not paged:
                    del waiting[skip]
                    state, tok, row_cache = engine.prefill_request(
                        state, req.prompt, temperature=self.temperature)
                    first = int(tok[0, 0].item())
                    t_first = self.time_fn() - t0
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
                need = state.pool.blocks_needed(len(req.prompt),
                                                req.max_new_tokens)
                if not state.pool.can_admit(need):
                    if skip == 0 and self.admission_age_s is not None \
                            and now - req.arrival_s > self.admission_age_s:
                        break      # aged head: no one admits past it
                    skip += 1      # try later arrivals that fit
                    continue
                row = free.pop()
                state, job = engine.begin_prefill(
                    state, row, req.prompt, req.max_new_tokens,
                    chunk_len=self.chunk_len, temperature=self.temperature)
                del waiting[skip]
                prefilling[row] = (req, job)
            # ---- chunked prefill: one chunk per prefilling row ------------
            for row in list(prefilling):
                req, job = prefilling[row]
                state, tok = engine.prefill_chunk(
                    state, job, temperature=self.temperature)
                if tok is not None:
                    job.first_token = tok
                if not job.done:
                    continue
                first = int(job.first_token[0, 0].item())
                t_first = self.time_fn() - t0
                del prefilling[row]
                if req.max_new_tokens == 1 or \
                        (self.eos_id >= 0 and first == self.eos_id):
                    finish(req, [first], row, t_first, t_first)
                    state = engine.free_slot(state, row)
                    free.append(row)
                else:
                    state = engine.admit_paged(
                        state, job, job.first_token,
                        temperature=self.temperature)
                    live[row] = (req, [first], t_first)
                    cursors[row] = len(req.prompt)
            self.peak_concurrency = max(self.peak_concurrency,
                                        len(live) + len(prefilling))
            if not live:
                drain(0)
                if not (live or prefilling):
                    if pending and not waiting:
                        wait = pending[0].arrival_s - (self.time_fn() - t0)
                        if wait > 0:       # idle until the next arrival
                            self.sleep_fn(min(wait, self.poll_s))
                    elif waiting:
                        # blocked admission: nothing to decode, idle a tick
                        self.sleep_fn(self.poll_s)
                continue
            # ---- one masked decode iteration across all slots -------------
            if paged:
                # alloc-on-advance: back the slot each live row writes next,
                # plus one page of lookahead.  Admission is commitment-
                # gated, so an early page costs nothing, and the table
                # re-uploads once per page of tokens, not at every boundary.
                bs = engine.block_size
                for row, (req, _, _) in live.items():
                    limit = len(req.prompt) + req.max_new_tokens - 1
                    state.pool.advance(row, min(cursors[row] + 1 + bs, limit))
            state = engine.decode_masked(state, temperature=self.temperature,
                                         eos_id=self.eos_id)
            fetch_q.append((state.tokens, state.active,
                            tuple((row, live[row][0].uid) for row in live)))
            for row in live:           # host mirror (clamped in advance)
                cursors[row] += 1
            drain(1 if self.overlap else 0)
        self.last_state = state
        return [done[r.uid] for r in reqs]


def summarize(results: Sequence[RequestResult], wall_s: float) -> dict:
    """Aggregate serving metrics.  Throughput and TTFT percentiles count
    completed requests (every request here completes: ``eos`` or
    ``limit``); an empty set reports NaN percentiles, not 0."""
    by_reason: dict = {}
    for r in results:
        by_reason[r.finish_reason] = by_reason.get(r.finish_reason, 0) + 1
    completed = [r for r in results if r.completed]
    gen = int(sum(len(r.new_tokens) for r in completed))
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
        "wall_s": wall_s,
        "tokens_per_s": gen / max(wall_s, 1e-9),
        "ttft_p50_s": p50,
        "ttft_p95_s": p95,
    }
