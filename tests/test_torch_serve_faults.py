"""Fault-tolerant serving in the port (``train/faults.py``, the fault sites
of ``train/kv_pool.py``, ``train/radix_cache.py`` and
``train/serve_engine.py``, the request lifecycle of
``train/serve_scheduler.py`` and the checkpointer's torn writes), on the
CPU.

In-port, every contract of ``tests/test_serving_faults.py`` at its
``ft-dense`` config, byte for byte against contiguous solo generation:
the plane's tape, storm and grammar; a transient fault at every serving
site (and through the prefix cache and the draft prefill) recovers to the
solo streams; exhausted retries fail only the rows they hit; a storm
never escapes; crash-resume at every iteration boundary and from a
mid-iteration crash (through the snapshot's JSON file); deadlines queued
and mid-decode, cancel and the queue limit on a virtual clock; the
invariant watchdog and the radix pin audit; torn checkpoint writes, sync
and async.  Beyond the reference: the same crash-resume and a
``prefill_chunk`` fault on a 2-layer ``rwkv6-7b`` smoke config, whose
B=1 carry must come through the retry untouched.

Cross-framework, against the JAX package: one tape or storm fires at the
same hits with the same counts in both planes, and a scheduler snapshot
the JAX scheduler wrote restores in the port's scheduler to the port's
uninterrupted streams.  All exact: no tolerance.
"""
import math
import os

import numpy as np
import pytest
import torch

from repro.train import faults as jax_faults
from repro_torch import configs
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.train import faults as faults_lib
from repro_torch.train.faults import SITES, CrashError, FaultError, FaultPlane
from repro_torch.train.kv_pool import KVBlockPool
from repro_torch.train.radix_cache import RadixCache
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_scheduler import (FINISH_REASONS,
                                               ContinuousScheduler, Request,
                                               load_snapshot, save_snapshot,
                                               summarize)

_CFG_KW = dict(name="ft-dense", family="dense", num_layers=4, d_model=32,
               num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
               max_seq_len=64)
CFG = ModelConfig(**_CFG_KW)
RWKV = configs.get_smoke_config("rwkv6-7b")          # 2 RWKV6 layers

REQ_SHAPES = ((5, 7), (9, 4), (3, 10), (6, 2), (4, 8), (7, 5), (2, 6),
              (8, 3))
MAX_LEN = 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these ops are tiny, and on a shared CPU many
    threads make them several times slower.  Every comparison here is
    between runs under the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(n=len(REQ_SHAPES), cfg=CFG):
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        (p,)).astype(np.int32),
                    max_new_tokens=g) for p, g in REQ_SHAPES[:n]]


def _init(cfg):
    return registry.get_model(cfg).init(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")


@pytest.fixture(scope="module")
def params():
    return _init(CFG)


def _solo(cfg, params, reqs):
    solo = ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN)
    return {i: solo.generate(r.prompt[None, :], r.max_new_tokens).tokens[0]
            for i, r in enumerate(reqs)}


@pytest.fixture(scope="module")
def solo_tokens(params):
    """uid -> full greedy stream (prompt + gen) from contiguous solo
    generation: the fault-free reference for every parity assert."""
    return _solo(CFG, params, _requests())


def _engine(params, cfg=CFG, **kw):
    return ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN,
                       paged=True, block_size=4, **kw)


@pytest.fixture(scope="module")
def plain_eng(params):
    return _engine(params)


@pytest.fixture(scope="module")
def prefix_eng(params):
    return _engine(params, prefix_cache=True)


@pytest.fixture(scope="module")
def spec_eng(params):
    return _engine(params, spec_decode=True, gamma=3, draft_depth=2)


def _check_result(res, solo):
    """Structural validity + parity: whatever a request emitted, full or
    partial, is a byte-exact prefix of its solo stream."""
    assert res.finish_reason in FINISH_REASONS
    want = solo[res.uid]
    got = res.tokens
    np.testing.assert_array_equal(got, want[:len(got)])
    if res.completed:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# FaultPlane units, and the same draws as the JAX package's plane
# ---------------------------------------------------------------------------


def test_fault_plane_tape_fires_at_exact_hits():
    plane = FaultPlane.from_tape([("pool.alloc", 2), ("engine.decode", 1,
                                                      "crash")])
    plane.fire("pool.alloc")                    # hit 1: clean
    with pytest.raises(FaultError) as ei:
        plane.fire("pool.alloc")                # hit 2: fault
    assert ei.value.site == "pool.alloc" and ei.value.hit == 2
    plane.fire("pool.alloc")                    # hit 3: clean again
    with pytest.raises(CrashError):
        plane.fire("engine.decode")
    assert plane.counts == {"pool.alloc": 3, "engine.decode": 1}
    assert plane.fired == [("pool.alloc", 2, "fault"),
                           ("engine.decode", 1, "crash")]


def test_crash_is_not_a_fault():
    """Containment catching FaultError must never swallow a crash: the
    classes are siblings, not parent and child."""
    assert not issubclass(CrashError, FaultError)
    assert not issubclass(FaultError, CrashError)
    for cls in (CrashError, FaultError):
        assert issubclass(cls, RuntimeError)


def test_fault_plane_parse_specs():
    plane = FaultPlane.parse("pool.alloc:3,sched.iter:7:crash")
    assert plane._tape == {("pool.alloc", 3): "fault",
                           ("sched.iter", 7): "crash"}
    storm = FaultPlane.parse("storm:0.25:9")
    assert storm._rate == 0.25
    for bad in ("nope.site:1", "pool.alloc:0", "pool.alloc:1:weird",
                "pool.alloc", "storm:1.5"):
        with pytest.raises(ValueError):
            FaultPlane.parse(bad)


def test_seeded_storm_is_deterministic():
    def fired(seed):
        plane = FaultPlane.seeded(0.3, seed=seed)
        out = []
        for site in SITES * 20:
            try:
                plane.fire(site)
                out.append(0)
            except FaultError:
                out.append(1)
        return out, plane
    a, plane_a = fired(4)
    b, _ = fired(4)
    c, _ = fired(5)
    assert a == b
    assert a != c
    assert sum(a) > 0
    # sched.iter is left out of the default storm (crash points are
    # explicit tape entries only)
    assert all(s != "sched.iter" for s, _, _ in plane_a.fired)


def test_null_plane_and_resolve():
    assert faults_lib.resolve(None) is faults_lib.NULL
    assert not faults_lib.NULL.enabled
    faults_lib.NULL.fire("pool.alloc")          # no-op, no counts
    assert faults_lib.NULL.counts == {}
    plane = FaultPlane.from_tape([])
    assert faults_lib.resolve(plane) is plane
    assert isinstance(faults_lib.resolve("pool.alloc:1"), FaultPlane)


def _drive(plane, sites):
    """Fire ``sites`` in order; the (site, hit, kind) of each raise."""
    out = []
    for site in sites:
        try:
            plane.fire(site)
        except (jax_faults.FaultError, jax_faults.CrashError, FaultError,
                CrashError) as e:
            out.append((e.site, e.hit, e.kind))
    return out


@pytest.mark.parametrize("spec", [
    "pool.alloc:2,engine.decode:1:crash,train.iter:3:crash,ckpt.write:4",
    "storm:0.05:0", "storm:0.3:7", "storm:1.0"])
def test_plane_fires_as_the_jax_plane(spec):
    """The same spec over one long seeded site sequence: the same hits
    raise with the same kinds, and the planes count the same hits."""
    rng = np.random.default_rng(11)
    sites = [SITES[i] for i in rng.integers(0, len(SITES), 600)]
    assert faults_lib.SITES == jax_faults.SITES
    assert faults_lib.ITER_SITES == jax_faults.ITER_SITES
    port, ref = FaultPlane.parse(spec), jax_faults.FaultPlane.parse(spec)
    got = _drive(port, sites)
    assert got == _drive(ref, sites)
    assert port.counts == ref.counts and port.fired == ref.fired
    assert got


# ---------------------------------------------------------------------------
# A fault at every site: retries recover, streams byte-identical
# ---------------------------------------------------------------------------

PLAIN_SITES = ("pool.alloc", "engine.prefill_chunk", "engine.decode",
               "engine.table_upload")
PREFIX_SITES = ("radix.match", "radix.publish", "pool.evict")


def _run_with_tape(eng, tape, reqs, **kw):
    plane = FaultPlane.parse(tape)
    eng.faults = plane
    try:
        sched = ContinuousScheduler(eng, max_batch=2, chunk_len=4,
                                    retry_backoff_s=1e-4, **kw)
        results = sched.run(reqs)
        return results, sched, plane, sched.fault_stats()
    finally:
        eng.faults = faults_lib.NULL


@pytest.mark.parametrize("site", PLAIN_SITES)
def test_transient_fault_recovers_byte_identical(site, plain_eng,
                                                 solo_tokens):
    """Two injected faults at `site`, a retry budget of 3: every request
    still completes with its exact solo stream, and the plane's receipts
    prove the site fired."""
    results, sched, plane, stats = _run_with_tape(
        plain_eng, f"{site}:1,{site}:2", _requests(), num_blocks=8,
        max_retries=3)
    assert len(results) == len(REQ_SHAPES)
    for res in results:
        assert res.completed
        _check_result(res, solo_tokens)
    assert plane.counts[site] >= 3          # site exercised past the tape
    assert len(plane.fired) == 2
    assert sched.retries >= 2
    assert stats["fault_sites"][site] == plane.counts[site]


@pytest.mark.parametrize("site", PREFIX_SITES)
def test_transient_fault_recovers_with_prefix_cache(site, prefix_eng,
                                                    solo_tokens):
    """The same through the radix-cache admission path (match and publish
    faults, and evict faults in a pool tight enough that pinned pages
    must be reclaimed)."""
    results, sched, plane, _ = _run_with_tape(
        prefix_eng, f"{site}:1,{site}:2", _requests(), num_blocks=8,
        max_retries=3)
    for res in results:
        assert res.completed
        _check_result(res, solo_tokens)
    assert plane.counts[site] >= 2
    assert sched.retries >= 1


def test_transient_fault_recovers_draft_prefill(spec_eng, solo_tokens):
    """Speculative engines add the draft's B=1 prefill as a fault site;
    recovery keeps speculation lossless."""
    results, sched, plane, _ = _run_with_tape(
        spec_eng, "engine.draft_prefill:1,engine.draft_prefill:2",
        _requests(), max_retries=3)
    for res in results:
        assert res.completed
        _check_result(res, solo_tokens)
    assert plane.counts["engine.draft_prefill"] >= 2


def test_exhausted_retries_fail_only_affected_rows(plain_eng, solo_tokens):
    """A streak of prefill-chunk faults with a retry budget of 1: some
    requests fail (``failed``, error recorded), the rest complete byte
    for byte: one bad request never takes down the batch."""
    tape = ",".join(f"engine.prefill_chunk:{n}" for n in range(1, 9))
    results, sched, plane, _ = _run_with_tape(
        plain_eng, tape, _requests(), num_blocks=8, max_retries=1)
    assert len(results) == len(REQ_SHAPES)
    failed = [r for r in results if r.finish_reason == "failed"]
    completed = [r for r in results if r.completed]
    assert failed and completed
    for res in failed:
        assert "engine.prefill_chunk" in res.error
    for res in results:
        _check_result(res, solo_tokens)
    assert sched.failed == len(failed)
    stats = summarize(results, 1.0)
    assert stats["finish_reasons"]["failed"] == len(failed)
    assert stats["completed"] == len(completed)
    assert sum(stats["finish_reasons"].values()) == len(results)


def test_batchwide_decode_fault_storm_fails_live_rows(plain_eng,
                                                      solo_tokens):
    """Every decode dispatch faults with no retry budget: every admitted
    request fails with exactly its prefill token, the scheduler never
    raises, and a clean run on the SAME engine afterwards is byte
    identical: containment leaves no residue."""
    tape = ",".join(f"engine.decode:{n}" for n in range(1, 40))
    reqs = _requests(4)
    results, sched, plane, _ = _run_with_tape(
        plain_eng, tape, reqs, num_blocks=8, max_retries=0)
    assert len(results) == 4
    for res in results:
        assert res.finish_reason == "failed"
        assert len(res.new_tokens) >= 1       # the prefill token survives
        _check_result(res, solo_tokens)
    assert plane.counts["engine.decode"] >= 1
    clean = ContinuousScheduler(plain_eng, max_batch=2, chunk_len=4,
                                num_blocks=8).run(reqs)
    for res in clean:
        assert res.completed
        _check_result(res, solo_tokens)


def test_fault_storm_never_escapes_the_scheduler(prefix_eng, solo_tokens):
    """A seeded storm over every site: a structured result for every
    request, completed ones byte-identical.  The storm is deterministic
    per (workload, seed): a fixed regression point, not a flake."""
    plane = FaultPlane.seeded(0.05, seed=3)
    prefix_eng.faults = plane
    try:
        sched = ContinuousScheduler(prefix_eng, max_batch=2, chunk_len=4,
                                    num_blocks=8, max_retries=2,
                                    retry_backoff_s=1e-4, invariant_every=1)
        results = sched.run(_requests())
    finally:
        prefix_eng.faults = faults_lib.NULL
    assert len(results) == len(REQ_SHAPES)
    for res in results:
        _check_result(res, solo_tokens)
    assert plane.fired                        # the storm stormed


# ---------------------------------------------------------------------------
# Crash-resume: byte-identical at every iteration boundary
# ---------------------------------------------------------------------------


def _assert_streams_equal(got, want):
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        np.testing.assert_array_equal(g.new_tokens, w.new_tokens)
        assert g.finish_reason == w.finish_reason


def _crash_sweep(eng, reqs, **kw):
    """sched.iter:k:crash for k = 1, 2, ... until the run outlives the
    tape; each crash restores its last snapshot on a clean scheduler and
    the merged streams must equal the uninterrupted run's.  Returns the
    number of boundaries swept."""
    eng.faults = faults_lib.NULL
    clean = ContinuousScheduler(eng, max_batch=2, chunk_len=4,
                                **kw).run(reqs)
    k = 0
    while True:
        k += 1
        eng.faults = FaultPlane.parse(f"sched.iter:{k}:crash")
        sched = ContinuousScheduler(eng, max_batch=2, chunk_len=4,
                                    snapshot_every=1, **kw)
        try:
            results = sched.run(reqs)
        except CrashError:
            snap = sched.last_snapshot
            assert snap is not None
            eng.faults = faults_lib.NULL
            resumed = ContinuousScheduler(eng, max_batch=2, chunk_len=4,
                                          **kw).restore(snap)
            _assert_streams_equal(resumed, clean)
        else:
            # the crash point lies past the last boundary: every iteration
            # of the workload was swept
            eng.faults = faults_lib.NULL
            _assert_streams_equal(results, clean)
            return k, clean


def test_crash_resume_parity_at_every_iteration_boundary(prefix_eng,
                                                         solo_tokens):
    """Every crash escapes run(); ``last_snapshot`` (taken at every
    boundary) restores through the chunked prefill and radix path, and
    the merged streams are byte-identical to the uninterrupted run."""
    k, clean = _crash_sweep(prefix_eng, _requests(3), num_blocks=12)
    for res in clean:
        _check_result(res, solo_tokens)
    assert k > 3                              # the sweep was not vacuous


def test_crash_mid_iteration_resumes_from_boundary_snapshot(
        prefix_eng, solo_tokens, tmp_path):
    """A crash INSIDE an iteration (mid-decode) loses at most that
    iteration's work; the snapshot round-trips through its JSON file."""
    reqs = _requests(3)
    prefix_eng.faults = faults_lib.NULL
    clean = ContinuousScheduler(prefix_eng, max_batch=2, chunk_len=4,
                                num_blocks=12).run(reqs)
    prefix_eng.faults = FaultPlane.parse("engine.decode:4:crash")
    sched = ContinuousScheduler(prefix_eng, max_batch=2, chunk_len=4,
                                num_blocks=12, snapshot_every=1)
    with pytest.raises(CrashError):
        sched.run(reqs)
    prefix_eng.faults = faults_lib.NULL
    path = tmp_path / "serve_snapshot.json"
    save_snapshot(sched.last_snapshot, path)
    snap = load_snapshot(path)
    resumed = ContinuousScheduler(prefix_eng, max_batch=2, chunk_len=4,
                                  num_blocks=12).restore(snap)
    _assert_streams_equal(resumed, clean)


def test_snapshot_written_by_jax_restores_in_the_port(params, plain_eng,
                                                      tmp_path):
    """The JAX scheduler, on the port's weights, crashes mid-run; its
    snapshot file restores in the port's scheduler, and the merged
    streams equal the port's uninterrupted run."""
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.train import serve_engine as jax_engine
    from repro.train import serve_scheduler as jax_sched
    from repro_torch import bridge
    reqs = _requests(3)
    jeng = jax_engine.ServeEngine(
        JModelConfig(**_CFG_KW), bridge.params_to_numpy(params),
        max_len=MAX_LEN, paged=True, block_size=4,
        faults="sched.iter:6:crash")
    jreqs = [jax_sched.Request(prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens)
             for r in reqs]
    js = jax_sched.ContinuousScheduler(jeng, max_batch=2, chunk_len=4,
                                       num_blocks=12, snapshot_every=1)
    with pytest.raises(jax_faults.CrashError):
        js.run(jreqs)
    path = tmp_path / "jax_snapshot.json"
    jax_sched.save_snapshot(js.last_snapshot, path)
    snap = load_snapshot(path)
    assert snap["inflight"] and any(i["emitted"] for i in snap["inflight"])
    plain_eng.faults = faults_lib.NULL
    clean = ContinuousScheduler(plain_eng, max_batch=2, chunk_len=4,
                                num_blocks=12).run(reqs)
    resumed = ContinuousScheduler(plain_eng, max_batch=2, chunk_len=4,
                                  num_blocks=12).restore(snap)
    _assert_streams_equal(resumed, clean)


# ---------------------------------------------------------------------------
# Recurrent carries under faults (rwkv6-7b smoke, 2 layers)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rwkv():
    p = _init(RWKV)
    return p, _solo(RWKV, p, _requests(cfg=RWKV))


def test_rwkv_prefill_chunk_fault_leaves_the_carry(rwkv):
    """A ``prefill_chunk`` fault on a recurrent model fires before the
    chunk writes the B=1 carry in place: the retried chunks run from the
    carry as it was, so every stream equals solo generation."""
    p, solo = rwkv
    eng = _engine(p, cfg=RWKV, prefix_cache=True)
    tape = "engine.prefill_chunk:2,engine.prefill_chunk:3,pool.alloc:4"
    results, sched, plane, _ = _run_with_tape(
        eng, tape, _requests(cfg=RWKV), num_blocks=12, max_retries=3)
    assert len(plane.fired) == 3 and sched.retries >= 3
    for res in results:
        assert res.completed
        _check_result(res, solo)


def test_rwkv_crash_resume_parity(rwkv):
    """Crash-resume at every boundary of a recurrent workload: restore
    re-prefills prompt + emitted from a fresh carry (prompts under 64
    tokens, where the chunked and per-step forms agree byte for byte)."""
    p, solo = rwkv
    k, clean = _crash_sweep(_engine(p, cfg=RWKV), _requests(3, cfg=RWKV),
                            num_blocks=12)
    for res in clean:
        _check_result(res, solo)
    assert k > 3


# ---------------------------------------------------------------------------
# Lifecycle: deadlines, cancellation, shedding (virtual clock)
# ---------------------------------------------------------------------------


class TickClock:
    """Deterministic virtual clock: every ``time()`` call advances by
    ``dt`` (so a busy serving loop moves through time without real
    sleeps); ``sleep`` jumps."""

    def __init__(self, dt=0.002):
        self.t = 0.0
        self.dt = dt

    def time(self):
        self.t += self.dt
        return self.t

    def sleep(self, s):
        self.t += s


def test_queued_request_past_deadline_is_shed_from_the_queue(plain_eng,
                                                             solo_tokens):
    """max_batch=1: B waits behind A and its deadline lapses before a
    slot frees: it finishes ``deadline`` with no tokens, A untouched."""
    plain_eng.faults = faults_lib.NULL
    clock = TickClock()
    reqs = [Request(prompt=_requests()[0].prompt, max_new_tokens=7),
            Request(prompt=_requests()[1].prompt, max_new_tokens=4,
                    deadline_s=0.01)]
    sched = ContinuousScheduler(plain_eng, max_batch=1, chunk_len=4,
                                num_blocks=8, time_fn=clock.time,
                                sleep_fn=clock.sleep)
    a, b = sched.run(reqs)
    assert a.completed
    _check_result(a, solo_tokens)
    assert b.finish_reason == "deadline"
    assert len(b.new_tokens) == 0
    assert b.slot == -1 and math.isnan(b.admitted_s)
    assert sched.deadline_hits == 1


def test_deadline_mid_decode_returns_partial_prefix(plain_eng,
                                                    solo_tokens):
    """The scheduler-wide deadline stops a live request mid-decode: its
    partial tokens are a byte-exact prefix of its solo stream."""
    plain_eng.faults = faults_lib.NULL
    clock = TickClock(dt=0.002)
    prompt = _requests()[0].prompt
    sched = ContinuousScheduler(plain_eng, max_batch=1, chunk_len=4,
                                num_blocks=12, time_fn=clock.time,
                                sleep_fn=clock.sleep, deadline_s=0.05)
    res, = sched.run([Request(prompt=prompt, max_new_tokens=30)])
    assert res.finish_reason == "deadline"
    assert 0 < len(res.new_tokens) < 30
    # greedy continuations share prefixes: the partial stream matches the
    # (shorter-budget) solo stream over their common extent
    want = solo_tokens[0]
    n = min(len(res.tokens), len(want))
    assert n > len(prompt)
    np.testing.assert_array_equal(res.tokens[:n], want[:n])
    assert sched.deadline_hits == 1


def test_cancel_lands_queued_and_live(plain_eng, solo_tokens):
    """cancel() from on_finish: a live request stops with a partial solo
    prefix, a queued one with nothing; unknown uids are ignored."""
    plain_eng.faults = faults_lib.NULL
    base = _requests()
    reqs = [Request(prompt=base[0].prompt[:3], max_new_tokens=2),   # uid 0
            Request(prompt=base[1].prompt, max_new_tokens=12),      # uid 1
            Request(prompt=base[2].prompt, max_new_tokens=8),       # uid 2
            Request(prompt=base[4].prompt, max_new_tokens=8)]       # uid 3
    sched = ContinuousScheduler(plain_eng, max_batch=2, chunk_len=4,
                                num_blocks=12)

    def on_finish(res):
        if res.uid == 0:
            sched.cancel(1)
            sched.cancel(3)
            sched.cancel(99)          # unknown: ignored
    r0, r1, r2, r3 = sched.run(reqs, on_finish=on_finish)
    assert r0.completed
    assert r1.finish_reason == "cancelled"
    assert len(r1.new_tokens) < 12    # cut mid-decode
    solo1 = solo_tokens[1]            # same prompt as base[1] (budget 4)
    n = min(len(r1.tokens), len(solo1))
    np.testing.assert_array_equal(r1.tokens[:n], solo1[:n])
    assert r3.finish_reason == "cancelled"
    assert len(r3.new_tokens) == 0    # never admitted (still queued)
    assert r2.completed               # untouched neighbour
    assert sched.cancelled == 2


def test_queue_limit_sheds_overflow(plain_eng):
    """queue_limit=1, max_batch=1, 4 arrivals at once: one serves, three
    shed with structured results, kept out of throughput and TTFT."""
    plain_eng.faults = faults_lib.NULL
    reqs = [Request(prompt=_requests()[0].prompt, max_new_tokens=5)
            for _ in range(4)]
    sched = ContinuousScheduler(plain_eng, max_batch=1, chunk_len=4,
                                num_blocks=8, queue_limit=1)
    results = sched.run(reqs)
    served = [r for r in results if r.completed]
    shed = [r for r in results if r.finish_reason == "shed"]
    assert len(served) == 1 and len(shed) == 3
    assert sched.shed == 3
    for r in shed:
        assert "queue_limit" in r.error
        assert len(r.new_tokens) == 0
    stats = summarize(results, 1.0)
    assert stats["finish_reasons"] == {"limit": 1, "shed": 3}
    assert stats["completed"] == 1
    assert stats["generated_tokens"] == 5
    assert stats["generated_tokens_all"] == 5
    assert stats["goodput"] == stats["tokens_per_s"]
    # an all-errored workload must not report a perfect latency tail
    empty = summarize(shed, 1.0)
    assert math.isnan(empty["ttft_p50_s"])
    assert empty["completed"] == 0


def test_constructor_checks():
    eng = object.__new__(ServeEngine)
    for kw in (dict(max_batch=0), dict(queue_limit=0), dict(max_retries=-1)):
        with pytest.raises(ValueError):
            ContinuousScheduler(eng, **kw)


# ---------------------------------------------------------------------------
# Invariant watchdog + radix pin audit
# ---------------------------------------------------------------------------


def test_invariant_watchdog_clean_run(prefix_eng, solo_tokens):
    """The pool and radix audit passes at EVERY iteration of a clean
    prefix-cache run (no false positives), with parity intact."""
    prefix_eng.faults = faults_lib.NULL
    results = ContinuousScheduler(prefix_eng, max_batch=2, chunk_len=4,
                                  num_blocks=8,
                                  invariant_every=1).run(_requests())
    for res in results:
        assert res.completed
        _check_result(res, solo_tokens)


def test_radix_pin_audit_trips_on_corruption():
    """A manufactured pin-count mismatch trips the audit."""
    pool = KVBlockPool(num_blocks=4, block_size=4, batch=2, max_blocks=4)
    radix = RadixCache(pool)
    prompt = np.zeros(8, np.int32)
    pool.admit(0, 8, 2)
    pool.advance(0, 8)
    radix.publish(prompt, pool.row_pages(0)[:2], 2)
    radix.check_invariants()
    pool.check_invariants()
    pool._pins[pool.row_pages(0)[0]] += 1   # a pin the tree never took
    with pytest.raises(AssertionError, match="pin-count audit"):
        radix.check_invariants()


# ---------------------------------------------------------------------------
# Torn checkpoint writes
# ---------------------------------------------------------------------------


def test_torn_checkpoint_write_keeps_previous_restorable(tmp_path):
    """The port's torn write leaves a ``.tmp`` that both packages' step
    index ignores; the previous checkpoint stays the latest."""
    from repro.checkpoint import checkpointer as jax_ckpt
    tree = {"w": np.arange(4, dtype=np.float32)}
    d = str(tmp_path)
    ckpt.save(d, 1, tree)
    with pytest.raises(FaultError):
        ckpt.save(d, 2, {"w": np.ones(4, np.float32)},
                  faults=FaultPlane.parse("ckpt.write:1"))
    assert os.path.isdir(tmp_path / "step_000000002.tmp")
    assert ckpt.all_steps(d) == [1]
    assert ckpt.latest_step(d) == 1
    assert jax_ckpt.latest_step(d) == 1
    restored = ckpt.restore(d, 1, tree)
    np.testing.assert_array_equal(restored["w"], tree["w"])
    # a clean retry sweeps the torn directory and lands normally
    ckpt.save(d, 2, {"w": np.ones(4, np.float32)})
    assert ckpt.all_steps(d) == [1, 2]
    assert not os.path.exists(tmp_path / "step_000000002.tmp")


def test_async_checkpointer_surfaces_torn_write_on_wait(tmp_path):
    tree = {"w": torch.zeros(3)}
    ac = ckpt.AsyncCheckpointer()
    ac.save(str(tmp_path), 1, tree, faults=FaultPlane.parse("ckpt.write:1"))
    with pytest.raises(FaultError):
        ac.wait()
    assert ckpt.all_steps(str(tmp_path)) == []
    ac.save(str(tmp_path), 1, tree)
    ac.wait()
    assert ckpt.all_steps(str(tmp_path)) == [1]


def test_restore_faults_fire_before_any_read(tmp_path):
    """``ckpt.restore`` fires before a file is opened, in ``restore`` and
    ``restore_subtree`` alike: a missing checkpoint still raises the
    injected fault first."""
    d = str(tmp_path / "none")
    for fn in (lambda f: ckpt.restore(d, 1, {}, faults=f),
               lambda f: ckpt.restore_subtree(d, 1, {}, "params", faults=f)):
        with pytest.raises(FaultError):
            fn(FaultPlane.parse("ckpt.restore:1"))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_lifecycle_line(capsys):
    """``--faults storm:...`` with ``--snapshot-every`` serves to the end
    and prints the reference's ``lifecycle:`` line."""
    from repro_torch.launch import serve
    results = serve.main([
        "--smoke", "--device", "cpu", "--continuous", "--paged",
        "--max-batch", "2", "--requests", "6", "--block-size", "4",
        "--chunk-len", "4", "--rate", "1000", "--faults", "storm:0.05:0",
        "--snapshot-every", "1", "--queue-limit", "4", "--deadline-s", "60",
        "--invariant-every", "1"])
    out = capsys.readouterr().out
    assert "lifecycle: " in out and "goodput tokens/s=" in out
    assert len(results) == 6
    assert all(r.finish_reason in FINISH_REASONS for r in results)
