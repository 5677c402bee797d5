"""Prefix sharing in the port (``train/kv_pool.py``'s prefix operations,
``train/radix_cache.py``, the engine's and scheduler's prefix hooks)
against the JAX package's, on the CPU.

Cross-framework: the port's pool and radix tree are driven op by op with
the JAX pool and tree by one seeded sequence of match / admit (plain,
prefix, copy-on-write) / advance / publish / free under a tight pool, so
the evictor runs; after every operation both hold the same tables,
refcounts, pins, free lists and telemetry.  The prefix-cached scheduler's
greedy streams and hit pattern equal the JAX scheduler's.

In-port, the contracts of ``tests/test_serving_prefix.py`` at the port's
smoke ``gpt2-12l`` (the reference's test configs use RoPE, which the port
has not ported yet): a hit is byte-identical to a cold run, also under
eviction pressure and on an int8 pool; a fully cached head never
deadlocks admission; copy-on-write never writes a shared page and clones
the scales with the page; admission charges shares as the reference does;
eviction is LRU over leaves; the ``blocks_needed`` boundary.  All exact:
no tolerance.
"""
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import mesh as mesh_lib
from repro.models import transformer as jtr
from repro.train import serve_engine as jax_engine
from repro.train import serve_scheduler as jax_sched
from repro.train.kv_pool import KVBlockPool as JaxPool
from repro.train.radix_cache import RadixCache as JaxRadix
from repro_torch import bridge
from repro_torch import configs
from repro_torch.train.kv_pool import KVBlockPool, PoolExhausted
from repro_torch.train.radix_cache import RadixCache
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_scheduler import (ContinuousScheduler, Request,
                                               summarize)

CFG = configs.get_smoke_config("gpt2-12l")
JCFG = jax_configs.get_smoke_config("gpt2-12l")


# ---------------------------------------------------------------------------
# Pool and radix tree, op by op against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these ops are tiny, and on a shared CPU many
    threads make them several times slower.  Every comparison here is
    between runs under the same setting, or within a stated tolerance."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool_state(pool, radix):
    return (pool.table.copy(), pool.version, sorted(pool._free),
            dict(pool._ref), dict(pool._pins), pool.free_blocks,
            pool.evictable_blocks, pool.remaining_commitment,
            sorted(radix.pinned_pages()), radix.num_nodes, radix.hits,
            radix.misses, radix.matched_tokens, radix.published_pages,
            radix.evicted_pages)


def _same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]


def _match_tuple(m):
    return None if m is None else (list(m.pages), m.skip, m.cow_last,
                                   m.tokens_matched)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pool_and_radix_match_jax_op_by_op(seed):
    """Prompts drawn from a 3-token vocabulary over pages of 2, so
    prefixes collide, exact-boundary full matches (COW) happen and the
    12-page pool runs dry (the evictor reclaims LRU leaves)."""
    rng = np.random.default_rng(seed)
    kw = dict(num_blocks=12, block_size=2, batch=3, max_blocks=8)
    pools = (KVBlockPool(**kw), JaxPool(**kw))
    trees = (RadixCache(pools[0]), JaxRadix(pools[1]))
    live = {}                                   # row -> prompt
    for _ in range(250):
        row = int(rng.integers(0, 3))
        if row in live:                          # finish: maybe publish
            prompt = live.pop(row)
            if rng.random() < 0.7:
                n_pub = len(prompt) // 2
                got = [t.publish(prompt, p.row_pages(row)[:n_pub], n_pub)
                       if n_pub else 0 for p, t in zip(pools, trees)]
                assert got[0] == got[1]
            for p in pools:
                p.free(row)
        else:
            prompt = rng.integers(0, 3, int(rng.integers(1, 9))).astype(
                np.int32)
            g = int(rng.integers(1, 5))
            cap = int(rng.integers(0, 5)) if rng.random() < 0.3 else None
            matches = [t.match(prompt, carryless=True, max_pages=cap)
                       for t in trees]
            assert _match_tuple(matches[0]) == _match_tuple(matches[1])
            need = pools[0].blocks_needed(len(prompt), g)
            m = matches[0]
            oks = [p.can_admit(need) if m is None else
                   p.can_admit_prefix(need, mm.pages, mm.cow_last)
                   for p, mm in zip(pools, matches)]
            assert oks[0] == oks[1]
            if oks[0] and need <= kw["max_blocks"]:
                cows = [p.admit(row, len(prompt), g) if mm is None else
                        p.admit_prefix(row, len(prompt), g, mm.pages,
                                       mm.cow_last)
                        for p, mm in zip(pools, matches)]
                assert cows[0] == cows[1]
                for p in pools:                 # the prompt's pages
                    p.advance(row, len(prompt))
                live[row] = prompt
        _same(_pool_state(pools[0], trees[0]), _pool_state(pools[1],
                                                            trees[1]))
        for p, t in zip(pools, trees):
            p.check_invariants()
            t.check_invariants()


def test_pool_share_refcount_and_free():
    pool = KVBlockPool(num_blocks=8, block_size=4, batch=4, max_blocks=8)
    pool.admit(0, 8, 1)
    pool.advance(0, 8)
    pages = list(pool.row_pages(0))
    for p in pages:
        pool.pin(p)                              # tree publish
        assert pool.ref_count(p) == 2
    assert pool.evictable_blocks == 0            # row still references them
    cow = pool.admit_prefix(1, 8, 1, pages)      # second row shares both
    assert cow is None
    assert [pool.ref_count(p) for p in pages] == [3, 3]
    assert (pool.table[1, :2] == pages).all()
    pool.free(0)
    assert [pool.ref_count(p) for p in pages] == [2, 2]
    assert pool.free_blocks == 6                 # shared pages never freed
    pool.free(1)
    assert pool.evictable_blocks == 2            # pin-only now
    pool.check_invariants()
    for p in pages:
        pool.unpin(p)
    assert pool.free_blocks == 8
    pool.check_invariants()
    with pytest.raises(ValueError, match="not pinned"):
        pool.unpin(pages[0])
    with pytest.raises(ValueError, match="not allocated"):
        pool.pin(pages[0])


def test_pool_cow_never_mutates_shared():
    """admit_prefix(cow_last=True) swaps the last shared page for a fresh
    clone target: the source keeps its other references, the row's table
    points at the private clone."""
    pool = KVBlockPool(num_blocks=8, block_size=4, batch=4, max_blocks=8)
    pool.admit(0, 8, 1)
    pool.advance(0, 8)
    pages = list(pool.row_pages(0))
    for p in pages:
        pool.pin(p)
    src, dst = pool.admit_prefix(1, 8, 1, pages, cow_last=True)
    assert src == pages[1] and dst not in pages
    assert pool.ref_count(src) == 2              # row 0 + pin (row 1 left)
    assert pool.ref_count(dst) == 1
    assert pool.table[1, 0] == pages[0] and pool.table[1, 1] == dst
    pool.check_invariants()
    pool.free(1)
    assert pool.ref_count(dst) == 0              # private clone freed
    assert pool.ref_count(src) == 2
    pool.check_invariants()
    with pytest.raises(ValueError):
        pool.admit_prefix(2, 8, 1, [], cow_last=True)
    with pytest.raises(ValueError):
        pool.admit_prefix(2, 4, 1, pages)        # 2 shared > 1-page need


def test_pool_admission_accounting_with_shares():
    """can_admit_prefix charges only the unmatched tail (+COW), and counts
    matched pinned-only pages that stop being evictable."""
    pool = KVBlockPool(num_blocks=4, block_size=4, batch=4, max_blocks=8)
    pool.admit(0, 8, 1)
    pool.advance(0, 8)
    pages = list(pool.row_pages(0))
    for p in pages:
        pool.pin(p)
    pool.free(0)                                 # 2 free + 2 pin-only
    # worst case 3 pages, 2 matched -> 1 own page; matched pages lose
    # evictability (2) => 1 + 2 <= free 2 + evictable 2
    assert pool.can_admit_prefix(3, pages)
    assert pool.can_admit_prefix(3, pages, cow_last=True)      # 2 + 2 <= 4
    assert not pool.can_admit_prefix(4, pages, cow_last=True)  # 3 + 2 > 4
    pool.admit_prefix(1, 8, 4, pages)
    assert not pool.can_admit(2)                 # 1 remaining + 2 > 2 + 0
    assert pool.can_admit(1)
    pool.check_invariants()


def test_pool_evictor_protocol():
    """With no evictor a dry free list raises even when pages are
    pinned-only; a registered evictor is called until a page frees."""
    pool = KVBlockPool(num_blocks=2, block_size=4, batch=4, max_blocks=8)
    pool.admit(0, 8, 1)
    pool.advance(0, 8)
    pinned = list(pool.row_pages(0))
    for p in pinned:
        pool.pin(p)
    pool.free(0)
    assert pool.can_admit(2)                     # backed by evictable pages
    pool.admit(1, 8, 1)
    with pytest.raises(PoolExhausted):           # evictor unset
        pool.advance(1, 8)

    class Unpinner:                              # minimal evictor protocol
        def evict_one(self):
            if not pinned:
                return False
            pool.unpin(pinned.pop())
            return True

    pool.evictor = Unpinner()
    assert pool.advance(1, 8)                    # reclaims both pins
    assert pool.free_blocks == 0 and pool.evictable_blocks == 0
    pool.check_invariants()


def _pool_with_row(n_tokens, num_blocks=8, row=0, gen=1):
    pool = KVBlockPool(num_blocks=num_blocks, block_size=4, batch=4,
                       max_blocks=8)
    pool.admit(row, n_tokens, gen)
    pool.advance(row, n_tokens)
    return pool


def test_radix_publish_match_dedup_and_lru():
    pool = _pool_with_row(12)
    radix = RadixCache(pool)
    prompt = np.arange(12, dtype=np.int32)
    pages = pool.row_pages(0)
    assert radix.publish(prompt, pages, 3) == 3
    assert radix.publish(prompt, pages, 3) == 0      # dedup: first wins
    assert sorted(radix.pinned_pages()) == sorted(pages)
    m = radix.match(np.arange(14, dtype=np.int32), carryless=True)
    assert m.skip == 12 and list(m.pages) == list(pages) and not m.cow_last
    m = radix.match(np.arange(12, dtype=np.int32), carryless=True)
    assert m.skip == 11 and m.cow_last               # exact boundary: COW
    assert m.tokens_matched == 12
    m = radix.match(np.arange(7, dtype=np.int32), carryless=True)
    assert m.skip == 4 and len(m.pages) == 1         # partial page ignored
    div = np.concatenate([np.arange(4), [63], np.arange(5, 12)])
    m = radix.match(div.astype(np.int32), carryless=True)
    assert m.skip == 4                               # divergence at page 1
    assert radix.match(np.arange(3, dtype=np.int32), carryless=True) is None
    # carry-bearing configs need a snapshot node strictly below P
    assert radix.match(np.arange(14, dtype=np.int32), carryless=False) \
        is None
    radix.publish(prompt, pages, 3, carry={"ring": "snap"}, carry_tokens=8)
    m = radix.match(np.arange(14, dtype=np.int32), carryless=False)
    assert m.skip == 8 and m.carry == {"ring": "snap"} and len(m.pages) == 2
    assert radix.match(np.arange(8, dtype=np.int32), carryless=False) is None


def test_radix_lru_leaf_eviction_order():
    """Pinned-only leaves evict least-recently-used first; interior nodes
    follow only once their subtree drains; row-referenced pages never."""
    pool = _pool_with_row(8)
    radix = RadixCache(pool)
    pa = np.arange(8, dtype=np.int32)
    radix.publish(pa, pool.row_pages(0), 2)
    pool.free(0)
    pool.admit(1, 8, 1)
    pool.advance(1, 8)
    pb = (10 + np.arange(8)).astype(np.int32)
    radix.publish(pb, pool.row_pages(1), 2)
    pool.free(1)
    assert radix.num_nodes == 4 and pool.evictable_blocks == 4
    radix.match(pa, carryless=True)                  # touch pa's path last
    assert radix.evict_one()
    m = radix.match(pb, carryless=True)
    assert m is not None and m.skip == 4             # pb's LEAF was the LRU
    m = radix.match(pa, carryless=True)
    assert m is not None and m.skip == 7 and m.cow_last
    cow = pool.admit_prefix(2, 8, 1, m.pages, m.cow_last)
    assert cow is not None
    while radix.evict_one():
        pool.check_invariants()
    assert pool.ref_count(m.pages[0]) >= 1           # still row-referenced
    pool.check_invariants()


def test_radix_eviction_releases_carry_snapshots_without_gc():
    """Evicted nodes are unlinked and their carry cleared, so a snapshot
    frees by refcount at once, with no cyclic garbage collection."""
    pool = _pool_with_row(12)
    radix = RadixCache(pool)
    carry = np.zeros(4)
    radix.publish(np.arange(12, dtype=np.int32), list(pool.row_pages(0)), 3,
                  carry=carry, carry_tokens=8)
    pool.free(0)
    ref = weakref.ref(carry)
    del carry
    gc.disable()
    try:
        while radix.evict_one():
            pass
        assert radix.num_nodes == 0
        assert ref() is None
    finally:
        gc.enable()
    pool.check_invariants()


# ---------------------------------------------------------------------------
# The prefix-cached engine and scheduler (smoke gpt2-12l)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(3), JCFG))
    return jp, bridge.params_from_jax(jp)


def _engine(tp, **kw):
    return ServeEngine(CFG, tp, device="cpu", max_len=48, paged=True,
                       block_size=4, prefix_cache=True, **kw)


def _shared_workload(seed=0, gen=6):
    """Six requests over one 12-token (3-page at block size 4) shared
    prefix S: three distinct tails, the exact page-boundary prompt S itself
    (the COW rerun), a full repeat and a mid-prefix divergence (one page
    matches)."""
    rng = np.random.default_rng(seed)
    S = rng.integers(0, CFG.vocab_size, (12,)).astype(np.int32)
    tails = [rng.integers(0, CFG.vocab_size, (t,)).astype(np.int32)
             for t in (3, 5, 2)]
    div = rng.integers(0, CFG.vocab_size, (8,)).astype(np.int32)
    prompts = [np.concatenate([S, tails[0]]), np.concatenate([S, tails[1]]),
               np.concatenate([S, tails[2]]), S.copy(),
               np.concatenate([S, tails[0]]), np.concatenate([S[:4], div])]
    return [Request(prompt=p, max_new_tokens=gen) for p in prompts]


def _assert_solo_parity(tp, requests, results):
    solo = ServeEngine(CFG, tp, device="cpu", max_len=48)
    for req, res in zip(requests, results):
        want = solo.generate(req.prompt[None, :], req.max_new_tokens).tokens
        np.testing.assert_array_equal(res.tokens, want[0])
        assert len(res.new_tokens) == req.max_new_tokens


def test_prefix_hits_match_solo_and_jax_scheduler(params):
    """One slot serves the workload in order, so the hit pattern is fixed:
    full repeat 12, exact boundary 11 (P-1 skipped plus the COW rerun),
    divergence 4.  Every stream equals cold solo generation and the JAX
    prefix-cached scheduler's stream, with the same hit pattern."""
    jp, tp = params
    reqs = _shared_workload()
    sched = ContinuousScheduler(_engine(tp), max_batch=1, chunk_len=4,
                                invariant_every=1)
    results = sched.run(reqs)
    _assert_solo_parity(tp, reqs, results)
    want_hits = [0, 12, 12, 11, 12, 4]
    assert [r.prefix_tokens for r in results] == want_hits
    stats = sched.prefix_stats()
    assert stats["prefix_requests"] == len(reqs)
    assert stats["prefix_hits"] == 5
    assert stats["prefix_skipped_tokens"] == sum(want_hits)
    jeng = jax_engine.ServeEngine(JCFG, jp, mesh=mesh_lib.single_device_mesh(),
                                  max_len=48, paged=True, block_size=4,
                                  prefix_cache=True)
    jsched = jax_sched.ContinuousScheduler(jeng, max_batch=1, chunk_len=4)
    want = jsched.run([jax_sched.Request(prompt=r.prompt,
                                         max_new_tokens=r.max_new_tokens)
                       for r in reqs])
    for g, w in zip(results, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.prefix_tokens == w.prefix_tokens
    assert jsched.prefix_stats() == stats


def test_prefix_cache_under_eviction_pressure(params):
    """A 6-page pool: serving the shared workload makes the evictor
    reclaim pinned-only pages mid-run, and every stream still matches cold
    solo generation."""
    _, tp = params
    reqs = _shared_workload()
    sched = ContinuousScheduler(_engine(tp), max_batch=1, chunk_len=4,
                                num_blocks=6, invariant_every=1)
    results = sched.run(reqs)
    _assert_solo_parity(tp, reqs, results)
    assert sched.prefix_hits >= 1
    assert sched.last_state.radix.evicted_pages >= 1


def test_prefix_publish_match_evict_lifecycle(params):
    """Engine-level lifecycle against a 4-page pool, one request at a time
    (max_new 1: prefill only): publish pins survive free-on-EOS, a repeat
    prompt hits, filling the pool evicts the LRU leaf path, and the
    evicted prefix misses afterwards; invariants hold throughout."""
    _, tp = params
    eng = _engine(tp)
    solo = ServeEngine(CFG, tp, device="cpu", max_len=48)
    state = eng.continuous_state(1, num_blocks=4)
    rng = np.random.default_rng(2)
    pa, pb, pc = (rng.integers(0, CFG.vocab_size, (8,)).astype(np.int32)
                  for _ in range(3))

    def serve(state, prompt, match=None):
        state, job = eng.begin_prefill(state, 0, prompt, 1, chunk_len=4,
                                       match=match)
        tok = None
        while not job.done:
            state, tok = eng.prefill_chunk(state, job)
        state = eng.admit_paged(state, job, tok)
        state.pool.check_invariants()
        state = eng.free_slot(state, 0)
        state.pool.check_invariants()
        state.radix.check_invariants()
        want = solo.generate(prompt[None, :], 1).tokens[0, -1]
        assert int(tok[0, 0]) == int(want)
        return state

    state = serve(state, pa)                     # publishes 2 pages
    assert state.pool.free_blocks == 2 and state.pool.evictable_blocks == 2
    state = serve(state, pb)                     # pool now fully pinned
    assert state.pool.free_blocks == 0 and state.pool.evictable_blocks == 4
    match = eng.prefix_match(state, pb)          # warm repeat: full 2 pages
    assert match is not None and match.skip == 7 and match.cow_last
    state = serve(state, pb, match=match)        # COW rerun, re-publish noop
    assert state.radix.evicted_pages == 1        # one page for the clone
    state = serve(state, pc)                     # needs 2 more: evict LRU
    assert state.radix.evicted_pages >= 2
    assert eng.prefix_match(state, pa) is None   # pa's path was the victim
    assert eng.prefix_match(state, pc) is not None


def test_prefix_cache_gates(params):
    _, tp = params
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(CFG, tp, device="cpu", max_len=48, prefix_cache=True)
    eng = ServeEngine(CFG, tp, device="cpu", max_len=48, paged=True)
    state = eng.continuous_state(1)
    assert state.radix is None and eng.prefix_match(state, [1, 2]) is None


def test_fully_cached_head_never_deadlocks_admission(params):
    """A fully cached head in a tight pool can charge MORE than a cold
    admission (its matched pinned-only pages stop being evictable), so the
    aged-head preflight re-clamps the match shallower until it fits: a
    4-page pool, A (P=12, G=5) publishes 3 pinned pages and finishes; the
    same prompt B at full depth needs 2 own + 3 de-evicted = 5 > 4
    forever, the 2-page clamp 2 + 2 = 4 admits now."""
    _, tp = params
    rng = np.random.default_rng(7)
    S = rng.integers(0, CFG.vocab_size, (12,)).astype(np.int32)
    C = rng.integers(0, CFG.vocab_size, (5,)).astype(np.int32)
    reqs = [Request(prompt=S.copy(), max_new_tokens=5),
            Request(prompt=S.copy(), max_new_tokens=5),
            Request(prompt=C, max_new_tokens=3)]
    clock = {"t": 0.0}

    def time_fn():                  # every reading advances 1 ms
        clock["t"] += 1e-3
        return clock["t"]
    sched = ContinuousScheduler(_engine(tp), max_batch=1, chunk_len=4,
                                num_blocks=4, time_fn=time_fn,
                                sleep_fn=lambda s: None, admission_age_s=0.0,
                                invariant_every=1)
    results = sched.run(reqs)
    _assert_solo_parity(tp, reqs, results)
    assert [r.prefix_tokens for r in results] == [0, 8, 0]
    assert sched.prefix_hits == 1


def test_blocks_needed_boundary_regression(params):
    """Slots 0..P+G-2 hold K/V: (P+G) % bs == 1 does not round up an extra
    page, so two boundary requests (P=5, G=8: 3 pages, not 4) serve
    together in 6 pages and each matches its solo stream."""
    _, tp = params
    pool = KVBlockPool(num_blocks=8, block_size=4, batch=4, max_blocks=8)
    assert pool.blocks_needed(5, 8) == 3
    assert pool.blocks_needed(1, 1) == 1
    assert pool.blocks_needed(4, 1) == 1
    assert pool.blocks_needed(4, 13) == 4
    rng = np.random.default_rng(4)
    reqs = [Request(prompt=rng.integers(0, CFG.vocab_size,
                                        (5,)).astype(np.int32),
                    max_new_tokens=8) for _ in range(2)]
    eng = _engine(tp)
    one = ContinuousScheduler(eng, max_batch=1, chunk_len=4, num_blocks=3)
    _assert_solo_parity(tp, reqs[:1], one.run(reqs[:1]))
    assert 2 * -(-(5 + 8) // 4) > 6
    two = ContinuousScheduler(eng, max_batch=2, chunk_len=4, num_blocks=6)
    _assert_solo_parity(tp, reqs, two.run(reqs))
    assert two.peak_concurrency == 2


def test_summarize_empty_results_is_nan():
    s = summarize([], 1.0)
    assert s["requests"] == 0 and s["generated_tokens"] == 0
    assert np.isnan(s["ttft_p50_s"]) and np.isnan(s["ttft_p95_s"])
    assert s["tokens_per_s"] == 0.0


# ---------------------------------------------------------------------------
# Quantized pages under the prefix cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_prefix_quantized_matches_quantized_cold(params, kv):
    """Prefix sharing stays a numerical no-op on the same quantized pool:
    published pages hold the bytes the hitting request's own prefill would
    have written (quantize-at-write depends only on content and position),
    so hit streams equal serving each request cold on a fresh pool of the
    same dtype, with the float lane's hit pattern."""
    _, tp = params
    reqs = _shared_workload()
    results = ContinuousScheduler(_engine(tp, kv_dtype=kv), max_batch=1,
                                  chunk_len=4).run(reqs)
    assert [r.prefix_tokens for r in results] == [0, 12, 12, 11, 12, 4]
    cold = ServeEngine(CFG, tp, device="cpu", max_len=48, paged=True,
                       block_size=4, kv_dtype=kv)
    for req, res in zip(reqs, results):
        want = ContinuousScheduler(cold, max_batch=1,
                                   chunk_len=4).run([req])[0]
        np.testing.assert_array_equal(res.tokens, want.tokens)


def test_cow_page_copy_clones_scales_with_pages(params):
    """The exact-boundary COW clone copies the scale slots with the int8
    page bytes (zeroed scales would dequantize the shared slots to zero):
    after the COW admission the clone equals the source in every pool
    leaf, the source's scales are non-trivial, and the rerun samples the
    publisher's token."""
    _, tp = params
    eng = _engine(tp, kv_dtype="int8")
    state = eng.continuous_state(1, num_blocks=6)
    prompt = np.random.default_rng(3).integers(
        0, CFG.vocab_size, (8,)).astype(np.int32)

    def serve(state, match=None):
        state, job = eng.begin_prefill(state, 0, prompt, 1, chunk_len=4,
                                       match=match)
        tok = None
        while not job.done:
            state, tok = eng.prefill_chunk(state, job)
        return eng.free_slot(eng.admit_paged(state, job, tok), 0), tok

    state, tok_a = serve(state)                  # publishes 2 pinned pages
    match = eng.prefix_match(state, prompt)      # exact boundary: COW
    assert match is not None and match.cow_last
    src = match.pages[-1]
    state, job = eng.begin_prefill(state, 0, prompt, 1, chunk_len=4,
                                   match=match)
    dst = int(state.pool.table[0, len(match.pages) - 1])
    assert dst != src
    for layer in state.cache.values():
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            assert torch.equal(layer[name][:, dst], layer[name][:, src])
        assert float(layer["k_scales"][:, src].abs().max()) > 1e-6
    tok = None
    while not job.done:                          # rerun matches publisher
        state, tok = eng.prefill_chunk(state, job)
    assert int(tok[0, 0]) == int(tok_a[0, 0])
    state = eng.admit_paged(state, job, tok)
    state.pool.check_invariants()
    state.radix.check_invariants()
