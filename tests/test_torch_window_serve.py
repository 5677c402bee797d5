"""Sliding-window ring caches on every serving path of the port, held
within the port, byte for byte, at smoke size on the CPU: ``gemma2-9b``
(4 layers, 1:1 ring of 8 : global pool, softcaps) and ``gemma3-12b`` (6
layers, 5 rings of 8 : 1 global, qk-norm), prompts and generations longer
than the window.

The reference's contracts (``tests/test_serving_paged.py``,
``tests/test_serving_prefix.py``, ``tests/test_serving_spec.py``,
``tests/test_kv_quant.py``) re-proved in the port: contiguous continuous
batching and paged chunked prefill (rings in the B=1 carry, pool pages for
the global layers) each give the streams of solo ``generate``; a prefix
hit past the window restores its publisher's ring snapshot and equals its
cold run; speculative streams (a depth-truncated draft whose rings roll
back, the verify's deferred ring commit) equal non-speculative decode,
with the prefix cache too; the draft's rolled-back rings equal sequential
decode of exactly the accepted tokens; int8 pool leaves keep f32 rings,
and over them prefix hits equal their cold runs; and γ + 1 past a window
is refused with the reference's message.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import registry
from repro_torch.models import transformer as tr
from repro_torch.train import steps
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_scheduler import ContinuousScheduler, Request

NAMES = ("gemma2-9b", "gemma3-12b")
MAX_LEN = 64
GAMMA = 3
# (prompt, new tokens): prompts on both sides of the ring of 8, streams
# that wrap it.
REQ_SHAPES = ((5, 9), (13, 6), (20, 4), (9, 7))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these ops are tiny, and on a shared CPU many
    threads make them several times slower.  Every comparison here is
    between runs under the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    cfg = configs.get_smoke_config(request.param)
    params = registry.get_model(cfg).init(torch.Generator().manual_seed(0),
                                          cfg, device="cpu")
    return cfg, params


def _requests(cfg, seed=0, shapes=REQ_SHAPES):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        (p,)).astype(np.int32),
                    max_new_tokens=g) for p, g in shapes]


def _assert_solo_parity(cfg, params, requests, results):
    solo = ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN)
    for req, res in zip(requests, results):
        want = solo.generate(req.prompt[None, :], req.max_new_tokens).tokens
        np.testing.assert_array_equal(res.tokens, want[0])
        assert len(res.new_tokens) == req.max_new_tokens


def _run(cfg, params, reqs, max_batch=2, **kw):
    eng = ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN, **kw)
    sched = ContinuousScheduler(eng, max_batch=max_batch, chunk_len=4,
                                invariant_every=1 if kw.get("paged") else 0)
    return sched, sched.run(reqs)


def test_contiguous_continuous_streams_equal_solo(model):
    cfg, params = model
    reqs = _requests(cfg)
    _, results = _run(cfg, params, reqs)
    _assert_solo_parity(cfg, params, reqs, results)


def test_paged_chunked_prefill_equals_solo(model):
    """Rings per row beside the pool: chunks of 4 advance the B=1 carry's
    rings, admission scatters them into the row, the global layers read
    the pool through the paged path."""
    cfg, params = model
    reqs = _requests(cfg)
    _, results = _run(cfg, params, reqs, paged=True, block_size=4)
    _assert_solo_parity(cfg, params, reqs, results)


def _prefix_requests(cfg, seed=0):
    """A shared prefix of 12 tokens (past the ring of 8), tails of
    different lengths, an exact repeat and a divergent prompt."""
    rng = np.random.default_rng(seed)
    S = rng.integers(0, cfg.vocab_size, (12,)).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32)
             for t in (3, 5, 2)]
    div = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)
    return [Request(prompt=p, max_new_tokens=6) for p in (
        np.concatenate([S, tails[0]]), np.concatenate([S, tails[1]]),
        np.concatenate([S, tails[2]]), S.copy(),
        np.concatenate([S, tails[0]]), np.concatenate([S[:4], div]))]


def test_prefix_hit_past_the_window_equals_cold(model):
    """Hits restore the ring snapshot taken at the publisher's last page
    boundary and rerun the tail: every stream equals its cold solo run."""
    cfg, params = model
    reqs = _prefix_requests(cfg)
    sched, results = _run(cfg, params, reqs, paged=True, block_size=4,
                          prefix_cache=True)
    _assert_solo_parity(cfg, params, reqs, results)
    assert sched.prefix_hits >= 2


def _draft_depth(cfg):
    """Half the smoke depth in whole periods: gemma2 drafts with 2 of 4
    layers (a ring and a global layer), gemma3 (one period of 6) with 0."""
    period = cfg.pattern_period
    return (cfg.num_layers // 2) // period * period


def test_spec_streams_equal_non_spec(model):
    """A depth-truncated draft (rejections every round): every stream
    equals non-speculative decode."""
    cfg, params = model
    reqs = _requests(cfg)
    sched, results = _run(cfg, params, reqs, paged=True, block_size=4,
                          spec_decode=True, gamma=GAMMA,
                          draft_depth=_draft_depth(cfg))
    _assert_solo_parity(cfg, params, reqs, results)
    stats = sched.spec_stats()
    assert stats["spec_rounds"] > 0
    assert stats["spec_accepted"] < stats["spec_proposed"]


def test_prefix_cache_with_spec_equals_solo(model):
    cfg, params = model
    reqs = _prefix_requests(cfg, seed=1)
    sched, results = _run(cfg, params, reqs, paged=True, block_size=4,
                          prefix_cache=True, spec_decode=True, gamma=GAMMA,
                          draft_depth=_draft_depth(cfg))
    _assert_solo_parity(cfg, params, reqs, results)
    assert sched.prefix_hits >= 2 and sched.spec_stats()["spec_rounds"] > 0


def test_draft_rings_rolled_back_equal_sequential_decode():
    """γ+1 draft steps over four rows (row 0 inactive) at cursors around
    the ring's wrap, then the rollback to accepted lengths 0, 1, 2 and
    γ+1: each row's rings equal plain decode of exactly its accepted
    tokens from the pre-round state, bit for bit."""
    cfg = configs.get_smoke_config("gemma2-9b").with_depth(2)
    params = registry.get_model(cfg).init(torch.Generator().manual_seed(3),
                                          cfg, device="cpu")
    rng = np.random.default_rng(9)
    B = 4
    cache = tr.lm_init_cache(params, cfg, B, MAX_LEN, torch.float32,
                             device="cpu")
    for lc in cache.values():
        for t in lc.values():
            t.copy_(torch.from_numpy(rng.normal(
                0, 0.5, tuple(t.shape)).astype(np.float32)))
    start = {ln: {k: t.clone() for k, t in lc.items()}
             for ln, lc in cache.items()}
    draft = steps.make_draft_loop_step(cfg, GAMMA, ring_layers=("layer0",))
    rollback = steps.make_draft_rollback_step(cfg, GAMMA,
                                              ring_layers=("layer0",))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))).long()
    index = torch.tensor([4, 6, 7, 30])
    active = torch.tensor([False, True, True, True])
    vt, cache, ring = draft(params, tok, cache, index, active, None)
    assert all(torch.equal(ring["layer0"][k], start["layer0"][k])
               for k in ("k", "v"))
    acc = [0, 1, 2, GAMMA + 1]
    cache = rollback(cache, ring, index, torch.tensor(acc))
    # Plain decode of the same tokens over the whole batch from the start
    # state, the rings after each step.
    seq = [start["layer0"]]
    plain = {ln: {k: t.clone() for k, t in lc.items()}
             for ln, lc in start.items()}
    with torch.inference_mode():
        for t in range(GAMMA + 1):
            _, plain = tr.lm_decode_step(params, cfg, vt[:, t:t + 1], plain,
                                         index + t)
            seq.append({k: v.clone() for k, v in plain["layer0"].items()})
    for b, a in enumerate(acc):
        for k in ("k", "v"):
            assert torch.equal(cache["layer0"][k][:, b],
                               seq[a][k][:, b]), (b, k)


def test_int8_pool_leaves_keep_float32_rings(model):
    """``kv_dtype`` int8 quantizes the global layers' pool (pages and f32
    scales) and leaves every ring per row in the cache dtype.  Over int8
    pages, prefix hits (shared quantized pages, restored f32 rings) equal
    the cold int8 runs byte for byte, and the streams keep the f32 pool's
    lengths."""
    cfg, params = model
    cache = tr.lm_init_paged_cache(params, cfg, 2, 8, 4, MAX_LEN,
                                   torch.float32, kv_dtype=torch.int8,
                                   device="cpu")
    for i in range(cfg.pattern_period):
        lc = cache[f"layer{i}"]
        if cfg.layer_window(i) > 0:
            assert set(lc) == {"k", "v"}
            assert lc["k"].dtype == torch.float32
            assert lc["k"].shape[1:3] == (2, 8)
        else:
            assert lc["k_pages"].dtype == torch.int8
            assert lc["k_scales"].dtype == torch.float32
    reqs = _prefix_requests(cfg, seed=2)
    f32 = _run(cfg, params, reqs, paged=True, block_size=4)[1]
    cold = _run(cfg, params, reqs, paged=True, block_size=4,
                kv_dtype="int8", max_batch=1)[1]
    sched, hit = _run(cfg, params, reqs, paged=True, block_size=4,
                      kv_dtype="int8", prefix_cache=True, max_batch=1)
    assert sched.prefix_hits >= 2
    for a, b, c in zip(cold, hit, f32):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert len(a.new_tokens) == len(c.new_tokens)


def test_gamma_past_the_window_is_refused():
    cfg = configs.get_smoke_config("gemma2-9b")
    params = registry.get_model(cfg).init(torch.Generator().manual_seed(0),
                                          cfg, device="cpu")
    with pytest.raises(ValueError, match=r"gamma 8 \+ 1 draft writes exceed "
                       "sliding window 8: a speculation round may not "
                       "overwrite a draft ring slot twice"):
        ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN, paged=True,
                    block_size=4, spec_decode=True, gamma=8, draft_depth=2)
    with pytest.raises(ValueError, match="exceed a sliding window 8"):
        steps.make_draft_rollback_step(cfg, 8, ring_layers=("layer0",))
    ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN, paged=True,
                block_size=4, spec_decode=True, gamma=7, draft_depth=2)
