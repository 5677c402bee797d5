"""Self-speculative decoding in the port (``train/kv_pool.truncate_row``,
``models/attention.attn_verify_chunk``, ``models/transformer.lm_verify``,
``train/steps``' draft loop, verify and row scatter, the engine's
``decode_spec`` and the scheduler's speculation rounds) against the JAX
package's, on the CPU.

Most run the port's smoke ``gpt2-12l`` at depth 4 (d_model 64, 4 heads of
16, vocab 256, ``max_seq_len`` 128), the JAX init carried over by
``repro_torch.bridge``; the reference's own RoPE GQA config
(``tests/test_serving_spec.py:CFG_DENSE``) holds the spec streams to
plain decode and solo generation.

Cross-framework: ``truncate_row`` op by op against the JAX pool; the
verify forward's logits within ``LOGIT_TOL`` of JAX's ``lm_verify`` and
its page writes (scales included) at rows with different cursors, an
inactive row and rows at their limit, over f32 and int8 pools; the greedy
accept rule's outputs equal to JAX's ``make_verify_step``; and the spec
scheduler's greedy streams equal to the JAX spec scheduler's.

In-port, the contracts of ``tests/test_serving_spec.py`` and the spec
cases of ``tests/test_serving_prefix.py``, all byte for byte: greedy spec
streams equal solo generation with a rejection-heavy draft; a
``copying_zeroL`` expansion's draft accepts exactly every proposal, on
the budget boundary too; a zero-layer draft; eos mid-budget; int8 spec
equals int8 non-spec on the same pool; prefix cache plus spec equals the
prefix cache alone; a request whose draft runs past ``max_len`` and
``max_seq_len``.  Sampling is held by distribution (the port draws with a
``torch.Generator``, the reference with threefry): the accept rule's first
emitted token against ``p_t[0]`` and its bonus against ``p_t[γ]``, within
``FREQ_TOL``.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.launch import mesh as mesh_lib
from repro.models import transformer as jtr
from repro.train import serve_engine as jax_engine
from repro.train import serve_scheduler as jax_sched
from repro.train import steps as jax_steps
from repro.train.kv_pool import KVBlockPool as JaxPool
from repro_torch import bridge
from repro_torch import configs
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.core import expansion as exp
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.models import transformer as tr
from repro_torch.train import steps
from repro_torch.train.kv_pool import KVBlockPool
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_scheduler import ContinuousScheduler, Request

CFG = configs.get_smoke_config("gpt2-12l").with_depth(4)
JCFG = jax_configs.get_smoke_config("gpt2-12l").with_depth(4)
LOGIT_TOL = 1e-5          # tests/test_torch_models.py's, after the stack
MAX_LEN = 48
REQ_SHAPES = ((5, 7), (9, 4), (3, 10), (6, 2), (4, 8), (7, 5))
# Sampled frequencies against their distribution over N_DRAWS rows: a
# binomial standard deviation is at most 0.5 / sqrt(N_DRAWS) = 0.0035.
N_DRAWS = 20000
FREQ_TOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these ops are tiny, and on a shared CPU many
    threads make them several times slower.  Every comparison here is
    between runs under the same setting, or within a stated tolerance."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(0), JCFG))
    return jp, bridge.params_from_jax(jp)


@pytest.fixture(scope="module")
def zerol():
    """A random 2-layer model and its ``copying_zeroL`` expansion to 4."""
    cfg2 = CFG.with_depth(2)
    p2 = registry.get_model(cfg2).init(torch.Generator().manual_seed(1),
                                       cfg2, device="cpu")
    return cfg2, p2, exp.expand_params(p2, cfg2, 4, "copying_zeroL")


def _requests(cfg=CFG, seed=0, shapes=REQ_SHAPES):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        (p,)).astype(np.int32),
                    max_new_tokens=g) for p, g in shapes]


def _spec(cfg, tp, **kw):
    kw.setdefault("gamma", 3)
    return ServeEngine(cfg, tp, device="cpu", max_len=kw.pop("max_len",
                                                             MAX_LEN),
                       paged=True, block_size=4, spec_decode=True, **kw)


def _run(eng, reqs, **kw):
    sched = ContinuousScheduler(eng, max_batch=2, chunk_len=4,
                                invariant_every=1, **kw)
    return sched, sched.run(reqs)


def _assert_solo_parity(cfg, tp, requests, results, max_len=MAX_LEN):
    solo = ServeEngine(cfg, tp, device="cpu", max_len=max_len)
    for req, res in zip(requests, results):
        want = solo.generate(req.prompt[None, :], req.max_new_tokens).tokens
        np.testing.assert_array_equal(res.tokens, want[0])
        assert len(res.new_tokens) == req.max_new_tokens


def _assert_same_streams(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)


# ---------------------------------------------------------------------------
# truncate_row, op by op against the JAX pool
# ---------------------------------------------------------------------------


def _pool_state(pool):
    return (pool.table.copy(), pool.version, sorted(pool._free),
            dict(pool._ref), dict(pool._pins), pool.free_blocks,
            pool.remaining_commitment, pool.evictable_blocks)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_truncate_row_matches_jax_pool_op_by_op(seed):
    """A seeded sequence of admissions (cold and over pinned prefix
    pages), speculation rounds (advance by up to γ+1, accept 1..γ+1,
    truncate to the new cursor), publishes, unpins and frees, on both
    pools: after every operation the same tables, version, free list,
    refcounts, pins and commitments.  Truncation never drops a shared
    prefix page from its row."""
    rng = np.random.default_rng(seed)
    kw = dict(num_blocks=16, block_size=2, batch=3, max_blocks=10)
    pools = (KVBlockPool(**kw), JaxPool(**kw))
    live = {}                        # row -> [prompt, budget, cursor, shared]
    pinned = []                      # pages pinned once, oldest first
    for _ in range(300):
        row = int(rng.integers(0, 3))
        if row not in live:
            P, G = int(rng.integers(1, 9)), int(rng.integers(1, 8))
            need = pools[0].blocks_needed(P, G)
            n_sh = int(rng.integers(0, min(len(pinned), P // 2) + 1))
            shared = pinned[:n_sh] if rng.random() < 0.6 else []
            own = need - len(shared)
            # No evictor: admit only what free pages back outright.
            oks = [p.can_admit_prefix(need, shared)
                   and p.remaining_commitment + own <= p.free_blocks
                   for p in pools]
            assert oks[0] == oks[1]
            if oks[0] and need <= kw["max_blocks"]:
                for p in pools:
                    p.admit_prefix(row, P, G, shared)
                    p.advance(row, P)
                live[row] = [P, G, P, list(shared)]
        else:
            P, G, cur, shared = live[row]
            limit = P + G - 1
            roll = rng.random()
            if roll < 0.15 or cur >= limit:
                for p in pools:
                    p.free(row)
                del live[row]
            elif roll < 0.25:                 # publish the prompt's pages
                for page in pools[0].row_pages(row)[:P // 2]:
                    if page not in pinned:
                        for p in pools:
                            p.pin(page)
                        pinned.append(page)
            elif roll < 0.3 and pinned:
                page = pinned.pop(0)
                for p in pools:
                    p.unpin(page)
            else:                             # one speculation round
                gamma = int(rng.integers(1, 5))
                for p in pools:
                    p.advance(row, min(cur + gamma + 1, limit))
                acc = int(rng.integers(1, min(gamma + 1, limit - cur) + 1))
                cur = live[row][2] = cur + acc
                before = [p.ref_count(s) for s in shared for p in pools[:1]]
                got = [p.truncate_row(row, cur) for p in pools]
                assert got[0] == got[1]
                for p in pools:
                    assert list(p.row_pages(row)[:len(shared)]) == shared
                assert [pools[0].ref_count(s) for s in shared] == before
        a, b = (_pool_state(p) for p in pools)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
        for p in pools:
            p.check_invariants()


def test_truncate_row_bookkeeping():
    pool = KVBlockPool(num_blocks=8, block_size=4, batch=2, max_blocks=8)
    pool.admit(0, 5, 10)                     # commitment: 4 pages
    pool.advance(0, 13)
    version = pool.version
    assert pool.truncate_row(0, 6)           # keeps ceil(6/4) = 2 pages
    assert len(pool.row_pages(0)) == 2 and pool.version == version + 1
    assert (pool.table[0, 2:] == pool.trash).all()
    assert pool.free_blocks == 6 and pool.remaining_commitment == 2
    assert not pool.truncate_row(0, 8)       # at the frontier: a no-op
    assert pool.version == version + 1
    pool.check_invariants()
    with pytest.raises(ValueError, match="not admitted"):
        pool.truncate_row(1, 0)
    with pytest.raises(ValueError):
        pool.truncate_row(0, -1)


# ---------------------------------------------------------------------------
# The verify forward and the greedy accept rule against JAX
# ---------------------------------------------------------------------------

BS, NB = 4, 32                         # NB * BS == max_seq_len
# Rows: mid-sequence; two positions short of its limit; inactive; at its
# limit next to max_seq_len, so positions 128, 129 lie past the position
# table and past the block table's width.
V_INDEX = np.array([5, 9, 7, 126])
V_LIMIT = np.array([20, 11, 30, 127])
V_ACTIVE = np.array([True, True, False, True])


def _verify_inputs(kv):
    rng = np.random.default_rng(11)
    B, C = len(V_INDEX), 4
    n_super, NP = CFG.num_layers, len(V_INDEX) * NB
    shape = (n_super, NP + 1, BS, CFG.num_kv_heads, CFG.head_dim)
    cache = {}
    for i in range(CFG.pattern_period):
        if kv == "int8":
            lc = {n: rng.integers(-127, 128, shape).astype(np.int8)
                  for n in ("k_pages", "v_pages")}
            lc.update({n: rng.uniform(0.002, 0.02, shape[:-1] + (1,))
                       .astype(np.float32) for n in ("k_scales", "v_scales")})
        else:
            lc = {n: rng.standard_normal(shape).astype(np.float32)
                  for n in ("k_pages", "v_pages")}
        cache[f"layer{i}"] = lc
    table = rng.permutation(NP).reshape(B, NB).astype(np.int32)
    tokens = rng.integers(0, CFG.vocab_size, (B, C)).astype(np.int32)
    wmask = V_ACTIVE[:, None] & (V_INDEX[:, None] + np.arange(C)[None, :]
                                 < V_LIMIT[:, None])
    return cache, table, tokens, wmask


# Jitted as the reference serves it: a traced gather clamps where an eager
# one past the end raises.
_jax_verify = jax.jit(jtr.lm_verify, static_argnums=(1,))


def _torch_tree(cache):
    return {ln: {k: torch.from_numpy(v.copy()) for k, v in lc.items()}
            for ln, lc in cache.items()}


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_lm_verify_matches_jax(params, kv):
    """Logits within ``LOGIT_TOL`` at every position in play.  The pool
    after the writes, the trash page aside: every slot not written byte
    for byte as it was (masked writes land nowhere else), and the written
    slots against JAX's.  The two frameworks' K/V projections differ in
    their last bits (up to ~2e-6 here), so written f32 K/V is held within
    ``LOGIT_TOL``, written int8 values within one quantization step and
    their scales within 1e-5 relative."""
    jp, tp = params
    cache, table, tokens, wmask = _verify_inputs(kv)
    jl, jc = _jax_verify(jp, JCFG, jnp.asarray(tokens),
                           jax.tree.map(jnp.asarray, cache),
                           jnp.asarray(V_INDEX, jnp.int32),
                           jnp.asarray(table), jnp.asarray(wmask))
    tc = _torch_tree(cache)
    with torch.inference_mode():
        tl, tc = tr.lm_verify(tp, CFG, torch.from_numpy(tokens).long(), tc,
                              torch.from_numpy(V_INDEX).long(),
                              torch.from_numpy(table),
                              torch.from_numpy(wmask))
    np.testing.assert_allclose(tl.numpy()[wmask], np.asarray(jl)[wmask],
                               atol=LOGIT_TOL, rtol=0)
    written = np.zeros(cache["layer0"]["k_pages"].shape[1:3], bool)
    for b, c in zip(*np.nonzero(wmask)):
        pos = V_INDEX[b] + c
        written[table[b, pos // BS], pos % BS] = True
    assert written.sum() == wmask.sum()
    trash = written.shape[0] - 1
    for ln, lc in cache.items():
        for name, before in lc.items():
            got = tc[ln][name].numpy()[:, :trash]
            want = np.asarray(jc[ln][name])[:, :trash]
            w = written[:trash]
            np.testing.assert_array_equal(got[:, ~w], before[:, :trash][:, ~w])
            if name.endswith("_scales"):
                np.testing.assert_allclose(got[:, w], want[:, w], rtol=1e-5)
            elif kv == "int8":
                step = np.abs(got[:, w].astype(np.int32) - want[:, w])
                assert step.max() <= 1
            else:
                np.testing.assert_allclose(got[:, w], want[:, w],
                                           atol=LOGIT_TOL, rtol=0)


def test_verify_step_greedy_matches_jax(params):
    """The greedy accept rule against JAX's ``make_verify_step`` on one
    round: proposals built from the target's own argmax so that rows
    accept 3 of 3, 1 of 3 and 0 of 3; eos on the second emitted token of
    the full-accept row; a row two positions short of its limit; an
    inactive row.  Every output equal."""
    jp, tp = params
    cache, table, _, _ = _verify_inputs("f32")
    rng = np.random.default_rng(4)
    index = np.array([5, 9, 7, 14])
    limit = np.array([30, 11, 30, 40])
    active = np.array([True, True, False, True])
    gamma, C = 3, 4
    tokens = rng.integers(0, CFG.vocab_size, (4, C)).astype(np.int32)
    keep = [3, 3, 0, 1]                 # proposals to take from the target
    wmask = active[:, None] & (index[:, None] + np.arange(C)[None, :]
                               < limit[:, None])
    for j in range(1, C):               # position j-1's argmax, in order
        logits, _ = _jax_verify(jp, JCFG, jnp.asarray(tokens),
                                jax.tree.map(jnp.asarray, cache),
                                jnp.asarray(index, jnp.int32),
                                jnp.asarray(table), jnp.asarray(wmask))
        g = np.asarray(jnp.argmax(logits, -1))
        for b in range(4):
            if j <= keep[b]:
                tokens[b, j] = g[b, j - 1]
            elif j == keep[b] + 1:
                tokens[b, j] = (g[b, j - 1] + 1) % CFG.vocab_size
    eos = int(tokens[0, 2])            # row 0 emits eos as its 2nd token
    jverify = jax_steps.make_verify_step(JCFG, gamma)
    want = jverify(jp, jnp.asarray(tokens), jax.tree.map(jnp.asarray, cache),
                   jnp.asarray(index, jnp.int32), jnp.asarray(active),
                   jnp.asarray(limit, jnp.int32), jnp.asarray(table),
                   jnp.int32(eos), jax.random.PRNGKey(0))
    verify = steps.make_verify_step(CFG, gamma)
    got = verify(tp, torch.from_numpy(tokens).long(), _torch_tree(cache),
                 torch.from_numpy(index).long(), torch.from_numpy(active),
                 torch.from_numpy(limit).long(), torch.from_numpy(table),
                 eos, None)
    out, acc, nxt, _, new_index, new_active = got
    w_out, w_acc, w_nxt, _, w_index, w_active, _ = want
    np.testing.assert_array_equal(acc.numpy(), np.asarray(w_acc))
    np.testing.assert_array_equal(out.numpy(), np.asarray(w_out))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(w_nxt))
    np.testing.assert_array_equal(new_index.numpy(), np.asarray(w_index))
    np.testing.assert_array_equal(new_active.numpy(), np.asarray(w_active))
    assert acc.tolist() == [2, 2, 0, 2]     # eos clamp, limit, inactive, 1+1
    assert new_active.tolist() == [False, False, False, True]


# ---------------------------------------------------------------------------
# The spec scheduler: greedy streams byte for byte
# ---------------------------------------------------------------------------


def test_spec_streams_match_jax_scheduler_and_solo(params):
    """A random depth-4 target with its depth-2 truncation as the draft
    (rejection-heavy: rollback and partial accepts every round), two slots
    reused, chunked prefill: every greedy stream equals the JAX spec
    scheduler's and solo generation, with the same acceptance counts."""
    jp, tp = params
    reqs = _requests()
    sched, results = _run(_spec(CFG, tp, draft_depth=2), reqs)
    _assert_solo_parity(CFG, tp, reqs, results)
    jeng = jax_engine.ServeEngine(JCFG, jp, mesh=mesh_lib.single_device_mesh(),
                                  max_len=MAX_LEN, paged=True, block_size=4,
                                  spec_decode=True, gamma=3, draft_depth=2)
    jsched = jax_sched.ContinuousScheduler(jeng, max_batch=2, chunk_len=4)
    want = jsched.run([jax_sched.Request(prompt=r.prompt,
                                         max_new_tokens=r.max_new_tokens)
                       for r in reqs])
    _assert_same_streams(results, want)
    assert [r.spec_rounds for r in results] == [r.spec_rounds for r in want]
    assert sched.spec_stats() == jsched.spec_stats()
    assert 0 < sched.acceptance_rate < 1.0
    for res in results:
        assert res.spec_rounds >= 1
        assert res.mean_accepted_len == (len(res.new_tokens) - 1) \
            / res.spec_rounds


# The reference's spec config (tests/test_serving_spec.py:CFG_DENSE): RoPE,
# GQA 4/2 of head dim 8, 4 layers, vocab 64, max_seq_len 64.
ROPE_CFG = ModelConfig(name="sp-dense", family="dense", num_layers=4,
                       d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                       vocab_size=64, max_seq_len=64)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_rope_spec_streams_equal_plain_decode(kv):
    """On the reference's RoPE GQA config (the JAX init carried over):
    greedy spec streams (depth-2 draft, γ 3) are byte-identical to the
    port's non-spec paged streams on the same pool dtype and, over f32
    pages, to solo generation."""
    jcfg = JaxModelConfig(**dataclasses.asdict(ROPE_CFG))
    tp = bridge.params_from_jax(jax.device_get(
        jtr.lm_init(jax.random.PRNGKey(5), jcfg)))
    reqs = _requests(ROPE_CFG, seed=3)
    kw = {} if kv is None else dict(kv_dtype=kv)
    _, results = _run(_spec(ROPE_CFG, tp, draft_depth=2, **kw), reqs)
    plain = ServeEngine(ROPE_CFG, tp, device="cpu", max_len=MAX_LEN,
                        paged=True, block_size=4, **kw)
    _assert_same_streams(results, _run(plain, reqs)[1])
    if kv is None:
        _assert_solo_parity(ROPE_CFG, tp, reqs, results)


def test_rope_positions_past_max_seq_len_are_served():
    """RoPE requests with P + G - 1 past ``max_seq_len`` (16) but inside
    ``max_len`` (48) are served, as the reference rotates any position:
    solo generation's logits at positions up to 28 agree with the JAX
    forward on the same params (carried over by the bridge) and tokens
    within ``LOGIT_TOL`` (absolute, plus 1e-5 relative), and the paged
    spec streams (depth-2 draft, γ 3) equal solo byte for byte."""
    cfg = dataclasses.replace(ROPE_CFG, max_seq_len=16)
    jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
    tp = registry.get_model(cfg).init(torch.Generator().manual_seed(6), cfg,
                                      device="cpu")
    jp = bridge.params_to_numpy(tp)
    reqs = _requests(cfg, seed=4, shapes=((20, 10), (13, 12)))
    solo = ServeEngine(cfg, tp, device="cpu", max_len=MAX_LEN)
    for req in reqs:
        P = len(req.prompt)
        res = solo.generate(req.prompt[None, :], req.max_new_tokens,
                            return_logits=True)
        want, _ = jax.jit(lambda p, t: jtr.lm_apply(p, jcfg, t))(
            jp, jnp.asarray(res.tokens[:, :-1]))
        np.testing.assert_allclose(res.logits, np.asarray(want)[:, P - 1:],
                                   atol=LOGIT_TOL, rtol=1e-5)
    _, results = _run(_spec(cfg, tp, draft_depth=2), reqs)
    _assert_solo_parity(cfg, tp, reqs, results)


@pytest.mark.parametrize("draft", ["depth", "params"])
def test_zeroL_draft_accepts_everything(zerol, draft):
    """The paper's free draft: a ``copying_zeroL`` 2->4 expansion served
    with its depth-2 truncation (or with the pre-expansion params as
    ``draft_params``, the --draft-checkpoint path) accepts every proposal,
    rate exactly 1.0, and the stream equals the 2-layer model's solo
    stream."""
    cfg2, p2, p4 = zerol
    kw = dict(draft_depth=2) if draft == "depth" else dict(draft_params=p2)
    eng = _spec(CFG, p4, **kw)
    assert eng.draft_cfg.num_layers == 2
    reqs = _requests(cfg2)[:4]
    sched, results = _run(eng, reqs)
    _assert_solo_parity(cfg2, p2, reqs, results)
    assert sched.acceptance_rate == 1.0


def test_acceptance_rate_exact_on_budget_boundary(zerol):
    """Budgets that end every row mid-round ((G-1) % (γ+1) != 0): only
    proposals in play count, so the perfect draft reads exactly 1.0."""
    cfg2, p2, p4 = zerol
    reqs = _requests(cfg2, seed=7, shapes=((5, 6), (7, 7), (4, 8), (6, 10)))
    sched, results = _run(_spec(CFG, p4, draft_depth=2), reqs)
    _assert_solo_parity(cfg2, p2, reqs, results)
    assert all(r.finish_reason == "limit" for r in results)
    stats = sched.spec_stats()
    assert stats["spec_proposed"] > 0
    assert stats["spec_accepted"] == stats["spec_proposed"]
    assert sched.acceptance_rate == 1.0


def test_zero_layer_draft(params):
    """``draft_depth=0``: embedding and head alone propose; the verified
    stream still equals solo generation."""
    _, tp = params
    reqs = _requests()[:4]
    eng = _spec(CFG, tp, gamma=2, draft_depth=0)
    state = eng.continuous_state(2)
    assert state.draft_cache == {}
    _, results = _run(eng, reqs)
    _assert_solo_parity(CFG, tp, reqs, results)


def test_eos_mid_budget_and_sampling_smoke(params):
    """EOS mid-budget ends the stream exactly where solo decode ends it;
    at temperature 0.8 every request emits its full budget of in-vocabulary
    tokens."""
    _, tp = params
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, CFG.vocab_size, (6,)).astype(np.int32)
    solo = ServeEngine(CFG, tp, device="cpu", max_len=MAX_LEN)
    stream = solo.generate(prompt[None, :], 12).tokens[0, 6:]
    eos = int(stream[4])
    cut = int(np.argmax(stream == eos)) + 1
    eng = _spec(CFG, tp, draft_depth=2)
    _, (res,) = _run(eng, [Request(prompt=prompt, max_new_tokens=12)],
                     eos_id=eos)
    assert res.finish_reason == "eos"
    np.testing.assert_array_equal(res.new_tokens, stream[:cut])
    reqs = _requests()[:4]
    _, results = _run(eng, reqs, temperature=0.8, seed=7)
    for req, res in zip(reqs, results):
        assert len(res.new_tokens) == req.max_new_tokens
        assert (res.new_tokens >= 0).all()
        assert (res.new_tokens < CFG.vocab_size).all()


@pytest.mark.parametrize("extra", [0, 1], ids=["P+G=max_seq_len",
                                               "P+G-1=max_seq_len"])
def test_draft_past_max_len_and_max_seq_len(params, extra):
    """P + G == max_len, with max_len == max_seq_len (128) or one more
    (P + G - 1 == max_seq_len; P + G <= max_len needs the one), γ = 3: the
    last rounds' draft runs positions up to P + G - 2 + γ, past the draft
    cache and the position table, and the verify's block index past the
    table's width.  Those writes drop and those reads clamp: the stream
    equals solo."""
    _, tp = params
    L = CFG.max_seq_len + extra
    reqs = _requests(seed=5, shapes=((L - 9, 9), (L - 14, 14)))
    sched, results = _run(_spec(CFG, tp, draft_depth=2, max_len=L), reqs)
    _assert_solo_parity(CFG, tp, reqs, results, max_len=L)
    assert sched.spec_rounds > 0


def test_int8_spec_equals_int8_non_spec(params):
    """On the same int8 pool, speculation stays a numerical no-op: verify
    writes quantize deterministically, and rejected slots past the rewound
    cursor are rewritten before they are read.  The truncated draft keeps
    acceptance below 1, so rollback runs."""
    _, tp = params
    reqs = _requests()
    plain = ServeEngine(CFG, tp, device="cpu", max_len=MAX_LEN, paged=True,
                        block_size=4, kv_dtype="int8")
    base = ContinuousScheduler(plain, max_batch=2, chunk_len=4).run(reqs)
    sched, results = _run(_spec(CFG, tp, draft_depth=2, kv_dtype="int8"),
                          reqs)
    _assert_same_streams(results, base)
    assert sched.spec_rounds > 0 and sched.acceptance_rate < 1.0
    assert sched.kv_stats()["kv_dtype"] == "int8"


def _shared_workload(seed=0, gen=6):
    """A 12-token shared prefix: three tails, the exact page-boundary
    prompt itself (copy-on-write) and a full repeat."""
    rng = np.random.default_rng(seed)
    S = rng.integers(0, CFG.vocab_size, (12,)).astype(np.int32)
    tails = [rng.integers(0, CFG.vocab_size, (t,)).astype(np.int32)
             for t in (3, 5, 2)]
    prompts = [np.concatenate([S, t]) for t in tails] + [
        S.copy(), np.concatenate([S, tails[0]])]
    return [Request(prompt=p, max_new_tokens=gen) for p in prompts]


@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefix_cache_with_spec_equals_prefix_cache_alone(params, kv):
    """Prefix hits under speculation, f32 and int8 pools: the same streams
    and hit pattern as the prefix cache without speculation; published
    pages are never written, and rollback never releases them."""
    _, tp = params
    reqs = _shared_workload()
    plain = ServeEngine(CFG, tp, device="cpu", max_len=MAX_LEN, paged=True,
                        block_size=4, prefix_cache=True, kv_dtype=kv)
    base_sched, base = _run(plain, reqs)
    sched, results = _run(_spec(CFG, tp, draft_depth=2, prefix_cache=True,
                                kv_dtype=kv), reqs)
    _assert_same_streams(results, base)
    assert [r.prefix_tokens for r in results] == \
        [r.prefix_tokens for r in base]
    assert sched.prefix_hits >= 1 and sched.spec_rounds > 0
    sched.last_state.radix.check_invariants()


def test_spec_refusals(params):
    _, tp = params
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(CFG, tp, device="cpu", max_len=MAX_LEN,
                    spec_decode=True, draft_depth=2)
    with pytest.raises(ValueError, match="draft_depth"):
        ServeEngine(CFG, tp, device="cpu", max_len=MAX_LEN, paged=True,
                    spec_decode=True)
    with pytest.raises(ValueError, match="gamma"):
        _spec(CFG, tp, gamma=0, draft_depth=2)
    with pytest.raises(ValueError, match="exceeds model depth"):
        _spec(CFG, tp, draft_depth=6)
    with pytest.raises(ValueError, match="gamma"):
        steps.make_verify_step(CFG, 0)


# ---------------------------------------------------------------------------
# The sampled accept rule, by distribution
# ---------------------------------------------------------------------------


def _fixed_logits_api(logits):
    """A model whose verify returns ``logits`` (B, C, V) whatever its
    input, so the accept rule alone is under test."""
    return registry.ModelApi(
        init=None, loss=None, apply=None, init_cache=None, decode_step=None,
        verify=lambda params, cfg, tokens, cache, *a: (logits, cache),
        spec_commit=lambda cache, index, acc: cache)


@pytest.mark.parametrize("case", ["reject", "accept"])
def test_sampled_accept_rule_distribution(monkeypatch, case):
    """N_DRAWS rows over a vocabulary of 5, γ = 2, fixed p_t and p_d.
    'reject': the first emitted token follows p_t[0] (speculative
    sampling keeps the target's distribution whatever the draft proposed).
    'accept': p_d == p_t, so every proposal is accepted and the bonus
    follows p_t[γ].  Frequencies within ``FREQ_TOL``."""
    V, gamma, B = 5, 2, N_DRAWS
    g = torch.Generator().manual_seed(0)
    p_t = torch.tensor([[0.1, 0.4, 0.2, 0.2, 0.1],
                        [0.3, 0.1, 0.1, 0.4, 0.1],
                        [0.05, 0.15, 0.5, 0.1, 0.2]])
    p_d = p_t[:gamma].clone() if case == "accept" else torch.tensor(
        [[0.4, 0.1, 0.1, 0.2, 0.2], [0.2, 0.2, 0.2, 0.2, 0.2]])
    d = torch.stack([torch.multinomial(p_d[j], B, replacement=True,
                                       generator=g) for j in range(gamma)],
                    dim=1)
    tokens = torch.cat([torch.zeros((B, 1), dtype=torch.long), d], dim=1)
    logits = torch.log(p_t)[None].expand(B, gamma + 1, V)
    monkeypatch.setattr(registry, "get_model",
                        lambda cfg: _fixed_logits_api(logits))
    verify = steps.make_verify_step(CFG, gamma, sample=True)
    out, acc, *_ = verify(
        None, tokens, {}, torch.zeros(B, dtype=torch.long),
        torch.ones(B, dtype=torch.bool), torch.full((B,), 100), None, -1,
        p_d[None].expand(B, gamma, V), 1.0, g)
    if case == "accept":
        assert (acc == gamma + 1).all()
        col = out[:, gamma]
        want = p_t[gamma]
    else:
        col = out[:, 0]
        want = p_t[0]
    freq = torch.bincount(col, minlength=V).double() / B
    np.testing.assert_allclose(freq.numpy(), want.numpy(), atol=FREQ_TOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

CLI_ARGV = ["--smoke", "--device", "cpu", "--continuous", "--paged",
            "--max-batch", "2", "--requests", "6", "--block-size", "4",
            "--chunk-len", "4", "--rate", "1000", "--invariant-every", "1"]


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = serve.main(argv)
    return buf.getvalue(), results


def test_cli_spec_prints_the_speculative_line():
    text, results = _cli(CLI_ARGV + ["--spec-depth", "1", "--gamma", "3"])
    line = [ln for ln in text.splitlines() if ln.startswith("speculative:")]
    assert len(line) == 1
    assert "draft_layers=1 gamma=3 rounds=" in line[0]
    assert "acceptance=" in line[0] and "mean_accepted_len=" in line[0]
    assert len(results) == 6
    assert all(r.finish_reason == "limit" and r.spec_rounds >= 1
               for r in results)


def test_cli_draft_checkpoint_restores_at_its_depth(tmp_path):
    """A 1-layer checkpoint as the draft of the 2-layer smoke model: the
    draft runs at the manifest's depth; without --paged spec is refused."""
    cfg1 = configs.get_smoke_config("gpt2-12l").with_depth(1)
    p1 = registry.get_model(cfg1).init(torch.Generator().manual_seed(5),
                                       cfg1, device="cpu")
    ckpt.save(str(tmp_path), 2, {"params": p1}, metadata={"num_layers": 1})
    text, _ = _cli(CLI_ARGV + ["--draft-checkpoint", str(tmp_path)])
    assert "speculative: draft_layers=1 gamma=4 " in text
    with pytest.raises(SystemExit, match="require --paged"):
        serve.main(["--smoke", "--device", "cpu", "--continuous",
                    "--spec-depth", "1"])
