"""The port's continuous batching and paged serving against the JAX
package's, on the CPU at smoke size (``gpt2-12l`` smoke: 2 layers,
d_model 64, 4 heads of 16, vocab 256), with the JAX init carried over by
``repro_torch.bridge``.

Cross-framework: every request's greedy stream from the port's scheduler
equals the JAX scheduler's (contiguous and paged; block size 4, chunk 4,
two slots so that slots are reused).  In-port, byte for byte, as the
reference's own tests hold the reference: paged equals continuous equals
solo ``ServeEngine.generate``, with overlap on and off; EOS frees a slot
that is then readmitted; a readmitted slot equals a fresh one; and the pool
keeps its invariants under Poisson arrivals with EOS.  The serving prefill
normalises and projects its last position only, and its logits match the
JAX prefill step to 1e-5.  On RoPE configs: the byte contracts above on
``llama3-0.3b``'s smoke config with GQA and qk-norm, and
``mixtral-0.3b``'s greedy streams equal to the JAX scheduler's (MoE has no
solo contract: capacity drops depend on the rows sharing a step).
"""
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import mesh as mesh_lib
from repro.models import transformer as jtr
from repro.train import serve_engine as jax_engine
from repro.train import serve_scheduler as jax_sched
from repro.train import steps as jax_steps
from repro_torch import bridge
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import transformer as tr
from repro_torch.train import serve_engine as engine_lib
from repro_torch.train import steps
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_scheduler import (ContinuousScheduler, Request,
                                               summarize)

CFG = configs.get_smoke_config("gpt2-12l")
JCFG = jax_configs.get_smoke_config("gpt2-12l")
LOGIT_TOL = 1e-5
MAX_LEN = 48
# (prompt, budget) of 8 ragged requests (the reference tests' shapes).
REQ_SHAPES = ((5, 7), (9, 4), (3, 10), (6, 2), (4, 8), (7, 5), (2, 6),
              (8, 3))


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
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(3), JCFG))
    return jp, bridge.params_from_jax(jp)


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab_size, (p,)).astype(np.int32), g)
            for p, g in REQ_SHAPES]


def _engine(tp, paged, **kw):
    return ServeEngine(CFG, tp, device="cpu", max_len=MAX_LEN, paged=paged,
                       block_size=4, **kw)


def _run(eng, prompts, **kw):
    reqs = [Request(prompt=p, max_new_tokens=g) for p, g in prompts]
    return ContinuousScheduler(eng, max_batch=2, chunk_len=4, **kw).run(reqs)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_streams_match_jax_scheduler(params, paged):
    """Per request, the port's greedy stream (overlap on and off) equals
    the JAX scheduler's on the same parameters."""
    jp, tp = params
    prompts = _prompts(1)
    jeng = jax_engine.ServeEngine(JCFG, jp, mesh=mesh_lib.single_device_mesh(),
                                  max_len=MAX_LEN, paged=paged, block_size=4)
    want = jax_sched.ContinuousScheduler(jeng, max_batch=2, chunk_len=4).run(
        [jax_sched.Request(prompt=p, max_new_tokens=g) for p, g in prompts])
    for overlap in (True, False):
        got = _run(_engine(tp, paged), prompts, overlap=overlap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.tokens, w.tokens)
            assert g.finish_reason == w.finish_reason == "limit"


def test_paged_equals_continuous_equals_solo(params):
    """In-port byte parity: a tight pool (8 pages of 4 tokens, so admission
    waits on free-on-EOS), chunked prefill, slot reuse, overlap on and off,
    against the contiguous scheduler and solo generation."""
    _, tp = params
    prompts = _prompts(0)
    solo = _engine(tp, False)
    want = [solo.generate(p[None, :], g).tokens[0] for p, g in prompts]
    runs = [_run(_engine(tp, False), prompts),
            _run(_engine(tp, True), prompts, num_blocks=8),
            _run(_engine(tp, True), prompts, num_blocks=8, overlap=False)]
    for results in runs:
        for res, w, (_, g) in zip(results, want, prompts):
            np.testing.assert_array_equal(res.tokens, w)
            assert len(res.new_tokens) == g and res.finish_reason == "limit"


# RoPE serving: llama3-0.3b's smoke config with GQA 4/2 (qk-norm on), and
# mixtral-0.3b's (8 experts top-2 at smoke width), the JAX init carried over.
ROPE_CFG = dataclasses.replace(configs.get_smoke_config("llama3-0.3b"),
                               num_kv_heads=2, qk_norm=True)
JROPE_CFG = dataclasses.replace(jax_configs.get_smoke_config("llama3-0.3b"),
                                num_kv_heads=2, qk_norm=True)


def _jax_params(jcfg, seed):
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(seed), jcfg))
    return jp, bridge.params_from_jax(jp)


def test_rope_paged_equals_continuous_equals_solo():
    """The in-port byte contracts on a RoPE config: paged (chunked prefill
    through a tight pool, overlap on and off) equals the contiguous
    scheduler equals solo generation (one whole prefill)."""
    _, tp = _jax_params(JROPE_CFG, 4)
    prompts = _prompts(2)
    solo = ServeEngine(ROPE_CFG, tp, device="cpu", max_len=MAX_LEN)
    want = [solo.generate(p[None, :], g).tokens[0] for p, g in prompts]

    def eng(paged):
        return ServeEngine(ROPE_CFG, tp, device="cpu", max_len=MAX_LEN,
                           paged=paged, block_size=4)
    runs = [_run(eng(False), prompts),
            _run(eng(True), prompts, num_blocks=8),
            _run(eng(True), prompts, num_blocks=8, overlap=False)]
    for results in runs:
        for res, w in zip(results, want):
            np.testing.assert_array_equal(res.tokens, w)


def test_mixtral_streams_match_jax_scheduler():
    """MoE under continuous paged serving: which tokens a step drops at
    capacity depends on the rows that share the step, so the reference
    holds no solo contract for MoE; the port's greedy streams are held to
    the JAX scheduler's on the same params and requests instead."""
    cfg = configs.get_smoke_config("mixtral-0.3b")
    jcfg = jax_configs.get_smoke_config("mixtral-0.3b")
    jp, tp = _jax_params(jcfg, 6)
    prompts = _prompts(3)
    jeng = jax_engine.ServeEngine(jcfg, jp, mesh=mesh_lib.single_device_mesh(),
                                  max_len=MAX_LEN, paged=True, block_size=4)
    want = jax_sched.ContinuousScheduler(jeng, max_batch=2, chunk_len=4).run(
        [jax_sched.Request(prompt=p, max_new_tokens=g) for p, g in prompts])
    got = _run(ServeEngine(cfg, tp, device="cpu", max_len=MAX_LEN,
                           paged=True, block_size=4), prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_eos_frees_slot_and_readmits(params, paged):
    """A row that samples EOS stops (reason 'eos', stream cut at the stop
    token); its freed slot serves the next request to its own end."""
    _, tp = params
    eng = _engine(tp, paged)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, CFG.vocab_size, (6,)).astype(np.int32)
    solo = eng.generate(prompt[None, :], 12).tokens[0, 6:]
    eos = int(solo[4])
    cut = int(np.argmax(solo == eos)) + 1
    other = rng.integers(0, CFG.vocab_size, (4,)).astype(np.int32)
    solo2 = eng.generate(other[None, :], 5).tokens[0, 4:]
    cut2 = (int(np.argmax(solo2 == eos)) + 1) if eos in solo2 else 5
    sched = ContinuousScheduler(eng, max_batch=1, eos_id=eos,
                                num_blocks=5 if paged else None)
    results = sched.run([Request(prompt=prompt, max_new_tokens=12),
                         Request(prompt=other, max_new_tokens=5)])
    assert results[0].finish_reason == "eos"
    np.testing.assert_array_equal(results[0].new_tokens, solo[:cut])
    assert results[1].slot == results[0].slot == 0
    np.testing.assert_array_equal(results[1].new_tokens, solo2[:cut2])
    if paged:
        pool = sched.last_state.pool
        assert pool.free_blocks == pool.num_blocks
        pool.check_invariants()


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_readmitted_slot_is_byte_identical_to_fresh(params, paged):
    """Serve a request in slot 0 until it stops, then admit a second one
    into the same slot: the slot's state equals admitting that request
    into a fresh engine's slot 0.  Contiguous: the whole cache.  Paged: the
    cursor, limit, token and the row's live K/V read through its table."""
    _, tp = params
    rng = np.random.default_rng(11)
    first = rng.integers(0, CFG.vocab_size, (6,)).astype(np.int32)
    second = rng.integers(0, CFG.vocab_size, (5,)).astype(np.int32)

    def admit(eng, state, prompt, budget):
        if not paged:
            state, tok, rc = eng.prefill_request(state, prompt)
            return eng.admit_request(state, 0, tok, rc, len(prompt), budget)
        state, job = eng.begin_prefill(state, 0, prompt, budget)
        while not job.done:
            state, tok = eng.prefill_chunk(state, job)
        return eng.admit_paged(state, job, tok)

    eng = _engine(tp, paged)
    used = admit(eng, eng.continuous_state(1), first, 2)
    for _ in range(3):
        used = eng.decode_masked(used)             # stops after one step
    assert not bool(used.active[0])
    if paged:
        used = eng.free_slot(used, 0)
    used = eng.decode_masked(admit(eng, used, second, 6))
    fresh = eng.decode_masked(admit(eng, eng.continuous_state(1), second, 6))
    for name in ("tokens", "index", "active", "limit"):
        assert torch.equal(getattr(used, name), getattr(fresh, name)), name
    for lname, leaves in used.cache.items():
        for key, t in leaves.items():
            other = fresh.cache[lname][key]
            if paged:          # the row's live slots, through its table
                n = int(used.index[0])
                idx = torch.arange(n)
                t = t[:, used.block_table[0, idx // 4].long(), idx % 4]
                other = other[:, fresh.block_table[0, idx // 4].long(),
                              idx % 4]
            assert torch.equal(t, other), (lname, key)


def test_pool_fuzz_poisson_arrivals_eos_and_invariants(params):
    """Poisson arrivals on a virtual clock, an EOS id that cuts some
    streams, a tight pool and ``invariant_every=1``: every request ends
    with its solo stream cut at the first EOS, and the pool comes back
    whole."""
    _, tp = params
    rng = np.random.default_rng(5)
    clock = [0.0]

    def tick(dt):
        clock[0] += dt

    eng = _engine(tp, True)
    prompts = [(rng.integers(0, CFG.vocab_size,
                             (int(rng.integers(1, 12)),)).astype(np.int32),
                int(rng.integers(1, 10))) for _ in range(10)]
    arrivals = np.cumsum(rng.exponential(0.01, len(prompts)))
    solo = [eng.generate(p[None, :], g).tokens[0, len(p):]
            for p, g in prompts]
    eos = int(max(solo, key=len)[2])
    sched = ContinuousScheduler(
        eng, max_batch=3, eos_id=eos, chunk_len=4, num_blocks=9,
        invariant_every=1, time_fn=lambda: clock[0], sleep_fn=tick)
    results = sched.run([Request(prompt=p, max_new_tokens=g, arrival_s=a)
                         for (p, g), a in zip(prompts, arrivals)])
    for res, want in zip(results, solo):
        cut = int(np.argmax(want == eos)) + 1 if eos in want else len(want)
        np.testing.assert_array_equal(res.new_tokens, want[:cut])
        assert res.finish_reason == ("eos" if eos in want[:cut] else "limit")
    assert {r.finish_reason for r in results} == {"eos", "limit"}
    pool = sched.last_state.pool
    pool.check_invariants()
    assert pool.free_blocks == pool.num_blocks and pool.committed_blocks == 0
    stats = summarize(results, 1.0)
    assert stats["completed"] == len(prompts)


def test_bf16_pool_halves_bytes_per_token_and_serves(params):
    """``kv_dtype='bf16'`` stores the pool in bf16 under f32 activations:
    half the bytes per cached token, and requests still run to their
    budgets (greedy parity with f32 is not expected)."""
    _, tp = params
    eng = _engine(tp, True, kv_dtype="bf16")
    sched = ContinuousScheduler(eng, max_batch=2)
    stats = sched.kv_stats()
    assert stats["kv_dtype"] == "bfloat16" and stats["kv_bytes_ratio"] == 0.5
    results = sched.run([Request(prompt=p, max_new_tokens=g)
                         for p, g in _prompts(2)[:3]])
    for res, (_, g) in zip(results, _prompts(2)[:3]):
        assert len(res.new_tokens) == g
        assert 0 <= res.new_tokens.min() and res.new_tokens.max() < 256
    leaf = sched.last_state.cache["layer0"]["k_pages"]
    assert leaf.dtype == torch.bfloat16


def test_pow2_chunks_match_reference():
    for n in range(1, 70):
        for cap in (None, 1, 3, 4, 7, 16):
            assert engine_lib.pow2_chunks(n, cap) \
                == jax_engine.pow2_chunks(n, cap)
    with pytest.raises(ValueError):
        engine_lib.pow2_chunks(0)


def test_serving_prefill_head_sees_the_last_position_only(params,
                                                          monkeypatch):
    """The serving prefill step never builds (B, P, V) logits: its head
    sees a (B, 1, D) input.  Its last logits match the JAX prefill step."""
    jp, tp = params
    prompts = np.random.default_rng(4).integers(
        0, CFG.vocab_size, (2, 10)).astype(np.int32)
    seen = []
    head = tr._head

    def spy(p, cfg, x):
        seen.append(tuple(x.shape))
        return head(p, cfg, x)
    monkeypatch.setattr(tr, "_head", spy)
    cache = tr.lm_init_cache(tp, CFG, 2, 16, torch.float32, device="cpu")
    nxt, last, _, index = steps.make_prefill_step(CFG)(
        tp, torch.from_numpy(prompts).long(), cache, None, None)
    assert seen == [(2, 1, CFG.d_model)]
    assert last.shape == (2, 1, CFG.vocab_size)
    assert index.tolist() == [10, 10]
    jcache = jtr.lm_init_cache(jp, JCFG, 2, 16, dtype=np.float32)
    jnxt, jlast, _, _, _ = jax_steps.make_prefill_step(JCFG)(
        jp, prompts, jcache, jax.random.PRNGKey(0))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve.main(argv)
    return buf.getvalue(), out


def test_cli_continuous_paged_on_cpu():
    text, results = _cli(["--smoke", "--device", "cpu", "--continuous",
                          "--paged", "--max-batch", "2", "--requests", "4",
                          "--prompt-len", "12", "--gen", "6",
                          "--block-size", "4", "--rate", "1000",
                          "--invariant-every", "1"])
    assert "paged max_batch=2 requests=4" in text
    assert "aggregate tokens/s=" in text and "ttft p50=" in text
    assert "kv storage: dtype=float32 bytes/token=1024.0" in text
    assert len(results) == 4
    assert all(r.finish_reason == "limit" for r in results)


@pytest.mark.parametrize("flag,dtype,ratio", [
    (["--prefix-cache"], "float32", "1.000"),
    (["--kv-dtype", "int8"], "int8", "0.312"),
    (["--kv-dtype", "fp8"], "float8_e4m3fn", "0.312")])
def test_cli_prefix_cache_and_quantized_pages(flag, dtype, ratio):
    """The prefix cache and 1-byte pages through the CLI: every request runs
    to its budget, the ``kv storage`` line gives the pool's dtype and its
    bytes-per-token ratio to f32 ((16 + 4) / 64 for 1-byte pages at the
    smoke head dim 16), and the prefix cache reports its hits over the
    shared system prefix (half the 12-token prompt budget: 6 tokens, one
    full page and a half)."""
    text, results = _cli(["--smoke", "--device", "cpu", "--continuous",
                          "--paged", "--max-batch", "2", "--requests", "4",
                          "--prompt-len", "12", "--gen", "6",
                          "--block-size", "4", "--rate", "1000",
                          "--invariant-every", "1"] + flag)
    assert f"kv storage: dtype={dtype} " in text
    assert f"ratio={ratio})" in text
    assert len(results) == 4
    assert all(r.finish_reason == "limit" for r in results)
    if "--prefix-cache" in flag:
        assert "prefix cache: hits=" in text and "/4 " in text
        assert all(len(r.prompt) >= 6 for r in results)
        hits = [r.prefix_tokens for r in results]
        assert sum(hits) > 0 and set(hits) <= {0, 4}
    else:
        assert "prefix cache:" not in text


@pytest.mark.parametrize("flag,item", [
    # Speculative decoding (item 9) and recurrent carries (item 17) are
    # ported: spec on rwkv6-7b and jamba (whose period of 8 leaves it the
    # zero-layer draft) serves now.  The ids stay the cases' old ones.
    pytest.param(["--spec-depth", "1", "--arch", "rwkv6-7b"], None,
                 id="flag0-item 9"),
    pytest.param(["--spec-depth", "0", "--arch", "jamba-v0.1-52b"], None,
                 id="flag1-item 9"),
    # The request lifecycle (item 11) is ported too: each of its flags
    # serves to the end.
    pytest.param(["--deadline-s", "60"], None, id="flag2-item 11"),
    pytest.param(["--queue-limit", "2"], None, id="flag3-item 11"),
    pytest.param(["--faults", "storm:0.1"], None, id="flag4-item 11"),
    pytest.param(["--snapshot-every", "2"], None, id="flag5-item 11")])
def test_refused_continuous_flags_name_their_roadmap_item(flag, item):
    argv = ["--smoke", "--device", "cpu", "--continuous", "--paged"] + flag
    if item is None:
        text, results = _cli(argv + ["--max-batch", "2", "--requests", "3",
                                     "--prompt-len", "8", "--gen", "4",
                                     "--block-size", "4", "--rate", "1000"])
        if "--spec-depth" in flag:
            assert "speculative: draft_layers=" in text
            assert all(r.finish_reason == "limit" for r in results)
        elif "--faults" in flag:
            assert "lifecycle: " in text
        assert len(results) == 3
        assert all(r.finish_reason in ("limit", "failed", "shed")
                   for r in results)
        return
    with pytest.raises(SystemExit, match=item):
        serve.main(argv)
