"""Recurrent carries in the port's continuous serving (``rwkv6-7b``, Mamba
stacks and jamba's hybrid) against the JAX package's, on the CPU at smoke
size.

Cross-framework, on the same params (the JAX init carried over by
``repro_torch.bridge``) and the same numpy inputs: ``lm_prefill_chunk``'s
logits, B=1 carry and pool pages over chunks under and over 64 tokens
(where both packages switch from the per-step to the chunked WKV and scan
forms); the masked paged decode step with an inactive row; and the
continuous scheduler's greedy streams, contiguous and paged, equal to the
JAX scheduler's.  Tolerances: ``LOGIT_TOL`` for logits after the stack,
``STATE_TOL`` relative to max(1, max|state|) for states (float32 sums in
other orders; the chunked forms over 64 tokens sum in yet another).

In-port, byte for byte, the contracts of ``tests/test_serving_paged.py``,
``tests/test_serving_continuous.py`` and ``tests/test_serving_prefix.py``
for the reference's own Mamba and RWKV6 configs: paged and chunked equal
contiguous solo generation; a readmitted slot equals a fresh one,
contiguous and paged; an int8 pool changes no bit (there is no paged
layer to quantize); prefix hits clamp to the publisher's carry snapshot
below P and equal cold runs, also a hit served while its publisher
decodes on; ``kv_stats`` of a pool with no paged layer; the CLI's
recurrent modes.
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
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.launch import mesh as mesh_lib
from repro.models import transformer as jtr
from repro.train import serve_engine as jax_engine
from repro.train import serve_scheduler as jax_sched
from repro.train import steps as jax_steps
from repro_torch import bridge
from repro_torch import configs
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.models import transformer as tr
from repro_torch.train import steps
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_scheduler import ContinuousScheduler, Request

LOGIT_TOL = 1e-4          # after the stack (tests/test_torch_rwkv.py's)
STATE_TOL = 1e-4          # relative to max(1, max|state|)
MAX_LEN = 48

# A Mamba stack beside the two smoke configs (tests/test_torch_jamba.py's).
_MAMBA = dict(name="t-mamba", family="ssm", num_layers=4, d_model=32,
              num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
              max_seq_len=160, attention="none", position="none",
              block_pattern=("mamba",))
PAIRS = {
    "rwkv": (configs.get_smoke_config("rwkv6-7b"),
             jax_configs.get_smoke_config("rwkv6-7b")),
    "mamba": (ModelConfig(**_MAMBA, ssm=SSMConfig(d_state=4)),
              JModelConfig(**_MAMBA, ssm=JSSMConfig(d_state=4))),
    "jamba": (configs.get_smoke_config("jamba-v0.1-52b"),
              jax_configs.get_smoke_config("jamba-v0.1-52b")),
}

# The reference's own configs (tests/test_serving_paged.py).
_REF = dict(family="ssm", num_layers=4, d_model=32, num_heads=4,
            num_kv_heads=4, d_ff=64, vocab_size=64, max_seq_len=64,
            attention="none", position="none")
REF_CFGS = {
    "mamba": ModelConfig(name="pg-mamba", block_pattern=("mamba",),
                         ssm=SSMConfig(d_state=4), **_REF),
    "rwkv": ModelConfig(name="pg-rwkv", norm="layernorm",
                        block_pattern=("rwkv",),
                        ssm=SSMConfig(kind="rwkv6", head_dim=16), **_REF),
}
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
def pair_params():
    """arch -> (JAX params, port params): the port's init, handed to JAX
    as numpy through ``repro_torch.bridge`` (bit for bit)."""
    out = {}
    for arch, (cfg, _) in PAIRS.items():
        tp = _port_params(cfg, seed=1)
        out[arch] = (bridge.params_to_numpy(tp), tp)
    return out


def _port_params(cfg, seed=0):
    return registry.get_model(cfg).init(torch.Generator().manual_seed(seed),
                                        cfg, device="cpu")


def _to_port(tree):
    """A JAX (or numpy) tree as torch tensors, the same nesting."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close_tree(got, want, tol, what):
    for key, w in want.items():
        if isinstance(w, dict):
            _close_tree(got[key], w, tol, f"{what}/{key}")
            continue
        w = np.asarray(w, np.float32)
        g = got[key].float().numpy()
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, f"{what}/{key}: {err:.2e} > {tol:.0e}"


def _random_states(jcache, rng):
    """The JAX cache tree with every per-row state leaf random (pool pages
    random too); scale leaves stay as they are."""
    out = {}
    for ln, lc in jcache.items():
        out[ln] = {k: (jnp.asarray(rng.normal(0, 0.5, v.shape)
                                   .astype(np.float32))
                       if not k.endswith("scales") else v)
                   for k, v in lc.items()}
    return out


# ---------------------------------------------------------------------------
# Cross-framework
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(PAIRS))
def test_prefill_chunk_matches_jax(pair_params, arch):
    """An 88-token prompt as chunks of 80 and 8 (over and under 64): each
    chunk's last logits, the carry after it and the pool pages."""
    cfg, jcfg = PAIRS[arch]
    jp, tp = pair_params[arch]
    bs, nb, P = 4, 24, 88
    jcache = jtr.lm_init_paged_cache(jp, jcfg, 1, nb, bs, P, jnp.float32)
    jcarry = jtr.lm_init_prefill_carry(jp, jcfg, P, jnp.float32)
    cache = tr.lm_init_paged_cache(tp, cfg, 1, nb, bs, P, torch.float32,
                                   device="cpu")
    carry = tr.lm_init_prefill_carry(tp, cfg, P, torch.float32, device="cpu")
    table = np.arange(nb, dtype=np.int32)[None, :]
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, P))
    ctx = 0
    for C in (80, 8):
        toks = prompt[:, ctx:ctx + C].astype(np.int32)
        jl, jcache, jcarry = jtr.lm_prefill_chunk(
            jp, jcfg, toks, jcache, jcarry, jnp.asarray(table), ctx)
        with torch.inference_mode():
            tl, cache, carry = tr.lm_prefill_chunk(
                tp, cfg, torch.from_numpy(toks).long(), cache, carry,
                torch.from_numpy(table), ctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        _close_tree(carry, jax.device_get(jcarry), STATE_TOL,
                    f"carry after {ctx + C}")
        ctx += C
    _close_tree(cache, jax.device_get(jcache), STATE_TOL, "pool")


@pytest.mark.parametrize("arch", list(PAIRS))
def test_masked_paged_decode_matches_jax(pair_params, arch):
    """One masked paged decode step over three rows at different cursors,
    row 1 inactive: logits of the active rows, every state, tokens,
    cursors and flags as JAX's; the inactive row's state bit for bit as
    it was (the reference's freeze select)."""
    cfg, jcfg = PAIRS[arch]
    jp, tp = pair_params[arch]
    rng = np.random.default_rng(5)
    B, bs, nb = 3, 4, 12
    jcache = _random_states(jax.device_get(jtr.lm_init_paged_cache(
        jp, jcfg, B, nb, bs, MAX_LEN, jnp.float32)), rng)
    cache = _to_port(jcache)
    before = _to_port(jax.device_get(jcache))
    table = rng.permutation(nb)[:B * 4].reshape(B, 4).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    index = np.array([5, 9, 13], np.int32)
    active = np.array([True, False, True])
    limit = np.array([20, 20, 20], np.int32)
    jstep = jax_steps.make_serve_decode_step(jcfg, masked=True, paged=True)
    jn, jl, jc, ji, ja, _ = jstep(jp, toks, jcache, index, active, limit,
                                  table, -1, jax.random.PRNGKey(0))
    step = steps.make_serve_decode_step(cfg, masked=True, paged=True)
    tn, tl, cache, ti, ta = step(
        tp, torch.from_numpy(toks).long(), cache,
        torch.from_numpy(index).long(), torch.from_numpy(active),
        torch.from_numpy(limit).long(), -1, None, None,
        torch.from_numpy(table))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _close_tree(cache, jax.device_get(jc), STATE_TOL, "cache")
    for ln, lc in cache.items():
        if cfg.layer_kind(int(ln[5:])) != "attn":
            for key, t in lc.items():
                assert torch.equal(t[:, 1], before[ln][key][:, 1]), (ln, key)


@pytest.mark.parametrize("arch", list(PAIRS))
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_streams_match_jax_scheduler(pair_params, arch, paged):
    """Per request, the port's greedy stream equals the JAX scheduler's
    (two slots, so slots are reused; chunks of at most 4)."""
    cfg, jcfg = PAIRS[arch]
    jp, tp = pair_params[arch]
    rng = np.random.default_rng(1)
    # Two prompt lengths: the JAX engine compiles a prefill per length.
    shapes = (((5, 6), (9, 4), (5, 3)) if arch == "jamba"
              else ((5, 7), (9, 4), (5, 6), (9, 3)))
    prompts = [(rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32), g)
               for p, g in shapes]
    jeng = jax_engine.ServeEngine(jcfg, jp,
                                  mesh=mesh_lib.single_device_mesh(),
                                  max_len=MAX_LEN, paged=paged, block_size=4)
    want = jax_sched.ContinuousScheduler(jeng, max_batch=2, chunk_len=4).run(
        [jax_sched.Request(prompt=p, max_new_tokens=g) for p, g in prompts])
    eng = ServeEngine(cfg, tp, device="cpu", max_len=MAX_LEN, paged=paged,
                      block_size=4)
    got = ContinuousScheduler(eng, max_batch=2, chunk_len=4).run(
        [Request(prompt=p, max_new_tokens=g) for p, g in prompts])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason == "limit"


# ---------------------------------------------------------------------------
# In-port, byte for byte
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("arch", list(REF_CFGS))
def test_paged_and_chunked_equal_contiguous_solo(arch):
    """A tight pool (8 pages of 4 tokens), chunks of 4, two slots, and the
    contiguous continuous engine: every stream equals solo generation."""
    cfg = REF_CFGS[arch]
    params = _port_params(cfg)
    reqs = _requests(cfg)
    for paged in (False, True):
        eng = ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN,
                          paged=paged, block_size=4)
        sched = ContinuousScheduler(eng, max_batch=2, chunk_len=4,
                                    num_blocks=8 if paged else None,
                                    invariant_every=1 if paged else 0)
        _assert_solo_parity(cfg, params, reqs, sched.run(reqs))


@pytest.mark.parametrize("arch", list(REF_CFGS))
def test_int8_pool_leaves_recurrent_streams_byte_identical(arch):
    """No paged attention layer, so nothing is quantized: the int8 engine's
    streams equal the f32 engine's byte for byte, and its pool prices 0
    bytes a token."""
    cfg = REF_CFGS[arch]
    params = _port_params(cfg)
    reqs = _requests(cfg)
    out = []
    for kv_dtype in (None, "int8"):
        eng = ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN,
                          paged=True, block_size=4, kv_dtype=kv_dtype)
        out.append(ContinuousScheduler(eng, max_batch=2, chunk_len=4,
                                       num_blocks=8).run(reqs))
        assert eng.kv_bytes_per_token() == 0.0
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("arch", list(REF_CFGS))
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_readmitted_slot_is_byte_identical_to_fresh(arch, paged):
    """Serve a request in slot 0 until it stops, admit a second one into
    the same slot: every recurrent state row (conv/ssm, tm_x/cm_x/wkv)
    equals admitting it into a fresh engine's slot 0, so nothing of the
    first tenant survives."""
    cfg = REF_CFGS[arch]
    eng = ServeEngine(cfg, _port_params(cfg), device="cpu", max_len=MAX_LEN,
                      paged=paged, block_size=4)
    rng = np.random.default_rng(11)
    first = rng.integers(0, cfg.vocab_size, (6,)).astype(np.int32)
    second = rng.integers(0, cfg.vocab_size, (5,)).astype(np.int32)

    def admit(state, prompt, budget):
        if not paged:
            state, tok, rc = eng.prefill_request(state, prompt)
            return eng.admit_request(state, 0, tok, rc, len(prompt), budget)
        state, job = eng.begin_prefill(state, 0, prompt, budget)
        while not job.done:
            state, tok = eng.prefill_chunk(state, job)
        return eng.admit_paged(state, job, tok)

    used = admit(eng.continuous_state(1), first, 2)
    for _ in range(3):
        used = eng.decode_masked(used)             # stops after one step
    assert not bool(used.active[0])
    if paged:
        used = eng.free_slot(used, 0)
    used = eng.decode_masked(admit(used, second, 6))
    fresh = eng.decode_masked(admit(eng.continuous_state(1), second, 6))
    for name in ("tokens", "index", "active", "limit"):
        assert torch.equal(getattr(used, name), getattr(fresh, name)), name
    for ln, leaves in used.cache.items():
        for key, t in leaves.items():
            assert torch.equal(t, fresh.cache[ln][key]), (ln, key)


def _shared_workload(cfg, seed=0, gen=6):
    """tests/test_serving_prefix.py's six requests over one 12-token shared
    prefix S: three tails, S itself, a full repeat, a divergence."""
    rng = np.random.default_rng(seed)
    S = rng.integers(0, cfg.vocab_size, (12,)).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32)
             for t in (3, 5, 2)]
    div = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)
    prompts = [np.concatenate([S, tails[0]]), np.concatenate([S, tails[1]]),
               np.concatenate([S, tails[2]]), S.copy(),
               np.concatenate([S, tails[0]]), np.concatenate([S[:4], div])]
    return [Request(prompt=p, max_new_tokens=gen) for p in prompts]


@pytest.mark.parametrize("arch", list(REF_CFGS))
def test_prefix_hits_clamp_to_the_snapshot_and_equal_cold(arch):
    """One slot (deterministic hits): matches clamp to the publisher's
    carry snapshot at the last page boundary below P (12 tokens) and miss
    where none fits (S itself, the divergence); every stream equals cold
    solo generation."""
    cfg = REF_CFGS[arch]
    params = _port_params(cfg)
    eng = ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN,
                      paged=True, block_size=4, prefix_cache=True)
    reqs = _shared_workload(cfg)
    sched = ContinuousScheduler(eng, max_batch=1, chunk_len=4,
                                invariant_every=1)
    results = sched.run(reqs)
    _assert_solo_parity(cfg, params, reqs, results)
    assert [r.prefix_tokens for r in results] == [0, 12, 12, 0, 12, 0]
    stats = sched.prefix_stats()
    assert stats["prefix_hits"] == 3 and stats["prefix_skipped_tokens"] == 36


@pytest.mark.parametrize("arch", list(REF_CFGS))
def test_prefix_hit_while_its_publisher_decodes_on(arch):
    """The aliasing guard: the publisher keeps decoding in slot 0 while a
    repeat of its prompt is admitted as a hit into slot 1 and served; the
    hit's stream equals cold solo generation, the tree's snapshot is the
    same bits after every prefill and decode step that followed its
    publication, and a second hit from it equals the first."""
    cfg = REF_CFGS[arch]
    params = _port_params(cfg)
    eng = ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN,
                      paged=True, block_size=4, prefix_cache=True)
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (14,)).astype(np.int32)
    state = eng.continuous_state(2)
    state, job = eng.begin_prefill(state, 0, prompt, 20, chunk_len=4)
    while not job.done:
        state, tok = eng.prefill_chunk(state, job)
    assert job.snap_at == 12 and job.ctx == 14
    state = eng.admit_paged(state, job, tok)
    snap = {ln: {k: t.clone() for k, t in lc.items()}
            for ln, lc in job.snapshot.items()}
    streams = []
    for row in (1, 1):
        for _ in range(3):                      # the publisher decodes on
            state = eng.decode_masked(state)
        match = eng.prefix_match(state, prompt)
        assert match is not None and match.skip == 12
        state, hit = eng.begin_prefill(state, row, prompt, 5, chunk_len=4,
                                       match=match)
        while not hit.done:
            state, tok = eng.prefill_chunk(state, hit)
            state = eng.decode_masked(state)
        state = eng.admit_paged(state, hit, tok)
        out = [int(tok[0, 0])]
        for _ in range(4):
            state = eng.decode_masked(state)
            out.append(int(state.tokens[row, 0]))
        streams.append(out)
        state = eng.free_slot(state, row)
        for ln, lc in match.carry.items():
            for key, t in lc.items():
                assert torch.equal(t, snap[ln][key]), (ln, key)
    want = ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN).generate(
        prompt[None, :], 5).tokens[0, len(prompt):]
    assert streams[0] == streams[1] == want.tolist()


def test_kv_stats_of_a_pool_without_paged_layers():
    """``rwkv6-7b``'s pool holds no paged layer: 0 bytes a token in every
    dtype and a ratio of 1.0, where the reference divides 0 by 0
    (``repro/train/serve_scheduler.py``, ``kv_bytes_ratio``)."""
    cfg, jcfg = PAIRS["rwkv"]
    for dtype in ("f32", "int8"):
        eng = ServeEngine(cfg, _port_params(cfg), device="cpu",
                          max_len=MAX_LEN, paged=True, block_size=4,
                          kv_dtype=dtype)
        ks = ContinuousScheduler(eng).kv_stats()
        assert ks["kv_bytes_per_token"] == ks["kv_bytes_per_token_f32"] == 0
        assert ks["kv_bytes_ratio"] == 1.0
    jp = bridge.params_to_numpy(_port_params(cfg))
    jeng = jax_engine.ServeEngine(jcfg, jp, mesh=mesh_lib.single_device_mesh(),
                                  max_len=MAX_LEN, paged=True, block_size=4)
    with pytest.raises(ZeroDivisionError):
        jax_sched.ContinuousScheduler(jeng).kv_stats()


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = serve.main(argv)
    return buf.getvalue(), results


CLI = ["--smoke", "--device", "cpu", "--continuous", "--max-batch", "2",
       "--requests", "4", "--block-size", "4", "--chunk-len", "4",
       "--rate", "1000", "--prompt-len", "8", "--gen", "4"]


@pytest.mark.parametrize("arch,extra,lines", [
    ("rwkv6-7b", ["--paged"], ["kv storage: dtype=float32 bytes/token=0.0 "
                               "(f32: 0.0, ratio=1.000)"]),
    ("rwkv6-7b", ["--paged", "--prefix-cache"], ["prefix cache: hits="]),
    ("rwkv6-7b", ["--paged", "--kv-dtype", "int8"],
     ["kv storage: dtype=int8 bytes/token=0.0"]),
    ("rwkv6-7b", ["--paged", "--spec-depth", "1"],
     ["speculative: draft_layers=1 gamma=4"]),
    ("jamba-v0.1-52b", [], ["aggregate tokens/s="]),
    ("jamba-v0.1-52b", ["--paged"], ["kv storage: dtype=float32"])])
def test_cli_serves_recurrent_models_in_every_mode(arch, extra, lines):
    text, results = _cli(CLI + ["--arch", arch] + extra)
    assert len(results) == 4
    assert all(r.finish_reason == "limit" for r in results)
    for line in lines + ["aggregate tokens/s="]:
        assert line in text, (line, text)
