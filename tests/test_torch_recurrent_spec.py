"""Self-speculative decoding over recurrent layers in the port: the
verify's replay into a (C+1)-deep checkpoint ring and ``lm_spec_commit``'s
per-row select (``models/transformer.py``), the draft loop's (γ+2)-deep
ring and ``make_draft_rollback_step`` (``train/steps.py``), and the
engine's speculation rounds, on the CPU at smoke size.

Cross-framework: ``lm_verify``'s logits and the states ``lm_spec_commit``
keeps at accepted lengths 0, 1 and γ+1 against the JAX package's, on the
same params and inputs, for ``rwkv6-7b``'s and jamba's smoke configs and
a Mamba stack (``LOGIT_TOL``, ``STATE_TOL`` relative to max(1, max|state|)).

In-port, byte for byte, the contracts of ``tests/test_serving_spec.py``
and the spec case of ``tests/test_serving_prefix.py`` for the reference's
own Mamba and RWKV6 configs: the verify plus commit equals sequential
decode of the accepted tokens, and so does a draft rolled back to its
accepted length; spec streams equal solo generation with a
rejection-heavy draft; a ``copying_zeroL`` 2 -> 4 expansion's draft
accepts exactly every proposal; prefix hits with speculation equal cold
solo runs; and jamba serves with its zero-layer draft, each stream equal
to the non-speculative one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch import configs
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.core import expansion as exp
from repro_torch.models import registry
from repro_torch.models import transformer as tr
from repro_torch.train import steps
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_scheduler import ContinuousScheduler, Request

LOGIT_TOL = 1e-4          # after the stack (tests/test_torch_rwkv.py's)
STATE_TOL = 1e-4          # relative to max(1, max|state|)
MAX_LEN = 48
GAMMA = 3

_MAMBA = dict(name="t-mamba", family="ssm", num_layers=4, d_model=32,
              num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
              max_seq_len=64, attention="none", position="none",
              block_pattern=("mamba",))
PAIRS = {
    "rwkv": (configs.get_smoke_config("rwkv6-7b"),
             jax_configs.get_smoke_config("rwkv6-7b")),
    "mamba": (ModelConfig(**_MAMBA, ssm=SSMConfig(d_state=4)),
              JModelConfig(**_MAMBA, ssm=JSSMConfig(d_state=4))),
    "jamba": (configs.get_smoke_config("jamba-v0.1-52b"),
              jax_configs.get_smoke_config("jamba-v0.1-52b")),
}
# The reference's own configs (tests/test_serving_spec.py).
_REF = dict(family="ssm", num_layers=4, d_model=32, num_heads=4,
            num_kv_heads=4, d_ff=64, vocab_size=64, max_seq_len=64,
            attention="none", position="none")
REF_CFGS = {
    "mamba": ModelConfig(name="sp-mamba", block_pattern=("mamba",),
                         ssm=SSMConfig(d_state=4), **_REF),
    "rwkv": ModelConfig(name="sp-rwkv", norm="layernorm",
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


def _params(cfg, seed=0):
    return registry.get_model(cfg).init(torch.Generator().manual_seed(seed),
                                        cfg, device="cpu")


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


def _random_cache(cache, rng):
    """``cache`` (port tensors) with every leaf drawn at random, in place;
    returns its numpy copy for JAX."""
    out = {}
    for ln, lc in cache.items():
        out[ln] = {}
        for key, t in lc.items():
            t.copy_(torch.from_numpy(rng.normal(0, 0.5, tuple(t.shape))
                                     .astype(np.float32)))
            out[ln][key] = t.numpy().copy()
    return out


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.float().numpy() - want).max()) / scale
    assert err <= tol, f"{what}: {err:.2e} > {tol:.0e}"


def _verify_inputs(cfg, rng, B=3, nb=16):
    """Tokens, cursors, write mask and a block table of 5 pages of 4 a row
    (positions up to 16: every verify position inside the table)."""
    C = GAMMA + 1
    toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
    index = np.array([5, 9, 13][:B], np.int32)
    active = np.array([True] * B)
    limit = np.full((B,), 40, np.int32)
    pos = index[:, None] + np.arange(C)[None, :]
    wmask = active[:, None] & (pos < limit[:, None])
    table = rng.permutation(nb)[:B * 5].reshape(B, 5).astype(np.int32)
    return toks, index, wmask, table


@pytest.mark.parametrize("arch", list(PAIRS))
def test_verify_and_commit_match_jax(arch):
    """Three rows at different cursors: the verify's logits at every
    position, then the states committed at accepted lengths 0, 1 and γ+1
    (row by row) and the pool's pages, against JAX's ``lm_verify`` and
    ``lm_spec_commit``."""
    cfg, jcfg = PAIRS[arch]
    tp = _params(cfg, seed=2)
    jp = bridge.params_to_numpy(tp)
    rng = np.random.default_rng(7)
    nb = 16
    cache = tr.lm_init_paged_cache(tp, cfg, 3, nb, 4, MAX_LEN, torch.float32,
                                   device="cpu")
    jcache = _random_cache(cache, rng)
    toks, index, wmask, table = _verify_inputs(cfg, rng, nb=nb)
    acc = np.array([0, 1, GAMMA + 1], np.int32)
    jl, jc = jtr.lm_verify(jp, jcfg, jnp.asarray(toks), jcache,
                           jnp.asarray(index), jnp.asarray(table),
                           jnp.asarray(wmask))
    jc = jtr.lm_spec_commit(jc, jnp.asarray(index), jnp.asarray(acc))
    with torch.inference_mode():
        tl, out = tr.lm_verify(tp, cfg, torch.from_numpy(toks).long(), cache,
                               torch.from_numpy(index).long(),
                               torch.from_numpy(table),
                               torch.from_numpy(wmask))
        out = tr.lm_spec_commit(out, torch.from_numpy(index).long(),
                                torch.from_numpy(acc).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    for ln, lc in jc.items():
        assert set(out[ln]) == set(lc), ln          # no ring left behind
        for key, w in lc.items():
            _close(out[ln][key], w, STATE_TOL, f"{ln}/{key}")
            assert out[ln][key] is cache[ln][key]   # written in place


def _sequential(cfg, params, start, toks, index):
    """Plain decode steps of ``toks`` (B, n) over the whole batch from the
    numpy cache ``start``: [(logits (B,1,V), state copy)] after each step,
    the start state first (logits None)."""
    cache = {ln: {k: torch.from_numpy(v.copy()) for k, v in lc.items()}
             for ln, lc in start.items()}
    out = [(None, start)]
    with torch.inference_mode():
        for t in range(toks.shape[1]):
            lg, cache = tr.lm_decode_step(
                params, cfg, torch.from_numpy(toks[:, t:t + 1]).long(),
                cache, torch.from_numpy(index + t).long())
            out.append((lg, {ln: {k: v.numpy().copy() for k, v in lc.items()}
                             for ln, lc in cache.items()}))
    return out


def _assert_rows_at(cache, seq, acc):
    """Row b of ``cache`` equals the sequential state after acc[b] steps."""
    for b, a in enumerate(acc):
        for ln, lc in seq[a][1].items():
            for key, v in lc.items():
                assert np.array_equal(cache[ln][key][:, b].numpy(),
                                      v[:, b]), (b, ln, key)


@pytest.mark.parametrize("arch", list(REF_CFGS))
def test_verify_commit_equals_sequential_decode(arch):
    """Per row, the verify's logits at positions 0..acc-1 and the state
    committed at ``acc`` equal plain decode steps of the same tokens from
    the same state, bit for bit (the replay is the decode math); ``acc ==
    0`` leaves the state as it was."""
    cfg = REF_CFGS[arch]
    params = _params(cfg)
    rng = np.random.default_rng(8)
    cache = tr.lm_init_paged_cache(params, cfg, 3, 16, 4, MAX_LEN,
                                   torch.float32, device="cpu")
    start = _random_cache(cache, rng)
    toks, index, wmask, table = _verify_inputs(cfg, rng)
    acc = [0, 2, GAMMA + 1]
    with torch.inference_mode():
        logits, out = tr.lm_verify(params, cfg, torch.from_numpy(toks).long(),
                                   cache, torch.from_numpy(index).long(),
                                   torch.from_numpy(table),
                                   torch.from_numpy(wmask))
        out = tr.lm_spec_commit(out, None, torch.tensor(acc))
    seq = _sequential(cfg, params, start, toks, index)
    for t in range(GAMMA + 1):
        assert torch.equal(logits[:, t], seq[t + 1][0][:, 0]), t
    _assert_rows_at(out, seq, acc)


@pytest.mark.parametrize("arch", list(REF_CFGS))
def test_draft_rolled_back_equals_sequential_decode(arch):
    """γ+1 draft steps over four rows (row 0 inactive), then the rollback
    to accepted lengths 0, 1, 2 and γ+1: each row's state equals plain
    decode of exactly its accepted tokens from the pre-round state."""
    cfg = REF_CFGS[arch].with_depth(2)
    params = _params(cfg, seed=3)
    rng = np.random.default_rng(9)
    B = 4
    cache = tr.lm_init_cache(params, cfg, B, MAX_LEN, torch.float32,
                             device="cpu")
    start = _random_cache(cache, rng)
    rec = tuple(cache)
    draft = steps.make_draft_loop_step(cfg, GAMMA, rec_layers=rec)
    rollback = steps.make_draft_rollback_step(cfg, GAMMA, rec_layers=rec)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))).long()
    index = np.array([4, 6, 8, 10])
    active = torch.tensor([False, True, True, True])
    vt, cache, ring = draft(params, tok, cache, torch.from_numpy(index),
                            active, None)
    assert all(leaf.shape[0] == GAMMA + 2
               for lc in ring.values() for leaf in lc.values())
    acc = [0, 1, 2, GAMMA + 1]
    cache = rollback(cache, ring, torch.from_numpy(index), torch.tensor(acc))
    _assert_rows_at(cache, _sequential(cfg, params, start, vt.numpy(), index),
                    acc)


@pytest.mark.parametrize("arch", list(REF_CFGS))
def test_spec_streams_equal_solo(arch):
    """A random 4-layer model drafted by its first 2 layers (rejections
    every round): every stream equals solo generation."""
    cfg = REF_CFGS[arch]
    params = _params(cfg)
    eng = ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN, paged=True,
                      block_size=4, spec_decode=True, gamma=GAMMA,
                      draft_depth=2)
    reqs = _requests(cfg)
    sched = ContinuousScheduler(eng, max_batch=2, chunk_len=4,
                                invariant_every=1)
    results = sched.run(reqs)
    _assert_solo_parity(cfg, params, reqs, results)
    stats = sched.spec_stats()
    assert stats["spec_rounds"] > 0
    assert 0 <= stats["spec_accepted"] < stats["spec_proposed"]


@pytest.mark.parametrize("arch", list(REF_CFGS))
def test_zerol_draft_accepts_everything(arch):
    """The paper's free draft: a ``copying_zeroL`` 2 -> 4 expansion served
    with its depth-2 truncation accepts exactly every proposal, and its
    streams equal the 2-layer source's solo generation."""
    cfg2, cfg4 = REF_CFGS[arch].with_depth(2), REF_CFGS[arch].with_depth(4)
    p2 = _params(cfg2, seed=1)
    p4 = exp.expand_params(p2, cfg2, 4, "copying_zeroL")
    reqs = _requests(cfg2)[:4]
    eng = ServeEngine(cfg4, p4, device="cpu", max_len=MAX_LEN, paged=True,
                      block_size=4, spec_decode=True, gamma=GAMMA,
                      draft_depth=2)
    sched = ContinuousScheduler(eng, max_batch=2, chunk_len=4)
    results = sched.run(reqs)
    _assert_solo_parity(cfg2, p2, reqs, results)
    assert sched.acceptance_rate == 1.0


@pytest.mark.parametrize("arch", list(REF_CFGS))
def test_prefix_cache_with_spec_equals_solo(arch):
    """tests/test_serving_prefix.py's shared-prefix workload on a
    prefix-cached speculative engine: hits restore the carry snapshot and
    rollback never reaches below P; streams equal cold solo."""
    cfg = REF_CFGS[arch]
    params = _params(cfg)
    rng = np.random.default_rng(0)
    S = rng.integers(0, cfg.vocab_size, (12,)).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32)
             for t in (3, 5, 2)]
    div = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)
    reqs = [Request(prompt=p, max_new_tokens=6) for p in (
        np.concatenate([S, tails[0]]), np.concatenate([S, tails[1]]),
        np.concatenate([S, tails[2]]), S.copy(),
        np.concatenate([S, tails[0]]), np.concatenate([S[:4], div]))]
    eng = ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN, paged=True,
                      block_size=4, prefix_cache=True, spec_decode=True,
                      gamma=GAMMA, draft_depth=2)
    sched = ContinuousScheduler(eng, max_batch=2, chunk_len=4,
                                invariant_every=1)
    results = sched.run(reqs)
    _assert_solo_parity(cfg, params, reqs, results)
    assert sched.prefix_hits >= 2
    assert sched.spec_stats()["spec_rounds"] > 0


def test_jamba_zero_layer_draft():
    """jamba's period is 8, so at its smoke depth the only truncated draft
    is the zero-layer one: the rounds drive the target's verify ring over
    its seven Mamba layers and the paged verify of its attention layer.
    One slot, so the MoE layers see the rows the plain engine's do in
    decode; each stream equals the non-speculative paged engine's."""
    cfg = configs.get_smoke_config("jamba-v0.1-52b")
    params = _params(cfg)
    reqs = _requests(cfg, shapes=((5, 6), (9, 5)))
    out = []
    for kw in (dict(), dict(spec_decode=True, gamma=GAMMA, draft_depth=0)):
        eng = ServeEngine(cfg, params, device="cpu", max_len=MAX_LEN,
                          paged=True, block_size=4, **kw)
        sched = ContinuousScheduler(eng, max_batch=1, chunk_len=4)
        out.append(sched.run(reqs))
    assert sched.spec_rounds > 0
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.tokens, b.tokens)
