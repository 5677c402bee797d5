"""MLA latent attention in the port (``deepseekv3-0.3b``) against the JAX
package's, on the CPU.

Cross-framework, on the JAX init carried over by ``repro_torch.bridge``
and the same numpy inputs: logits, loss and every gradient (``wkv_a`` and
``wkv_b`` among them) of the reference's serving config ``CFG_MLA`` (4
layers, rank 8; ``deepseekv3-0.3b``'s smoke config is among
``tests/test_torch_testbeds.py``'s architectures); the decode
steps' logits over the latent cache; ``paged_mla_attention_ref`` over f32
and int8 latent pages (the new latent selected at the cursor, keys
re-rotated at their slot positions); and the greedy streams of continuous
paged serving against the JAX ``ServeEngine``'s, f32 and int8 pools.

In-port, the reference's contracts (``tests/test_paper_testbeds.py``,
``tests/test_serving_paged.py``, ``tests/test_serving_prefix.py``,
``tests/test_serving_spec.py``): decode equals the forward and the cache
holds latents, not K/V; paged, prefix-hit and speculative streams equal
solo generation byte for byte (a ``copying_zeroL`` draft accepts
everything); int8 latent pages agree with f32 on at least 0.9 of the
tokens; the pool prices a token at r values (plus one scale a slot);
``mla_kv_lora_rank=0`` keeps the dense K/V path; a window ring is refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels.paged_attention import ref as jpaged
from repro.launch import mesh as mesh_lib
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro.train import serve_engine as jax_engine
from repro.train import serve_scheduler as jax_sched
from repro_torch import bridge
from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import expansion as exp
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.models import common, registry
from repro_torch.models import transformer as tr
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_scheduler import ContinuousScheduler, Request

# The reference's serving config (tests/test_serving_paged.py:49).
_MLA = dict(name="pg-mla", family="dense", num_layers=4, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
            max_seq_len=64, attention="mla", mla_kv_lora_rank=8)
CFG = ModelConfig(**_MLA)
JCFG = JModelConfig(**_MLA)
REQ_SHAPES = ((5, 7), (9, 4), (3, 10), (6, 2), (4, 8), (7, 5), (2, 6),
              (8, 3))
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-5            # absolute, plus 1e-4 relative
QUANT_AGREEMENT = 0.9


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


def _requests(seed=0, shapes=REQ_SHAPES):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, CFG.vocab_size,
                                        (p,)).astype(np.int32),
                    max_new_tokens=g) for p, g in shapes]


def _engine(tp, **kw):
    return ServeEngine(CFG, tp, device="cpu", max_len=48, paged=True,
                       block_size=4, **kw)


def _solo(cfg, tp, reqs, results):
    solo = ServeEngine(cfg, tp, device="cpu", max_len=48)
    for req, res in zip(reqs, results):
        want = solo.generate(req.prompt[None, :], req.max_new_tokens).tokens
        np.testing.assert_array_equal(res.tokens, want[0])
        assert len(res.new_tokens) == req.max_new_tokens


def _agreement(res_a, res_b):
    tot = hit = 0
    for a, b in zip(res_a, res_b):
        ta, tb = np.asarray(a.new_tokens), np.asarray(b.new_tokens)
        n = min(len(ta), len(tb))
        hit += int((ta[:n] == tb[:n]).sum())
        tot += max(len(ta), len(tb))
    return hit / max(tot, 1)


def test_logits_loss_and_grads_match_jax():
    """Logits and the loss of a (2, 20) batch, and every leaf's gradient
    (the latent projections among them) against ``jax.grad``, on
    ``CFG_MLA`` (``deepseekv3-0.3b``'s smoke config, with its MoE, is
    ``tests/test_torch_testbeds.py``'s case)."""
    jcfg, cfg = JCFG, CFG
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(7), jcfg))
    rng = np.random.default_rng(1)
    toks, labels = (rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
                    for _ in range(2))
    want, jaux = jax.jit(lambda p, t: jtr.lm_apply(p, jcfg, t))(jp, toks)
    flat = {k: v.clone().requires_grad_()
            for k, v in bridge.flatten(bridge.params_from_jax(jp)).items()}
    got, aux = tr.lm_apply(bridge.unflatten(flat), cfg,
                           torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5, atol=1e-9)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.lm_loss(p, jcfg, toks, labels), has_aux=True))(jp)
    loss, _ = registry.get_model(cfg).loss(
        bridge.unflatten(flat), cfg,
        {"tokens": torch.from_numpy(toks).long(),
         "labels": torch.from_numpy(labels).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jflat = bridge.flatten(jax.device_get(jgrads))
    assert jflat.keys() == flat.keys()
    assert any("wkv_a" in k for k in jflat)
    for key, g in jflat.items():
        np.testing.assert_allclose(flat[key].grad.numpy(), g, atol=GRAD_TOL,
                                   rtol=1e-4, err_msg=key)


def _reduced():
    """``tests/test_paper_testbeds.py``'s reduction of deepseekv3-0.3b (no
    capacity drops: decode and the forward route the same tokens)."""
    def reduce(cfg):
        moe = dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                  expert_ffn_dim=32, capacity_factor=100.0,
                                  num_shared_experts=1)
        return dataclasses.replace(
            cfg, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=64, vocab_size=128, max_seq_len=64, moe=moe,
            mla_kv_lora_rank=32)
    return (reduce(jax_configs.get_config("deepseekv3-0.3b")),
            reduce(configs.get_config("deepseekv3-0.3b")))


def test_decode_matches_forward_and_jax_and_the_cache_is_latent():
    """Eight decode steps over the contiguous latent cache: the forward's
    logits (the reference's bound 5e-3; here float32 sums in other
    orders), each step's logits against the JAX decode's, and the cache
    leaf (B, S, r) with r below the 2 KV hd a token K/V would take."""
    jcfg, cfg = _reduced()
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(0), jcfg))
    tp = bridge.params_from_jax(jp)
    toks = np.random.default_rng(1).integers(0, 128, (2, 8)).astype(np.int32)
    full, _ = tr.lm_apply(tp, cfg, torch.from_numpy(toks).long())
    cache = tr.lm_init_cache(tp, cfg, 2, 16, dtype=torch.float32,
                             device="cpu")
    jcache = jtr.lm_init_cache(jp, jcfg, 2, 16, dtype=jnp.float32)
    leaf = cache["layer0"]["latent"]
    assert set(cache["layer0"]) == {"latent"}
    assert leaf.shape == (2, 2, 16, cfg.mla_kv_lora_rank)
    assert cfg.mla_kv_lora_rank < 2 * cfg.num_kv_heads * cfg.head_dim
    outs = []
    for t in range(8):
        lg, cache = tr.lm_decode_step(tp, cfg, torch.from_numpy(
            toks[:, t:t + 1]).long(), cache, torch.full((2,), t))
        jlg, jcache = jtr.lm_decode_step(jp, jcfg, toks[:, t:t + 1], jcache,
                                         jnp.int32(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                   atol=LOGIT_TOL, rtol=0)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(leaf.numpy(), np.asarray(jcache["layer0"][
        "latent"]), atol=LOGIT_TOL, rtol=0)
    assert (torch.stack(outs, 1) - full).abs().max().item() < 5e-3


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_paged_mla_attention_ref_matches_jax(kv):
    """The latent pool's read against the reference's: pages permuted
    through a table, garbage past each cursor, the new latent selected at
    the cursor, keys rotated at slot positions, softcap 30; int8 pages
    dequantized with their per-slot scales."""
    rng = np.random.default_rng(3)
    B, C, H, KV, hd, r, bs, NB = 2, 3, 4, 2, 16, 8, 4, 5
    NP = B * NB + 1
    q = rng.standard_normal((B, C, H, hd), dtype=np.float32)
    lat = rng.standard_normal((NP, bs, r), dtype=np.float32)
    scales = None
    if kv == "int8":
        lat = rng.integers(-127, 128, (NP, bs, r)).astype(np.int8)
        scales = rng.uniform(0.01, 0.05, (NP, bs, 1)).astype(np.float32)
    table = rng.permutation(NP - 1)[:B * NB].reshape(B, NB).astype(np.int32)
    idx = np.array([6, 13], np.int32)
    new = rng.standard_normal((B, r), dtype=np.float32)
    wkv_b = rng.standard_normal((r, 2 * KV * hd), dtype=np.float32) / 3
    S = NB * bs
    valid = np.arange(S)[None, None, :] <= (idx[:, None] + np.arange(C))[
        :, :, None]
    want = jpaged.paged_mla_attention_ref(
        q, lat, table, valid, wkv_b, KV,
        rotate_fn=lambda k: jcommon.apply_rope(k, jnp.arange(S)[None, :],
                                               1e4),
        latent_new=new, index=idx, latent_scales=scales, logit_softcap=30.0)
    t = torch.from_numpy
    got = paged_ref.paged_mla_attention_ref(
        t(q), t(lat), t(table), t(valid), t(wkv_b), KV,
        rotate_fn=lambda k: common.apply_rope(
            k, torch.arange(S)[None, :], 1e4, 64),
        latent_new=t(new), index=t(idx),
        latent_scales=None if scales is None else t(scales),
        logit_softcap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_greedy_streams_match_jax_engine(params, kv):
    """Continuous paged serving (chunked prefill, paged decode over latent
    pages) against the JAX engine's on the same weights and requests:
    every f32 token equal; over int8 pages at least the int8 lane (both
    quantize bit-exactly; float sums in other orders can move a value
    across a rounding edge)."""
    jp, tp = params
    reqs = _requests(1)
    jeng = jax_engine.ServeEngine(JCFG, jp,
                                  mesh=mesh_lib.single_device_mesh(),
                                  max_len=48, paged=True, block_size=4,
                                  kv_dtype=kv)
    want = jax_sched.ContinuousScheduler(
        jeng, max_batch=2, chunk_len=4, num_blocks=8).run(
        [jax_sched.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
         for r in reqs])
    got = ContinuousScheduler(_engine(tp, kv_dtype=kv), max_batch=2,
                              chunk_len=4, num_blocks=8).run(reqs)
    if kv is None:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.tokens, b.tokens)
    else:
        assert _agreement(got, want) >= QUANT_AGREEMENT
    for a, b in zip(got, want):
        assert len(a.new_tokens) == len(b.new_tokens)


def test_paged_streams_equal_solo_generation(params):
    """The reference's paged contract on its MLA lane: a tight pool (8
    pages of 4), chunked prefill, two slots; every stream equals solo
    contiguous generation byte for byte, and the pool gets every page
    back."""
    _, tp = params
    reqs = _requests()
    sched = ContinuousScheduler(_engine(tp), max_batch=2, chunk_len=4,
                                num_blocks=8, invariant_every=1)
    _solo(CFG, tp, reqs, sched.run(reqs))


def test_prefix_hits_equal_solo_generation(params):
    """The reference's prefix workload (one 12-token shared prefix: three
    tails, the exact page-boundary prompt, a full repeat, a mid-prefix
    divergence) on one slot: MLA is carryless, so it hits at any page
    depth (12, 12, 11 with one copy-on-write rerun token, 12, 4), and
    every hit equals solo generation."""
    _, tp = params
    rng = np.random.default_rng(0)
    S = rng.integers(0, CFG.vocab_size, (12,)).astype(np.int32)
    tails = [rng.integers(0, CFG.vocab_size, (t,)).astype(np.int32)
             for t in (3, 5, 2)]
    div = rng.integers(0, CFG.vocab_size, (8,)).astype(np.int32)
    prompts = [np.concatenate([S, tails[0]]), np.concatenate([S, tails[1]]),
               np.concatenate([S, tails[2]]), S.copy(),
               np.concatenate([S, tails[0]]), np.concatenate([S[:4], div])]
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    sched = ContinuousScheduler(_engine(tp, prefix_cache=True), max_batch=1,
                                chunk_len=4, invariant_every=1)
    results = sched.run(reqs)
    _solo(CFG, tp, reqs, results)
    assert [r.prefix_tokens for r in results] == [0, 12, 12, 11, 12, 4]


def test_spec_streams_equal_solo_and_the_zerol_draft_accepts_all(params):
    """Speculation over latent pages: a random depth-2 draft (rejections
    every round, rollback by cursor alone) gives solo generation's
    streams; the paper's draft, a ``copying_zeroL`` 2 -> 4 expansion
    drafted at depth 2, accepts exactly everything and serves the
    pre-expansion model's streams."""
    _, tp = params
    reqs = _requests()
    sched = ContinuousScheduler(_engine(tp, spec_decode=True, gamma=3,
                                        draft_depth=2),
                                max_batch=2, chunk_len=4)
    _solo(CFG, tp, reqs, sched.run(reqs))
    assert sched.spec_stats()["spec_rounds"] > 0
    cfg2, cfg4 = CFG.with_depth(2), CFG.with_depth(4)
    p2 = tr.lm_init(torch.Generator().manual_seed(1), cfg2, device="cpu")
    p4 = exp.expand_params(p2, cfg2, 4, "copying_zeroL")
    eng = ServeEngine(cfg4, p4, device="cpu", max_len=48, paged=True,
                      block_size=4, spec_decode=True, gamma=3, draft_depth=2)
    sched = ContinuousScheduler(eng, max_batch=2, chunk_len=4)
    _solo(cfg2, p2, reqs[:4], sched.run(reqs[:4]))
    assert sched.acceptance_rate == 1.0


def test_int8_agreement_and_latent_priced_pool(params):
    """The reference's int8 lane on MLA (measured 1.0 there): greedy
    agreement with the f32 pool at least 0.9, lengths and finish reasons
    equal; a token costs r values per layer, and in int8 r bytes plus one
    f32 scale."""
    _, tp = params
    reqs = _requests()
    runs = {}
    for kv in (None, "int8"):
        sched = ContinuousScheduler(_engine(tp, kv_dtype=kv), max_batch=2,
                                    chunk_len=4, num_blocks=8)
        runs[kv] = (sched.run(reqs), sched.kv_stats())
    (f32, s32), (i8, s8) = runs[None], runs["int8"]
    assert _agreement(f32, i8) >= QUANT_AGREEMENT
    for a, b in zip(f32, i8):
        assert len(a.new_tokens) == len(b.new_tokens)
        assert a.finish_reason == b.finish_reason
    r, L = CFG.mla_kv_lora_rank, CFG.num_layers
    assert s32["kv_bytes_per_token"] == L * r * 4
    assert s8["kv_bytes_per_token"] == L * (r + 4)
    assert s8["kv_bytes_per_token_f32"] == L * r * 4


def test_rank_zero_takes_the_dense_path():
    """``mla_kv_lora_rank=0`` keys every path on the rank: standard wk/wv,
    a K/V pool, and paged streams equal solo generation."""
    cfg = dataclasses.replace(CFG, name="pg-mla0", mla_kv_lora_rank=0)
    tp = tr.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert "wk" in tp["blocks"]["layer0"]["attn"]
    assert "wkv_a" not in tp["blocks"]["layer0"]["attn"]
    eng = ServeEngine(cfg, tp, device="cpu", max_len=48, paged=True,
                      block_size=4)
    cache = eng.continuous_state(2, num_blocks=8).cache
    assert "k_pages" in cache["layer0"]
    assert "latent_pages" not in cache["layer0"]
    reqs = _requests()[:4]
    _solo(cfg, tp, reqs, ContinuousScheduler(eng, max_batch=2, chunk_len=4,
                                             num_blocks=8).run(reqs))


def test_window_ring_is_refused():
    """An MLA sliding-window ring is refused, with the reference's
    message, when its chunked prefill runs."""
    cfg = dataclasses.replace(CFG, name="pg-mla-w", window_pattern=(4, 0))
    tp = tr.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    sched = ContinuousScheduler(ServeEngine(cfg, tp, device="cpu",
                                            max_len=48, paged=True,
                                            block_size=4),
                                max_batch=2, chunk_len=4)
    with pytest.raises(NotImplementedError,
                       match="MLA sliding-window rings are not served"):
        sched.run(_requests()[:2])
