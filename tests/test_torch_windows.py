"""Sliding-window and softcapped attention in the port against the JAX
package's, on the CPU: ``gemma2-9b`` (1:1 local 4096 : global, attention
softcap 50, final softcap 30) and ``gemma3-12b`` (5:1 local 1024 : global,
qk-norm, θ 1e6) at their smoke size (windows capped at 8, d_model 64, 4
heads of 16, vocab 256), where sequences of 20 tokens make every window
bind.

Cross-framework, on the JAX init carried over by ``repro_torch.bridge``
and the same numpy inputs: the configs; logits (``LOGIT_TOL``), loss and
``jax.grad`` (``GRAD_TOL``); greedy tokens and per-step logits of the
port's engine against the JAX ``ServeEngine`` over a prompt longer than
the window and a decode that wraps the ring; and the ring operations one
by one against the reference's: ``_fill_cache`` with a prompt longer than
the ring (bit for bit), a prefill chunk over a ring (its output and the
advanced ring, within ``RING_TOL``: gemma3's qk-norm rounds k in another
order), the verify's per-query ring gather and ``spec_ring_commit`` (bit
for bit on the same pending K/V).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import mesh as mesh_lib
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.train.serve_engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch import configs
from repro_torch.models import attention, registry
from repro_torch.models import transformer as tr
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.tree import tree_map

NAMES = ("gemma2-9b", "gemma3-12b")
LOGIT_TOL = 1e-5
# Gradients: absolute, plus 1e-4 relative (float32 sums in other orders).
GRAD_TOL = 1e-5
RING_TOL = 1e-6            # one attention layer's output


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these ops are tiny, and on a shared CPU many
    threads make them several times slower.  Every comparison here is
    between runs under the same setting, or within a stated tolerance."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(B, S, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab,
                                                (B, S)).astype(np.int32)


def _params(name, seed=0):
    """Both configs and both params trees (the JAX init, carried over)."""
    jcfg = jax_configs.get_smoke_config(name)
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, configs.get_smoke_config(name), jp, bridge.params_from_jax(jp)


def test_configs_copy_the_reference_and_the_registry_admits_them():
    for name in NAMES:
        want = jax_configs.get_config(name)
        assert dataclasses.asdict(configs.get_config(name)) \
            == dataclasses.asdict(want)
        assert dataclasses.asdict(configs.get_smoke_config(name)) \
            == dataclasses.asdict(jax_configs.get_smoke_config(name))
        registry.get_model(configs.get_config(name))
        assert name in configs.PORTED_ARCHS
        assert configs.default_remat(name) == jax_configs.default_remat(name)
    assert configs.REMAT_DEFAULTS == jax_configs.REMAT_DEFAULTS
    assert configs.get_smoke_config("gemma2-9b").window_pattern == (8, 0)


@pytest.mark.parametrize("name", NAMES)
def test_logits_loss_and_grads_match_jax(name):
    """A (2, 20) batch through 4 (gemma2) or 6 (gemma3) layers whose
    windows of 8 bind: logits, the loss and every leaf's gradient against
    ``jax.grad`` (softcaps and qk-norm scales among them)."""
    jcfg, cfg, jp, tp = _params(name, seed=len(name))
    toks, labels = _tokens(2, 20, 1), _tokens(2, 20, 2)
    want, _ = jax.jit(lambda p, t: jtr.lm_apply(p, jcfg, t))(jp, toks)
    got, _ = tr.lm_apply(tp, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.lm_loss(p, jcfg, toks, labels), has_aux=True))(jp)
    flat = {k: v.clone().requires_grad_()
            for k, v in bridge.flatten(tp).items()}
    loss, _ = registry.get_model(cfg).loss(
        bridge.unflatten(flat), cfg,
        {"tokens": torch.from_numpy(toks).long(),
         "labels": torch.from_numpy(labels).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jflat = bridge.flatten(jax.device_get(jgrads))
    assert jflat.keys() == flat.keys()
    for key, g in jflat.items():
        np.testing.assert_allclose(flat[key].grad.numpy(), g, atol=GRAD_TOL,
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("P", [5, 12])
def test_greedy_generate_past_the_window_matches_jax_engine(name, P):
    """Greedy tokens and per-step logits of the port's contiguous engine
    against the JAX ServeEngine: a prompt shorter and one longer than the
    ring of 8 (the prefill fills it modulo 8), then 10 decode steps that
    wrap it."""
    jcfg, cfg, jp, tp = _params(name, seed=P)
    prompts = _tokens(2, P, seed=P + 1)
    G = 10
    want = JaxServeEngine(jcfg, jp, mesh=mesh_lib.single_device_mesh(),
                          max_len=P + G + 1).generate(prompts, G,
                                                      return_logits=True)
    got = ServeEngine(cfg, tp, device="cpu", max_len=P + G + 1).generate(
        prompts, G, return_logits=True)
    top2 = np.sort(want.logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 2 * LOGIT_TOL, (
        "near-tie: greedy tokens undefined at this tolerance")
    np.testing.assert_allclose(got.logits, want.logits, atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


@pytest.mark.parametrize("S,W", [(5, 8), (8, 8), (13, 8), (20, 8), (17, 4)])
def test_fill_cache_with_a_prompt_longer_than_the_ring(S, W):
    """Each ring slot keeps the last token that maps to it, bit for bit as
    the reference's ``_fill_cache`` leaves it, and as W decode-style
    writes at ``t % W`` leave it."""
    rng = np.random.default_rng(S * W)
    new = rng.standard_normal((2, S, 3, 4), dtype=np.float32)
    buf = torch.zeros((2, W, 3, 4))
    got = attention._fill_cache(buf, torch.from_numpy(new))
    assert got is buf
    want = np.asarray(jattn._fill_cache(jnp.zeros((2, W, 3, 4)), new))
    np.testing.assert_array_equal(got.numpy(), want)
    seq = np.zeros((2, W, 3, 4), np.float32)
    for t in range(S):
        seq[:, t % W] = new[:, t]
    np.testing.assert_array_equal(got.numpy(), seq)


def _window_layer(name, seed):
    """Layer 0 (a window layer) of both models: configs, attention params
    of both and the ring width."""
    jcfg, cfg, jp, tp = _params(name, seed=seed)
    assert cfg.layer_window(0) == 8
    jl = jax.tree.map(lambda x: x[0], jp["blocks"]["layer0"]["attn"])
    tl = tree_map(lambda x: x[0], tp["blocks"]["layer0"]["attn"])
    return jcfg, cfg, jl, tl


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("ctx,C", [(0, 4), (3, 4), (6, 8), (13, 2), (16, 8)])
def test_prefill_chunk_over_a_ring_matches_jax(name, ctx, C):
    """One chunk of C tokens at ``ctx`` against a random B=1 ring of 8:
    the chunk's attention output and the advanced ring against the
    reference's ``attn_prefill_chunk``."""
    jcfg, cfg, jl, tl = _window_layer(name, seed=ctx + C)
    rng = np.random.default_rng(ctx * 10 + C)
    ring = {k: rng.standard_normal((1, 8, cfg.num_kv_heads, cfg.head_dim),
                                   dtype=np.float32) for k in ("k", "v")}
    x = rng.standard_normal((1, C, cfg.d_model), dtype=np.float32)
    pos = np.arange(ctx, ctx + C)[None]
    want, jring = jattn.attn_prefill_chunk(jl, jcfg, x, ring, ctx, pos, 8)
    cache = {k: torch.from_numpy(v.copy()) for k, v in ring.items()}
    got, cache = attention.attn_prefill_chunk(
        tl, cfg, torch.from_numpy(x), cache, ctx, torch.from_numpy(pos), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RING_TOL,
                               rtol=0)
    for k in ("k", "v"):       # gemma3's qk-norm rounds k differently
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jring[k]),
                                   atol=RING_TOL, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_verify_over_a_ring_and_its_commit_match_jax(name):
    """Three rows verifying C = 4 positions at cursors 2, 7 and 13 against
    random rings: the output, the deferred chunk K/V (the rings untouched)
    and ``spec_ring_commit`` at accepted lengths 0, 2 and 4 against the
    reference's."""
    jcfg, cfg, jl, tl = _window_layer(name, seed=7)
    rng = np.random.default_rng(11)
    B, C = 3, 4
    ring = {k: rng.standard_normal((B, 8, cfg.num_kv_heads, cfg.head_dim),
                                   dtype=np.float32) for k in ("k", "v")}
    x = rng.standard_normal((B, C, cfg.d_model), dtype=np.float32)
    index = np.array([2, 7, 13], np.int32)
    pos = index[:, None] + np.arange(C)[None]
    want, jc = jattn.attn_verify_chunk(jl, jcfg, x, ring, index, pos, 8)
    cache = {k: torch.from_numpy(v.copy()) for k, v in ring.items()}
    got, tc = attention.attn_verify_chunk(
        tl, cfg, torch.from_numpy(x), cache, torch.from_numpy(index).long(),
        torch.from_numpy(pos), 8, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RING_TOL,
                               rtol=0)
    for k in ("k", "v"):
        np.testing.assert_array_equal(cache[k].numpy(), ring[k])
        np.testing.assert_allclose(tc["pending"][k].numpy(),
                                   np.asarray(jc["pending"][k]),
                                   atol=RING_TOL, rtol=0)
    # The commit moves data only: on the same pending K/V it is bit-exact.
    acc = np.array([0, 2, 4], np.int32)
    pend = {k: np.array(jc["pending"][k])[None] for k in ("k", "v")}
    jk, jv = jattn.spec_ring_commit(ring["k"][None], ring["v"][None],
                                    pend["k"], pend["v"], index, acc)
    k, v = (cache[n][None].clone() for n in ("k", "v"))
    attention.spec_ring_commit(k, v, torch.from_numpy(pend["k"]),
                               torch.from_numpy(pend["v"]),
                               torch.from_numpy(index).long(),
                               torch.from_numpy(acc).long())
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert np.array_equal(k[0, 0].numpy(), ring["k"][0])   # acc 0: frozen
