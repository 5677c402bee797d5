"""The port's model code against the JAX package's, on the CPU at smoke
size (``gpt2-12l`` smoke: 2 layers, d_model 64, 4 heads of 16, vocab 256).

Both sides get the same parameters (the JAX init, carried over by
``repro_torch.bridge``) and the same numpy inputs.  Tolerances are absolute
and stated per test; they cover float32 sums taken in other orders by XLA's
and PyTorch's CPU kernels (activations here are O(1), logits O(0.1)).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import common as jcommon
from repro.models import attention as jattn
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch import configs
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import mlp
from repro_torch.models import registry
from repro_torch.models import transformer as tr

CFG = configs.get_smoke_config("gpt2-12l")
JCFG = jax_configs.get_smoke_config("gpt2-12l")
TOL = 1e-5          # one layer's activations
LOGIT_TOL = 1e-5    # logits after the whole stack


def _port(tree):
    return bridge.params_from_jax(jax.device_get(tree))


def _params(n_layers, seed=0):
    jp = jtr.lm_init(jax.random.PRNGKey(seed), JCFG, num_layers=n_layers)
    return jp, _port(jp)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def test_config_copy_matches_reference():
    for name in ("gpt2-12l", "gpt2-24l"):
        want = dataclasses.asdict(jax_configs.get_config(name))
        assert dataclasses.asdict(configs.get_config(name)) == want
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert dataclasses.asdict(configs.get_config("whisper-base")) \
        == dataclasses.asdict(jax_configs.get_config("whisper-base"))
    with pytest.raises(KeyError, match="unknown architecture"):
        configs.get_config("whisper-large")


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_apply_norm_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64, dtype=np.float32),
         "bias": rng.standard_normal(64, dtype=np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    want = jcommon.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), kind)
    got = common.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind)
    _close(got, want, 1e-6)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 241, dtype=np.float32)
    got = common.activate(torch.from_numpy(x), "gelu")
    _close(got, jcommon.activate(jnp.asarray(x), "gelu"), 1e-6)
    assert abs(float(common.activate(torch.tensor(1.0), "gelu"))
               - 0.841192) < 1e-6


def test_mlp_matches_jax():
    jp = jmlp.mlp_init(jax.random.PRNGKey(1), JCFG)
    x = np.random.default_rng(1).standard_normal((2, 7, 64), dtype=np.float32)
    want = jmlp.mlp_apply(jp, JCFG, jnp.asarray(x))
    _close(mlp.mlp_apply(_port(jp), CFG, torch.from_numpy(x)), want, TOL)


def test_attn_apply_matches_jax():
    jp = jattn.attn_init(jax.random.PRNGKey(2), JCFG)
    x = np.random.default_rng(2).standard_normal((2, 24, 64), dtype=np.float32)
    pos = np.broadcast_to(np.arange(24)[None], (2, 24))
    want = jattn.attn_apply(jp, JCFG, jnp.asarray(x), jnp.asarray(pos),
                            window=0)
    got = attn.attn_apply(_port(jp), CFG, torch.from_numpy(x),
                          torch.from_numpy(pos.copy()), window=0)
    _close(got, want, TOL)


@pytest.mark.parametrize("n_layers", [0, 2])
def test_lm_apply_matches_jax(n_layers):
    jp, tp = _params(n_layers)
    toks = _tokens(2, 20)
    want, _ = jtr.lm_apply(jp, JCFG, jnp.asarray(toks))
    got, aux = tr.lm_apply(tp, CFG, torch.from_numpy(toks).long())
    assert got.shape == (2, 20, CFG.vocab_size) and float(aux) == 0.0
    _close(got, want, LOGIT_TOL)


def _jax_prefill(jp, toks, max_len):
    cache = jtr.lm_init_cache(jp, JCFG, toks.shape[0], max_len, jnp.float32)
    return jtr.lm_prefill(jp, JCFG, jnp.asarray(toks), cache)


@pytest.mark.parametrize("n_layers", [0, 2])
def test_lm_prefill_and_decode_step_match_jax(n_layers):
    """Prefill logits and the filled cache, then two decode steps (logits
    and cache), held against JAX; the block-free model has no cache."""
    jp, tp = _params(n_layers, seed=3)
    B, P, max_len = 2, 12, 32
    toks = _tokens(B, P, seed=3)
    jlog, jcache = _jax_prefill(jp, toks, max_len)
    cache = tr.lm_init_cache(tp, CFG, B, max_len, torch.float32, device="cpu")
    log, cache = tr.lm_prefill(tp, CFG, torch.from_numpy(toks).long(), cache)
    _close(log, jlog, LOGIT_TOL)
    assert (cache == {}) == (n_layers == 0)
    for lname, lc in cache.items():
        for leaf in ("k", "v"):
            assert lc[leaf].shape == (n_layers, B, max_len, CFG.num_kv_heads,
                                      CFG.head_dim)
            _close(lc[leaf], jcache[lname][leaf], TOL)

    nxt = _tokens(B, 2, seed=4)
    for t in range(2):
        index = P + t
        jlog, jcache = jtr.lm_decode_step(jp, JCFG, jnp.asarray(nxt[:, t:t + 1]),
                                          jcache, jnp.int32(index))
        log, cache = tr.lm_decode_step(
            tp, CFG, torch.from_numpy(nxt[:, t:t + 1]).long(), cache,
            torch.full((B,), index))
        assert log.shape == (B, 1, CFG.vocab_size)
        _close(log, jlog, LOGIT_TOL)
        for lname, lc in cache.items():
            for leaf in ("k", "v"):
                _close(lc[leaf], jcache[lname][leaf], TOL)


def test_decode_step_per_row_cursors_match_jax():
    """Rows at different cursors write and mask their own slots."""
    jp, tp = _params(2, seed=5)
    B, P, max_len = 3, 10, 16
    toks = _tokens(B, P, seed=5)
    _, jcache = _jax_prefill(jp, toks, max_len)
    cache = tr.lm_init_cache(tp, CFG, B, max_len, torch.float32, device="cpu")
    _, cache = tr.lm_prefill(tp, CFG, torch.from_numpy(toks).long(), cache)
    index = np.array([4, 7, 10], np.int32)
    tok = _tokens(B, 1, seed=6)
    jlog, jcache = jtr.lm_decode_step(jp, JCFG, jnp.asarray(tok), jcache,
                                      jnp.asarray(index))
    log, cache = tr.lm_decode_step(tp, CFG, torch.from_numpy(tok).long(),
                                   cache, torch.from_numpy(index))
    _close(log, jlog, LOGIT_TOL)
    _close(cache["layer0"]["k"], jcache["layer0"]["k"], TOL)


def test_prefill_cache_equals_token_by_token_decode_cache():
    """In-port contract: the cache one prefill leaves equals the cache a
    token-by-token decode of the same prompt leaves, and so do the last
    logits."""
    _, tp = _params(2, seed=7)
    B, P, max_len = 2, 9, 16
    toks = torch.from_numpy(_tokens(B, P, seed=7)).long()
    pc = tr.lm_init_cache(tp, CFG, B, max_len, torch.float32, device="cpu")
    plog, pc = tr.lm_prefill(tp, CFG, toks, pc)
    dc = tr.lm_init_cache(tp, CFG, B, max_len, torch.float32, device="cpu")
    for t in range(P):
        dlog, dc = tr.lm_decode_step(tp, CFG, toks[:, t:t + 1], dc, t)
    for lname in pc:
        for leaf in ("k", "v"):
            torch.testing.assert_close(pc[lname][leaf], dc[lname][leaf],
                                       atol=TOL, rtol=0)
    torch.testing.assert_close(plog[:, -1], dlog[:, 0], atol=LOGIT_TOL,
                               rtol=0)


def test_param_module_facade_moves_and_names_the_tree():
    _, tp = _params(2)
    mod = registry.ParamModule(tp)
    sd = mod.state_dict()
    assert "blocks.layer0.attn.wq" in sd and "pos_embed" in sd
    assert sd["blocks.layer0.attn.wq"].shape == (2, 64, 64)
    tree = mod.to(torch.float64).tree()
    assert tree["blocks"]["layer0"]["mlp"]["w_up"].dtype == torch.float64
    assert bridge.flatten(tree).keys() == bridge.flatten(tp).keys()


def test_unported_architectures_raise_naming_the_roadmap():
    """M-RoPE and MLA now run: on text-only ids an M-RoPE model gives the
    RoPE model's logits bit for bit, and the registry takes an MLA config
    (with ``mla_kv_lora_rank`` 0 its attention keeps wk and wv)."""
    rope = dataclasses.replace(CFG, position="rope")
    mrope = dataclasses.replace(CFG, position="mrope")
    params = tr.lm_init(torch.Generator().manual_seed(0), rope, device="cpu")
    toks = torch.from_numpy(_tokens(2, 12, 3)).long()
    assert torch.equal(tr.lm_apply(params, mrope, toks)[0],
                       tr.lm_apply(params, rope, toks)[0])
    mla = dataclasses.replace(CFG, family="moe", attention="mla")
    registry.get_model(mla)
    assert set(attn.attn_init(None, mla, device="meta")) \
        == {"wq", "wk", "wv", "wo"}
