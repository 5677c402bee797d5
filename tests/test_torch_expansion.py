"""The port's depth expansion against the JAX package's, on the CPU
(``gpt2-12l`` smoke widths).

Copying methods and ``zero`` are pure data movement, so the port's result
is held byte-exact against JAX ``expand_params`` on the same params (the
JAX init, carried over by ``repro_torch.bridge``); so are
``expand_opt_state`` under all three policies and ``truncate_params``.
Function preservation (``zero``, ``copying_zeroL``, ``copying_zeroN``) is
re-proved in the port, bit for bit, as ``tests/test_expansion.py`` proves
it in JAX.  ``random`` draws from a ``torch.Generator``, so it is checked
by its init scale and its determinism, not against JAX's bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core import expansion as jexp
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch import configs
from repro_torch.core import expansion as exp
from repro_torch.models import transformer as tr

CFG = configs.get_smoke_config("gpt2-12l")
JCFG = jax_configs.get_smoke_config("gpt2-12l")
COPYING = ("copying_stack", "copying_inter", "copying_last",
           "copying_zeroL", "copying_zeroN")


def _params(layers, seed=0):
    jp = jtr.lm_init(jax.random.PRNGKey(seed), JCFG, num_layers=layers)
    return jp, bridge.params_from_jax(jax.device_get(jp))


def _assert_same(got, want):
    got = bridge.flatten(bridge.params_to_numpy(got))
    want = bridge.flatten(jax.device_get(want))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("method", ("zero",) + COPYING)
@pytest.mark.parametrize("insert_at", ["bottom", "top"])
def test_expand_params_byte_exact(method, insert_at):
    jp, tp = _params(2)
    want = jexp.expand_params(jp, JCFG.with_depth(2), 5, method,
                              key=jax.random.PRNGKey(1), insert_at=insert_at)
    got = exp.expand_params(tp, CFG.with_depth(2), 5, method,
                            insert_at=insert_at)
    _assert_same(got, want)
    assert got["embed"] is tp["embed"]             # inherited, not copied


def test_zero_from_zero_layer_source_byte_exact():
    jp, tp = _params(0)
    want = jexp.expand_params(jp, JCFG.with_depth(0), 3, "zero",
                              key=jax.random.PRNGKey(0))
    _assert_same(exp.expand_params(tp, CFG.with_depth(0), 3, "zero"), want)
    with pytest.raises(ValueError):
        exp.expand_stack(None, 3, "copying_stack")


@pytest.mark.parametrize("policy", ["inherit", "copy", "reset"])
@pytest.mark.parametrize("method", ["copying_stack", "copying_inter", "zero"])
def test_expand_opt_state_byte_exact(policy, method):
    jp, tp = _params(2)
    rng = np.random.default_rng(3)
    moms = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32),
        jax.device_get(jp))
    jstate = {"step": jnp.asarray(7, jnp.int32),
              "m": jax.tree.map(jnp.asarray, moms)}
    tstate = {"step": torch.tensor(7, dtype=torch.int32),
              "m": bridge.params_from_jax(moms)}
    jgrown = jexp.expand_params(jp, JCFG.with_depth(2), 5, method,
                                key=jax.random.PRNGKey(1))
    tgrown = exp.expand_params(tp, CFG.with_depth(2), 5, method)
    want = jexp.expand_opt_state(jstate, jgrown, policy, method)
    got = exp.expand_opt_state(tstate, tgrown, policy, method)
    assert int(got["step"]) == int(want["step"])
    _assert_same(got["m"], want["m"])
    for (_, m), (_, p) in zip(bridge.flatten(got["m"]).items(),
                              bridge.flatten(tgrown).items()):
        assert m.data_ptr() != p.data_ptr()      # moments never alias params


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_truncate_params_byte_exact(depth):
    jp, tp = _params(4)
    _assert_same(exp.truncate_params(tp, CFG.with_depth(4), depth),
                 jexp.truncate_params(jp, JCFG.with_depth(4), depth))
    with pytest.raises(ValueError):
        exp.truncate_params(tp, CFG.with_depth(4), 5)


def _logits(params, layers, tokens):
    with torch.no_grad():
        return tr.lm_apply(params, CFG.with_depth(layers), tokens)[0]


@pytest.mark.parametrize("method", ["zero", "copying_zeroL", "copying_zeroN"])
def test_function_preserving_methods(method):
    """The grown model computes the source model's logits, bit for bit;
    plain copying does not."""
    _, small = _params(2, seed=5)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab_size, (2, 16)))
    base = _logits(small, 2, tokens)
    grown = exp.expand_params(small, CFG.with_depth(2), 4, method)
    assert torch.equal(_logits(grown, 4, tokens), base)
    copied = exp.expand_params(small, CFG.with_depth(2), 4, "copying_stack")
    assert (_logits(copied, 4, tokens) - base).abs().max() > 1e-3
    if method == "copying_zeroL":
        # the truncated draft IS the pre-expansion model
        draft = exp.truncate_params(grown, CFG.with_depth(4), 2)
        assert torch.equal(_logits(draft, 2, tokens), base)


def test_random_init_scale_and_determinism():
    """New blocks drawn at the muP init scale (std 1/sqrt(fan_in)), old
    blocks kept, the same generator seed giving the same bits."""
    cfg = dataclasses.replace(CFG, d_model=256, d_ff=512)
    small = tr.lm_init(torch.Generator().manual_seed(0), cfg, num_layers=1,
                       device="cpu")

    def grow(seed):
        return exp.expand_params(small, cfg.with_depth(1), 4, "random",
                                 generator=torch.Generator().manual_seed(seed))
    grown = grow(17)
    wq = grown["blocks"]["layer0"]["attn"]["wq"]
    w_down = grown["blocks"]["layer0"]["mlp"]["w_down"]
    assert wq.shape[0] == 4
    assert torch.equal(wq[0], small["blocks"]["layer0"]["attn"]["wq"][0])
    for w, fan_in in ((wq, cfg.d_model), (w_down, cfg.d_ff)):
        std = float(w[1:].std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.02, std
    ln = grown["blocks"]["layer0"]["ln1"]["scale"]
    assert torch.equal(ln[1:], torch.ones_like(ln[1:]))
    assert torch.equal(grow(17)["blocks"]["layer0"]["attn"]["wq"], wq)
    assert not torch.equal(grow(18)["blocks"]["layer0"]["attn"]["wq"], wq)
    zero_src = tr.lm_init(torch.Generator().manual_seed(0), cfg,
                          num_layers=0, device="cpu")
    assert exp.expand_params(zero_src, cfg.with_depth(0), 2, "random")[
        "blocks"]["layer0"]["attn"]["wq"].shape[0] == 2
