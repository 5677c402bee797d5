"""The port's RWKV6 model and serving path against the JAX package's, on the
CPU at smoke size (``rwkv6-7b`` smoke: 2 layers, d_model 64, 4 heads of 16,
d_ff 128, vocab 256).

Both sides get the same parameters (the JAX init, carried over by
``repro_torch.bridge``) and the same numpy inputs.  Tolerances: 1e-5 for
one block's outputs and states (float32 sums in other orders, O(1)
activations), 1e-4 for logits after the stack and for served logits (the
CPU takes the chunked WKV form from 64 positions on, whose sums run in
another order than the per-step form's).  A greedy token is only defined
where its top-2 margin exceeds the logit tolerance; the serving test
asserts the margin, so a flip fails as a margin, never silently.
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
from repro.checkpoint import checkpointer as jax_ckpt
from repro.launch import mesh as mesh_lib
from repro.launch import serve as jax_serve
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.train.serve_engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch import configs
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.models import ssm
from repro_torch.models import transformer as tr
from repro_torch.train.serve_engine import ServeEngine

CFG = configs.get_smoke_config("rwkv6-7b")
JCFG = jax_configs.get_smoke_config("rwkv6-7b")
TOL = 1e-5           # one block
LOGIT_TOL = 1e-4     # after the stack


def _port(tree):
    return bridge.params_from_jax(jax.device_get(tree))


def _params(n_layers, seed=0):
    jp = jtr.lm_init(jax.random.PRNGKey(seed), JCFG, num_layers=n_layers)
    return jax.device_get(jp), _port(jp)


def _block(seed=0):
    jp = jax.device_get(jssm.rwkv_init(jax.random.PRNGKey(seed), JCFG))
    return jp, _port(jp)


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, CFG.d_model)).astype(np.float32)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (B, S)).astype(np.int32)


def _state(B, seed):
    """A nonzero decode state, as numpy (JAX) and tensors (port)."""
    rng = np.random.default_rng(seed)
    H, hd = ssm.rwkv_dims(CFG)
    st = {"tm_x": rng.standard_normal((B, CFG.d_model)),
          "cm_x": rng.standard_normal((B, CFG.d_model)),
          "wkv": rng.standard_normal((B, H, hd, hd))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    return st, {k: torch.from_numpy(v.copy()) for k, v in st.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def _close_states(got, want, tol=TOL):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == torch.float32, key
        _close(got[key], want[key], tol)


def test_config_copy_matches_reference():
    for get in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jax_configs, get)("rwkv6-7b"))
        assert dataclasses.asdict(getattr(configs, get)("rwkv6-7b")) == want
    assert ssm.rwkv_dims(CFG) == (4, 16)


@pytest.mark.parametrize("S", [9, 70])
def test_time_and_channel_mix_match_jax(S):
    jp, tp = _block(seed=S)
    x = _x(2, S, seed=S)
    jst, tst = _state(2, seed=S)
    _close(ssm.rwkv_time_mix(tp, CFG, torch.from_numpy(x)),
           jssm.rwkv_time_mix(jp, JCFG, x), TOL)
    _close(ssm.rwkv_channel_mix(tp, CFG, torch.from_numpy(x)),
           jssm.rwkv_channel_mix(jp, JCFG, x), TOL)
    y, s = ssm.rwkv_time_mix(tp, CFG, torch.from_numpy(x), state=tst["wkv"],
                             x_prev=tst["tm_x"], return_state=True)
    jy, js = jssm.rwkv_time_mix(jp, JCFG, x, state=jst["wkv"],
                                x_prev=jst["tm_x"], return_state=True)
    _close(y, jy, TOL)
    _close(s, js, TOL)


@pytest.mark.parametrize("S", [9, 70])
def test_prefills_match_jax_with_their_states(S):
    jp, tp = _block(seed=3)
    x = _x(2, S, seed=4)
    jst, tst = _state(2, seed=5)
    y, st = ssm.rwkv_time_mix_prefill(tp, CFG, torch.from_numpy(x), tst)
    jy, jst2 = jssm.rwkv_time_mix_prefill(jp, JCFG, x, jst)
    _close(y, jy, TOL)
    _close_states(st, jst2)
    y, st = ssm.rwkv_channel_mix_prefill(tp, CFG, torch.from_numpy(x), st)
    jy, jst3 = jssm.rwkv_channel_mix_prefill(jp, JCFG, x, jst2)
    _close(y, jy, TOL)
    _close_states(st, jst3)


def test_decode_step_matches_jax():
    jp, tp = _block(seed=6)
    x = _x(3, 1, seed=7)
    jst, tst = _state(3, seed=8)
    y, st = ssm.rwkv_decode(tp, CFG, torch.from_numpy(x), tst)
    jy, jst2 = jssm.rwkv_decode(jp, JCFG, x, jst)
    _close(y, jy, TOL)
    _close_states(st, jst2)
    y, st = ssm.rwkv_channel_mix_decode(tp, CFG, torch.from_numpy(x), st)
    jy, jst3 = jssm.rwkv_channel_mix_decode(jp, JCFG, x, jst2)
    _close(y, jy, TOL)
    _close_states(st, jst3)


@pytest.mark.parametrize("layers", [0, 2])
def test_lm_apply_matches_jax(layers):
    jp, tp = _params(layers, seed=10 + layers)
    toks = _tokens(2, 70, seed=layers)
    cfg, jcfg = CFG.with_depth(layers), JCFG.with_depth(layers)
    got, aux = tr.lm_apply(tp, cfg, torch.from_numpy(toks).long())
    want, jaux = jtr.lm_apply(jp, jcfg, toks)
    _close(got, want, LOGIT_TOL)
    assert aux.item() == float(jaux) == 0.0


def test_lm_loss_grads_match_jax():
    """``lm_loss`` on the CPU through autograd of the plain WKV forms,
    against ``jax.grad`` of the reference."""
    jp, tp = _params(2, seed=12)
    toks = _tokens(2, 20, seed=1)
    labels = _tokens(2, 20, seed=2)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, JCFG, toks, labels), has_aux=True)(jp)
    flat = {k: v.requires_grad_() for k, v in bridge.flatten(tp).items()}
    loss, _ = registry.get_model(CFG).loss(
        bridge.unflatten(flat), CFG,
        {"tokens": torch.from_numpy(toks).long(),
         "labels": torch.from_numpy(labels).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=TOL)
    for key, g in bridge.flatten(jax.device_get(jgrads)).items():
        np.testing.assert_allclose(flat[key].grad.numpy(), g, atol=TOL,
                                   rtol=1e-4, err_msg=key)


def test_prefill_then_decode_equals_the_full_forward():
    """In-port: prefill P tokens, then decode the rest one at a time; each
    position's logits equal the full forward's."""
    _, tp = _params(2, seed=13)
    toks = torch.from_numpy(_tokens(2, 75, seed=3)).long()
    full, _ = tr.lm_apply(tp, CFG, toks)
    P = 66
    cache = tr.lm_init_cache(tp, CFG, 2, 80, torch.float32, device="cpu")
    logits, cache = tr.lm_prefill(tp, CFG, toks[:, :P], cache)
    _close(logits, full[:, :P], LOGIT_TOL)
    for t in range(P, toks.shape[1]):
        step, cache = tr.lm_decode_step(tp, CFG, toks[:, t:t + 1], cache, t)
        _close(step[:, 0], full[:, t], LOGIT_TOL)


def test_cache_keeps_the_recurrent_state_float32():
    _, tp = _params(2)
    cache = tr.lm_init_cache(tp, CFG, 3, 40, torch.bfloat16, device="cpu")
    H, hd = ssm.rwkv_dims(CFG)
    shapes = {"tm_x": (2, 3, CFG.d_model), "cm_x": (2, 3, CFG.d_model),
              "wkv": (2, 3, H, hd, hd)}
    assert {k: tuple(v.shape) for k, v in cache["layer0"].items()} == shapes
    assert all(v.dtype == torch.float32 and not v.any()
               for v in cache["layer0"].values())


def test_bridge_round_trip_is_bit_exact():
    jp, tp = _params(2, seed=14)
    assert "mu" in tp["blocks"]["layer0"]["rwkv_tm"]
    back = bridge.params_to_numpy(tp)
    flat_j, flat_b = bridge.flatten(jp), bridge.flatten(back)
    assert flat_j.keys() == flat_b.keys()
    for key, want in flat_j.items():
        np.testing.assert_array_equal(flat_b[key], np.asarray(want),
                                      err_msg=key)
    module = registry.ParamModule(tp)
    assert "blocks.layer0.rwkv_tm.mu.r" in module.state_dict()


@pytest.mark.parametrize("P", [10, 70])
def test_greedy_generate_matches_jax_engine(P):
    jp, tp = _params(2, seed=20 + P)
    prompts = _tokens(2, P, seed=P)
    G = 6
    want = JaxServeEngine(JCFG, jp, mesh=mesh_lib.single_device_mesh(),
                          max_len=P + G + 1).generate(prompts, G,
                                                      return_logits=True)
    before = wkv_ops.KERNEL_LAUNCHES
    got = ServeEngine(CFG, tp, device="cpu", max_len=P + G + 1).generate(
        prompts, G, return_logits=True)
    assert wkv_ops.KERNEL_LAUNCHES == before
    assert got.tokens.shape == (2, P + G) and got.steps == G
    top2 = np.sort(want.logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    assert margin.min() > 2 * LOGIT_TOL, (
        f"near-tie (margin {margin.min():.2e}): greedy tokens undefined at "
        "this tolerance; pick another seed")
    np.testing.assert_allclose(got.logits, want.logits, atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_serve_cli_serves_a_jax_checkpoint(tmp_path):
    """A JAX-written checkpoint of the smoke model at 3 layers: the port
    serves it at the manifest's depth and samples the JAX CLI's greedy
    tokens (both draw prompts from the same seed)."""
    jp, _ = _params(3, seed=15)
    jax_ckpt.save(str(tmp_path), 5, {"params": jp},
                  metadata={"num_layers": 3})
    argv = ["--arch", "rwkv6-7b", "--smoke", "--checkpoint", str(tmp_path),
            "--batch", "2", "--prompt-len", "8", "--gen", "6", "--seed", "4"]
    out = _run(serve.main, argv + ["--device", "cpu"])
    want = _run(jax_serve.main, argv)
    assert "arch=rwkv6-7b-smoke layers=3" in out

    def sample(text):
        return [line for line in text.splitlines()
                if line.startswith("sample:")]
    assert sample(out) == sample(want) and sample(out)


def test_serve_cli_on_cpu_and_default_device(monkeypatch):
    out = _run(serve.main, ["--arch", "rwkv6-7b", "--smoke", "--device",
                            "cpu", "--batch", "2", "--prompt-len", "8",
                            "--gen", "4"])
    assert "arch=rwkv6-7b-smoke layers=2" in out and "sample: [" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "rwkv6-7b", "--smoke"])


@pytest.mark.parametrize("argv,item", [
    (["--arch", "rwkv6-7b", "--continuous"], "item 17"),
    (["--arch", "rwkv6-7b", "--continuous", "--paged"], "item 17"),
    (["--arch", "jamba-v0.1-52b", "--continuous"], "item 17"),
    (["--arch", "gemma2-9b"], "sliding-window")])
def test_unported_paths_name_their_roadmap_item(argv, item):
    with pytest.raises((SystemExit, NotImplementedError), match=item):
        serve.main(argv + ["--smoke", "--device", "cpu"])


def test_unported_layers_raise_naming_their_items():
    _, tp = _params(2)
    with pytest.raises(NotImplementedError, match="item 17"):
        ServeEngine(CFG, tp, device="cpu").continuous_state(2)
    with pytest.raises(NotImplementedError, match="item 17"):
        tr.lm_init_paged_cache(tp, CFG, 2, 8, 4, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        tr.lm_init_prefill_carry(tp, CFG, 32, device="cpu")
    mamba = dataclasses.replace(CFG, block_pattern=("mamba",))
    mp = registry.get_model(mamba).init(torch.Generator().manual_seed(0),
                                        mamba, device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        ServeEngine(mamba, mp, device="cpu").continuous_state(2)
    with pytest.raises(NotImplementedError, match="item 17"):
        tr.lm_init_paged_cache(mp, mamba, 2, 8, 4, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        registry.get_model(dataclasses.replace(CFG, family="moe"))


def test_random_init_shapes_and_scales():
    """The port draws its own weights (torch.Generator): shapes and dtypes
    equal the reference's, the scales follow the same init rules."""
    jp, _ = _params(2)
    tp = tr.lm_init(torch.Generator().manual_seed(0), CFG, device="cpu")
    flat_j, flat_t = bridge.flatten(jp), bridge.flatten(tp)
    assert flat_j.keys() == flat_t.keys()
    for key, want in flat_j.items():
        assert tuple(flat_t[key].shape) == want.shape, key
    blk = tp["blocks"]["layer0"]["rwkv_tm"]
    jblk = jp["blocks"]["layer0"]["rwkv_tm"]
    np.testing.assert_allclose(blk["w_base"].numpy(), jblk["w_base"],
                               atol=1e-6)
    assert abs(float(blk["w_r"].std()) * CFG.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(blk["u"].std()) - 0.1) < 0.03
    assert jnp.allclose(jblk["mu"]["r"], 0.5) and bool(
        (blk["mu"]["r"] == 0.5).all())
