"""M-RoPE and frontend embeds in the port (``qwen2-vl-2b``) against the JAX
package's, on the CPU.

``apply_mrope`` against ``repro.models.common.apply_mrope`` with distinct
temporal, height and width ids at head dims 16 and 64 (where the reference
rescales its (16, 24, 24) sections to hd/2) and 128 (where it does not), at
θ 1e6 (qwen2-vl's) and 1e4, within ``tests/test_torch_rope.py``'s bound
(1e-6 · max|x| plus, at θ 1e6, position · 1e-9 · max|x|: the port gathers
each band's angles from its f64-built table); text-only ids rotate to
``apply_rope``'s bits.  On ``qwen2-vl-2b``'s smoke config and the JAX init
carried over by ``repro_torch.bridge``: ``lm_loss`` with 8 frontend embeds
prepended (the loss over the text tail), its logits and every gradient
against ``jax.grad`` (``tests/test_torch_testbeds.py``'s tolerances), and
continuous paged serving (text-only, as the reference's engine serves it)
against the JAX engine's greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import mesh as mesh_lib
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro.train import serve_engine as jax_engine
from repro.train import serve_scheduler as jax_sched
from repro_torch import bridge
from repro_torch import configs
from repro_torch.models import common, registry
from repro_torch.models import transformer as tr
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_scheduler import ContinuousScheduler, Request

NAME = "qwen2-vl-2b"
ROPE_TOL = 1e-6
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-5            # absolute, plus 1e-4 relative


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
def model():
    jcfg = jax_configs.get_smoke_config(NAME)
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(5), jcfg))
    return jcfg, configs.get_smoke_config(NAME), jp, bridge.params_from_jax(jp)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.mark.parametrize("theta", [1e6, 1e4])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_apply_mrope_matches_jax(hd, theta):
    """(3, B, S) ids whose three components differ (an image patch grid:
    t fixed, h and w walking a 16-wide grid, offset by the text before
    it), up to position 4095."""
    S, max_len = 96, 4096
    rng = np.random.default_rng(hd)
    base = rng.integers(0, max_len - 128, (2, 1))
    grid = np.arange(S)[None, :]
    pos = np.stack([np.broadcast_to(base, (2, S)), base + grid // 16,
                    base + grid % 16 + rng.integers(0, 64, (2, 1))]
                   ).astype(np.int32)                          # (3, 2, S)
    x = _x(hd, (2, S, 3, hd))
    want = np.asarray(jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                          theta))
    got = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta, max_len).numpy()
    secs = common.mrope_sections(hd)
    assert sum(secs) == hd // 2 and (secs == [16, 24, 24]) == (hd == 128)
    scale = float(np.abs(x).max())
    slope = 1e-9 if theta > 1e4 else 0.0
    tol = scale * (ROPE_TOL + slope * pos.max(0)[:, :, None, None])
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_text_only_ids_rotate_to_rope_bits(hd):
    """t = h = w = position: every band gathers the RoPE table's own
    entries, so the rotation is ``apply_rope``'s, bit for bit."""
    x = torch.from_numpy(_x(hd + 1, (2, 40, 2, hd)))
    pos = torch.from_numpy(np.random.default_rng(hd).integers(
        0, 1000, (2, 40)))
    got = common.apply_mrope(x, pos[None].expand(3, 2, 40), 1e6, 1024)
    assert torch.equal(got, common.apply_rope(x, pos, 1e6, 1024))


def test_lm_loss_with_embeds_and_grads_match_jax(model):
    """8 frontend embeds prepended to 20 text tokens: logits (28
    positions), the loss over the text tail and every leaf's gradient
    against ``jax.grad``; the embeds' gradient too."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(2)
    toks, labels = (rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
                    for _ in range(2))
    embeds = rng.standard_normal((2, cfg.num_frontend_embeds, cfg.d_model),
                                 dtype=np.float32)
    want, _ = jax.jit(lambda p, t, e: jtr.lm_apply(p, jcfg, t, embeds=e))(
        jp, toks, embeds)
    got, _ = tr.lm_apply(tp, cfg, torch.from_numpy(toks).long(),
                         embeds=torch.from_numpy(embeds))
    assert got.shape == (2, 28, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    (jloss, jm), (jgrads, jgemb) = jax.jit(jax.value_and_grad(
        lambda p, e: jtr.lm_loss(p, jcfg, toks, labels, embeds=e),
        argnums=(0, 1), has_aux=True))(jp, embeds)
    flat = {k: v.clone().requires_grad_()
            for k, v in bridge.flatten(tp).items()}
    emb = torch.from_numpy(embeds).requires_grad_()
    loss, metrics = registry.get_model(cfg).loss(
        bridge.unflatten(flat), cfg,
        {"tokens": torch.from_numpy(toks).long(),
         "labels": torch.from_numpy(labels).long(), "embeds": emb})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]),
                               rtol=1e-5)
    jflat = bridge.flatten(jax.device_get(jgrads))
    assert jflat.keys() == flat.keys()
    for key, g in jflat.items():
        np.testing.assert_allclose(flat[key].grad.numpy(), g, atol=GRAD_TOL,
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(emb.grad.numpy(), np.asarray(jgemb),
                               atol=GRAD_TOL, rtol=1e-4)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_paged_serving_matches_jax_engine(model, kv):
    """Text-only continuous paged serving (chunked prefill, the paged
    decode, M-RoPE ids t = h = w) on the JAX weights: every token equals
    the JAX engine's, over f32 and over int8 pages."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(4)
    shapes = ((5, 7), (11, 4), (3, 9), (8, 5))
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        (p,)).astype(np.int32),
                    max_new_tokens=g) for p, g in shapes]
    jeng = jax_engine.ServeEngine(jcfg, jp,
                                  mesh=mesh_lib.single_device_mesh(),
                                  max_len=48, paged=True, block_size=4,
                                  kv_dtype=kv)
    want = jax_sched.ContinuousScheduler(
        jeng, max_batch=2, chunk_len=4, num_blocks=12).run(
        [jax_sched.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
         for r in reqs])
    eng = ServeEngine(cfg, tp, device="cpu", max_len=48, paged=True,
                      block_size=4, kv_dtype=kv)
    got = ContinuousScheduler(eng, max_batch=2, chunk_len=4,
                              num_blocks=12).run(reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
