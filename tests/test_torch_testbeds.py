"""The RoPE architectures in the port against the JAX package's, on the CPU:
the paper's §B testbeds (``llama3-0.3b``, ``qwen3-0.3b`` with qk-norm and
tied weights, ``mixtral-0.3b`` with 8 experts top-2) and the registry's
``yi-34b`` (GQA 56/8, θ 5e6), ``starcoder2-3b`` (GQA 24/2, LayerNorm,
GELU, tied), ``deepseek-moe-16b`` and ``moonshot-v1-16b-a3b`` (64 experts
top-6, 2 shared), each at its smoke size (2 layers, d_model 64, 4 heads of
16, vocab 256; 8 experts top-2 and one shared).

Cross-framework, on the JAX init carried over by ``repro_torch.bridge``
and the same numpy tokens: the configs, logits (``LOGIT_TOL``, at
positions near the full configs' ``max_seq_len`` too), loss and
``jax.grad`` (``GRAD_TOL``; float32 sums in other orders through two
layers), and ``moe_apply`` at the full configs' expert counts (64 top-6
with 2 shared, 8 top-2), prefill and T = B decode, capacity drops
included.  In-port: the reference's decode-matches-forward contract of
``tests/test_paper_testbeds.py``; depth expansion over the qk-norm
leaves, the untied head and the MoE layers (``zero`` and
``copying_zeroL`` keep the function, and the truncated ``copying_zeroL``
draft is bitwise the source); the architectures still refused, each
naming its ROADMAP item; ``yi-34b`` refused on one card before any weight
is drawn; the launchers on the CPU.
"""
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch import configs
from repro_torch.configs import paper_testbeds
from repro_torch.core import expansion as exp
from repro_torch.launch import mesh as torch_mesh
from repro_torch.launch import serve, train
from repro_torch.models import attention, mlp, registry
from repro_torch.models import transformer as tr

NAMES = ("llama3-0.3b", "qwen3-0.3b", "mixtral-0.3b", "yi-34b",
         "starcoder2-3b", "deepseek-moe-16b", "moonshot-v1-16b-a3b",
         "deepseekv3-0.3b")
TESTBEDS = NAMES[:3]
LOGIT_TOL = 1e-5
# Gradients: absolute, plus 1e-4 relative (float32 sums in other orders).
GRAD_TOL = 1e-5


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
    assert set(configs.PORTED_ARCHS) >= set(NAMES)


@pytest.mark.parametrize("name,item", [
    ("deepseekv3-0.3b", "MLA sliding-window rings are not served"),
    ("whisper-base", "no prefill path"),
    # The mesh is ported (item 13), continuous serving on it too (item
    # 20), and crash snapshots on a mesh (item 22): the case now serves.
    # The id stays the case's old one.
    pytest.param("qwen2-vl-2b", None,
                 id="qwen2-vl-2b-mesh sharding: ROADMAP queue A item 13")])
def test_the_rest_still_raises_naming_its_item(name, item):
    """The last three architectures of the reference registry now have
    configs equal to the reference's; what they still refuse: an MLA
    sliding-window ring (the reference refuses it) and serving the
    encoder-decoder (the reference's message).  Crash snapshots in
    continuous serving on a mesh (``--mesh`` with ``--continuous
    --snapshot-every``), once refused, serve ``qwen2-vl-2b`` to the end
    on a one-rank 'host' mesh."""
    assert dataclasses.asdict(configs.get_config(name)) \
        == dataclasses.asdict(jax_configs.get_config(name))
    assert name in configs.PORTED_ARCHS and name in configs.ARCH_HELP
    argv = ["--arch", name, "--smoke", "--device", "cpu"]
    if name == "deepseekv3-0.3b":
        cfg = dataclasses.replace(configs.get_smoke_config(name),
                                  window_pattern=(8,))
        p = attention.attn_init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        x = torch.zeros((1, 4, cfg.d_model))
        pos = torch.arange(4)[None, :]
        with pytest.raises(NotImplementedError, match=item):
            attention.attn_prefill_chunk(p, cfg, x, {}, 0, pos, window=8)
        with pytest.raises(NotImplementedError, match=item):
            attention.attn_verify_chunk(p, cfg, x, {}, torch.zeros(1).long(),
                                        pos, 8, None)
        return
    if name == "qwen2-vl-2b":
        argv += ["--mesh", "host", "--continuous", "--snapshot-every", "1",
                 "--requests", "3", "--gen", "4", "--rate", "1000"]
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                results = serve.main(argv)
        finally:
            torch_mesh.close_world()   # the one-rank world of '--mesh'
        assert [r.finish_reason for r in results] == ["limit"] * 3
        return
    with pytest.raises((SystemExit, NotImplementedError), match=item):
        serve.main(argv)


def test_deepseekv3_is_listed_but_refused_naming_mla():
    """``deepseekv3-0.3b`` is no longer refused: the registry admits it
    and its attention carries the latent projections (wkv_a (D, r),
    wkv_b (r, 2 KV hd)) in place of wk and wv."""
    cfg = paper_testbeds.PAPER_TESTBEDS["deepseekv3-0.3b"]
    assert configs.get_config("deepseekv3-0.3b") is cfg
    registry.get_model(cfg)
    p = attention.attn_init(None, cfg, device="meta")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wq": (512, 512), "wkv_a": (512, 128), "wkv_b": (128, 512),
        "wo": (512, 512)}


@pytest.mark.parametrize("name", NAMES)
def test_logits_loss_and_grads_match_jax(name):
    """Logits and aux (the MoE losses) of a (2, 20) batch, then the loss and
    every leaf's gradient (qk-norm scales, the untied head, router, expert
    stacks and shared experts among them) against ``jax.grad``."""
    jcfg, cfg, jp, tp = _params(name, seed=len(name))
    toks, labels = _tokens(2, 20, 1), _tokens(2, 20, 2)
    want, jaux = jax.jit(lambda p, t: jtr.lm_apply(p, jcfg, t))(jp, toks)
    got, aux = tr.lm_apply(tp, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5, atol=1e-9)
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


@pytest.mark.parametrize("name", ["llama3-0.3b", "starcoder2-3b",
                                  "yi-34b"])
def test_logits_at_positions_near_max_seq_len_match_jax(name):
    """The smoke widths at the full config's max_seq_len (1024, 16384 and,
    at θ 5e6, 32768): a (2, 20) batch at the last 20 positions below it,
    logits within ``LOGIT_TOL`` of JAX's (the frameworks' f32 sin/cos of
    angles up to ~32767 rad differ by at most an ulp of the rotation)."""
    L = configs.get_config(name).max_seq_len
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(name),
                               max_seq_len=L)
    cfg = dataclasses.replace(configs.get_smoke_config(name), max_seq_len=L)
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(3), jcfg))
    toks = _tokens(2, 20, 4)
    pos = np.broadcast_to(np.arange(L - 20, L)[None], (2, 20)).copy()
    want, _ = jax.jit(lambda p, t, q: jtr.lm_apply(p, jcfg, t, positions=q))(
        jp, toks, pos)
    got, _ = tr.lm_apply(bridge.params_from_jax(jp), cfg,
                         torch.from_numpy(toks).long(),
                         positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)


def test_bridge_carries_the_new_leaves_bit_exactly():
    for name in ("qwen3-0.3b", "llama3-0.3b", "deepseek-moe-16b"):
        _, _, jp, tp = _params(name)
        flat = bridge.flatten(tp)
        assert any("q_norm" in k for k in flat) == (name == "qwen3-0.3b")
        assert ("['lm_head']" in flat) == (name != "qwen3-0.3b")
        back = bridge.params_to_numpy(tp)
        for key, want in bridge.flatten(jp).items():
            assert np.array_equal(bridge.flatten(back)[key], want), key


@pytest.mark.parametrize("experts,top_k,shared,T", [
    (64, 6, 2, (2, 24)), (64, 6, 2, (8, 1)), (8, 2, 0, (2, 24)),
    (8, 2, 0, (8, 1))], ids=["64x6+2-prefill", "64x6+2-decode",
                             "8x2-prefill", "8x2-decode"])
def test_moe_apply_at_the_full_expert_counts_matches_jax(experts, top_k,
                                                         shared, T):
    """deepseek-moe/moonshot's and mixtral's routing at smoke widths (numpy
    weights of the init's scale, the reference's layout): y and both
    auxiliary losses, a prefill of 48 tokens (capacity 5 at 64 x 6, so
    experts drop tokens) and a T = B = 8 decode step (capacity 4)."""
    base = configs.get_smoke_config("mixtral-0.3b")
    moe = dataclasses.replace(base.moe, num_experts=experts, top_k=top_k,
                              num_shared_experts=shared)
    cfg = dataclasses.replace(base, moe=moe)
    jcfg = dataclasses.replace(jax_configs.get_smoke_config("mixtral-0.3b"),
                               moe=dataclasses.replace(
                                   jax_configs.get_smoke_config(
                                       "mixtral-0.3b").moe,
                                   num_experts=experts, top_k=top_k,
                                   num_shared_experts=shared))
    rng = np.random.default_rng(experts + T[1])

    def dense(*shape):
        return (rng.standard_normal(shape, dtype=np.float32)
                / np.float32(np.sqrt(shape[-2])))
    jp = {"router": dense(64, experts), "w_gate": dense(experts, 64, 32),
          "w_up": dense(experts, 64, 32), "w_down": dense(experts, 32, 64)}
    if shared:
        jp["shared"] = {"w_gate": dense(64, 32 * shared),
                        "w_up": dense(64, 32 * shared),
                        "w_down": dense(32 * shared, 64)}
    x = np.random.default_rng(T[0]).standard_normal(
        T + (64,), dtype=np.float32)
    y, aux = mlp.moe_apply(bridge.params_from_jax(jp), cfg,
                           torch.from_numpy(x))
    jy, jaux = jax.jit(lambda p, x: jmlp.moe_apply(p, jcfg, x))(jp, x)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    for key in ("aux_loss", "router_zloss"):
        np.testing.assert_allclose(aux[key].item(), float(jaux[key]),
                                   rtol=1e-5, err_msg=key)


def _reduce(cfg):
    """``tests/test_paper_testbeds.py``'s reduction."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, num_experts=4, top_k=2,
                                  expert_ffn_dim=32, capacity_factor=100.0,
                                  num_shared_experts=min(
                                      1, moe.num_shared_experts))
    return dataclasses.replace(
        cfg, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=128, max_seq_len=64, moe=moe)


@pytest.mark.parametrize("name", TESTBEDS)
def test_testbed_decode_matches_forward(name):
    """The reference's contract, in-port: eight decode steps against the
    contiguous cache give the forward's logits (its bound, 5e-3; here
    float32 sums in other orders)."""
    cfg = _reduce(configs.get_config(name))
    api = registry.get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(_tokens(2, 8, 1, vocab=128)).long()
    logits, _ = api.apply(params, cfg, toks)
    assert torch.isfinite(logits).all()
    cache = api.init_cache(params, cfg, 2, 16, dtype=torch.float32,
                           device="cpu")
    outs = []
    for t in range(8):
        lg, cache = api.decode_step(params, cfg, toks[:, t:t + 1], cache,
                                    torch.tensor(t))
        outs.append(lg[:, 0])
    err = float((torch.stack(outs, 1) - logits).abs().max())
    assert err < 5e-3, (name, err)


@pytest.mark.parametrize("name", ["qwen3-0.3b", "llama3-0.3b",
                                  "mixtral-0.3b"])
def test_expansion_keeps_the_function_and_the_draft_is_the_source(name):
    """A 1-layer smoke model expanded to 3 by ``zero`` and by
    ``copying_zeroL``: the same logits bit for bit (the new layers' residual
    branches are exactly 0; MoE capacity 100 so that no token drops); the
    copying_zeroL result truncated back to 1 layer is bitwise the source."""
    cfg = dataclasses.replace(configs.get_smoke_config(name),
                              num_layers=1)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=100.0))
    p1 = registry.get_model(cfg).init(torch.Generator().manual_seed(2), cfg,
                                      device="cpu")
    toks = torch.from_numpy(_tokens(2, 12, 3)).long()
    want, _ = tr.lm_apply(p1, cfg, toks)
    for method in ("zero", "copying_zeroL"):
        p3 = exp.expand_params(p1, cfg, 3, method)
        got, _ = tr.lm_apply(p3, cfg.with_depth(3), toks)
        assert torch.equal(got, want), method
    p3 = exp.expand_params(p1, cfg, 3, "copying_zeroL")
    draft = exp.truncate_params(p3, cfg.with_depth(3), 1)
    for key, leaf in bridge.flatten(p1).items():
        assert torch.equal(bridge.flatten(draft)[key], leaf), key


def _run(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(argv)
    return res, out.getvalue()


def test_serve_cli_refuses_yi_34b_on_one_card(monkeypatch):
    """Full-depth yi-34b (60 layers, ~138 GB of float32 weights) is
    refused before any weight is drawn, with the way out named."""
    class Props:
        total_memory = 80 * 10 ** 9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: Props())
    with pytest.raises(SystemExit, match=r"yi-34b at 60 layers holds 13\d\.\d"
                                         r" GB.*fewer layers"):
        serve.main(["--arch", "yi-34b"])


def test_launchers_take_the_new_archs_on_the_cpu():
    """Continuous paged serving of qwen3 with speculation and progressive
    training of llama3 through the CLIs, smoke size."""
    _, out = _run(serve.main, [
        "--arch", "qwen3-0.3b", "--smoke", "--device", "cpu", "--continuous",
        "--paged", "--spec-depth", "1", "--gamma", "3", "--max-batch", "2",
        "--requests", "4", "--block-size", "4", "--chunk-len", "4",
        "--rate", "1000", "--invariant-every", "1"])
    assert "arch=qwen3-0.3b-smoke" in out and "speculative:" in out
    res, out = _run(train.main, [
        "--arch", "llama3-0.3b", "--smoke", "--device", "cpu", "--steps",
        "4", "--tau", "0.5", "--source-layers", "1", "--seq-len", "16",
        "--batch", "4"])
    assert "[expand]" in out and res.final_layers == 2
    assert np.isfinite(res.history["loss"]).all()
