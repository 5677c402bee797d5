"""The port's Mamba blocks, MoE feed-forward and the jamba hybrid stack
against the JAX package's, on the CPU at smoke size (``jamba-v0.1-52b``
smoke: one period of 8 layers, Mamba at offsets 0-3 and 5-7 with d_state 4,
GQA attention (4 heads of 16, 2 KV heads) at offset 4, MoE of 8 experts of
width 32, top-2, on the odd layers; d_model 64, vocab 256), and an
all-Mamba stack (the reference's serving test config).

Both sides get the same parameters (the JAX init, carried over by
``repro_torch.bridge``) and the same numpy inputs.  Tolerances: 1e-5 for
one block's outputs and states (float32 sums in other orders, O(1)
activations), 1e-4 for logits after the stack and for served logits (the
CPU takes the chunked scan from 64 positions on, whose products of decays
run in another order than the per-step form's).  A greedy token is only
defined where its top-2 margin exceeds the logit tolerance; the serving
tests assert the margin, so a flip fails as a margin, never silently.
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
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.launch import mesh as mesh_lib
from repro.launch import serve as jax_serve
from repro.models import mlp as jmlp
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.train.serve_engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch import configs
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.launch import serve
from repro_torch.models import mlp
from repro_torch.models import registry
from repro_torch.models import ssm
from repro_torch.models import transformer as tr
from repro_torch.train.serve_engine import ServeEngine

CFG = configs.get_smoke_config("jamba-v0.1-52b")
JCFG = jax_configs.get_smoke_config("jamba-v0.1-52b")
TOL = 1e-5           # one block
LOGIT_TOL = 1e-4     # after the stack

_MAMBA_ONLY = dict(name="t-mamba", family="ssm", num_layers=4, d_model=32,
                   num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                   max_seq_len=96, attention="none", position="none",
                   block_pattern=("mamba",))
MAMBA = ModelConfig(**_MAMBA_ONLY, ssm=SSMConfig(d_state=4))
JMAMBA = JModelConfig(**_MAMBA_ONLY, ssm=JSSMConfig(d_state=4))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these ops are tiny, and on a shared CPU many
    threads make them several times slower.  Every comparison here is
    between runs under the same setting, or within a stated tolerance."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_drop(cfg):
    """``cfg`` with an MoE capacity of every token (capacity factor E/K):
    no token is dropped at any length, so one prefill equals a
    token-by-token decode, as for a dense feed-forward."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def _port(tree):
    return bridge.params_from_jax(jax.device_get(tree))


def _params(jcfg=JCFG, seed=0, n_layers=None):
    jp = jtr.lm_init(jax.random.PRNGKey(seed), jcfg, num_layers=n_layers)
    return jax.device_get(jp), _port(jp)


def _x(B, S, seed, D=CFG.d_model, shift=0.0):
    return (np.random.default_rng(seed).standard_normal((B, S, D))
            + shift).astype(np.float32)


def _tokens(B, S, seed=0, vocab=CFG.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def _mamba_state(B, seed):
    """A nonzero decode state, as numpy (JAX) and tensors (port)."""
    rng = np.random.default_rng(seed)
    d_inner, _, d_state, d_conv = ssm.mamba_dims(CFG)
    st = {"conv": rng.standard_normal((B, d_conv - 1, d_inner)),
          "ssm": rng.standard_normal((B, d_inner, d_state))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    return st, {k: torch.from_numpy(v.copy()) for k, v in st.items()}


def _close_states(got, want, tol=TOL):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == torch.float32, key
        _close(got[key], want[key], tol)


def _mamba_block(seed):
    jp = jax.device_get(jssm.mamba_init(jax.random.PRNGKey(seed), JCFG))
    return jp, _port(jp)


def test_config_copy_matches_reference():
    for get in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jax_configs, get)("jamba-v0.1-52b"))
        got = dataclasses.asdict(getattr(configs, get)("jamba-v0.1-52b"))
        assert got == want
    assert ssm.mamba_dims(CFG) == jssm.mamba_dims(JCFG) == (128, 4, 4, 4)
    assert CFG.moe.num_experts == 8 and CFG.moe.expert_ffn_dim == 32


@pytest.mark.parametrize("S", [9, 70])
def test_mamba_apply_matches_jax_in_both_branches(S):
    """The full-sequence branch (zero left context, the train forward) and
    the state branch (serve prefill, its new conv/ssm state); S = 70 takes
    the chunked scan on both sides."""
    jp, tp = _mamba_block(seed=S)
    x = _x(2, S, seed=S)
    _close(ssm.mamba_apply(tp, CFG, torch.from_numpy(x)),
           jssm.mamba_apply(jp, JCFG, x), TOL)
    jst, tst = _mamba_state(2, seed=S)
    y, st = ssm.mamba_prefill(tp, CFG, torch.from_numpy(x), tst)
    jy, jst2 = jssm.mamba_prefill(jp, JCFG, x, jst)
    _close(y, jy, TOL)
    _close_states(st, jst2)


def test_mamba_decode_matches_jax():
    jp, tp = _mamba_block(seed=6)
    x = _x(3, 1, seed=7)
    jst, tst = _mamba_state(3, seed=8)
    for _ in range(3):                       # a few steps of carried state
        y, tst = ssm.mamba_decode(tp, CFG, torch.from_numpy(x.copy()), tst)
        jy, jst = jssm.mamba_decode(jp, JCFG, x, jst)
        _close(y, jy, TOL)
        _close_states(tst, jst)
        x = np.asarray(jy)


def _moe_case(shared: bool, overflow: bool, B=2, S=40, seed=0):
    """MoE params and inputs.  ``overflow`` points every token's router
    logits at expert 0 (inputs shifted by +1, router column 0 along the
    all-ones direction), so expert 0 gets every token of a group and drops
    all past its capacity."""
    cfg = dataclasses.replace(JCFG, moe=dataclasses.replace(
        JCFG.moe, num_shared_experts=1 if shared else 0))
    jp = jax.device_get(jmlp.moe_init(jax.random.PRNGKey(seed), cfg))
    x = _x(B, S, seed=seed + 1, shift=1.0 if overflow else 0.0)
    if overflow:
        jp["router"] = np.array(jp["router"])
        jp["router"][:, 0] = 0.5
    tcfg = dataclasses.replace(CFG, moe=dataclasses.replace(
        CFG.moe, num_shared_experts=1 if shared else 0))
    return cfg, tcfg, jp, _port(jp), x


@pytest.mark.parametrize("shared,overflow", [(False, False), (True, False),
                                             (True, True)])
def test_moe_apply_matches_jax(shared, overflow):
    """y and both auxiliary losses; with ``overflow`` the dispatch drops
    tokens, and the same ones: the stable sort orders an expert's
    (token, choice) pairs as jnp.argsort does."""
    jcfg, tcfg, jp, tp, x = _moe_case(shared, overflow)
    y, aux = mlp.moe_apply(tp, tcfg, torch.from_numpy(x))
    jy, jaux = jmlp.moe_apply(jp, jcfg, x)
    _close(y, jy, TOL)
    for key in ("aux_loss", "router_zloss"):
        np.testing.assert_allclose(aux[key].item(), float(jaux[key]),
                                   rtol=1e-5, err_msg=key)
    if overflow:
        # Each group of 40 tokens sends all of them to expert 0, whose
        # capacity is 12: 28 are dropped from it per group.
        logits = np.einsum("gtd,de->gte", x.reshape(2, 40, -1), jp["router"])
        assert (logits.argmax(-1) == 0).all()
        assert mlp._capacity(40, tcfg.moe) == 12


def test_moe_groups_and_capacity_follow_the_reference():
    for B, S, groups in ((4, 1, 1), (4, 1024, 4), (1, 128, 1), (32, 8, 16),
                         (3, 6, 3), (20, 1, 4)):
        assert mlp._num_groups(B, S, 0) == groups, (B, S)
    moe = configs.get_config("jamba-v0.1-52b").moe
    assert mlp._capacity(1024, moe) == 160 and mlp._capacity(4, moe) == 4


@pytest.mark.parametrize("S", [20, 70])
def test_lm_apply_and_loss_match_jax(S):
    """jamba-smoke logits and aux (MoE losses summed over the 4 MoE
    layers), and ``lm_loss``."""
    jp, tp = _params(seed=10 + S)
    toks = _tokens(2, S, seed=S)
    labels = _tokens(2, S, seed=S + 1)
    got, aux = tr.lm_apply(tp, CFG, torch.from_numpy(toks).long())
    want, jaux = jtr.lm_apply(jp, JCFG, toks)
    _close(got, want, LOGIT_TOL)
    assert aux.item() > 0
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    loss, parts = tr.lm_loss(tp, CFG, torch.from_numpy(toks).long(),
                             torch.from_numpy(labels).long())
    jloss, jparts = jtr.lm_loss(jp, JCFG, toks, labels)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(parts["ce"].item(), float(jparts["ce"]),
                               rtol=1e-5)


def test_lm_loss_grads_match_jax():
    """``lm_loss`` on the CPU through autograd of the plain scan forms and
    the MoE dispatch, against ``jax.grad`` of the reference."""
    jp, tp = _params(seed=12)
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
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for key, g in bridge.flatten(jax.device_get(jgrads)).items():
        np.testing.assert_allclose(flat[key].grad.numpy(), g, atol=TOL,
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("cfg", [_no_drop(CFG), MAMBA],
                         ids=["jamba-no-drop", "mamba"])
def test_prefill_then_decode_equals_token_by_token_decode(cfg):
    """In-port: prefill P tokens then decode the rest, against decoding
    every token one at a time from an empty cache; each position's logits
    agree.  (With capacity drops one prefill and single-token decodes
    route different token sets, as in the reference, so the jamba case
    gives every token a slot.)"""
    tp = tr.lm_init(torch.Generator().manual_seed(13), cfg, device="cpu")
    toks = torch.from_numpy(_tokens(2, 72, seed=3,
                                    vocab=cfg.vocab_size)).long()
    P = 66
    steps = []
    cache = tr.lm_init_cache(tp, cfg, 2, 80, torch.float32, device="cpu")
    for t in range(toks.shape[1]):
        logits, cache = tr.lm_decode_step(tp, cfg, toks[:, t:t + 1], cache, t)
        steps.append(logits[:, 0])
    full, _ = tr.lm_apply(tp, cfg, toks)
    _close(full, torch.stack(steps, dim=1), LOGIT_TOL)
    cache = tr.lm_init_cache(tp, cfg, 2, 80, torch.float32, device="cpu")
    logits, cache = tr.lm_prefill(tp, cfg, toks[:, :P], cache)
    _close(logits, torch.stack(steps[:P], dim=1), LOGIT_TOL)
    for t in range(P, toks.shape[1]):
        step, cache = tr.lm_decode_step(tp, cfg, toks[:, t:t + 1], cache, t)
        _close(step[:, 0], steps[t], LOGIT_TOL)


def test_cache_keeps_the_mamba_state_float32():
    _, tp = _params()
    cache = tr.lm_init_cache(tp, CFG, 3, 40, torch.bfloat16, device="cpu")
    d_inner, _, d_state, d_conv = ssm.mamba_dims(CFG)
    want = {"conv": (1, 3, d_conv - 1, d_inner),
            "ssm": (1, 3, d_inner, d_state)}
    assert {k: tuple(v.shape) for k, v in cache["layer0"].items()} == want
    assert all(v.dtype == torch.float32 and not v.any()
               for v in cache["layer0"].values())
    assert cache["layer4"]["k"].dtype == torch.bfloat16


def test_bridge_round_trip_is_bit_exact():
    """Mamba leaves and the stacked expert leaves (n_super, E, ., .) go
    to the port and back unchanged."""
    jp, tp = _params(jcfg=JCFG.with_depth(16), seed=14)
    assert tp["blocks"]["layer1"]["moe"]["w_gate"].shape == (2, 8, 64, 32)
    assert tp["blocks"]["layer0"]["mamba"]["A_log"].shape == (2, 128, 4)
    back = bridge.params_to_numpy(tp)
    flat_j, flat_b = bridge.flatten(jp), bridge.flatten(back)
    assert flat_j.keys() == flat_b.keys()
    for key, want in flat_j.items():
        np.testing.assert_array_equal(flat_b[key], np.asarray(want),
                                      err_msg=key)
    module = registry.ParamModule(tp)
    assert "blocks.layer1.moe.w_down" in module.state_dict()
    assert "blocks.layer0.mamba.dt_bias" in module.state_dict()


@pytest.mark.parametrize("P", [10, 70])
@pytest.mark.parametrize("arch", ["jamba", "mamba"])
def test_greedy_generate_matches_jax_engine(P, arch):
    """Greedy tokens and per-step logits of the port's engine on the CPU
    against the JAX ServeEngine, below and above S = 64 (the per-step and
    the chunked scan); the jamba prompt overflows experts in the
    prefill, so the dispatch drops the same tokens on both sides."""
    cfg, jcfg = (CFG, JCFG) if arch == "jamba" else (MAMBA, JMAMBA)
    seed = 20 + P + (0 if arch == "jamba" else 100)
    jp, tp = _params(jcfg=jcfg, seed=seed)
    prompts = _tokens(2, P, seed=seed, vocab=cfg.vocab_size)
    G = 6
    want = JaxServeEngine(jcfg, jp, mesh=mesh_lib.single_device_mesh(),
                          max_len=P + G + 1).generate(prompts, G,
                                                      return_logits=True)
    before = scan_ops.KERNEL_LAUNCHES
    got = ServeEngine(cfg, tp, device="cpu", max_len=P + G + 1).generate(
        prompts, G, return_logits=True)
    assert scan_ops.KERNEL_LAUNCHES == before
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
    """A JAX-written jamba-smoke checkpoint (one period): the port serves
    it at the manifest's depth and samples the JAX CLI's greedy tokens
    (both draw prompts from the same seed)."""
    jp, _ = _params(seed=15)
    jax_ckpt.save(str(tmp_path), 5, {"params": jp},
                  metadata={"num_layers": 8})
    argv = ["--arch", "jamba-v0.1-52b", "--smoke", "--checkpoint",
            str(tmp_path), "--batch", "2", "--prompt-len", "8", "--gen", "6",
            "--seed", "4"]
    out = _run(serve.main, argv + ["--device", "cpu"])
    want = _run(jax_serve.main, argv)
    assert "arch=jamba-v0.1-52b-smoke layers=8" in out

    def sample(text):
        return [line for line in text.splitlines()
                if line.startswith("sample:")]
    assert sample(out) == sample(want) and sample(out)


def test_serve_cli_refuses_continuous_naming_its_item():
    """Recurrent carries in continuous serving (ROADMAP item 17) are
    ported, so jamba serves continuously, contiguous and paged: its seven
    Mamba layers keep per-row state beside the attention layer's pool and
    thread a B=1 carry through chunked prefill (the name is the old
    test's)."""
    for extra in (["--continuous"], ["--continuous", "--paged"]):
        out = _run(serve.main, ["--arch", "jamba-v0.1-52b", "--smoke",
                                "--device", "cpu", "--max-batch", "2",
                                "--requests", "3", "--prompt-len", "8",
                                "--gen", "4", "--block-size", "4",
                                "--rate", "1000"] + extra)
        assert "aggregate tokens/s=" in out and out.count("tok (limit)") == 3
    _, tp = _params()
    cache = tr.lm_init_paged_cache(tp, CFG, 2, 8, 4, 32, device="cpu")
    carry = tr.lm_init_prefill_carry(tp, CFG, 32, device="cpu")
    for i in range(CFG.pattern_period):
        if CFG.layer_kind(i) == "attn":
            assert set(cache[f"layer{i}"]) == {"k_pages", "v_pages"}
            assert carry[f"layer{i}"] == {}
        else:
            assert set(cache[f"layer{i}"]) == set(carry[f"layer{i}"]) \
                == {"conv", "ssm"}
            assert cache[f"layer{i}"]["ssm"].shape[1] == 2
            assert carry[f"layer{i}"]["ssm"].shape[1] == 1


def test_random_init_shapes_and_scales():
    """The port draws its own weights (torch.Generator): keys and shapes
    equal the reference's, the scales follow the same init rules."""
    jp, _ = _params()
    tp = tr.lm_init(torch.Generator().manual_seed(0), CFG, device="cpu")
    flat_j, flat_t = bridge.flatten(jp), bridge.flatten(tp)
    assert flat_j.keys() == flat_t.keys()
    for key, want in flat_j.items():
        assert tuple(flat_t[key].shape) == want.shape, key
    blk = tp["blocks"]["layer0"]["mamba"]
    jblk = jp["blocks"]["layer0"]["mamba"]
    for key in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(blk[key].numpy(), jblk[key], atol=1e-6)
    dt = torch.nn.functional.softplus(blk["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert abs(float(blk["dt_proj"].std()) - 1.0) < 0.1
    assert abs(float(blk["conv_w"].std()) - 0.5) < 0.1
    w = tp["blocks"]["layer1"]["moe"]["w_gate"]
    assert abs(float(w.std()) * CFG.d_model ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("arch,layers", [("gpt2-12l", 1), ("gpt2-12l", 3),
                                         ("rwkv6-7b", 2),
                                         ("jamba-v0.1-52b", 16)])
def test_lm_init_stacks_the_same_tree_leaf_by_leaf(arch, layers):
    """``lm_init`` stacks the super-blocks leaf by leaf: the same seed
    gives exactly the tree the whole-tree ``torch.stack`` of the drawn
    super-blocks gives (the draw order is unchanged), and one super-block
    is a view of its draws."""
    cfg = configs.get_smoke_config(arch).with_depth(layers)
    got = tr.lm_init(torch.Generator().manual_seed(7), cfg, device="cpu")
    gen = torch.Generator().manual_seed(7)
    want = tr.lm_init(gen, cfg.with_depth(0), device="cpu")
    blocks = [tr.superblock_init(gen, cfg, device="cpu")
              for _ in range(layers // cfg.pattern_period)]
    want["blocks"] = tr.tree_map(lambda *xs: torch.stack(xs), *blocks)
    flat_g, flat_w = bridge.flatten(got), bridge.flatten(want)
    assert flat_g.keys() == flat_w.keys()
    for key, w in flat_w.items():
        assert torch.equal(flat_g[key], w), key
    if layers == cfg.pattern_period:
        leaf = next(iter(bridge.flatten(got["blocks"]).values()))
        assert leaf._base is not None          # unsqueeze(0) of the draw


def test_serve_cli_refuses_weights_the_card_cannot_hold(monkeypatch):
    """Full-depth jamba (206 GB of float32 weights) is refused before any
    weight is drawn, with the way out named."""
    class Props:
        total_memory = 80 * 10 ** 9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: Props())
    with pytest.raises(SystemExit, match="fewer layers"):
        serve.main(["--arch", "jamba-v0.1-52b"])
