"""The encoder-decoder in the port (``whisper-base``) against the JAX
package's, on the CPU, at its smoke size (2 + 2 layers, d_model 64, 4
heads of 16, 16 encoder frames, vocab 256).

Cross-framework, on the JAX init carried over by ``repro_torch.bridge``
(which carries ``enc_blocks``, ``enc_pos``, ``enc_final_norm`` and
``pos_embed`` both ways bit for bit) and the same numpy frames and tokens:
``sinusoidal_positions``; ``encode``; ``encdec_apply`` and ``encdec_loss``
with every gradient against ``jax.grad``; two Muon-NSGD ``make_train_step``
steps on batches that carry ``frames``; ``encdec_init_cache`` and eight
``encdec_decode_step`` steps; ``expand_params`` 2 -> 4 (``zero`` and the
copying methods bit for bit the reference's, encoder included) and
``truncate_params``; and the plain flash path at S_k != S_q (decoder
queries over more encoder frames, ragged blocks) against JAX's
``naive_attention`` and ``blocked_attention``.

In-port: greedy decoding through ``encdec_decode_step`` equals the
teacher-forced argmax of ``encdec_apply``; ``zero`` and ``copying_zeroL``
keep the function; ``ServeEngine`` and ``launch/serve.py`` refuse the
architecture with the reference's message and ``launch/train.py`` with
its own (the synthetic batches carry no frames); ``Generator`` (the
reference's ``tests/test_system.py:111``) is greedy-consistent.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs import base as jbase
from repro.core import expansion as jexp
from repro.core.schedules import make_schedule as jax_make_schedule
from repro.kernels.flash_attention import ref as jfa_ref
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.optim.base import make_optimizer as jax_make_optimizer
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch import configs
from repro_torch.configs import base as tbase
from repro_torch.core import expansion as exp
from repro_torch.core.schedules import make_schedule
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve, train
from repro_torch.models import common, encdec, registry
from repro_torch.optim.base import make_optimizer
from repro_torch.train import steps
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_lib import Generator

NAME = "whisper-base"
CFG = configs.get_smoke_config(NAME)
JCFG = jax_configs.get_smoke_config(NAME)
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


def _params(layers=None, seed=0):
    cfg = JCFG if layers is None else JCFG.with_depth(layers)
    jp = jax.device_get(jencdec.encdec_init(jax.random.PRNGKey(seed), cfg))
    return jp, bridge.params_from_jax(jp)


def _batch(B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab_size, (B, S + 1)).astype(np.int32)
    frames = rng.standard_normal((B, CFG.encoder_seq_len, CFG.d_model),
                                 dtype=np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": frames}


def _t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def test_config_and_params_carry_over():
    """The configs are the reference's, the tree's keys and shapes match
    the port's own init, and the bridge carries the encoder's leaves and
    the positions both ways bit for bit."""
    assert CFG == configs.get_smoke_config(NAME)
    jp, tp = _params()
    mine = encdec.encdec_init(torch.Generator().manual_seed(0), CFG,
                              device="cpu")
    assert {k: tuple(v.shape) for k, v in bridge.flatten(mine).items()} \
        == {k: v.shape for k, v in bridge.flatten(jp).items()}
    for key in ("enc_pos", "pos_embed", "enc_final_norm", "enc_blocks"):
        assert key in tp
    back = bridge.flatten(bridge.params_to_numpy(tp))
    for key, want in bridge.flatten(jp).items():
        assert back[key].dtype == want.dtype
        np.testing.assert_array_equal(back[key], want, err_msg=key)


def test_sinusoidal_positions_match_jax():
    """float32 sin and cos of the same float32 angles: one ulp apart at
    most, across frameworks' libm."""
    got = common.sinusoidal_positions(1500, 512, "cpu").numpy()
    want = np.asarray(jcommon.sinusoidal_positions(1500, 512))
    np.testing.assert_allclose(got, want, atol=2e-7 * 1500, rtol=0)
    assert got.shape == (1500, 512) and got.dtype == np.float32


def test_encode_apply_loss_and_grads_match_jax():
    """The encoder's output, the logits, the loss and every leaf's
    gradient (encoder, cross-attention and both position tables among
    them) against ``jax.grad``."""
    jp, tp = _params(seed=1)
    b = _batch(seed=2)
    want = jax.jit(lambda p, f: jencdec.encode(p, JCFG, f))(jp, b["frames"])
    got = encdec.encode(tp, CFG, torch.from_numpy(b["frames"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    want, _ = jax.jit(lambda p, t, f: jencdec.encdec_apply(p, JCFG, t, f))(
        jp, b["tokens"], b["frames"])
    got, aux = encdec.encdec_apply(tp, CFG, _t(b)["tokens"], _t(b)["frames"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    assert aux.item() == 0.0
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jencdec.encdec_loss(p, JCFG, b["tokens"], b["labels"],
                                      b["frames"]), has_aux=True))(jp)
    flat = {k: v.clone().requires_grad_()
            for k, v in bridge.flatten(tp).items()}
    loss, metrics = registry.get_model(CFG).loss(bridge.unflatten(flat), CFG,
                                                 _t(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert metrics["aux"].item() == 0.0
    jflat = bridge.flatten(jax.device_get(jgrads))
    assert jflat.keys() == flat.keys()
    for key, g in jflat.items():
        np.testing.assert_allclose(flat[key].grad.numpy(), g, atol=GRAD_TOL,
                                   rtol=1e-4, err_msg=key)


def test_train_steps_on_frames_match_jax():
    """Two Muon-NSGD steps under WSD through ``make_train_step`` on
    batches that carry ``frames`` (the reference's
    ``tests/test_models_smoke.py`` path): losses and params."""
    jp, tp = _params(seed=3)
    jopt = jax_make_optimizer(jbase.OptimizerConfig())
    opt = make_optimizer(tbase.OptimizerConfig())
    jstep = jsteps.make_train_step(
        JCFG, jopt, jax_make_schedule(jbase.ScheduleConfig(), 0.01, 10),
        donate=False)
    step = steps.make_train_step(
        CFG, opt, make_schedule(tbase.ScheduleConfig(), 0.01, 10))
    jstate, state = jopt.init(jp), opt.init(tp)
    for i in range(2):
        b = _batch(seed=10 + i)
        jp, jstate, jm = jstep(jp, jstate, jax.tree.map(jnp.asarray, b),
                               jnp.asarray(i))
        tp, state, m = step(tp, state, _t(b), i)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   atol=1e-5)
    got = bridge.flatten(bridge.params_to_numpy(tp))
    for key, w in bridge.flatten(jax.device_get(jp)).items():
        np.testing.assert_allclose(got[key], w, atol=1e-5, err_msg=key)


def test_decode_steps_match_jax_and_greedy_equals_teacher_forcing():
    """``encdec_init_cache`` (the cross K/V of the encoder's output) and
    eight ``encdec_decode_step`` steps against the JAX decode's logits,
    then greedy decoding of 8 tokens equals the argmax of
    ``encdec_apply`` over the tokens it produced."""
    jp, tp = _params(seed=4)
    b = _batch(seed=5)
    frames = b["frames"]
    enc = encdec.encode(tp, CFG, torch.from_numpy(frames))
    jenc = jencdec.encode(jp, JCFG, frames)
    cache = encdec.encdec_init_cache(tp, CFG, 2, 16, enc, torch.float32,
                                     device="cpu")
    jcache = jencdec.encdec_init_cache(jp, JCFG, 2, 16, jenc, jnp.float32)
    np.testing.assert_allclose(cache["cross_k"].numpy(),
                               np.asarray(jcache["cross_k"]), atol=LOGIT_TOL,
                               rtol=0)
    toks = b["tokens"][:, :8]
    for t in range(8):
        lg, cache = encdec.encdec_decode_step(
            tp, CFG, torch.from_numpy(toks[:, t:t + 1]).long(), cache,
            torch.full((2,), t))
        jlg, jcache = jencdec.encdec_decode_step(jp, JCFG, toks[:, t:t + 1],
                                                 jcache, jnp.int32(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                   atol=LOGIT_TOL, rtol=0)
    # greedy from a one-token prompt, then teacher forcing over the stream
    api = registry.get_model(CFG)
    cache = api.init_cache(tp, CFG, 2, 16, torch.float32, device="cpu",
                           enc_out=enc)
    out = [torch.from_numpy(toks[:, :1]).long()]
    for t in range(8):
        lg, cache = api.decode_step(tp, CFG, out[-1], cache,
                                    torch.full((2,), t))
        out.append(lg.argmax(-1))
    stream = torch.cat(out, dim=1)
    logits, _ = api.apply(tp, CFG, stream[:, :-1], torch.from_numpy(frames))
    assert torch.equal(logits.argmax(-1), stream[:, 1:])


@pytest.mark.parametrize("method", ["zero", "copying_zeroL", "copying_stack",
                                    "random"])
def test_expand_and_truncate_over_enc_blocks_match_jax(method):
    """2 -> 4 decoder layers: the encoder grows with it (to the fresh
    init's depth under ``zero``/``random``: 2 here, where the smoke
    config's 2 encoder layers scale with ``with_depth``'s num_layers; to
    the decoder's target under copying), leaf shapes as the reference's,
    deterministic methods bit for bit the reference's; ``zero`` and
    ``copying_zeroL`` keep the function; ``truncate_params`` keeps the
    whole encoder and cuts the decoder."""
    cfg2, jcfg2 = CFG.with_depth(2), JCFG.with_depth(2)
    jp, tp = _params(2, seed=6)
    want = jax.device_get(jexp.expand_params(jp, jcfg2, 4, method,
                                             key=jax.random.PRNGKey(0)))
    got = exp.expand_params(tp, cfg2, 4, method,
                            generator=torch.Generator().manual_seed(0))
    wflat, gflat = bridge.flatten(want), bridge.flatten(got)
    assert {k: v.shape for k, v in wflat.items()} \
        == {k: tuple(v.shape) for k, v in gflat.items()}
    assert wflat["['enc_blocks']['ln1']['scale']"].shape[0] == (
        4 if method.startswith("copying") else 2)
    if method != "random":
        for key, w in wflat.items():
            np.testing.assert_array_equal(gflat[key].numpy(), w, err_msg=key)
    b = _batch(seed=7)
    base, _ = encdec.encdec_apply(tp, cfg2, _t(b)["tokens"], _t(b)["frames"])
    grown, _ = encdec.encdec_apply(got, CFG.with_depth(4), _t(b)["tokens"],
                                   _t(b)["frames"])
    if method == "zero":
        # zero blocks add nothing to either stream: the encoder's new
        # layers and the decoder's keep the function exactly
        assert torch.equal(grown, base)
    elif method == "copying_zeroL":
        # new decoder blocks add nothing; the encoder's copied blocks run
        # again, so the function changes there (as in the reference)
        np.testing.assert_allclose(
            grown.numpy(), np.asarray(jencdec.encdec_apply(
                want, JCFG.with_depth(4), b["tokens"], b["frames"])[0]),
            atol=LOGIT_TOL, rtol=0)
    cut = exp.truncate_params(got, CFG.with_depth(4), 2)
    assert cut["enc_blocks"] is got["enc_blocks"]
    assert bridge.flatten(cut["blocks"])["['ln1']['scale']"].shape[0] == 2


@pytest.mark.parametrize("Sq,Sk", [(8, 32), (300, 1500), (17, 600)])
def test_flash_plain_path_takes_more_keys_than_queries(Sq, Sk):
    """Non-causal attention of Sq queries over Sk keys on the plain path
    (naive up to 256 queries, blocked past it, as the reference picks):
    against JAX's ``naive_attention`` and ``blocked_attention`` (whose
    ragged last block, 1500 = 2·512 + 476, adds nothing), GQA 4/2."""
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((2, Sq, 4, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, Sk, 2, 16), dtype=np.float32)
            for _ in range(2))
    got = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=False).numpy()
    for fn in (jfa_ref.naive_attention, jfa_ref.blocked_attention):
        want = np.asarray(fn(q, k, v, causal=False))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_serving_and_the_trainer_refuse_with_their_messages():
    """The engine serves decoder-only models (the reference's message,
    before any weight is drawn from the CLI); the trainer's synthetic
    batches carry no frames."""
    _, tp = _params()
    assert registry.get_model(CFG).prefill is None
    with pytest.raises(NotImplementedError, match="no prefill path"):
        ServeEngine(CFG, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        serve.main(["--arch", NAME, "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="carry no encoder 'frames'"):
        train.main(["--arch", NAME, "--smoke", "--device", "cpu"])


def test_generator_greedy_consistency():
    """The reference's ``tests/test_system.py:111`` on the port's
    ``Generator``: two greedy generations of 8 tokens are equal and equal
    the teacher-forced argmax of the full forward."""
    cfg = configs.get_smoke_config("gpt2-12l")
    api = registry.get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    gen = Generator(cfg, params, max_len=24, device="cpu")
    prompts = np.random.default_rng(0).integers(0, 256, (2, 4)).astype(
        np.int32)
    out = gen.generate(prompts, 8)
    assert out.tokens.shape == (2, 12)
    np.testing.assert_array_equal(out.tokens, gen.generate(prompts, 8).tokens)
    logits, _ = api.apply(params, cfg, torch.from_numpy(
        out.tokens[:, :-1]).long())
    greedy = logits[:, 3:].argmax(-1).numpy()
    np.testing.assert_array_equal(out.tokens[:, 4:], greedy)
