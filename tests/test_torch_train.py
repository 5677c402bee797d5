"""The port's training path against the JAX package's, on the CPU at smoke
size (``gpt2-12l`` smoke: 2 layers, d_model 64, 4 heads of 16, vocab 256).

Both sides get the same params (the JAX init or a JAX checkpoint, carried
over by ``repro_torch.bridge``) and the same numpy batches.  Tolerances,
absolute, stated per test, cover float32 sums taken in other orders by XLA
and PyTorch, which Muon's Newton–Schulz amplifies over steps:

  * loss and cross entropy: 1e-5 (O(5) values, one forward);
  * gradients: 1e-5 absolute plus 1e-4 relative;
  * train-step params after three steps: 1e-5; losses 1e-5;
  * the resumed end-to-end run: losses within 2e-4 over six steps through
    an expansion (each lr-scaled Muon step moves every weight by ~1e-2).

In-port invariants are exact: bit-identical synthetic batches and a
resumed run byte-identical to the uninterrupted one.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.checkpoint import checkpointer as jckpt
from repro.configs import base as jbase
from repro.core.schedules import make_schedule as jax_make_schedule
from repro.data import synthetic as jsyn
from repro.kernels.flash_attention import ref as jax_fa_ref
from repro.models import common as jcommon
from repro.models import registry as jax_registry
from repro.models import transformer as jtr
from repro.optim.base import make_optimizer as jax_make_optimizer
from repro.train import loop as jloop
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch import configs
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import base as tbase
from repro_torch.core.schedules import make_schedule
from repro_torch.data import synthetic as syn
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import common
from repro_torch.models import transformer as tr
from repro_torch.optim.base import make_optimizer
from repro_torch.train import loop
from repro_torch.train import steps

CFG = configs.get_smoke_config("gpt2-12l")
JCFG = jax_configs.get_smoke_config("gpt2-12l")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these ops are tiny, and on a shared CPU many
    threads make them several times slower.  Every comparison here is
    between runs under the same setting, or within a stated tolerance."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(layers, seed=0):
    jp = jtr.lm_init(jax.random.PRNGKey(seed), JCFG, num_layers=layers)
    return jp, bridge.params_from_jax(jax.device_get(jp))


def _batch(B=4, S=32, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = 3 * rng.standard_normal((2, 8, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) < 0.6).astype(np.float32)
    for m, cap in ((None, 0.0), (mask, 0.0), (mask, 5.0),
                   (np.zeros_like(mask), 0.0)):
        want = jcommon.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m), final_softcap=cap)
        got = common.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m), final_softcap=cap)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("layers", [0, 1, 2])
def test_lm_loss_and_grads_match_jax(layers):
    jp, tp = _params(layers, seed=layers)
    b = _batch(seed=layers)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, JCFG.with_depth(layers), b["tokens"],
                              b["labels"]), has_aux=True)(jp)
    flat = {k: v.requires_grad_() for k, v in bridge.flatten(tp).items()}
    loss, metrics = tr.lm_loss(bridge.unflatten(flat), CFG.with_depth(layers),
                               *_t(b).values())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]),
                               atol=1e-5)
    assert metrics["aux"].item() == float(jm["aux"]) == 0.0
    for key, g in bridge.flatten(jax.device_get(jgrads)).items():
        np.testing.assert_allclose(flat[key].grad.numpy(), g, atol=1e-5,
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("S,H,KV,hd,causal,window,cap", [
    (64, 4, 4, 16, True, 0, 0.0), (96, 4, 2, 32, True, 16, 0.0),
    (80, 4, 1, 16, True, 0, 20.0), (64, 2, 2, 16, False, 0, 30.0),
    (300, 2, 1, 16, True, 32, 30.0)])
def test_attention_backward_matches_jax_grad(S, H, KV, hd, causal, window,
                                             cap):
    """Autograd through the port's plain attention (naive up to 256
    positions, blocked beyond) against ``jax.grad`` of the JAX
    ``ref.blocked_attention``: the gradient the CUDA backward is held to
    on the card."""
    rng = np.random.default_rng(S)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((2, S, H, hd), (2, S, KV, hd), (2, S, KV, hd),
                    (2, S, H, hd)))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    want = jax.grad(lambda q, k, v: jnp.sum(jax_fa_ref.blocked_attention(
        q, k, v, block_k=64, **kw) * do), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa_ops.flash_attention(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


def test_synthetic_batches_bit_identical():
    for seed, V, S, B in ((0, 256, 32, 8), (3, 50304, 17, 2)):
        dj = jsyn.DataConfig(vocab_size=V, seq_len=S, global_batch=B,
                             seed=seed)
        dt = syn.DataConfig(vocab_size=V, seq_len=S, global_batch=B,
                            seed=seed)
        for step in (0, 5):
            want, got = jsyn.SyntheticLM(dj).batch(step), \
                syn.SyntheticLM(dt).batch(step)
            for key in want:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
        for w, g in zip(jsyn.make_eval_batches(dj, 2),
                        syn.make_eval_batches(dt, 2)):
            np.testing.assert_array_equal(g["tokens"], w["tokens"])


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_jax(grad_accum):
    """Three ``make_train_step`` steps (Muon-NSGD under WSD, one layer)
    from the same params and batches."""
    jp, tp = _params(1, seed=3)
    jcfg, cfg = JCFG.with_depth(1), CFG.with_depth(1)
    jopt = jax_make_optimizer(jbase.OptimizerConfig())
    opt = make_optimizer(tbase.OptimizerConfig())
    jsched = jax_make_schedule(jbase.ScheduleConfig(), 0.01, 10)
    sched = make_schedule(tbase.ScheduleConfig(), 0.01, 10)
    jstep = jsteps.make_train_step(jcfg, jopt, jsched, grad_accum=grad_accum,
                                   donate=False)
    step = steps.make_train_step(cfg, opt, sched, grad_accum=grad_accum)
    jstate, state = jopt.init(jp), opt.init(tp)
    for i in range(3):
        b = _batch(seed=10 + i)
        jp, jstate, jm = jstep(jp, jstate, jax.tree.map(jnp.asarray, b),
                               jnp.asarray(i))
        tp, state, m = step(tp, state, _t(b), i)
        for key in ("loss", "ce", "aux", "lr"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       atol=1e-5, err_msg=key)
        assert m["lr"].item() == float(jm["lr"])
    got = bridge.flatten(bridge.params_to_numpy(tp))
    for key, w in bridge.flatten(jax.device_get(jp)).items():
        np.testing.assert_allclose(got[key], w, atol=1e-5, err_msg=key)
    assert int(state["step"]) == int(jstate["step"]) == 3


T, K = 8, 2         # total steps; the step whose checkpoint both resume
TAU = 0.5           # expansion at step 4


def _tcfgs():
    kw = dict(total_steps=T, seq_len=16, global_batch=4, source_layers=1,
              eval_every=3, eval_batches=1, seed=0, log_every=1,
              checkpoint_every=K, keep_checkpoints=100)
    jt = jbase.TrainConfig(expansions=(jbase.ExpansionConfig(
        at_frac=TAU, target_layers=2, init="copying_zeroL"),), **kw)
    tt = tbase.TrainConfig(expansions=(tbase.ExpansionConfig(
        at_frac=TAU, target_layers=2, init="copying_zeroL"),), **kw)
    return jt, tt


def _resume_dir(src, dst, step):
    os.makedirs(dst)
    name = f"step_{step:09d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return dst


def test_resumed_end_to_end_matches_jax(tmp_path):
    """JAX trains and checkpoints step K; the port and JAX each resume from
    a copy of it through a copying_zeroL expansion to T.  Same expansion
    step, same final depth, loss curves within 2e-4; the JAX checkpointer
    restores the port's final checkpoint; and in the port a run resumed
    from label K is byte-identical to the uninterrupted run."""
    jt, tt = _tcfgs()
    logs = []
    jloop.train(JCFG, jt, checkpoint_dir=str(tmp_path / "jax_full"),
                log_fn=logs.append)
    jres = jloop.train(JCFG, jt, checkpoint_dir=_resume_dir(
        tmp_path / "jax_full", tmp_path / "jax_resumed", K),
        log_fn=logs.append)
    tres = loop.train(CFG, tt, checkpoint_dir=_resume_dir(
        tmp_path / "jax_full", tmp_path / "port_resumed", K),
        log_fn=logs.append, device="cpu")
    assert f"[resume] step={K} layers=1" in logs
    assert tres.history["expansion_steps"] == \
        jres.history["expansion_steps"] == [int(TAU * T)]
    assert tres.final_layers == jres.final_layers == 2
    assert tres.history["step"] == jres.history["step"] == list(range(T))
    assert tres.history["layers"] == jres.history["layers"]
    np.testing.assert_allclose(tres.history["loss"], jres.history["loss"],
                               atol=2e-4)
    np.testing.assert_allclose(tres.history["eval_loss"],
                               jres.history["eval_loss"], atol=2e-4)

    # The JAX checkpointer reads what the port wrote.
    port_dir = str(tmp_path / "port_resumed")
    assert jckpt.latest_step(port_dir) == T
    jlike = jax.eval_shape(
        lambda k: jax_registry.get_model(JCFG).init(k, JCFG),
        jax.random.PRNGKey(0))
    got = jckpt.restore_subtree(port_dir, T, jlike, "params")
    want = bridge.params_to_numpy(tres.params)
    for key, leaf in bridge.flatten(jax.device_get(got)).items():
        np.testing.assert_array_equal(leaf, bridge.flatten(want)[key])
    jopt = jax_make_optimizer(jbase.OptimizerConfig())
    full = jckpt.restore(port_dir, T, {"params": jlike,
                                       "opt_state": jopt.init(jlike)})
    assert int(full["opt_state"]["step"]) == T
    assert jckpt.load_metadata(port_dir, T)["num_layers"] == 2

    # In the port: resume replays nothing.
    full_run = loop.train(CFG, tt, checkpoint_dir=str(tmp_path / "port_full"),
                          log_fn=logs.append, device="cpu")
    resumed = loop.train(CFG, tt, checkpoint_dir=_resume_dir(
        tmp_path / "port_full", tmp_path / "port_full_resumed", K),
        log_fn=logs.append, device="cpu")
    def clock_free(h):                 # step_time is wall-clock noise
        return {k: v for k, v in h.items() if k != "step_time"}
    assert clock_free(resumed.history) == clock_free(full_run.history)
    a = bridge.flatten(bridge.params_to_numpy(full_run.params))
    b = bridge.flatten(bridge.params_to_numpy(resumed.params))
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    ma = bridge.flatten(bridge.params_to_numpy(full_run.opt_state["m"]))
    mb = bridge.flatten(bridge.params_to_numpy(resumed.opt_state["m"]))
    for key in ma:
        np.testing.assert_array_equal(ma[key], mb[key], err_msg=key)


def test_checkpoint_keep_and_atomic_layout(tmp_path):
    _, tp = _params(1)
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, {"params": tp}, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    like = tr.lm_init(None, CFG.with_depth(1), device="meta")
    back = ckpt.restore(str(tmp_path), 4, {"params": like})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 4, {"params": tr.lm_init(
            None, CFG.with_depth(2), device="meta")})
    for key, leaf in bridge.flatten(bridge.params_to_numpy(tp)).items():
        np.testing.assert_array_equal(
            bridge.flatten(back["params"])[key], leaf)


def test_launch_train_smoke_cpu(capsys, tmp_path):
    launch_train.main(["--smoke", "--device", "cpu", "--steps", "6",
                       "--tau", "0.5", "--source-layers", "1",
                       "--seq-len", "32", "--batch", "8",
                       "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[expand] step=3 -> 2 layers" in out
    assert "final loss:" in out and "(layers 2)" in out
    assert "train tokens/s layers=1" in out
    assert ckpt.all_steps(str(tmp_path)) == [3, 6]
    # --remat is ported (ROADMAP queue A item 15), and so is --mesh (item
    # 13): in one process a 4x2 spec is refused against the world of 1.
    with pytest.raises(ValueError, match="has 8 ranks; the world has 1"):
        launch_train.main(["--smoke", "--device", "cpu", "--mesh", "4x2"])
    # The fault-tolerance flags are ported (ROADMAP queue A item 11): a bad
    # spec is the plane's own error now, not a refusal.
    with pytest.raises(ValueError, match="unknown fault site"):
        launch_train.main(["--smoke", "--device", "cpu", "--faults", "x:1"])
