"""The rest of the training recipe in the port against the JAX package's,
on the CPU: AdamW, SGD and NSGD (``optim/adamw.py``, ``optim/sgd.py``),
``make_optimizer``'s four builders, AdamW's second moment through depth
expansion and crash-resume, and the muP audit (``core/mup.py``).

Cross-framework: five updates of each optimizer on the same params and
gradients (``grad_clip`` 0 and 1, weight decay on): moments bit-exact
without clipping (each is one multiply-add of the same float32 values),
within 1e-7 with it (the global norm sums in another order), params within
1e-6; ``expand_opt_state`` of an AdamW state under ``inherit``, ``copy``
and ``reset`` bit-exact; ``spectral_lr_scale``,
``spectral_norm_estimate`` (8 power iterations from the same start
vector), ``check_spectral_condition`` (ratios within 1e-4) and
``activation_scale_probe`` on ``gpt2-12l``'s smoke params.  In-port: an
AdamW run crashed mid-training resumes from its checkpoint to the
uninterrupted run's losses, params and both moments bit for bit, and the
launcher trains with each ``--optimizer``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.core import expansion as jexp
from repro.core import mup as jmup
from repro.models import transformer as jtr
from repro.optim import base as joptim
from repro_torch import bridge
from repro_torch import configs
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import (ExpansionConfig, OptimizerConfig,
                                      ScheduleConfig, TrainConfig)
from repro_torch.core import expansion as exp
from repro_torch.core import mup
from repro_torch.launch import train as launch_train
from repro_torch.optim import base as optim_base
from repro_torch.train.engine import ProgressiveTrainer
from repro_torch.train.faults import CrashError
from repro_torch.tree import tree_leaves

NAMES = ("adamw", "sgd", "nsgd")
PARAM_TOL = 1e-6
CLIP_MOMENT_TOL = 1e-7
MUP_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these ops are tiny, and on a shared CPU many
    threads make them several times slower.  Every comparison here is
    between runs under the same setting, or within a stated tolerance."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (3, 5, 7), "b": (11,), "c": (4, 6)}


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("name", NAMES)
def test_five_updates_match_jax(name, clip):
    kw = dict(name=name, grad_clip=clip, weight_decay=0.1)
    jo = joptim.make_optimizer(JOptimizerConfig(**kw))
    to = optim_base.make_optimizer(OptimizerConfig(**kw))
    start = _leaves(0, SHAPES)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    js, ts = jo.init(jp), to.init(tp)
    assert set(ts) == set(js) and ts["step"].dtype == torch.int32
    for key in ("m", "v"):
        if key in js:
            for k in SHAPES:
                assert ts[key][k].dtype == (torch.float32 if name == "adamw"
                                            else tp[k].dtype)
    for i in range(5):
        grads = _leaves(10 + i, SHAPES)
        lr = np.float32(0.01 * (i + 1))
        jp, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp, jnp.float32(lr))
        tp2, ts = to.update({k: torch.from_numpy(v) for k, v in grads.items()},
                            ts, tp, torch.tensor(lr))
        assert tp2 is tp                          # written in place
    assert int(ts["step"]) == int(js["step"]) == 5
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=PARAM_TOL, rtol=0, err_msg=k)
        for key in ("m", "v"):
            if key not in js:
                continue
            got, want = ts[key][k].numpy(), np.asarray(js[key][k])
            if clip == 0.0:
                np.testing.assert_array_equal(got, want, err_msg=(key, k))
            else:
                np.testing.assert_allclose(got, want, atol=CLIP_MOMENT_TOL,
                                           rtol=0, err_msg=(key, k))


def _gpt2_params(seed=0, depth=None):
    jcfg = jax_configs.get_smoke_config("gpt2-12l")
    cfg = configs.get_smoke_config("gpt2-12l")
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(seed), jcfg,
                                    num_layers=depth))
    return jcfg, cfg, jp, bridge.params_from_jax(jp)


@pytest.mark.parametrize("policy,method", [
    ("inherit", "random"), ("copy", "copying_stack"),
    ("copy", "copying_zeroL"), ("reset", "random")])
def test_adamw_second_moment_through_expansion_matches_jax(policy, method):
    """An AdamW state after two updates at depth 1, expanded to depth 2
    next to the params: 'm' and 'v' (and 'step') as the reference's
    ``expand_opt_state`` leaves them, bit for bit."""
    jcfg, cfg, jp, tp = _gpt2_params(depth=1)
    jo = joptim.make_optimizer(JOptimizerConfig(name="adamw"))
    to = optim_base.make_optimizer(OptimizerConfig(name="adamw"))
    js, ts = jo.init(jp), to.init(tp)
    for i in range(2):
        g = jax.tree.map(lambda x: np.full(x.shape, 0.01 * (i + 1),
                                           np.float32), jp)
        jp, js = jo.update(g, js, jp, jnp.float32(1e-3))
        tp, ts = to.update(bridge.params_from_jax(g), ts, tp,
                           torch.tensor(1e-3))
    jnew = jax.device_get(jexp.expand_params(jp, jcfg, 2, "zero"))
    tnew = bridge.params_from_jax(jnew)
    jos = jexp.expand_opt_state(js, jnew, policy, method)
    tos = exp.expand_opt_state(ts, tnew, policy, method)
    assert int(tos["step"]) == int(jos["step"])
    for key in ("m", "v"):
        want = bridge.flatten(jax.device_get(jos[key]))
        got = bridge.flatten(tos[key])
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, atol=1e-9,
                                       rtol=1e-6, err_msg=(key, k))


def test_mup_audit_matches_jax():
    """gpt2's smoke params: the per-tensor LR scales, the power-iteration
    spectral norms, the audit's ratios and the activation probe."""
    _, _, jp, tp = _gpt2_params(seed=3)
    for shape in ((64,), (64, 256), (256, 64), (2, 64, 192), (3, 1, 5)):
        assert mup.spectral_lr_scale(shape) == jmup.spectral_lr_scale(shape)
    jflat, tflat = bridge.flatten(jp), bridge.flatten(tp)
    for key, leaf in jflat.items():
        want = float(jmup.spectral_norm_estimate(jnp.asarray(leaf)))
        got = float(mup.spectral_norm_estimate(tflat[key]))
        np.testing.assert_allclose(got, want, rtol=MUP_TOL, err_msg=key)
    want = jmup.check_spectral_condition(jp)
    got = mup.check_spectral_condition(tp)
    assert got.keys() == want.keys() and len(got) > 0
    for name, row in want.items():
        assert got[name]["target"] == row["target"]
        for field in ("sigma", "ratio"):
            np.testing.assert_allclose(got[name][field], row[field],
                                       rtol=MUP_TOL, err_msg=(name, field))
    act = np.random.default_rng(4).standard_normal((3, 7, 64)).astype(
        np.float32) * 2.5
    np.testing.assert_allclose(
        float(mup.activation_scale_probe(torch.from_numpy(act))),
        float(jmup.activation_scale_probe(jnp.asarray(act))), rtol=1e-6)


def _trainer(ckpt_dir=None, **kw):
    cfg = dataclasses.replace(configs.get_smoke_config("gpt2-12l"),
                              max_seq_len=16)
    tc = TrainConfig(total_steps=8, seq_len=16, global_batch=4,
                     source_layers=1,
                     expansions=(ExpansionConfig(at_frac=0.5,
                                                 target_layers=2),),
                     optimizer=OptimizerConfig(name="adamw",
                                               learning_rate=1e-3),
                     schedule=ScheduleConfig(name="constant"),
                     eval_every=10_000, eval_batches=1, seed=0, log_every=1,
                     checkpoint_every=3, keep_checkpoints=100)
    return ProgressiveTrainer(cfg, tc, checkpoint_dir=ckpt_dir, device="cpu",
                              log_fn=lambda *a: None, **kw)


def test_adamw_crash_resume_is_bit_identical(tmp_path):
    """AdamW through an expansion at step 4 (its 'v' expanded with 'm'),
    crashed at step 7 and resumed from the checkpoint at 6: the losses,
    params and both moments of the uninterrupted run, bit for bit."""
    clean = _trainer().run()
    d = str(tmp_path)
    with pytest.raises(CrashError):
        _trainer(ckpt_dir=d, faults="train.iter:7:crash").run()
    assert ckpt.latest_step(d) == 6
    res = _trainer(ckpt_dir=d).run()
    assert res.history["loss"] == clean.history["loss"]
    for a, b in ((res.params, clean.params), (res.opt_state["m"],
                                              clean.opt_state["m"]),
                 (res.opt_state["v"], clean.opt_state["v"])):
        la, lb = tree_leaves(a), tree_leaves(b)
        assert len(la) == len(lb)
        assert all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("name", ["muon_nsgd", "adamw", "nsgd", "sgd"])
def test_launcher_trains_with_each_optimizer(capsys, name):
    res = launch_train.main(["--smoke", "--device", "cpu", "--steps", "3",
                             "--tau", "0", "--seq-len", "16", "--batch", "4",
                             "--optimizer", name, "--lr", "1e-3"])
    out = capsys.readouterr().out
    assert "final loss:" in out and res.history["loss"]
    assert all(np.isfinite(res.history["loss"]))
    assert ("v" in res.opt_state) == (name == "adamw")
