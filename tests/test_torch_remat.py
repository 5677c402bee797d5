"""Activation checkpointing (remat) in the port, on the CPU: each
super-block of the loss forward under ``torch.utils.checkpoint``
(non-reentrant), ``'nothing'`` keeping no activation inside it and
``'dots'`` keeping the matrix products' outputs (a selective-checkpoint
policy, the counterpart of the reference's
``dots_with_no_batch_dims_saveable``).

In-port: remat ``True``, ``'nothing'`` and ``'dots'`` give the loss, every
gradient and the params after two AdamW steps of remat off, bit for bit,
on ``gpt2-12l``'s and ``gemma2-9b``'s smoke models (recomputation reruns
the same deterministic forward); 'dots' reruns no matrix product in the
backward, 'nothing' every one of the super-blocks'.  Cross-framework: the remat'ed loss and
its gradients against ``jax.grad`` of the reference's remat'ed
``lm_loss`` within 1e-5 (plus 1e-4 relative).  The launcher: a bare
``--remat`` takes the architecture's policy from ``REMAT_DEFAULTS``, and
an unknown knob is refused.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch import configs
from repro_torch.configs.base import OptimizerConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import registry
from repro_torch.models import transformer as tr
from repro_torch.optim import base as optim_base
from repro_torch.train import loop, steps

NAMES = ("gpt2-12l", "gemma2-9b")
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


def _batch(cfg, seed, B=2, S=20):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).long(),
            "labels": torch.from_numpy(toks[:, 1:]).long()}


def _params(cfg, seed=0):
    return registry.get_model(cfg).init(torch.Generator().manual_seed(seed),
                                        cfg, device="cpu")


def _loss_and_grads(cfg, params, batch, remat):
    flat = {k: v.clone().requires_grad_()
            for k, v in bridge.flatten(params).items()}
    loss, _ = registry.get_model(cfg).loss(bridge.unflatten(flat), cfg,
                                           batch, remat=remat)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in flat.items()}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("remat", [True, "nothing", "dots"])
def test_remat_is_bit_identical_to_remat_off(name, remat):
    cfg = configs.get_smoke_config(name)
    params = _params(cfg, seed=len(name))
    batch = _batch(cfg, 1)
    loss0, g0 = _loss_and_grads(cfg, params, batch, False)
    loss1, g1 = _loss_and_grads(cfg, params, batch, remat)
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys()
    for key in g0:
        assert torch.equal(g0[key], g1[key]), key
    opt = optim_base.make_optimizer(OptimizerConfig(name="adamw"))
    sched = lambda step: torch.tensor(1e-3, dtype=torch.float32)
    trained = []
    for knob in (False, remat):
        p = {k: v.clone() for k, v in bridge.flatten(params).items()}
        p = bridge.unflatten(p)
        state = opt.init(p)
        step = steps.make_train_step(cfg, opt, sched, remat=knob)
        losses = []
        for i in range(2):
            p, state, m = step(p, state, _batch(cfg, 10 + i), i)
            losses.append(m["loss"])
        trained.append((bridge.flatten(p), losses))
    (pa, la), (pb, lb) = trained
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for key in pa:
        assert torch.equal(pa[key], pb[key]), key


def test_policies_save_what_they_name():
    """Matrix products the backward runs, counted with a dispatch mode:
    'dots' reruns none of the forward's products without a batch
    dimension (their outputs are kept), so it runs as many of them as
    remat off, and reruns the batched ones (the attention's, on the CPU),
    as the reference's dots_with_no_batch_dims_saveable does; 'nothing'
    reruns every product of the super-blocks; and both keep less for the
    backward than remat off."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = self.batched = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.bmm.default and args[0].shape[0] > 1:
                self.batched += 1
            else:
                self.n += func in (torch.ops.aten.mm.default,
                                   torch.ops.aten.addmm.default,
                                   torch.ops.aten.bmm.default)
            return func(*args, **(kwargs or {}))

    cfg = configs.get_smoke_config("gemma2-9b")
    params = _params(cfg)
    batch = _batch(cfg, 2)
    runs, batched, saved = {}, {}, {}
    for knob in (False, "dots", "nothing"):
        flat = {k: v.clone().requires_grad_()
                for k, v in bridge.flatten(params).items()}
        nbytes = [0]

        def pack(t):
            nbytes[0] += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = registry.get_model(cfg).loss(bridge.unflatten(flat),
                                                   cfg, batch, remat=knob)
        with Count() as count:
            loss.backward()
        runs[knob], batched[knob], saved[knob] = (count.n, count.batched,
                                                  nbytes[0])
    assert runs["dots"] == runs[False] < runs["nothing"]
    assert batched[False] < batched["dots"] == batched["nothing"]
    assert saved["dots"] < saved[False] and saved["nothing"] < saved[False]


@pytest.mark.parametrize("remat", ["nothing", "dots"])
def test_remat_loss_and_grads_match_jax_remat(remat):
    """gemma2's smoke model (windows of 8 binding at S = 20): the port's
    remat'ed loss and gradients against ``jax.grad`` of the reference's
    remat'ed ``lm_loss`` on the same (carried-over) params."""
    jcfg = jax_configs.get_smoke_config("gemma2-9b")
    cfg = configs.get_smoke_config("gemma2-9b")
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(5), jcfg))
    tp = bridge.params_from_jax(jp)
    batch = _batch(cfg, 3)
    toks, labels = batch["tokens"].numpy(), batch["labels"].numpy()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.lm_loss(p, jcfg, toks, labels, remat=remat),
        has_aux=True))(jp)
    loss, grads = _loss_and_grads(cfg, tp, batch, remat)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jflat = bridge.flatten(jax.device_get(jgrads))
    assert jflat.keys() == grads.keys()
    for key, g in jflat.items():
        np.testing.assert_allclose(grads[key].numpy(), g, atol=GRAD_TOL,
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("argv,want", [
    (["--remat"], "dots"), (["--remat", "nothing"], "nothing"),
    ([], False)])
def test_launcher_remat_picks_the_arch_default(monkeypatch, argv, want):
    """A bare ``--remat`` is ``REMAT_DEFAULTS[arch]`` ('dots' for
    gemma3-12b), a named policy is itself, and the default is off; the
    run trains with it (two steps of gemma3's smoke model)."""
    seen = []
    real = loop.train

    def spy(cfg, tcfg, **kw):
        seen.append(tcfg.remat)
        return real(cfg, tcfg, **kw)
    monkeypatch.setattr(launch_train.loop, "train", spy)
    launch_train.main(["--arch", "gemma3-12b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--tau", "0", "--seq-len", "12",
                       "--batch", "2", "--optimizer", "adamw"] + argv)
    assert seen == [want]
    assert configs.default_remat("gemma3-12b") == "dots"
    assert configs.default_remat("gpt2-12l") == "nothing"


def test_unknown_remat_knob_is_refused():
    cfg = configs.get_smoke_config("gpt2-12l")
    opt = optim_base.make_optimizer(OptimizerConfig(name="sgd"))
    with pytest.raises(ValueError, match="remat='full'"):
        steps.make_train_step(cfg, opt, lambda s: torch.tensor(0.1),
                              remat="full")
    with pytest.raises(ValueError, match="remat='full'"):
        tr.remat_policy("full")
