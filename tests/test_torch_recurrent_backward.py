"""The recurrent backward passes of the port against the JAX package's, on
the CPU: the plain reverse recurrences the CUDA backward kernels are held to
(``kernels/rwkv6/ref.wkv_bwd_ref``, ``kernels/mamba_scan/ref.
selective_scan_bwd_ref``) against ``jax.vjp`` of the reference's per-step
forms (``wkv_ref``, ``selective_scan_ref``) and against torch autograd of
the port's own per-step forms, and one training step of the ``rwkv6-7b``
and jamba smoke configs against the reference's.

The reference's ``wkv_chunked`` is not a yardstick here: its gradient is
NaN where decays near 0 make its pairwise exponents overflow (ROADMAP
queue C).  Tolerances: each gradient within 1e-5 of max(1, max|JAX|)
(float32 sums in other orders, over at most 100 steps), every entry
finite; the training steps as ``tests/test_torch_train.py`` states them
(loss 1e-5, params 1e-5 absolute after one Muon step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs import base as jbase
from repro.core.schedules import make_schedule as jax_make_schedule
from repro.kernels.mamba_scan import ref as jscan
from repro.kernels.rwkv6 import ref as jwkv
from repro.models import transformer as jtr
from repro.optim.base import make_optimizer as jax_make_optimizer
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch import configs
from repro_torch.configs import base as tbase
from repro_torch.core.schedules import make_schedule
from repro_torch.kernels.mamba_scan import ref as scan_ref
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.optim.base import make_optimizer
from repro_torch.train import steps

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these ops are tiny, and on a shared CPU many
    threads make them several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL * scale:.3e}"


# Decays: near 0.69 and 0.9975 (the ends of rwkv_init's range) and near 0,
# a tenth exactly 0 and a twentieth below the reference's 1e-30 floor.
def _decays(rng, shape, regime):
    if regime == "near 0":
        w = rng.uniform(1e-4, 0.05, shape)
        pick = rng.random(shape)
        w[pick < 0.1] = 0.0
        tiny = (pick >= 0.1) & (pick < 0.15)
        w[tiny] = 10.0 ** rng.uniform(-37, -31, int(tiny.sum()))
        return w
    return rng.uniform(*{"near 0.69": (0.69, 0.72),
                         "near 0.9975": (0.995, 0.9975)}[regime], shape)


def _wkv_arrays(seed, S, regime, state, B=2, H=2, hd=8):
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(f) for _ in range(3))
    w = _decays(rng, (B, S, H, hd), regime).astype(f)
    u = (0.1 * rng.standard_normal((H, hd))).astype(f)
    s0 = (rng.standard_normal((B, H, hd, hd)) if state
          else np.zeros((B, H, hd, hd))).astype(f)
    dy = rng.standard_normal((B, S, H, hd)).astype(f)
    ds = rng.standard_normal((B, H, hd, hd)).astype(f)
    return (r, k, v, w, u, s0), dy, ds


@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 64, 100])
def test_wkv_bwd_ref_matches_jax_vjp(S):
    """Every gradient (r, k, v, w, u, S_0) from output and final-state
    cotangents, at every decay regime, zero and random S_0; and torch
    autograd of the port's ``wkv_ref`` on the same inputs."""
    for n, regime in enumerate(("near 0.69", "near 0.9975", "near 0")):
        for state in (False, True):
            xs, dy, ds = _wkv_arrays(100 * S + 10 * n + state, S, regime,
                                     state)
            _, vjp = jax.vjp(jwkv.wkv_ref, *map(jnp.asarray, xs))
            want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
            tx = [torch.from_numpy(x) for x in xs]
            got = wkv_ref.wkv_bwd_ref(*tx, torch.from_numpy(dy),
                                      torch.from_numpy(ds))
            leaves = [x.clone().requires_grad_() for x in tx]
            y, s = wkv_ref.wkv_ref(*leaves)
            auto = torch.autograd.grad(
                (y * torch.from_numpy(dy)).sum()
                + (s * torch.from_numpy(ds)).sum(), leaves)
            for name, g, a, j in zip("r k v w u s0".split(), got, auto,
                                     want):
                what = f"S={S} {regime} state={state} d{name}"
                _close(g, j, what)
                _close(g, a.numpy(), what + " (autograd)")


def test_wkv_bwd_ref_without_a_final_state_gradient_and_in_bfloat16():
    """ds_final None is a zero cotangent; bf16 r/k/v/dy give gradients in
    bf16 from float32 sums (the JAX vjp on the same bf16 values)."""
    xs, dy, _ = _wkv_arrays(7, 33, "near 0.69", True)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in xs[:3]]
    tx = bf + [torch.from_numpy(x) for x in xs[3:]]
    tdy = torch.from_numpy(dy).to(torch.bfloat16)
    jx = [jnp.asarray(x.float().numpy()) for x in bf] + list(
        map(jnp.asarray, xs[3:]))
    _, vjp = jax.vjp(jwkv.wkv_ref, *jx)
    s_shape = xs[5].shape
    want = vjp((jnp.asarray(tdy.float().numpy()),
                jnp.zeros(s_shape, jnp.float32)))
    got = wkv_ref.wkv_bwd_ref(*tx, tdy, None)
    for x, g in zip(tx, got):
        assert g.dtype == x.dtype
    for name, g, j in zip("r k v".split(), got[:3], want[:3]):
        # rounded once to bf16 on the port's side: 2^-8 relative
        j = np.asarray(j)
        err = np.abs(g.float().numpy() - j)
        assert (err <= 2.0 ** -8 * np.abs(j) + TOL * max(
            1.0, float(np.abs(j).max()))).all(), name
    for name, g, j in zip("w u s0".split(), got[3:], want[3:]):
        _close(g, j, name)


# Scan regimes: decays near 1 (dt * A in [-1e-3, -1e-5]), large dt * A (down
# to -80: exp underflows within a step) and the model's dt = softplus(N(0,
# 1)), A = -(1..N).
def _scan_arrays(seed, S, N, regime, B=2, d=12):
    rng = np.random.default_rng(seed)
    f = np.float32
    u = rng.standard_normal((B, S, d)).astype(f)
    if regime == "model":
        dt = np.log1p(np.exp(rng.standard_normal((B, S, d)))).astype(f)
        A = -np.tile(np.arange(1, N + 1), (d, 1)).astype(f)
    else:
        (dlo, dhi), (alo, ahi) = {"near 1": ((0.01, 0.1), (1e-3, 1e-2)),
                                  "large": ((1.0, 5.0), (1.0, 16.0))}[regime]
        dt = rng.uniform(dlo, dhi, (B, S, d)).astype(f)
        A = -rng.uniform(alo, ahi, (d, N)).astype(f)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(f) for _ in range(2))
    Dp = (1.0 + 0.1 * rng.standard_normal(d)).astype(f)
    h0 = rng.standard_normal((B, d, N)).astype(f)
    dy = rng.standard_normal((B, S, d)).astype(f)
    dh = rng.standard_normal((B, d, N)).astype(f)
    return (u, dt, A, Bm, Cm, Dp), h0, dy, dh


@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("S", [1, 15, 64, 100])
def test_scan_bwd_ref_matches_jax_vjp(S, N):
    """Every gradient (u, dt, A, B, C, D, and h0 where given) from output
    and final-state cotangents, with and without h0, at every regime; and
    torch autograd of the port's ``selective_scan_ref``."""
    names = "u dt A B C D h0".split()
    for n, regime in enumerate(("near 1", "large", "model")):
        xs, h0, dy, dh = _scan_arrays(1000 + 10 * S + N + n, S, N, regime)
        tx = [torch.from_numpy(x) for x in xs]
        for with_h0 in (True, False):
            if with_h0:
                def f(*a):
                    return jscan.selective_scan_ref(*a[:6], h0=a[6])
                _, vjp = jax.vjp(f, *map(jnp.asarray, xs + (h0,)))
                want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
                got = scan_ref.selective_scan_bwd_ref(
                    *tx, torch.from_numpy(h0), torch.from_numpy(dy),
                    torch.from_numpy(dh))
                leaves = [x.clone().requires_grad_() for x in tx
                          + [torch.from_numpy(h0)]]
                y, h = scan_ref.selective_scan_ref(*leaves[:6], h0=leaves[6])
                loss = ((y * torch.from_numpy(dy)).sum()
                        + (h * torch.from_numpy(dh)).sum())
            else:
                def f(*a):
                    return jscan.selective_scan_ref(*a)[0]
                _, vjp = jax.vjp(f, *map(jnp.asarray, xs))
                want = vjp(jnp.asarray(dy))
                got = scan_ref.selective_scan_bwd_ref(
                    *tx, None, torch.from_numpy(dy))[:6]
                leaves = [x.clone().requires_grad_() for x in tx]
                y, _ = scan_ref.selective_scan_ref(*leaves)
                loss = (y * torch.from_numpy(dy)).sum()
            auto = torch.autograd.grad(loss, leaves)
            for name, g, a, j in zip(names, got, auto, want):
                what = f"S={S} N={N} {regime} h0={with_h0} d{name}"
                _close(g, j, what)
                _close(g, a.numpy(), what + " (autograd)")


def _cut(cfg, layers):
    """``cfg`` at ``layers`` layers.  jamba's pattern period is 8, so its
    first two layers (a dense Mamba layer, then a Mamba layer with the
    MoE) become a period-2 pattern of their own, as the card trains them
    (``chip_smoke.py`` phase 42)."""
    if len(cfg.block_pattern) > layers:
        cfg = dataclasses.replace(cfg,
                                  block_pattern=cfg.block_pattern[:layers])
    return cfg.with_depth(layers)


def _step_pair(arch, layers, seed, optimizer):
    jcfg = _cut(jax_configs.get_smoke_config(arch), layers)
    cfg = _cut(configs.get_smoke_config(arch), layers)
    jp = jtr.lm_init(jax.random.PRNGKey(seed), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp))
    jopt = jax_make_optimizer(jbase.OptimizerConfig(name=optimizer))
    opt = make_optimizer(tbase.OptimizerConfig(name=optimizer))
    jsched = jax_make_schedule(jbase.ScheduleConfig(), 0.01, 10)
    sched = make_schedule(tbase.ScheduleConfig(), 0.01, 10)
    jstep = jsteps.make_train_step(jcfg, jopt, jsched, donate=False)
    step = steps.make_train_step(cfg, opt, sched)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jp, _, jm = jstep(jp, jopt.init(jp), jax.tree.map(jnp.asarray, b),
                      jnp.asarray(2))
    tp, _, m = step(tp, opt.init(tp),
                    {k: torch.from_numpy(v).long() for k, v in b.items()}, 2)
    return jp, jm, tp, m


@pytest.mark.parametrize("arch,layers,optimizer", [
    ("rwkv6-7b", 2, "muon_nsgd"), ("jamba-v0.1-52b", 2, "nsgd")])
def test_one_training_step_matches_jax(arch, layers, optimizer):
    """One ``make_train_step`` step (under WSD; the optimizers the card's
    runs use, ``chip_smoke.py`` phases 41-42) of the smoke config from the
    JAX init carried over by ``bridge``: the loss and every updated param.
    On the CPU the port differentiates its plain WKV and scan forms, as the
    card's backward kernels are held to."""
    jp, jm, tp, m = _step_pair(arch, layers, seed=5, optimizer=optimizer)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), atol=1e-5,
                                   err_msg=key)
    got = bridge.flatten(bridge.params_to_numpy(tp))
    for key, w in bridge.flatten(jax.device_get(jp)).items():
        np.testing.assert_allclose(got[key], w, atol=1e-5, err_msg=key)
