"""The port's Muon-NSGD and LR schedules against the JAX package's, on the
CPU.

One ``muon_nsgd`` update runs on both sides from the same params (the JAX
init of ``gpt2-12l`` smoke, carried over by ``repro_torch.bridge``), the
same gradients and momenta (numpy, from a seed) and the same float32
learning rate.  Tolerances: momenta bit-exact (one multiply and one add in
f32 on both sides); params 1e-6 absolute (an lr-scaled Newton–Schulz or
normalized update of O(1) entries, summed in another order in f32).
Schedules: wsd and constant bit-exact at every step; cosine within 1e-9
absolute (float32 cos of two libraries differ by an ulp of cos, ~6e-8,
scaled by peak_lr / 2 = 5e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core import schedules as jax_schedules
from repro.models import registry as jax_registry
from repro.models import transformer as jtr
from repro.optim import muon as jax_muon
from repro_torch import bridge
from repro_torch import configs
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import schedules
from repro_torch.models import registry
from repro_torch.optim import base as optim_base
from repro_torch.optim import muon
from repro_torch.tree import leaves_with_path


def test_leaf_split_matches_jax_on_gpt2():
    """Which leaves take Muon and which NSGD, and which count as stacked,
    on the full ``gpt2-12l`` tree (shapes only)."""
    jcfg = jax_configs.get_config("gpt2-12l")
    shapes = jax.eval_shape(
        lambda k: jax_registry.get_model(jcfg).init(k, jcfg),
        jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): (jax_muon._is_matrix(p, x),
                                      jax_muon._stacked(p))
            for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    cfg = configs.get_config("gpt2-12l")
    params = registry.get_model(cfg).init(None, cfg, device="meta")
    got = {bridge.keystr(p): (muon._is_matrix(p, x), muon._stacked(p))
           for p, x in leaves_with_path(params)}
    assert got == want
    assert muon.NSGD_NAMES == jax_muon.NSGD_NAMES
    assert sum(m for m, _ in got.values()) == 7      # 6 per layer + embed


def _shared_state(seed=0):
    jcfg = jax_configs.get_smoke_config("gpt2-12l")
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), jp)
    moms = jax.tree.map(
        lambda p: 0.1 * rng.standard_normal(p.shape).astype(np.float32), jp)
    return jp, grads, moms


@pytest.mark.parametrize("mup,grad_clip", [(True, 0.0), (False, 0.5)])
def test_muon_update_matches_jax(mup, grad_clip):
    jp, grads, moms = _shared_state()
    lr = np.float32(0.0123)
    jopt = jax_muon.muon_nsgd(JaxOptimizerConfig(mup=mup,
                                                 grad_clip=grad_clip))
    jstate = {"step": jnp.asarray(3, jnp.int32),
              "m": jax.tree.map(jnp.asarray, moms)}
    want_p, want_s = jax.device_get(jopt.update(
        jax.tree.map(jnp.asarray, grads), jstate,
        jax.tree.map(jnp.asarray, jp), jnp.asarray(lr)))

    opt = optim_base.make_optimizer(OptimizerConfig(mup=mup,
                                                    grad_clip=grad_clip))
    params = bridge.params_from_jax(jp)
    state = {"step": torch.tensor(3, dtype=torch.int32),
             "m": bridge.params_from_jax(moms)}
    new_p, new_s = opt.update(bridge.params_from_jax(grads), state, params,
                              torch.tensor(lr))
    assert new_p is params                           # updated in place
    assert int(new_s["step"]) == 4
    got_p = bridge.flatten(bridge.params_to_numpy(new_p))
    got_m = bridge.flatten(bridge.params_to_numpy(new_s["m"]))
    for key, want in bridge.flatten(want_p).items():
        np.testing.assert_allclose(got_p[key], want, atol=1e-6, err_msg=key)
    for key, want in bridge.flatten(want_s["m"]).items():
        np.testing.assert_array_equal(got_m[key], want, err_msg=key)


def test_orthogonalize_batches_the_stack():
    """A stacked leaf (L, n, m) orthogonalizes as its L matrices do alone,
    and as the JAX vmap does."""
    x = np.random.default_rng(1).standard_normal((3, 24, 40)).astype(
        np.float32)
    got = muon.orthogonalize(torch.from_numpy(x))
    each = torch.stack([muon.orthogonalize(torch.from_numpy(a))
                        for a in x])
    assert torch.equal(got, each)
    want = np.asarray(jax_muon.orthogonalize(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


@pytest.mark.parametrize("name", ["wsd", "cosine", "constant"])
@pytest.mark.parametrize("total", [7, 100, 1000])
def test_schedules_match_jax_at_every_step(name, total):
    jfn = getattr(jax_schedules, name)(0.01, total)
    tfn = getattr(schedules, name)(0.01, total)
    want = np.array([np.asarray(jfn(s)) for s in range(total + 2)])
    got = np.array([tfn(s).numpy() for s in range(total + 2)])
    assert got.dtype == want.dtype == np.float32
    if name == "cosine":
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_other_optimizers_name_their_roadmap_item():
    """make_optimizer builds each of the reference's four optimizers (queue
    A item 5 is ported), and an unknown name raises KeyError, as the
    reference's does."""
    for name in ("muon_nsgd", "adamw", "nsgd", "sgd"):
        opt = optim_base.make_optimizer(OptimizerConfig(name=name))
        assert opt.name == name
    with pytest.raises(KeyError):
        optim_base.make_optimizer(OptimizerConfig(name="lion"))
