"""Parameters and checkpoints carried from the JAX package to the port.

The bridge must copy bits unchanged both ways, for the tree and for the
flat keypath form the JAX checkpointer's manifest names, at 0, 1 and 2
blocks (the zero/one-layer sources and a grown model).  The port's
checkpoint reader must restore what the JAX ``checkpointer.save`` wrote.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.checkpoint import checkpointer as jax_ckpt
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch import configs
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.models import registry

CFG = configs.get_smoke_config("gpt2-12l")
JCFG = jax_configs.get_smoke_config("gpt2-12l")


def _jax_params(n_layers, seed=0):
    return jax.device_get(jtr.lm_init(jax.random.PRNGKey(seed), JCFG,
                                      num_layers=n_layers))


def _flat_jax(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_bits_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), key


@pytest.mark.parametrize("form", ["tree", "flat"])
@pytest.mark.parametrize("n_layers", [0, 1, 2])
def test_round_trip_is_bit_exact(n_layers, form):
    jp = _jax_params(n_layers, seed=n_layers)
    src = jp if form == "tree" else _flat_jax(jp)
    tp = bridge.params_from_jax(src)
    assert all(isinstance(t, torch.Tensor) for t in bridge.flatten(tp).values())
    assert ("blocks" in tp) == (n_layers > 0)
    if n_layers:
        # the stacked n_super axis is kept on every block leaf
        assert tp["blocks"]["layer0"]["attn"]["wq"].shape == (n_layers, 64, 64)
    back = bridge.params_to_numpy(tp)
    _assert_bits_equal(_flat_jax(jp), bridge.flatten(back))
    # the port's keypaths are JAX's keystr
    assert set(bridge.flatten(tp)) == set(_flat_jax(jp))


def test_port_init_has_the_reference_tree():
    """Same keys and shapes as the JAX init (values come from another
    generator)."""
    jp = _flat_jax(_jax_params(2))
    tp = bridge.flatten(registry.get_model(CFG).init(
        torch.Generator().manual_seed(0), CFG, device="cpu"))
    assert jp.keys() == tp.keys()
    for key in jp:
        assert tuple(tp[key].shape) == jp[key].shape, key
        assert tp[key].dtype == torch.float32


def test_bfloat16_leaves_keep_their_bits():
    x = jnp.asarray(np.linspace(-3, 3, 10, dtype=np.float32), jnp.bfloat16)
    t = bridge.params_from_jax({"w": np.asarray(x)})["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          np.asarray(x).view(np.int16))


def test_restore_subtree_reads_a_jax_checkpoint(tmp_path):
    jp = _jax_params(2, seed=4)
    opt = {"mu": jax.tree.map(jnp.zeros_like, jp)}
    jax_ckpt.save(str(tmp_path), 7, {"params": jp, "opt": opt},
                  metadata={"num_layers": 2})
    jax_ckpt.save(str(tmp_path), 9, {"params": jp, "opt": opt},
                  metadata={"num_layers": 2})
    assert ckpt.all_steps(str(tmp_path)) == [7, 9]
    assert ckpt.latest_step(str(tmp_path)) == 9
    assert ckpt.load_metadata(str(tmp_path), 9)["num_layers"] == 2
    like = registry.get_model(CFG).init(None, CFG, device="meta")
    restored = ckpt.restore_subtree(str(tmp_path), 9, like, "params")
    _assert_bits_equal(_flat_jax(jp), bridge.flatten(restored))

    deeper = registry.get_model(CFG).init(None, CFG, num_layers=4,
                                          device="meta")
    with pytest.raises(ValueError, match="depth mismatch"):
        ckpt.restore_subtree(str(tmp_path), 9, deeper, "params")
    with pytest.raises(KeyError, match="no leaf"):
        ckpt.restore_subtree(str(tmp_path), 9, {"extra": like["embed"]},
                             "params")


def test_keystr_parse_round_trip():
    key = "['blocks']['layer0']['attn']['wq']"
    assert bridge.unflatten({key: 1}) == {"blocks": {"layer0": {"attn":
                                                                {"wq": 1}}}}
    assert bridge.keystr(("blocks", "layer0", "attn", "wq")) == key
    with pytest.raises(ValueError):
        bridge.unflatten({"blocks.layer0": 1})
