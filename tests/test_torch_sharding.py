"""The port's placement rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``) on the conftest's 8 fake
CPU devices, and the int8 error-feedback compression against
``repro.distributed.collectives``.

Every leaf of every registry config, at smoke and at full width (JAX
``eval_shape``, torch ``meta``; full width at one pattern period of
depth: the stack axis is never sharded and the rules read the inner
shape, so depth cannot change a spec), params and AdamW state, goes through
both rules on meshes 1x1, 8x1 (``host``), 4x2 and 2x2x2 (``pod``) under
the ``tp`` and ``fsdp`` layouts and ``moe_fsdp`` ``auto``/``ef``; the
batch and cache rules (contiguous, ring, recurrent and paged-pool leaves,
quantized scales included) the same.  A one-axis tuple and the bare axis
name are taken as equal: JAX 0.9's ``PartitionSpec`` stores ``('data',)``
as ``'data'``.  In-process and cheap: no ranks are started.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.distributed import collectives as jcoll
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import registry as jregistry
from repro.optim.base import make_optimizer as jmake_optimizer
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro_torch import bridge, configs
from repro_torch.configs.base import OptimizerConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.models import registry, transformer
from repro_torch.optim.base import make_optimizer
from repro_torch.tree import leaves_with_path

ARCHS = ("gpt2-12l",) + tuple(configs.PORTED_ARCHS)
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
VARIANTS = [dict(layout="tp", moe_fsdp="auto", fsdp=True),
            dict(layout="tp", moe_fsdp="ef", fsdp=True),
            dict(layout="tp", moe_fsdp="auto", fsdp=False),
            dict(layout="fsdp", moe_fsdp="auto", fsdp=True)]


def _jax_mesh(name):
    shape, names = MESHES[name]
    n = int(np.prod(shape))
    return jmesh.make_mesh(shape, names, devices=jax.devices()[:n])


def _port_mesh(name):
    shape, names = MESHES[name]
    return shd.MeshShape(names, shape)


def _jax_spec(s):
    return tuple(s.spec)


def _flat_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(getattr(p, "key", p)) for p in path)] = leaf
    return out


def _flat_port(tree):
    return dict(leaves_with_path(tree))


def _trees(name, smoke):
    jcfg = (jax_get_smoke_config if smoke else jax_get_config)(name)
    cfg = (configs.get_smoke_config if smoke else configs.get_config)(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if not smoke and not cfg.is_encoder_decoder:
        cfg = cfg.with_depth(cfg.pattern_period)
        jcfg = jcfg.with_depth(jcfg.pattern_period)
    jp = jax.eval_shape(lambda k: jregistry.get_model(jcfg).init(k, jcfg),
                        jax.random.PRNGKey(0))
    tp = registry.get_model(cfg).init(None, cfg, device="meta")
    jos = jax.eval_shape(jmake_optimizer(JOptimizerConfig(name="adamw")).init,
                         jp)
    tos = make_optimizer(OptimizerConfig(name="adamw")).init(tp)
    return cfg, jp, tp, jos, tos


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("name", ARCHS)
def test_param_and_opt_state_rules_match_reference(name, smoke):
    """Every param and AdamW-state leaf: the same spec as the reference's
    rule on every mesh and layout variant."""
    cfg, jp, tp, jos, tos = _trees(name, smoke)
    jflat, tflat = _flat_jax(jp), _flat_port(tp)
    assert sorted(jflat) == sorted(tflat)
    for path in tflat:
        assert tuple(jflat[path].shape) == tuple(tflat[path].shape), path
    checked = 0
    for mesh_name in MESHES:
        jm, tm = _jax_mesh(mesh_name), _port_mesh(mesh_name)
        for kw in VARIANTS:
            jsh = _flat_jax(jshd.params_shardings(jp, jm, **kw))
            tsh = _flat_port(shd.params_shardings(tp, tm, **kw))
            for path, spec in tsh.items():
                assert shd.same_spec(spec, _jax_spec(jsh[path])), \
                    (mesh_name, kw, path, spec, jsh[path].spec)
                local = shd.local_shape(tflat[path].shape, spec, tm)
                assert all(int(a) * int(np.prod(
                    [tm.shape[x] for x in shd.dim_axes(e)])) == int(b)
                    for a, b, e in zip(local, tflat[path].shape, spec))
                checked += 1
            josh = jshd.opt_state_shardings(jos, jm, **kw)
            tosh = shd.opt_state_shardings(tos, tm, **kw)
            for k in ("m", "v"):
                jm_flat = _flat_jax(josh[k])
                for path, spec in _flat_port(tosh[k]).items():
                    assert shd.same_spec(spec, _jax_spec(jm_flat[path]))
            assert shd.same_spec(tosh["step"], _jax_spec(josh["step"]))
    assert checked == len(tflat) * len(MESHES) * len(VARIANTS)


def _cache_trees(cfg):
    """Contiguous (rings, recurrent states) and paged (int8: with scale
    leaves) cache shapes of ``cfg``'s smoke model, batch 8."""
    p = registry.get_model(cfg).init(None, cfg, device="meta")
    trees = {}
    if cfg.is_encoder_decoder:
        return trees
    trees["contiguous"] = transformer.lm_init_cache(
        p, cfg, 8, 32, torch.float32, device="meta")
    trees["paged"] = transformer.lm_init_paged_cache(
        p, cfg, 8, 16, 4, 32, torch.float32, kv_dtype=torch.int8,
        device="meta")
    return trees


@pytest.mark.parametrize("name", ARCHS)
def test_cache_and_batch_rules_match_reference(name):
    """Every cache leaf (contiguous, ring, recurrent, paged pool and its
    scales) and batch leaves of several sizes: the reference's spec on
    every mesh and layout."""
    cfg = configs.get_smoke_config(name)
    trees = _cache_trees(cfg)
    for mesh_name in MESHES:
        jm, tm = _jax_mesh(mesh_name), _port_mesh(mesh_name)
        for kind, tree in trees.items():
            structs = jax.tree.map(
                lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
                bridge.unflatten({k: v for k, v in
                                  bridge.flatten(tree).items()}))
            jsh = _flat_jax(jshd.cache_shardings(structs, jm))
            for path, spec in _flat_port(shd.cache_shardings(tree,
                                                             tm)).items():
                assert shd.same_spec(spec, _jax_spec(jsh[path])), \
                    (mesh_name, kind, path, spec, jsh[path].spec)
        for layout in ("tp", "fsdp"):
            for b in (1, 2, 6, 8, 16):
                batch = {"tokens": jax.ShapeDtypeStruct((b, 16), jnp.int32),
                         "labels": jax.ShapeDtypeStruct((b, 16), jnp.int32)}
                jsh = jshd.batch_shardings(batch, jm, layout=layout)
                tsh = shd.batch_shardings(
                    {k: torch.empty(v.shape, device="meta")
                     for k, v in batch.items()}, tm, layout=layout)
                for k in batch:
                    assert shd.same_spec(tsh[k], _jax_spec(jsh[k])), \
                        (mesh_name, layout, b, tsh[k], jsh[k].spec)


def test_cache_caveats_held_to_documented_placements():
    """The reference's three stale assertions: its rule gives the
    documented placements, spelled by JAX 0.9 with the bare name.  Both
    rules are held to them, one-axis tuple and bare name taken as equal."""
    cases = [
        ("4x2", {"k": (3, 8, 24, 2, 16)}, "k",
         (None, ("data",), "model", None, None)),
        ("4x2", {"v": (64, 8, 4, 2)}, "v", (None, ("data",), "model", None)),
        ("8x1", {"layer0": {"k_pages": (2, 16, 8, 2, 8),
                            "v_pages": (2, 16, 8, 2, 8)},
                 "layer1": {"k": (2, 8, 16, 2, 8)}}, None, None),
    ]
    for mesh_name, shapes, leaf, want in cases:
        jm, tm = _jax_mesh(mesh_name), _port_mesh(mesh_name)
        structs = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
            is_leaf=lambda x: isinstance(x, tuple))
        metas = jax.tree.map(lambda s: torch.empty(s, device="meta"), shapes,
                             is_leaf=lambda x: isinstance(x, tuple))
        jsh = jshd.cache_shardings(structs, jm)
        tsh = shd.cache_shardings(metas, tm)
        if leaf is not None:
            assert shd.same_spec(tsh[leaf], want)
            assert shd.same_spec(_jax_spec(jsh[leaf]), want)
            assert tsh[leaf][0] is None
            continue
        # pages never split over 'data'; a contiguous batch dim still is
        for got in (tsh, {k: {n: _jax_spec(s) for n, s in v.items()}
                          for k, v in jsh.items()}):
            assert got["layer0"]["k_pages"][1] is None
            assert shd.dim_axes(got["layer1"]["k"][1]) == ("data",)


def test_same_spec_and_placements():
    assert shd.same_spec((None, ("data",)), (None, "data"))
    assert shd.same_spec((None, "model", None), (None, "model"))
    assert not shd.same_spec(("data",), ("model",))
    assert not shd.same_spec((("data", "model"),), ("data",))
    from torch.distributed.tensor import Replicate, Shard
    m = _port_mesh("2x2x2")
    assert shd.placements((None, ("data", "model")), m) == (
        Replicate(), Shard(1), Shard(1))
    assert shd.placements(("model", "pod"), m) == (Shard(1), Replicate(),
                                                   Shard(0))


def test_int8_error_feedback_matches_reference_bit_for_bit():
    """compress_int8 / decompress_int8 / the error-feedback tree functions
    against the reference's on the same arrays, over three rounds of
    feedback: q, scales, dequantized values and residuals bit for bit."""
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((17, 5)).astype(np.float32) * 3,
             "b": {"c": rng.standard_normal((64,)).astype(np.float32)
                   * 1e-3,
                   "d": np.zeros((4, 4), np.float32)}}
    tg = bridge.unflatten({k: torch.from_numpy(v.copy())
                           for k, v in bridge.flatten(grads).items()})
    jg = jax.tree.map(jnp.asarray, grads)
    t_ef, j_ef = coll.init_error_feedback(tg), jcoll.init_error_feedback(jg)
    for _ in range(3):
        t_comp, t_ef = coll.compress_grads_with_ef(tg, t_ef)
        j_comp, j_ef = jcoll.compress_grads_with_ef(jg, j_ef)
        for key, (tq, ts) in bridge.flatten(t_comp).items():
            jq, js = bridge.flatten(jax.device_get(j_comp))[key]
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        for key, e in bridge.flatten(t_ef).items():
            np.testing.assert_array_equal(
                e.numpy(), np.asarray(bridge.flatten(jax.device_get(
                    j_ef))[key]))
        t_d = bridge.flatten(coll.decompress_grads(t_comp))
        j_d = bridge.flatten(jax.device_get(jcoll.decompress_grads(j_comp)))
        for key in t_d:
            np.testing.assert_array_equal(t_d[key].numpy(),
                                          np.asarray(j_d[key]))
    q, s = coll.compress_int8(torch.from_numpy(grads["a"]))
    jq, js = jcoll.compress_int8(jnp.asarray(grads["a"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        coll.decompress_int8(q, s).numpy(),
        np.asarray(jcoll.decompress_int8(jq, js)))
