"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

  * a rank's parameter bytes at 16x16 and 2x16x16, every assigned arch at
    full width, equal the sum of the reference's shard shapes
    (``repro.distributed.sharding.params_shardings`` over a JAX
    ``AbstractMesh`` of the production shape: the rules read only the
    axis sizes, so no 256 or 512 devices are needed), at one pattern
    period of depth (the stack axis is never sharded: depth scales a
    rank's bytes and changes no spec; the reference's MoE inits take
    seconds a layer to trace);
  * the smoke ``gpt2-12l`` train step on a 2x4 mesh (the conftest's 8 CPU
    devices for the reference, rank 0 of a fake world of 8 for the port):
    the port's argument bytes a rank equal the reference's
    ``memory_analysis().argument_size_in_bytes`` but for the reference's
    ``step`` argument, an int32 scalar the port passes as a Python int;
  * the CLI on smoke configs (three archs) at both production meshes
    writes one JSON a cell with every key the reference's ``run_cell``
    writes (``count_s``
    in place of ``lower_s`` and ``compile_s``), the report renders them,
    and a failing cell is listed and exits 1.
"""
import contextlib
import dataclasses
import functools
import inspect
import io
import json
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import registry as jregistry
from repro.roofline import analysis as janalysis
from repro_torch import configs as cfglib
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import report


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with the environment's XLA flags
    kept: the module appends a 512-device flag to ``XLA_FLAGS`` when
    imported (for its own process), which would give every later JAX
    backend in this worker 512 devices instead of the conftest's 8."""
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return dryrun


jdryrun = _reference_dryrun()

PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_rank_bytes(params, sizes, names):
    shardings = jshd.params_shardings(params, AbstractMesh(sizes, names))
    leaves = jax.tree.leaves(params)
    specs = jax.tree.leaves(shardings,
                            is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(specs)
    return sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
               for x, s in zip(leaves, specs))


@pytest.mark.parametrize("arch", cfglib.ASSIGNED_ARCHS)
def test_rank_parameter_bytes_equal_the_references_shards(arch):
    cfg = cfglib.get_config(arch)
    cfg = cfg.with_depth(cfg.pattern_period)
    jcfg = dataclasses.replace(jget_config(arch), num_layers=cfg.num_layers)
    api = jregistry.get_model(jcfg)
    jparams = jax.eval_shape(functools.partial(api.init, cfg=jcfg,
                                               dtype=jnp.bfloat16),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    for mesh_kind, (sizes, names) in PRODUCTION.items():
        params, _ = dryrun.rank_params(cfg, MeshShape(names, sizes))
        got = sum(x.numel() * x.element_size()
                  for x in jax.tree.leaves(params,
                                           is_leaf=torch.is_tensor))
        assert got == _reference_rank_bytes(jparams, sizes, names), \
            mesh_kind


def test_argument_bytes_of_the_smoke_step_equal_the_references():
    shape = ("t", 64, 8, "train")
    jm = jmesh.make_mesh((2, 4), ("data", "model"),
                         devices=jax.devices()[:8])
    lowered = jdryrun.build_train_lowering(
        jget_smoke_config("gpt2-12l"), JShapeConfig(*shape), jm)
    want = lowered.compile().memory_analysis().argument_size_in_bytes
    dryrun.fake_world(8)
    try:
        m = mesh_lib.make_mesh((2, 4), ("data", "model"), "cpu")
        _, got, _ = dryrun.count_train(cfglib.get_smoke_config("gpt2-12l"),
                                       ShapeConfig(*shape), m)
    finally:
        mesh_lib.close_world(barrier=False)
    step_scalar = 4                    # the reference's int32 `step`
    assert got + step_scalar == want, (got, want)


# The reference's run_cell keys beside RooflineTerms.to_json's.
REFERENCE_EXTRA_KEYS = ("lower_s", "compile_s", "tag", "xla_flops_raw",
                        "hlo_bytes_raw", "kernel_region_bytes",
                        "params_total", "params_active", "fits_hbm")
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes")
# The reference's shape cells at small sizes (smoke configs hold 128
# positions).
SMALL_SHAPES = {"train_4k": ShapeConfig("train_4k", 32, 16, "train"),
                "prefill_32k": ShapeConfig("prefill_32k", 32, 16,
                                           "prefill"),
                "decode_32k": ShapeConfig("decode_32k", 64, 16, "decode"),
                "long_500k": ShapeConfig("long_500k", 128, 1, "decode")}


# An encoder-decoder, a recurrent arch with the long_500k cell, an MoE
# (``--arch all`` over every arch: see the README for its time).
CLI_ARCHS = ("whisper-base", "rwkv6-7b", "deepseek-moe-16b")


def _reference_keys():
    src = inspect.getsource(jdryrun.run_cell)
    assert all(f'"{k}"' in src for k in REFERENCE_EXTRA_KEYS)
    for k in MEMORY_KEYS:
        assert f'"{k}"' in src
    terms = janalysis.RooflineTerms("a", "s", "single", 1, 1.0, 1.0, 0.0,
                                    {}, 1.0)
    return set(terms.to_json()) | set(REFERENCE_EXTRA_KEYS)


def test_cli_on_smoke_configs_at_both_production_meshes(tmp_path,
                                                        monkeypatch):
    smoke = {a: cfglib.get_smoke_config(a) for a in cfglib.ASSIGNED_ARCHS}
    monkeypatch.setattr(cfglib, "get_config", smoke.__getitem__)
    monkeypatch.setattr(cfglib, "SHAPES", SMALL_SHAPES)
    monkeypatch.setattr(dryrun, "SHAPES", SMALL_SHAPES)
    out = tmp_path / "dryrun"
    for arch in CLI_ARCHS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dryrun.main(["--arch", arch, "--mesh", "both", "--out",
                         str(out)])
        assert "All dry-run cells counted successfully." in buf.getvalue()
    files = sorted(os.listdir(out))
    want_cells = sum(len(cfglib.applicable_shapes(a))
                     for a in CLI_ARCHS) * 2
    assert len(files) == want_cells
    want = (_reference_keys() - {"lower_s", "compile_s"}) | {"count_s"}
    for fn in files:
        with open(out / fn) as f:
            d = json.load(f)
        assert want <= set(d), (fn, want - set(d))
        assert set(d["per_device_memory"]) == set(MEMORY_KEYS)
        assert d["chips"] == (256 if d["mesh"] == "single" else 512)
        assert d["hlo_flops"] > 0 and d["t_compute"] > 0
        assert d["fits_hbm"] is True
    rows = report.load_all(str(out))
    assert len(rows) == want_cells // 2
    text = report.render(rows)
    assert all(f"| {a} |" in text for a in CLI_ARCHS)
    # A cell that fails is listed, and the run exits 1.
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "yi-34b", "--shape", "no_such_shape",
                     "--mesh", "single", "--out", str(out)])
    assert e.value.code == 1
    assert "1 FAILURES" in buf.getvalue()
