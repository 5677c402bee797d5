"""Dry run of the port: every (arch × shape) cell counted on the
production meshes (``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch gemma2-9b]
        [--shape train_4k] [--mesh single|multi|both]
        [--out experiments/dryrun_torch] [--tag baseline]

The reference lowers and compiles each cell on 512 placeholder CPU
devices.  The port is one process per rank, so a cell here is rank 0 of
a fake world of 256 (``single``: 16x16) or 512 (``multi``: 2x16x16)
ranks, whose process group (``torch.distributed``'s ``fake`` backend)
completes every collective without moving a byte.  The port's own
production mesh is built on it (``launch.mesh.make_production_mesh``),
and the rank's leaves and batch are meta tensors of their local shapes
under ``distributed/sharding``, in bf16 as the reference's dry run.  One
step runs under ``roofline.torch_cost.StepCounter``:

  * ``train``: loss, backward and the optimizer's update (Muon-NSGD by
    default) through ``train.steps.make_train_step`` under the trainer's
    ``MeshContext``, remat on (the reference's ``remat`` default
    'nothing' turns it on as full recompute, 'dots' keeps matmul outputs);
  * ``prefill``: the forward (``ModelApi.apply``) under the server's
    placement (``serve_engine.place_params``: no FSDP, 'model' shards
    where the layer computes on them);
  * ``decode``: one ``decode_step`` of a new token a row against a cache
    of ``seq_len`` slots (``init_cache``, outside the count).

The counts are a rank's; the JSON scales them by the chips, as the
reference scales its per-chip module, and holds every key the reference's
``run_cell`` writes: ``count_s`` (the count's seconds) takes the place of
``lower_s`` and ``compile_s``, and ``xla_flops_raw`` is null (no XLA).
``per_device_memory``: ``argument_size_in_bytes`` is the rank's params,
optimizer state and batch, ``temp_size_in_bytes`` the counter's peak of
the storages the step makes, ``output_size_in_bytes`` the step's outputs,
``alias_size_in_bytes`` the part of them updated in place in an
argument's storage.  ``fits_hbm``: a rank's arguments and temp below the
card's 80 GB.

The dry run makes no tensor on any device but meta and launches no
kernel: the kernel wrappers take their plain versions on meta, inside
their regions, and the counter reads the kernels' work.  A cell that
fails is listed and the run exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs as cfglib
from repro_torch.configs.base import (HW_HBM_BYTES, SHAPES, ModelConfig,
                                      OptimizerConfig, ScheduleConfig,
                                      ShapeConfig)
from repro_torch.core.schedules import make_schedule
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import MeshContext, mesh_scope
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry
from repro_torch.optim.base import make_optimizer
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.torch_cost import StepCounter
from repro_torch.train import serve_engine
from repro_torch.train import steps as steps_lib
from repro_torch.tree import leaves_with_path, tree_map_with_path

MESHES = {"single": 256, "multi": 512}


def fake_world(world: int) -> None:
    """Make this process rank 0 of a ``world``-rank fake process group:
    the one it is in already, or a new one (any other destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local(tree, specs, mesh):
    """Meta tensors of the rank's shapes of ``tree``'s leaves."""
    return tree_map_with_path(
        lambda path, x: torch.empty(shd.local_shape(x.shape, specs[path],
                                                    mesh),
                                    dtype=x.dtype, device="meta"), tree)


def _rows(batch: dict, mesh, layout: str) -> dict:
    """The rank's rows of each batch leaf (dim 0 over ``batch_axes``)."""
    def one(x):
        n = mesh.axes_size(shd.batch_axes(x.shape[0], mesh, layout))
        return torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                           dtype=x.dtype, device="meta")
    return {k: one(v) for k, v in batch.items()}


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size()
               for _, x in leaves_with_path(tree)
               if isinstance(x, torch.Tensor))


def _storages(tree) -> set:
    return {x.untyped_storage()._cdata for _, x in leaves_with_path(tree)
            if isinstance(x, torch.Tensor)}


def _outputs(out, args) -> tuple:
    """(output bytes, of which in an argument's storage)."""
    held = _storages(args)
    leaves = [x for _, x in leaves_with_path(
        out if isinstance(out, dict) else {"out": out})
        if isinstance(x, torch.Tensor)]
    total = sum(x.numel() * x.element_size() for x in leaves)
    alias = sum(x.numel() * x.element_size() for x in leaves
                if x.untyped_storage()._cdata in held)
    return total, alias


def rank_params(cfg: ModelConfig, mesh, dtype=torch.bfloat16,
                moe_fsdp="auto", layout="tp"):
    """(the rank's params as meta tensors, {path: spec}) under the
    trainer's placement; ``mesh`` needs only axis names and sizes (a
    ``sharding.MeshShape`` will do)."""
    full = registry.get_model(cfg).init(None, cfg, dtype=dtype,
                                        device="meta")
    specs = dict(leaves_with_path(shd.params_shardings(
        full, mesh, moe_fsdp=moe_fsdp, layout=layout)))
    return _local(full, specs, mesh), specs


def count_train(cfg: ModelConfig, shape: ShapeConfig, mesh,
                dtype=torch.bfloat16, remat=True, optimizer="muon_nsgd",
                moe_fsdp="auto", layout="tp"):
    """(count, argument bytes, outputs) of one train step on the rank."""
    params, specs = rank_params(cfg, mesh, dtype, moe_fsdp, layout)
    opt = make_optimizer(OptimizerConfig(name=optimizer))
    opt_state = opt.init(params)
    batch = _rows(registry.input_specs(cfg, shape), mesh, layout)
    step = steps_lib.make_train_step(
        cfg, opt, make_schedule(ScheduleConfig(), 0.01, 100_000),
        remat=remat, mesh=MeshContext(mesh, layout, specs))
    args = {"params": params, "opt_state": opt_state, "batch": batch}
    with StepCounter() as counter:
        new_params, new_state, _ = step(params, opt_state, batch, 0)
    return counter.count, _nbytes(args), _outputs(
        {"params": new_params, "opt_state": new_state}, args)


def _served(cfg, mesh, dtype):
    api = registry.get_model(cfg)
    full = api.init(None, cfg, dtype=dtype, device="meta")
    params, ctx = serve_engine.place_params(cfg, full, mesh)
    return api, params, ctx


def count_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  dtype=torch.bfloat16):
    """(count, argument bytes, outputs) of one prefill forward."""
    api, params, ctx = _served(cfg, mesh, dtype)
    batch = _rows(registry.input_specs(cfg, shape), mesh, "tp")
    args = {"params": params, "batch": batch}
    with StepCounter() as counter, torch.no_grad(), mesh_scope(ctx):
        if cfg.is_encoder_decoder:
            out = api.apply(params, cfg, batch["tokens"], batch["frames"])
        else:
            out = api.apply(params, cfg, batch["tokens"],
                            embeds=batch.get("embeds"))
    return counter.count, _nbytes(args), _outputs(out[0], args)


def count_decode(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 dtype=torch.bfloat16):
    """(count, argument bytes, outputs) of one decode step against a cache
    of ``shape.seq_len`` slots."""
    api, params, ctx = _served(cfg, mesh, dtype)
    inputs = _rows(registry.decode_input_specs(cfg, shape), mesh, "tp")
    B = inputs["tokens"].shape[0]
    with torch.no_grad(), mesh_scope(ctx):
        cache = api.init_cache(params, cfg, B, shape.seq_len, torch.bfloat16,
                               device="meta")
    args = {"params": params, "cache": cache, **inputs}
    with StepCounter() as counter, torch.no_grad(), mesh_scope(ctx):
        logits, cache = api.decode_step(params, cfg, inputs["tokens"], cache,
                                        inputs["index"])
    return counter.count, _nbytes(args), _outputs(
        {"logits": logits, "cache": cache}, args)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             tag: str = "baseline", optimizer: str = "muon_nsgd",
             moe_fsdp: str = "auto", remat="nothing",
             layout: str = "tp") -> dict:
    """Count one cell and write its JSON."""
    cfg = cfglib.get_config(arch)
    shape = SHAPES[shape_name]
    fake_world(MESHES[mesh_kind])
    mesh = mesh_lib.make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                         device="cpu")
    chips = mesh.world_size
    t0 = time.time()
    if shape.mode == "train":
        count, arg_bytes, (out_bytes, alias) = count_train(
            cfg, shape, mesh, optimizer=optimizer, moe_fsdp=moe_fsdp,
            remat=remat if remat != "nothing" else True, layout=layout)
    elif shape.mode == "prefill":
        count, arg_bytes, (out_bytes, alias) = count_prefill(cfg, shape,
                                                             mesh)
    else:
        count, arg_bytes, (out_bytes, alias) = count_decode(cfg, shape,
                                                            mesh)
    t_count = time.time() - t0
    mem_info = {"argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": out_bytes,
                "temp_size_in_bytes": count.peak_bytes,
                "generated_code_size_in_bytes": 0,
                "alias_size_in_bytes": alias}
    # A rank's counts: scaled to global totals (the roofline formulas
    # divide by `chips` again), as the reference scales its per-chip HLO.
    by_op = {k: v * chips for k, v in count.coll.items()}
    terms = roofline.RooflineTerms(
        arch=arch, shape=shape_name, mesh=mesh_kind, chips=chips,
        hlo_flops=count.flops * chips,
        hlo_bytes=count.bytes * chips,
        coll_bytes_weighted=roofline.weighted_collective_bytes(by_op),
        coll_by_op=by_op,
        model_flops=roofline.model_flops_estimate(cfg, shape),
        per_device_memory=mem_info,
        flops_by_unit={k: v * chips for k, v in count.by_unit.items()},
    )
    result = {**terms.to_json(), "count_s": t_count, "tag": tag,
              "xla_flops_raw": None,
              "hlo_bytes_raw": (count.bytes + count.kernel_bytes) * chips,
              "kernel_region_bytes": count.kernel_bytes * chips,
              "kernel_regions": dict(count.regions),
              "params_total": cfg.param_count(),
              "params_active": cfg.param_count(active_only=True),
              "fits_hbm": (mem_info["argument_size_in_bytes"]
                           + mem_info["temp_size_in_bytes"]) < HW_HBM_BYTES}
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}__{tag}.json")
    with open(fn, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[dryrun] {arch} x {shape_name} x {mesh_kind} ({tag}): OK "
          f"count={t_count:.1f}s flops={terms.hlo_flops:.3e} "
          f"coll={terms.coll_bytes_weighted:.3e}B dominant={terms.dominant}",
          flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--optimizer", default="muon_nsgd")
    ap.add_argument("--moe-fsdp", default="auto", choices=["auto", "ef"])
    ap.add_argument("--remat", default="nothing", choices=["nothing", "dots"])
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp"])
    args = ap.parse_args(argv)

    archs = list(cfglib.ASSIGNED_ARCHS) if args.arch == "all" else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = []
    try:
        for arch in archs:
            shapes = ([s.name for s in cfglib.applicable_shapes(arch)]
                      if args.shape == "all" else [args.shape])
            for shape in shapes:
                for mesh_kind in meshes:
                    try:
                        run_cell(arch, shape, mesh_kind, args.out, args.tag,
                                 args.optimizer, args.moe_fsdp, args.remat,
                                 args.layout)
                    except Exception as e:
                        failures.append((arch, shape, mesh_kind, repr(e)))
                        print(f"[dryrun] {arch} x {shape} x {mesh_kind}: "
                              f"FAIL {e}", flush=True)
                        traceback.print_exc()
    finally:
        mesh_lib.close_world(barrier=False)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f[:3], f[3][:200])
        sys.exit(1)
    print("\nAll dry-run cells counted successfully.")


if __name__ == "__main__":
    main()
