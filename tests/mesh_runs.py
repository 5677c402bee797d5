"""Scenarios run on every rank of a mesh: the bodies that
``tests/test_torch_distributed.py``, ``tests/test_torch_mesh_serve.py``,
``tests/test_torch_mesh_layers.py``, ``tests/test_torch_mesh_faults.py``
and ``chip_smoke.py``'s mesh phases (43, 44) start with
``repro_torch.launch.mesh.spawn``.

This module imports no JAX: spawned ranks import it alone, on the CPU as
on the card.  Its importer puts this directory on ``sys.path`` (pytest
does so for the tests; ``chip_smoke.py`` itself), and spawned ranks inherit
that path.  ``run(scenarios, device)`` runs a list of ``(name, function
name, kwargs)`` in order on the calling rank and returns ``{name:
result}``; every function here takes its mesh as a spec string (built
over the world the rank joined) and returns plain numpy and Python
values, the same on every rank unless it says otherwise.  Params travel
as ``{keystr: array}`` (``bridge.flatten``).
"""
from __future__ import annotations

import gc
import hashlib
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.core import expansion as exp
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import MeshContext, mesh_scope
from repro_torch.kernels import launch_counts, zero_launch_counts
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry
from repro_torch.optim.base import make_optimizer
from repro_torch.train import steps as steps_lib
from repro_torch.train.engine import ProgressiveTrainer
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.tree import leaves_with_path, tree_map, tree_map_with_path

_MESHES: Dict[str, object] = {}


def mesh_for(spec: str, device: str):
    """One ``Mesh`` per spec and rank process (its groups are made once)."""
    if spec not in _MESHES:
        _MESHES[spec] = mesh_lib.make_train_mesh(spec, device=device)
    return _MESHES[spec]


def _numpy(flat: dict) -> dict:
    return {k: bridge.to_numpy(v) for k, v in flat.items()}


def _tensors(flat_np: dict, device) -> dict:
    return bridge.unflatten({k: torch.from_numpy(np.array(v)).to(device)
                             for k, v in flat_np.items()})


def _gather_tree(tree, shardings, m):
    """Every leaf of the rank's sharded ``tree`` whole, on every rank (a
    collective), for comparing a run's trees."""
    flat = bridge.flatten(shardings)
    return tree_map_with_path(
        lambda path, x: coll.unshard_leaf(
            x, flat[bridge.keystr(path)], m, path), tree)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_params(cfg, seed: int, device):
    """``cfg``'s random weights drawn on ``device``'s card from ``seed``
    (``chip_smoke.draw_on_card``'s draw: seconds, where a host draw of a
    model of billions of params takes a minute); the same on every rank
    of one card."""
    return registry.get_model(cfg).init(
        torch.Generator(device=device).manual_seed(seed), cfg, device=device)


class _CardInit(ProgressiveTrainer):
    """The trainer with its fresh init drawn on the card
    (``card_params`` from ``card_seed``), then cut to the rank's
    shards."""
    card_seed = 0

    def _init_state(self, cfg):
        params = card_params(cfg, self.card_seed, self.device)
        if self.mesh is not None:
            params = self._shard(cfg, params)
        return params, self.opt.init(params)


def train(cfg, tcfg, mesh: Optional[str], device: str = "cpu",
          ckpt_dir: Optional[str] = None, want_params: bool = False,
          count: bool = False, expect_crash: bool = False,
          ns_shapes: bool = False, card_seed: Optional[int] = None,
          **engine_kw) -> dict:
    """A ``ProgressiveTrainer`` run on ``mesh`` (None: no mesh).  Returns
    its history, final depth, fault stats, step times, peak device memory
    (above what the process held when the run began),
    the whole final params (``want_params``), the kernels' launches in
    the run (``count``: this rank's counters, zeroed just before) and the
    shape of every stack Muon's ``orthogonalize`` took on this rank
    (``ns_shapes``); ``card_seed``: the fresh init drawn on the card
    (``card_params``) instead of the trainer's host draw;
    ``mesh_s`` is the time spent building the mesh in this call.  With
    ``expect_crash`` an injected ``CrashError`` ends the run and the
    result is ``{"crashed": True}``."""
    t0 = time.perf_counter()
    m = mesh_for(mesh, device) if mesh else None
    mesh_s = time.perf_counter() - t0
    base = 0
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    if count:
        zero_launch_counts()
    cls = ProgressiveTrainer if card_seed is None else _CardInit
    trainer = cls(cfg, tcfg, mesh=m, device=device, checkpoint_dir=ckpt_dir,
                  log_fn=lambda *a, **k: None, **engine_kw)
    if card_seed is not None:
        trainer.card_seed = card_seed
    if expect_crash:
        from repro_torch.train.faults import CrashError
        try:
            trainer.run()
        except CrashError:
            return {"crashed": True}
        return {"crashed": False}
    seen: list = []
    if ns_shapes:
        from repro_torch.optim import muon
        plain = muon.orthogonalize

        def recorded(m, steps=5):
            seen.append(tuple(m.shape))
            return plain(m, steps)
        muon.orthogonalize = recorded
    try:
        res = trainer.run()
    finally:
        if ns_shapes:
            muon.orthogonalize = plain
    _sync(device)
    out = {"history": {k: v for k, v in res.history.items()
                       if k != "step_time"},
           "final_layers": res.final_layers,
           "fault_stats": res.fault_stats,
           "step_times": [dt for _, dt in res.step_times],
           "seconds": time.perf_counter() - t0, "mesh_s": mesh_s,
           "rank": 0 if m is None else m.rank}
    if count:
        out["counts"] = launch_counts()
    if ns_shapes:
        out["ns_shapes"] = seen
    if torch.device(device).type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    if want_params:
        params = res.params
        if m is not None:
            specs = shd.params_shardings(
                registry.get_model(cfg.with_depth(res.final_layers)).init(
                    None, cfg.with_depth(res.final_layers), device="meta"),
                m, fsdp=engine_kw.get("fsdp", True),
                moe_fsdp=engine_kw.get("moe_fsdp", "auto"),
                layout=engine_kw.get("layout", "tp"))
            params = _gather_tree(params, specs, m)
        out["params"] = _numpy(bridge.flatten(params))
    return out


def _shard_state(cfg, params_np: dict, m, opt_name: str, device):
    """Whole params -> this rank's shards, and the optimizer's fresh state
    over them."""
    params = _tensors(params_np, device)
    like = registry.get_model(cfg).init(None, cfg, device="meta")
    specs = shd.params_shardings(like, m)
    local = tree_map_with_path(
        lambda path, x: coll.shard_leaf(x, _at(specs, path), m,
                                        path).clone(),
        params)
    opt = make_optimizer(_opt_cfg(opt_name))
    return local, opt.init(local), specs


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _opt_cfg(name):
    from repro_torch.configs.base import OptimizerConfig
    return OptimizerConfig(name=name)


def layer_grads(cfg, params_np: dict, tokens: np.ndarray,
                labels: np.ndarray, mesh: Optional[str],
                device: str = "cpu", layout: str = "tp",
                moe_fsdp: str = "auto",
                frames: Optional[np.ndarray] = None) -> dict:
    """One loss and its gradients on ``mesh`` (None: one device) from the
    whole ``params_np``: the loss (the mean over the DP ranks' rows), every
    leaf's gradient gathered whole, the leaves ``materialize`` gathered
    over 'model' (``model_gathers``, as keystrs), the shape each leaf has
    as its layer uses it (under the mesh's 'model' split), the shapes of
    q and k each flash call of the loss took (``flash_shapes``) and the
    kernels' launches (this rank's counters); ``layout`` and
    ``moe_fsdp`` as the trainer takes them; ``frames``: an
    encoder-decoder's batch frames."""
    from repro_torch.distributed import context
    from repro_torch.kernels.flash_attention import ops as fa_ops
    api = registry.get_model(cfg)
    params = _tensors(params_np, device)
    batch = {"tokens": torch.from_numpy(np.asarray(tokens)).long(),
             "labels": torch.from_numpy(np.asarray(labels)).long()}
    if frames is not None:
        batch["frames"] = torch.from_numpy(np.asarray(frames))
    zero_launch_counts()
    if mesh is None:
        flat = {k: v.requires_grad_() for k, v in
                bridge.flatten(params).items()}
        loss, _ = api.loss(bridge.unflatten(flat), cfg,
                           {k: v.to(device) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(flat.values()))
        return {"loss": loss.item(), "counts": launch_counts(),
                "grads": _numpy(dict(zip(flat, grads)))}
    m = mesh_for(mesh, device)
    like = api.init(None, cfg, device="meta")
    specs = shd.params_shardings(like, m, layout=layout, moe_fsdp=moe_fsdp)
    flat_specs = dict(leaves_with_path(specs))
    local = tree_map_with_path(
        lambda path, x: coll.shard_leaf(x, flat_specs[path], m,
                                        path).clone(), params)
    axes = shd.batch_axes(batch["tokens"].shape[0], m, layout)
    n, i = m.axes_size(axes), m.axes_index(axes)
    rows = {k: v.reshape((n, -1) + tuple(v.shape[1:]))[i].to(m.device)
            for k, v in batch.items()}
    flat = {k: v.requires_grad_() for k, v in bridge.flatten(local).items()}
    ctx = MeshContext(m, layout, flat_specs)
    # ``materialize`` unpacks (``held_parts``) each leaf it has gathered
    # over 'model', and no other: the paths it is called with are the
    # leaves gathered over 'model' in the loss.
    gathered = set()
    held_parts = context.held_parts

    def counting(path, *a):
        gathered.add(bridge.keystr(path))
        return held_parts(path, *a)

    flash_shapes = []
    flash = fa_ops.flash_attention

    def recording(q, k, *a, **kw):
        flash_shapes.append((tuple(q.shape), tuple(k.shape)))
        return flash(q, k, *a, **kw)

    with mesh_scope(ctx):
        tree = bridge.unflatten(flat)
        with torch.no_grad():
            used = {bridge.keystr(p): tuple(x.shape) for p, x in
                    leaves_with_path(context.materialize(tree, cfg))}
        context.held_parts = counting
        fa_ops.flash_attention = recording
        try:
            loss, _ = api.loss(tree, cfg, rows)
        finally:
            context.held_parts = held_parts
            fa_ops.flash_attention = flash
        grads = torch.autograd.grad(loss, list(flat.values()))
        loss = context.dp_mean(loss.detach())
    whole = _gather_tree(bridge.unflatten(dict(zip(flat, grads))), specs, m)
    return {"loss": float(loss), "counts": launch_counts(),
            "grads": _numpy(bridge.flatten(whole)),
            "model_gathers": sorted(gathered), "used_shapes": used,
            "flash_shapes": flash_shapes}


def encdec_train(cfg, params_np: Optional[dict], batches: List[dict],
                 mesh: Optional[str], device: str = "cpu",
                 card_seed: Optional[int] = None, count: bool = False,
                 want_params: bool = False) -> dict:
    """An encoder-decoder's Muon-NSGD steps under WSD (the configs'
    defaults, lr 0.01 over 10 steps) through ``make_train_step``, one a
    batch of ``batches`` (numpy tokens, labels and frames), on ``mesh``
    (None: one device) from ``params_np`` or weights drawn on the card
    (``card_seed``): each step's loss and seconds, the kernels' launches
    (``count``: this rank's counters, zeroed just before) and the final
    params gathered whole (``want_params``)."""
    from repro_torch.configs.base import OptimizerConfig, ScheduleConfig
    from repro_torch.core.schedules import make_schedule
    m = mesh_for(mesh, device) if mesh else None
    dev = m.device if m else device
    params = card_params(cfg, card_seed, dev) if card_seed is not None \
        else _tensors(params_np, dev)
    ctx = specs = None
    if m is not None:
        specs = shd.params_shardings(registry.get_model(cfg).init(
            None, cfg, device="meta"), m)
        flat_specs = dict(leaves_with_path(specs))
        params = tree_map_with_path(
            lambda path, x: coll.shard_leaf(x, flat_specs[path], m,
                                            path).clone(), params)
        ctx = MeshContext(m, "tp", flat_specs)
    opt = make_optimizer(OptimizerConfig())
    state = opt.init(params)
    step = steps_lib.make_train_step(
        cfg, opt, make_schedule(ScheduleConfig(), 0.01, 10), mesh=ctx)
    if count:
        zero_launch_counts()
    losses, seconds = [], []
    for i, b in enumerate(batches):
        rows = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        rows = {k: v.long() if k != "frames" else v for k, v in rows.items()}
        if m is not None:
            axes = shd.batch_axes(rows["tokens"].shape[0], m)
            n, j = m.axes_size(axes), m.axes_index(axes)
            rows = {k: v.reshape((n, -1) + tuple(v.shape[1:]))[j]
                    for k, v in rows.items()}
        rows = {k: v.to(dev) for k, v in rows.items()}
        _sync(dev)
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, rows, i)
        losses.append(float(metrics["loss"]))
        seconds.append(time.perf_counter() - t0)
    out = {"losses": losses, "step_s": seconds}
    if count:
        out["counts"] = launch_counts()
    if want_params:
        if m is not None:
            params = _gather_tree(params, specs, m)
        out["params"] = _numpy(bridge.flatten(params))
    return out


def encdec_decode(cfg, params_np: Optional[dict], frames: np.ndarray,
                  num_tokens: int, mesh: Optional[str], device: str = "cpu",
                  card_seed: Optional[int] = None,
                  count: bool = False) -> dict:
    """Greedy decoding of ``num_tokens`` tokens a row from token 0 through
    ``encdec_decode_step`` over the encoder's output of ``frames``, on
    ``mesh`` under the serving placement (``serve_engine.place_params``;
    None: one device), from ``params_np`` or weights drawn on the card:
    the tokens (B, 1 + num_tokens), each step's logits (B, num_tokens, V),
    whole on every rank, the cache's leaf shapes on this rank and the
    kernels' launches (``count``)."""
    from repro_torch.models import encdec
    from repro_torch.train.serve_engine import place_params
    m = mesh_for(mesh, device) if mesh else None
    dev = m.device if m else device
    api = registry.get_model(cfg)
    params = card_params(cfg, card_seed, dev) if card_seed is not None \
        else _tensors(params_np, dev)
    ctx = None
    if m is not None:
        params, ctx = place_params(cfg, params, m)
        params = tree_map(lambda x: x.to(dev), params)
    B = frames.shape[0]
    if count:
        zero_launch_counts()
    with torch.inference_mode(), mesh_scope(ctx):
        enc = encdec.encode(params, cfg, torch.from_numpy(
            np.asarray(frames)).to(dev))
        cache = api.init_cache(params, cfg, B, num_tokens + 1,
                               torch.float32, device=dev, enc_out=enc)
        toks = [torch.zeros((B, 1), dtype=torch.long, device=dev)]
        logits = []
        for t in range(num_tokens):
            lg, cache = api.decode_step(params, cfg, toks[-1], cache,
                                        torch.full((B,), t, device=dev))
            logits.append(lg)
            toks.append(lg.argmax(-1))
    out = {"tokens": torch.cat(toks, dim=1).cpu().numpy(),
           "logits": torch.cat(logits, dim=1).float().cpu().numpy(),
           "cache_shapes": {bridge.keystr(p): tuple(x.shape)
                            for p, x in leaves_with_path(cache)}}
    if count:
        out["counts"] = launch_counts()
    return out


def expand_logits(cfg, target: int, method: str, params_np: dict,
                  tokens: np.ndarray, mesh: str, device: str = "cpu") -> dict:
    """Logits of ``cfg``'s model and of its ``method`` expansion to
    ``target`` layers, both computed on ``mesh`` from the rank's shards
    (the expansion sharded), gathered whole."""
    m = mesh_for(mesh, device)
    local, state, specs = _shard_state(cfg, params_np, m, "adamw", device)
    tok = torch.from_numpy(np.asarray(tokens)).long().to(m.device)

    def logits(c, p):
        flat = dict(leaves_with_path(shd.params_shardings(
            registry.get_model(c).init(None, c, device="meta"), m)))
        with torch.no_grad(), mesh_scope(MeshContext(m, "tp", flat)):
            out, _ = registry.get_model(c).apply(p, c, tok)
        return out.cpu().numpy()

    before = logits(cfg, local)
    fn = exp.make_expand_fn(cfg, target, method, mesh=m)
    new_p, _ = fn(local, state, torch.Generator().manual_seed(2))
    return {"before": before, "after": logits(cfg.with_depth(target), new_p)}


def expand_state(cfg, target: int, method: str, policy: str,
                 params_np: dict, mesh: str, device: str = "cpu") -> dict:
    """A sharded expansion of params and AdamW state (the moments made
    nonzero by one step's worth of fill) under ``policy``: the whole
    expanded trees, and whether every moment shard has its param shard's
    shape."""
    m = mesh_for(mesh, device)
    local, state, _ = _shard_state(cfg, params_np, m, "adamw", device)
    for k in ("m", "v"):
        state[k] = tree_map_with_path(lambda path, x: x + 0.5, state[k])
    fn = exp.make_expand_fn(cfg, target, method, opt_state_policy=policy,
                            mesh=m)
    new_p, new_os = fn(local, state, torch.Generator().manual_seed(3))
    tcfg = cfg.with_depth(target)
    specs = shd.params_shardings(
        registry.get_model(tcfg).init(None, tcfg, device="meta"), m)
    same = all(
        tuple(a.shape) == tuple(b.shape)
        for k in ("m", "v")
        for (_, a), (_, b) in zip(bridge.flatten(new_os[k]).items(),
                                  bridge.flatten(new_p).items()))
    whole = {"params": _gather_tree(new_p, specs, m),
             "m": _gather_tree(new_os["m"], specs, m),
             "v": _gather_tree(new_os["v"], specs, m)}
    return {"same_shapes": same,
            "trees": {k: _numpy(bridge.flatten(v)) for k, v in whole.items()},
            "step": int(new_os["step"])}


def save_state(cfg, params_np: dict, mesh: str, directory: str, step: int,
               use_async: bool = False, device: str = "cpu") -> dict:
    """Save params and a fresh AdamW state from the rank's shards (rank 0
    writes whole leaves); and whether this rank holds anything after a
    gather to the writer (rank 0 alone should)."""
    m = mesh_for(mesh, device)
    local, state, specs = _shard_state(cfg, params_np, m, "adamw", device)
    shardings = {"params": specs,
                 "opt_state": {"m": specs, "v": specs, "step": ()}}
    tree = {"params": local, "opt_state": state}
    meta = {"num_layers": cfg.num_layers}
    if use_async:
        saver = ckpt.AsyncCheckpointer()
        saver.save(directory, step, tree, metadata=meta, mesh=m,
                   shardings=shardings)
        saver.wait()
    else:
        ckpt.save(directory, step, tree, metadata=meta, mesh=m,
                  shardings=shardings)
    coll.all_reduce(torch.zeros(1, device=m.device),
                    m.group(m.axis_names))                 # barrier
    held = ckpt.gather_to_writer(tree, shardings, m)
    return {"saved": m.rank == 0, "holds_gathered": held is not None}


def restore_state(cfg, mesh: str, directory: str, step: int,
                  device: str = "cpu", opt_name: str = "adamw") -> dict:
    """Restore a checkpoint as the rank's shards under ``mesh``, then gather
    them whole: the tree, and whether each shard has its spec's shape."""
    m = mesh_for(mesh, device)
    like_p = registry.get_model(cfg).init(None, cfg, device="meta")
    opt = make_optimizer(_opt_cfg(opt_name))
    like = {"params": like_p, "opt_state": opt.init(like_p)}
    specs = shd.params_shardings(like_p, m)
    shardings = {"params": specs,
                 "opt_state": {k: (specs if k in ("m", "v") else ())
                               for k in like["opt_state"]}}
    got = ckpt.restore(directory, step, like, mesh=m, shardings=shardings)
    local = bridge.params_from_jax(got)
    ok = all(tuple(x.shape) == shd.local_shape(w.shape, s, m)
             for (_, x), (_, w), (_, s) in zip(
                 bridge.flatten(local["params"]).items(),
                 bridge.flatten(like_p).items(),
                 bridge.flatten(specs).items()))
    local = tree_map_with_path(lambda p, x: x.to(m.device), local)
    whole = _gather_tree(local, shardings, m)
    return {"tree": _numpy(bridge.flatten(whole)), "shard_shapes_ok": ok}


def copy_step(src: str, dst: str, step: int, mesh: str,
              device: str = "cpu") -> dict:
    """Rank 0 copies checkpoint ``step`` of ``src`` into a fresh ``dst``;
    every rank waits for it."""
    m = mesh_for(mesh, device)
    if m.rank == 0:
        name = f"step_{step:09d}"
        os.makedirs(dst)
        shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    coll.all_reduce(torch.zeros(1, device=m.device),
                    m.group(m.axis_names))                 # barrier
    return {}


def flash_local(shape, seed: int = 0, device: str = "cuda",
                kv_heads: int | None = None, s_k: int | None = None,
                causal: bool = True) -> dict:
    """The flash kernel forward and backward at a rank's local shape
    (B, S, H, hd) of q, over ``kv_heads`` K/V heads (H by default) of
    ``s_k`` keys (S by default; a cross-attention's, ``causal=False``),
    against its plain version on the same inputs (float32): max abs
    errors of out, dq, dk, dv.  The launches count nowhere: the caller
    reads its main path's counters before."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    B, S, H, hd = shape
    kv_shape = (B, S if s_k is None else s_k,
                H if kv_heads is None else kv_heads, hd)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=g).to(device)
                   for s in (shape, kv_shape, kv_shape, shape))
    errs = {}
    outs = {}
    for force in ("kernel", "ref"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa_ops.flash_attention(*leaves, causal=causal, force=force)
        grads = torch.autograd.grad(out, leaves, do)
        outs[force] = (out.detach(),) + tuple(grads)
    for name, a, b in zip(("out", "dq", "dk", "dv"), outs["kernel"],
                          outs["ref"]):
        errs[name] = float((a - b).abs().max())
    return errs


def paged_local(B: int, H: int, KV: int, hd: int, bs: int, pages: int,
                kv_dtype: str = "float32", seed: int = 0,
                device: str = "cuda") -> dict:
    """The paged decode kernel at a rank's local shape (B rows, H query
    heads over KV heads of hd, ``pages`` pages of bs a row, cursors drawn
    over them; f32 queries over ``kv_dtype`` pages, int8/fp8 with their
    scale pages) against its plain version on the same inputs: the max
    abs error relative to max(1, max|plain|).  The launches count
    nowhere: the caller reads its main path's counters before."""
    from repro_torch.core import quant
    from repro_torch.kernels.paged_attention import ops as pa_ops
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = B * pages + 1
    q = torch.randn((B, 1, H, hd), generator=g)
    kp, vp = (torch.randn((n, bs, KV, hd), generator=g) for _ in range(2))
    table = torch.randperm(n - 1, generator=g)[:B * pages].reshape(
        B, pages).int()
    index = torch.randint(0, pages * bs, (B,), generator=g).int()
    kw = {}
    if kv_dtype != "float32":
        dt = getattr(torch, kv_dtype)
        (kp, ks), (vp, vs) = (quant.quantize(t, axis=-1, dtype=dt)
                              for t in (kp, vp))
        kw = dict(k_scales=ks.to(device), v_scales=vs.to(device))
    args = [t.to(device) for t in (q, kp, vp, table, index)]
    got = pa_ops.paged_attention(*args, **kw)
    want = pa_ops.paged_attention(*args, force="ref", **kw)
    return {"max_abs_err": float((got - want).abs().max())
            / max(1.0, float(want.abs().max()))}


def _served_params(cfg, params_np, ckpt_dir, card_seed, device):
    """(params, cfg) to serve: ``ckpt_dir``'s latest checkpoint (at its
    depth), weights drawn on the card from ``card_seed``, or
    ``params_np``."""
    if ckpt_dir is not None:
        from repro_torch.launch.serve import load_params
        return load_params(ckpt_dir, cfg)
    if card_seed is not None:
        return card_params(cfg, card_seed, device), cfg
    return _tensors(params_np, "cpu"), cfg


def held(eng) -> dict:
    """What a ``ServeEngine`` holds on this rank: the bytes of its params
    (the draft's leaves that are views of the target's counted once) and
    each leaf's shape ({keystr: shape})."""
    seen, total = set(), 0
    trees = [eng.params] + ([eng.draft_params] if eng.spec_decode else [])
    for tree in trees:
        for _, x in leaves_with_path(tree):
            key = x.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += x.untyped_storage().nbytes()
    return {"param_bytes": total,
            "shapes": {bridge.keystr(p): tuple(x.shape)
                       for p, x in leaves_with_path(eng.params)}}


def serve(cfg, params_np: Optional[dict], prompts: np.ndarray,
          num_tokens: int, mesh: Optional[str], device: str = "cpu",
          max_len: int = 32, count: bool = False,
          ckpt_dir: Optional[str] = None,
          card_seed: Optional[int] = None,
          engine_kw: Optional[dict] = None) -> dict:
    """Greedy ``generate`` on ``mesh`` (None: one device): tokens and
    logits, gathered to every rank, and what the engine holds on this rank
    (:func:`held`).  ``ckpt_dir``: serve its latest checkpoint's
    params (at its depth) instead of ``params_np``; ``card_seed``: weights
    drawn on the card (``card_params``); ``engine_kw``: more
    ``ServeEngine`` arguments (the placement knobs ``fsdp``, ``layout``,
    ``moe_fsdp``)."""
    m = mesh_for(mesh, device) if mesh else None
    params, cfg = _served_params(cfg, params_np, ckpt_dir, card_seed,
                                 m.device if m else device)
    if count:
        zero_launch_counts()
    eng = ServeEngine(cfg, params, device=device, mesh=m, max_len=max_len,
                      **(engine_kw or {}))
    del params
    t0 = time.perf_counter()
    res = eng.generate(np.asarray(prompts, np.int32), num_tokens,
                       return_logits=True)
    out = {"tokens": res.tokens, "logits": res.logits,
           "seconds": time.perf_counter() - t0, "held": held(eng)}
    if count:
        out["counts"] = launch_counts()
    return out


def cache_shapes(cfg, params_np: dict, mesh: Optional[str],
                 device: str = "cpu", batch: int = 2, max_len: int = 16,
                 block_size: int = 4) -> dict:
    """The shapes of the caches a ``ServeEngine`` on ``mesh`` makes on
    this rank (they differ between 'model' ranks only in which heads or
    channels they hold): {"contiguous" | "paged" | "carry": {keystr:
    shape}}."""
    from repro_torch.distributed.context import mesh_scope as scope
    m = mesh_for(mesh, device) if mesh else None
    eng = ServeEngine(cfg, _tensors(params_np, "cpu"), device=device,
                      mesh=m, max_len=max_len)
    with scope(eng._ctx):
        made = {"contiguous": eng.api.init_cache(
                    eng.params, cfg, batch, max_len, torch.float32,
                    device="meta"),
                "paged": eng.api.init_paged_cache(
                    eng.params, cfg, batch, 8, block_size, max_len,
                    torch.float32, device="meta"),
                "carry": eng.api.init_prefill_carry(
                    eng.params, cfg, max_len, torch.float32,
                    device="meta")}
    return {k: {bridge.keystr(p): tuple(x.shape)
                for p, x in leaves_with_path(v)} for k, v in made.items()}


def radix_pages_hash(state) -> Optional[str]:
    """sha256 over the pages the radix tree holds: their ids, then every
    pool leaf's bytes at those pages (K/V pages, MLA latents, int8/fp8
    scales) in path order; None without a radix tree (or a state: a
    restore with nothing left to serve runs none)."""
    if state is None or state.radix is None:
        return None
    pages = sorted(state.radix.pinned_pages())
    h = hashlib.sha256(np.asarray(pages, np.int64).tobytes())
    idx = torch.as_tensor(pages, dtype=torch.long)
    for path, leaf in leaves_with_path(state.cache):
        if steps_lib._is_paged_leaf(path):
            part = leaf[:, idx.to(leaf.device)].cpu().contiguous()
            h.update(str(path).encode())
            h.update(part.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def pool_bytes(state) -> Optional[int]:
    """The bytes of the paged pool's leaves (pages and scale pages) this
    rank holds in ``state``; None without a state."""
    if state is None:
        return None
    return sum(leaf.numel() * leaf.element_size()
               for path, leaf in leaves_with_path(state.cache)
               if steps_lib._is_paged_leaf(path))


class TickClock:
    """A virtual clock: every reading advances it by ``dt``; a sleep
    jumps."""

    def __init__(self, dt: float):
        self.t = 0.0
        self.dt = dt

    def time(self) -> float:
        self.t += self.dt
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def _result_dicts(results) -> list:
    return [dict(uid=r.uid, tokens=r.tokens, slot=r.slot,
                 finish_reason=r.finish_reason, arrival_s=r.arrival_s,
                 admitted_s=r.admitted_s, finished_s=r.finished_s,
                 prefix_tokens=r.prefix_tokens, spec_rounds=r.spec_rounds,
                 mean_accepted_len=r.mean_accepted_len, error=r.error)
            for r in results]


def cserve(cfg, params_np: Optional[dict], requests: List[dict],
           mesh: Optional[str], device: str = "cpu", max_len: int = 48,
           max_batch: int = 4, engine_kw: Optional[dict] = None,
           sched_kw: Optional[dict] = None, skew_s: float = 0.0,
           count: bool = False, ckpt_dir: Optional[str] = None,
           card_seed: Optional[int] = None, faults: Optional[str] = None,
           snapshot_dir: Optional[str] = None,
           cancel: Optional[dict] = None,
           restore_from: Optional[str] = None,
           tick_s: Optional[float] = None) -> dict:
    """``requests`` (dicts of ``Request`` fields) served through
    ``ContinuousScheduler`` on ``mesh`` (None: one device) with
    ``ServeEngine(**engine_kw)`` and ``ContinuousScheduler(**sched_kw)``.
    The scheduler's clock is ``time.perf_counter`` plus ``skew_s`` times
    this rank's number, or with ``tick_s`` a virtual clock that every
    reading advances by ``tick_s`` (a sleep jumps).  Returns each request's tokens, finish reason,
    arrival, admission and finish times, prefix tokens, speculation rounds,
    mean accepted length and error (``results``); the scheduler's stats
    (``fault`` the fault plane's site hits and the retry and reason
    counters); the kernels' launches in the timed run (``count``: this
    rank's counters, zeroed just before it); ``summarize``'s metrics and
    the run's seconds; ``radix_hash`` (:func:`radix_pages_hash` of the
    final state), what the engine holds (:func:`held`) and the final
    state's pool bytes (:func:`pool_bytes`).
    ``ckpt_dir``: serve its latest checkpoint's params instead of
    ``params_np``; ``card_seed``: weights drawn on the card.

    Faults: ``faults`` (a ``--faults`` spec) is the engine's plane for the
    run (``sched_kw`` may set ``snapshot_every``).  A ``CrashError`` that
    ends the run is restored: rank 0 writes the scheduler's last snapshot
    into ``snapshot_dir`` (``save_snapshot``), every rank reads it and a
    fresh scheduler (``sched_kw`` without ``snapshot_every``, no plane)
    restores it; ``crashed`` says so, and the fault stats are the
    crashed run's.  ``cancel`` ({"after": uid, "uids": [...]}) cancels
    ``uids`` from rank 0's ``on_finish`` of request ``after`` (from the
    one process off a mesh).  ``restore_from``: restore that snapshot
    file on a fresh scheduler instead of running ``requests``."""
    from repro_torch.train.faults import CrashError
    from repro_torch.train.serve_scheduler import (ContinuousScheduler,
                                                   Request, load_snapshot,
                                                   save_snapshot, summarize)
    m = mesh_for(mesh, device) if mesh else None
    params, cfg = _served_params(cfg, params_np, ckpt_dir, card_seed,
                                 m.device if m else device)
    rank = 0 if m is None else m.rank
    eng = ServeEngine(cfg, params, device=device, mesh=m, max_len=max_len,
                      **(engine_kw or {}))
    del params
    kw = dict(sched_kw or {})
    if tick_s is None:
        kw.update(time_fn=lambda: time.perf_counter() + skew_s * rank)
    else:
        clock = TickClock(tick_s)
        kw.update(time_fn=clock.time, sleep_fn=clock.sleep)

    def scheduler(**extra):
        return ContinuousScheduler(eng, max_batch=max_batch,
                                   **{**kw, **extra})
    sched = scheduler()
    reqs = [Request(prompt=np.asarray(r["prompt"], np.int32),
                    max_new_tokens=int(r["max_new_tokens"]),
                    arrival_s=float(r.get("arrival_s", 0.0)),
                    deadline_s=r.get("deadline_s"), uid=r.get("uid"))
            for r in requests]
    on_finish = None
    if cancel is not None and rank == 0:
        def on_finish(res):
            if res.uid == cancel["after"]:
                for uid in cancel["uids"]:
                    sched.cancel(uid)
    eng.faults = faults
    _sync(device)
    if count:
        zero_launch_counts()
    t0 = time.perf_counter()
    crashed = False
    if restore_from is not None:
        eng.faults = None
        results = sched.restore(load_snapshot(restore_from))
    else:
        try:
            results = sched.run(reqs, on_finish=on_finish)
        except CrashError:
            crashed = True
            path = os.path.join(snapshot_dir, "snapshot.json")
            save_snapshot(sched.last_snapshot, path, mesh=m)
            crashed_stats = sched.fault_stats()
            eng.faults = None
            sched = scheduler(snapshot_every=0)
            results = sched.restore(load_snapshot(path))
    _sync(device)
    seconds = time.perf_counter() - t0
    fault = crashed_stats if crashed else sched.fault_stats()
    eng.faults = None
    out = {"results": _result_dicts(results),
           "stats": {"spec": sched.spec_stats(),
                     "prefix": sched.prefix_stats(),
                     "kv": sched.kv_stats(), "fault": fault},
           "crashed": crashed,
           "summary": summarize(results, seconds), "seconds": seconds,
           "radix_hash": radix_pages_hash(sched.last_state), "rank": rank,
           "held": held(eng), "pool_bytes": pool_bytes(sched.last_state)}
    if count:
        out["counts"] = launch_counts()
    return out


def teardown_probe(mesh: str, device: str = "cpu") -> dict:
    """Leave the mesh's process groups held the ways a run leaves them (a
    ``Mesh`` cached in ``_MESHES``, and one in a reference cycle), run a
    few collectives, then tear the world down with ``close_world``:
    the names of the threads this process still runs (gloo's worker and
    transport threads must all be gone)."""
    m = mesh_for(mesh, device)
    cycle = {"mesh": mesh_lib.make_train_mesh(mesh, device=device)}
    cycle["self"] = cycle
    x = torch.ones(4, device=m.device)
    for _ in range(3):
        coll.all_gather(x, m.group(m.axis_names), 0)
        coll.all_reduce(x, cycle["mesh"].group(m.axis_names))
    del cycle, x
    mesh_lib.close_world()
    task = "/proc/self/task"
    names = []
    if os.path.isdir(task):
        for t in os.listdir(task):
            try:
                with open(os.path.join(task, t, "comm")) as f:
                    names.append(f.read().strip())
            except OSError:
                pass
    return {"threads": sorted(names)}


def collective_counts(mesh: str, device: str = "cpu") -> dict:
    """One all-reduce, all-gather, reduce-scatter and broadcast of a
    (4, 8) f32 tensor over every rank, under the step counter
    (``roofline.torch_cost``): its collective bytes by kind."""
    from repro_torch.roofline.torch_cost import StepCounter
    m = mesh_for(mesh, device)
    group = m.group(m.axis_names)
    x = torch.ones((4, 8), device=m.device)
    with StepCounter() as counter:
        coll.all_reduce(x, group)
        coll.all_gather(x, group, 0)
        out = torch.empty((4 // m.world_size, 8), device=m.device)
        torch.distributed.reduce_scatter_tensor(out, x, group=group)
        torch.distributed.broadcast(x, 0, group=group)
    return dict(counter.count.coll)


def run(scenarios: List[tuple], device: str = "cpu") -> dict:
    """Run ``(name, function name, kwargs)`` scenarios in order on this
    rank; {name: result}, and under "_seconds" each scenario's wall time
    on this rank."""
    out = {"_seconds": {}}
    for name, fn, kwargs in scenarios:
        t0 = time.perf_counter()
        out[name] = globals()[fn](device=device, **kwargs)
        out["_seconds"][name] = time.perf_counter() - t0
        if torch.device(device).type == "cuda":
            # The ranks share a card: a scenario's cached blocks must not
            # hold memory the next one (or the other rank) needs.
            gc.collect()
            torch.cuda.empty_cache()
    return out
