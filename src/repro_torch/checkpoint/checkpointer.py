"""Atomic checkpointing in the reference's layout
(``repro/checkpoint/checkpointer.py``), pure numpy:

    <dir>/step_<N>/manifest.json   leaf keypaths + metadata
                   arrays.npz      leaf_<i> arrays, stored gathered

Leaves are numbered in the order JAX flattens the same tree (dict keys
sorted) and the manifest records each leaf's keypath string
(``"['params']['blocks']['layer0']['attn']['wq']"``, the format of
``jax.tree_util.keystr`` that ``bridge.keystr`` reproduces), so the JAX
package restores what the port writes and the port restores, and serves,
what the JAX ``ProgressiveTrainer`` wrote.  A save is written to
``step_<N>.tmp``, its manifest fsync'd, then renamed; the oldest steps
beyond ``keep`` are removed.

Fault sites (``train.faults``): ``save(faults=)`` fires ``ckpt.write`` in
the torn-write window, after ``arrays.npz`` lands and before the manifest,
so an injected fault or crash leaves a ``.tmp`` that :func:`all_steps`
ignores and the next save sweeps; :func:`restore` and
:func:`restore_subtree` fire ``ckpt.restore`` before any file is read.
:class:`AsyncCheckpointer` keeps one write in flight: its snapshot is a
device clone taken on the compute stream before ``save`` returns, and the
device-to-host copy and the file write run in a worker thread.

On a mesh (``mesh=`` with ``shardings``, a spec tree shaped like the
saved tree) every rank calls ``save``; each leaf in turn is gathered to
rank 0 alone (``gather_to_writer``: the ranks that split it with rank 0
send their shards, the others hold nothing) and moved to its host memory
before the next leaf, and rank 0 writes, in the format above, so a mesh's
checkpoint is a single-device checkpoint (the manifest records each
leaf's spec).  No rank ever holds the whole state on its device: rank 0
holds one whole leaf at a time.  ``restore``/``restore_subtree`` with
``mesh=`` and ``shardings`` slice each leaf as it is read, and return
this rank's slices: a checkpoint saved under any mesh restores under any
other, or under none.  The two leaves a tensor-parallel rank holds packed
(Mamba's ``in_proj``, MLA's ``wkv_b``: ``sharding.held_parts``) are
unpacked on the way to the file and packed again as they are read, so
the file always holds the reference's layout.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.distributed.sharding import (dim_axes, held_parts, pack,
                                              unpack)
from repro_torch.train import faults as faults_lib
from repro_torch.tree import tree_leaves, tree_map


def _treedef_str(tree) -> str:
    """``str(treedef)`` of a nested dict as JAX prints it."""
    def fmt(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({fmt(tree)})"


def _leaf_to_writer(x, spec, mesh, path):
    """Rank 0: the whole leaf in host memory; every other rank None.  The
    ranks that split the leaf with rank 0 (those at coordinate 0 on every
    axis the leaf is not split over) send their shards to rank 0 in one
    ``gather`` over their group; the rest take no part.  Under gloo the
    shards go through host memory (their destination), under NCCL they
    are gathered on the devices.  A packed leaf (``sharding.held_parts``)
    is unpacked: the file holds the reference's layout."""
    axes = tuple(a for a in mesh.axis_names
                 if mesh.shape[a] > 1 and any(a in dim_axes(e) for e in spec))
    if not axes:
        if mesh.rank != 0:
            return None
        return x.cpu() if isinstance(x, torch.Tensor) else x
    if any(mesh.coords[a] for a in mesh.axis_names if a not in axes):
        return None
    src = x.detach().contiguous()
    if mesh.backend != "nccl":
        src = src.cpu()
    n = mesh.axes_size(axes)
    parts = [torch.empty_like(src) for _ in range(n)] \
        if mesh.rank == 0 else None
    dist.gather(src, parts, dst=0, group=mesh.group(axes))
    if mesh.rank != 0:
        return None
    full = torch.empty(tuple(s * mesh.axes_size(dim_axes(e))
                             for s, e in zip(src.shape, spec)),
                       dtype=src.dtype)
    sizes = [mesh.shape[a] for a in axes]
    for j, part in enumerate(parts):
        coords = dict(zip(axes, np.unravel_index(j, sizes)))
        index = []
        for d, e in enumerate(spec):
            i = 0
            for a in dim_axes(e):
                i = i * mesh.shape[a] + int(coords.get(a, 0))
            index.append(slice(i * src.shape[d], (i + 1) * src.shape[d]))
        full[tuple(index)] = part.cpu()
    return unpack(full, held_parts(path, spec, mesh, full.shape[-1]),
                  mesh.shape.get("model", 1))


def gather_to_writer(tree: Any, shardings: Any, mesh) -> Optional[Any]:
    """Rank 0: ``tree``'s leaves whole in host memory, gathered one leaf at
    a time; every other rank None (a collective: every rank of ``mesh``
    calls it)."""
    flat = bridge.flatten(tree)
    specs = bridge.flatten(shardings)
    out = {k: _leaf_to_writer(x, specs[k], mesh, bridge.parse_keystr(k))
           for k, x in flat.items()}
    return bridge.unflatten(out) if mesh.rank == 0 else None


def _is_writer(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def save(directory: str, step: int, tree: Any,
         metadata: Optional[dict] = None, keep: int = 3, faults=None,
         mesh=None, shardings=None) -> Optional[str]:
    """Atomically save ``tree`` (a nested dict of tensors or arrays: params,
    opt state, ...) at ``step``; returns the step directory.

    ``faults`` (a ``train.faults`` plane) arms the ``ckpt.write`` site
    after ``arrays.npz`` lands and before the manifest: the preemption
    window.  The step directory is then left as a ``.tmp`` that
    :func:`all_steps` ignores and the next save sweeps, so the previous
    checkpoint stays the latest.  With ``mesh`` every rank calls it: the
    leaves are gathered to rank 0, which writes (the others return
    None)."""
    if mesh is not None:
        tree = gather_to_writer(tree, shardings, mesh)
        if not _is_writer(mesh):
            return None
    return _write(directory, step, tree, metadata, keep, faults, shardings)


def _write(directory: str, step: int, tree: Any, metadata, keep: int,
           faults, shardings) -> str:
    plane = faults_lib.resolve(faults)
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = bridge.flatten(tree)
    arrays = {f"leaf_{i}": bridge.to_numpy(x)
              for i, x in enumerate(flat.values())}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    plane.fire("ckpt.write")
    manifest = {
        "step": step,
        "num_leaves": len(flat),
        "treedef": _treedef_str(tree),
        "paths": list(flat),
        # Leaves are stored whole; a mesh's specs are recorded.
        "shardings": ([repr(s) for s in bridge.flatten(shardings).values()]
                      if shardings is not None else [""] * len(flat)),
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}")


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, name, "manifest.json")):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _slice(a: np.ndarray, spec, mesh, path) -> np.ndarray:
    """This rank's shard of a whole numpy leaf under ``spec`` (a packed
    leaf packed first)."""
    if a.ndim:
        a = pack(a, held_parts(path, spec, mesh, a.shape[-1]),
                 mesh.shape.get("model", 1))
    for d, e in enumerate(spec):
        axes = dim_axes(e)
        n = mesh.axes_size(axes)
        if n > 1:
            size = a.shape[d] // n
            i = mesh.axes_index(axes)
            a = a[(slice(None),) * d + (slice(i * size, (i + 1) * size),)]
    return np.array(a, order="C")       # 0-d leaves stay 0-d


def _slicer(shardings, mesh):
    """(key, whole leaf) -> what the caller keeps: this rank's slice on a
    mesh, taken as the leaf is read, else the leaf."""
    if mesh is None:
        return lambda key, a: a
    specs = bridge.flatten(shardings)
    return lambda key, a: _slice(a, specs[key], mesh,
                                 bridge.parse_keystr(key))


def restore(directory: str, step: int, like, faults=None, mesh=None,
            shardings=None):
    """Restore a whole checkpoint into the structure of ``like`` (a nested
    dict whose leaves have ``.shape``) as a nested dict of numpy arrays.
    Leaves are taken in order, as the reference restores; a keypath or
    shape that differs from the manifest's raises ``ValueError``.
    ``faults`` arms the ``ckpt.restore`` site before any file is read, so
    a faulted read loads nothing and the caller may retry.  With ``mesh``
    and ``shardings`` (a spec tree shaped like ``like``, whose shapes are
    the whole leaves') each leaf comes back as this rank's slice."""
    faults_lib.resolve(faults).fire("ckpt.restore")
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = bridge.flatten(like)
    if manifest["num_leaves"] != len(want):
        raise ValueError(f"{path}: checkpoint has {manifest['num_leaves']} "
                         f"leaves, expected {len(want)}")
    paths = manifest.get("paths") or list(want)
    keep = _slicer(shardings, mesh)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (key, like_leaf) in enumerate(want.items()):
            leaf = data[f"leaf_{i}"]
            if paths[i] != key or tuple(leaf.shape) != tuple(like_leaf.shape):
                raise ValueError(
                    f"{path}: leaf {i} is {paths[i]!r} {leaf.shape}, caller "
                    f"expects {key!r} {tuple(like_leaf.shape)}")
            out[key] = keep(key, leaf)
    return bridge.unflatten(out)


def restore_subtree(directory: str, step: int, like, prefix: str,
                    faults=None, mesh=None, shardings=None):
    """Restore one top-level subtree (e.g. ``'params'``) of a checkpoint as a
    nested dict of numpy arrays shaped like ``like`` (a nested dict whose
    leaves have ``.shape``, e.g. tensors on the ``meta`` device).  A leaf
    the checkpoint lacks raises ``KeyError``; a shape that differs (a
    config or depth mismatch) raises ``ValueError``.  ``faults`` arms the
    ``ckpt.restore`` site before any file is read.  ``mesh`` and
    ``shardings`` slice as in :func:`restore`."""
    faults_lib.resolve(faults).fire("ckpt.restore")
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    paths = manifest.get("paths")
    if paths is None:
        raise ValueError(f"{path}: checkpoint predates keypath manifests")
    index = {p: i for i, p in enumerate(paths)}
    head = bridge.keystr((prefix,))
    keep = _slicer(shardings, mesh)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for keypath, like_leaf in bridge.flatten(like).items():
            key = head + keypath
            if key not in index:
                raise KeyError(f"{path}: no leaf {key!r} in checkpoint "
                               f"(subtree {prefix!r})")
            leaf = data[f"leaf_{index[key]}"]
            want = tuple(like_leaf.shape)
            if tuple(leaf.shape) != want:
                raise ValueError(
                    f"{path}: leaf {key!r} has shape {leaf.shape}, caller "
                    f"expects {want} — config/depth mismatch between the "
                    "checkpoint and the requested model")
            out[keypath] = keep(keypath, leaf)
    return bridge.unflatten(out)


def load_metadata(directory: str, step: int) -> dict:
    with open(os.path.join(_step_dir(directory, step), "manifest.json")) as f:
        return json.load(f)["metadata"]


class AsyncCheckpointer:
    """Overlaps a checkpoint's device-to-host copy and file write with
    training, one write in flight.

    ``save`` returns once a device clone of every tensor leaf is queued on
    the current (compute) stream: the trainer updates params and momenta
    in place, so the next step would otherwise change what the write reads.
    A worker thread waits for the clones (an event, not the whole stream),
    copies them to the host on a side stream, so the copy overlaps the next
    step, and runs :func:`save`.  Errors, an injected ``CrashError``
    included, surface on the next ``wait`` or ``save``.  On a mesh every
    rank calls ``save``: the leaves are gathered to rank 0's host memory
    (a collective, so not in the worker; the gathered tree is already a
    copy, so no device clone is taken) and rank 0's worker writes them."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, directory: str, step: int, tree: Any,
             metadata: Optional[dict] = None, keep: int = 3, faults=None,
             mesh=None, shardings=None):
        snap = None
        if mesh is not None:
            # The gather first, on every rank: an error of rank 0's last
            # write must not make it skip a collective the others enter.
            snap = gather_to_writer(tree, shardings, mesh)
            if not _is_writer(mesh):
                return
        self.wait()
        if snap is None:
            snap = tree_map(lambda x: x.detach().clone()
                            if isinstance(x, torch.Tensor) else x, tree)
        cuda = [x for x in tree_leaves(snap)
                if isinstance(x, torch.Tensor) and x.is_cuda]
        ready = side = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record()
            side = torch.cuda.Stream(device=cuda[0].device)

        def run():
            try:
                host = snap
                if ready is not None:
                    ready.synchronize()
                    with torch.cuda.stream(side):
                        host = tree_map(lambda x: x.cpu()
                                        if isinstance(x, torch.Tensor)
                                        else x, snap)
                _write(directory, step, host, metadata, keep, faults,
                       shardings)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the write in flight; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
