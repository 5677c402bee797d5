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
beyond ``keep`` are removed.  Writes are synchronous; the reference's
``AsyncCheckpointer`` comes with ROADMAP queue A item 6.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np

from repro_torch import bridge


def _treedef_str(tree) -> str:
    """``str(treedef)`` of a nested dict as JAX prints it."""
    def fmt(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({fmt(tree)})"


def save(directory: str, step: int, tree: Any,
         metadata: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically save ``tree`` (a nested dict of tensors or arrays: params,
    opt state, ...) at ``step``; returns the step directory."""
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
    manifest = {
        "step": step,
        "num_leaves": len(flat),
        "treedef": _treedef_str(tree),
        "paths": list(flat),
        # Leaves are stored gathered from one device: no layout to record.
        "shardings": [""] * len(flat),
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


def restore(directory: str, step: int, like):
    """Restore a whole checkpoint into the structure of ``like`` (a nested
    dict whose leaves have ``.shape``) as a nested dict of numpy arrays.
    Leaves are taken in order, as the reference restores; a keypath or
    shape that differs from the manifest's raises ``ValueError``."""
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = bridge.flatten(like)
    if manifest["num_leaves"] != len(want):
        raise ValueError(f"{path}: checkpoint has {manifest['num_leaves']} "
                         f"leaves, expected {len(want)}")
    paths = manifest.get("paths") or list(want)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (key, like_leaf) in enumerate(want.items()):
            leaf = data[f"leaf_{i}"]
            if paths[i] != key or tuple(leaf.shape) != tuple(like_leaf.shape):
                raise ValueError(
                    f"{path}: leaf {i} is {paths[i]!r} {leaf.shape}, caller "
                    f"expects {key!r} {tuple(like_leaf.shape)}")
            out[key] = leaf
    return bridge.unflatten(out)


def restore_subtree(directory: str, step: int, like, prefix: str):
    """Restore one top-level subtree (e.g. ``'params'``) of a checkpoint as a
    nested dict of numpy arrays shaped like ``like`` (a nested dict whose
    leaves have ``.shape``, e.g. tensors on the ``meta`` device).  A leaf
    the checkpoint lacks raises ``KeyError``; a shape that differs (a
    config or depth mismatch) raises ``ValueError``."""
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    paths = manifest.get("paths")
    if paths is None:
        raise ValueError(f"{path}: checkpoint predates keypath manifests")
    index = {p: i for i, p in enumerate(paths)}
    head = bridge.keystr((prefix,))
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
            out[keypath] = leaf
    return bridge.unflatten(out)


def load_metadata(directory: str, step: int) -> dict:
    with open(os.path.join(_step_dir(directory, step), "manifest.json")) as f:
        return json.load(f)["metadata"]
