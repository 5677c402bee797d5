"""Checkpoint reading (``repro/checkpoint/checkpointer.py``, the read side).

Reads the reference's layout, so the port serves what the JAX
``ProgressiveTrainer`` wrote, at its grown depth:

    <dir>/step_<N>/manifest.json   leaf keypaths + metadata
                   arrays.npz      leaf_<i> arrays, stored gathered

Leaves are matched by the keypath strings the manifest records
(``"['params']['blocks']['layer0']['attn']['wq']"``), the format of
``jax.tree_util.keystr`` that ``bridge.keystr`` reproduces.  Writing,
keep-N and the async checkpointer come with ROADMAP queue A item 6.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from repro_torch import bridge


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
