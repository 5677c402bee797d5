"""Carry parameters between the JAX package and the port.

The port keeps the reference's parameter tree: nested dicts with the same
keys, and the leading stacked ``n_super`` axis on every leaf of
``params["blocks"]``.  ``params_from_jax`` takes that tree as numpy arrays
(``jax.device_get`` of the reference's params), or the flat
``{keystr: array}`` form that the reference's checkpoint manifest names
(``"['blocks']['layer0']['attn']['wq']"``), and returns torch tensors on the
CPU; ``params_to_numpy`` goes back.  Both copy bits unchanged.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_KEY = re.compile(r"\['([^']*)'\]")


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def parse_keystr(key: str):
    """The dict keys of a ``keystr`` path."""
    parts = _KEY.findall(key)
    if not parts or keystr(parts) != key:
        raise ValueError(f"not a dict keypath: {key!r}")
    return parts


def flatten(tree, prefix=()) -> Dict[str, object]:
    """{keystr(path): leaf} over a nested dict, in key-sorted order (the
    reference's pytree order)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[keystr(prefix + (k,))] = v
    return out


def unflatten(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for key, leaf in flat.items():
        path = parse_keystr(key)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t) -> np.ndarray:
    """A host copy of a tensor (or array) as numpy, bits unchanged."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        raise TypeError("bfloat16 has no numpy dtype; cast before export")
    return t.numpy().copy()


def params_from_jax(tree_or_flat) -> dict:
    """The reference's params (nested numpy tree, or flat keystr dict) as
    the port's nested dict of CPU tensors."""
    if tree_or_flat and all(isinstance(k, str) and k.startswith("[")
                            for k in tree_or_flat):
        tree_or_flat = unflatten(tree_or_flat)
    flat = flatten(tree_or_flat)
    return unflatten({k: _to_tensor(v) for k, v in flat.items()})


def params_to_numpy(params) -> dict:
    """The port's params as a nested dict of numpy arrays (the reference's
    pytree, host side)."""
    return unflatten({k: to_numpy(v) for k, v in flatten(params).items()})
