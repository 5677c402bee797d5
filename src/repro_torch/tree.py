"""Nested-dict trees of tensors: the port's counterpart of the ``jax.tree``
utilities its modules use.  Leaves are visited in sorted key order, the
order in which JAX flattens a dict, so sums over leaves and checkpoint
leaf numbering follow the reference's."""
from __future__ import annotations

from typing import Callable, Iterator, Tuple


def tree_map(fn: Callable, *trees):
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_map_with_path(fn: Callable, *trees, path: Tuple[str, ...] = ()):
    """``fn(path, *leaves)``; ``path`` is the tuple of dict keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map_with_path(fn, *(t[k] for t in trees),
                                      path=path + (k,))
                for k in trees[0]}
    return fn(path, *trees)


def leaves_with_path(tree, path: Tuple[str, ...] = ()) -> Iterator:
    """(path, leaf) pairs in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]
