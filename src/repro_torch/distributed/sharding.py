"""Parameter, batch and cache placement rules
(``repro/distributed/sharding.py``), as pure functions of a leaf's path,
its full shape and the mesh's axis sizes.

Strategy (the reference's MaxText-style rules):
  * 'model': tensor parallelism over heads, d_ff, vocab and experts;
  * 'data': FSDP, every param leaf additionally sharded over 'data' on its
    largest remaining dim;
  * 'pod': pure data parallelism.
A dim that does not divide its axis degrades to replication.  The stack
axis of ``blocks``/``enc_blocks`` is never sharded.

A spec is the reference's ``PartitionSpec`` as a tuple, one entry per dim:
None, an axis name, or a tuple of axis names (the batch rule writes a
one-axis tuple where JAX 0.9 prints the bare name; ``same_spec`` takes the
two as equal).  ``placements`` gives a spec's ``torch.distributed.tensor``
placements.  ``mesh`` is anything with ``.shape`` (axis name -> size) and
``.axis_names``: a ``launch.mesh.Mesh``, or a ``MeshShape`` for a mesh
that is not built.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.tree import tree_map_with_path

Spec = Tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes only: the rules need nothing else."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


# name fragments -> which dim gets the 'model' axis (negative = from end)
_MODEL_DIM_RULES = [
    # MoE expert stacks (E, D, F): shard experts (EP)
    (("w_gate", "w_up", "w_down"), "moe", 0),
    # embeddings: shard vocab
    (("embed",), None, 0),
    (("lm_head",), None, -1),                 # (D, V): shard vocab
    # attention projections: shard heads dim (= last for wq/wk/wv, first for wo)
    (("wq", "wk", "wv", "wkv_a", "wkv_b", "w_r", "w_k", "w_v", "w_g",
      "cm_k", "in_proj", "x_proj"), None, -1),
    (("wo", "w_o", "cm_v", "out_proj", "w_down"), None, -2),
    (("w_gate", "w_up"), None, -1),           # dense FFN: shard d_ff
    (("dt_proj", "w_a", "w_b", "router", "shared"), None, -1),
]


def _model_dim(names: Tuple[str, ...], ndim: int) -> Optional[int]:
    last = names[-1]
    in_moe = "moe" in names and "shared" not in names
    for keys, scope, dim in _MODEL_DIM_RULES:
        if last in keys:
            if scope == "moe" and not in_moe:
                continue
            return dim % ndim if ndim else None
    return None


def _largest_first(shape) -> list:
    """Dims by size, largest first, ties in dim order (numpy's argsort of
    the negated sizes, which is stable at these lengths)."""
    return sorted(range(len(shape)), key=lambda d: -shape[d])


def param_spec(path, shape, mesh, fsdp: bool = True, moe_fsdp: str = "auto",
               layout: str = "tp") -> Spec:
    """Spec of one parameter leaf: ``path`` the tuple of dict keys,
    ``shape`` its full shape.

    moe_fsdp: 'auto' FSDP picks the largest remaining dim; 'ef' shards an
    MoE expert stack's expert-ffn dim over 'data' instead.  layout 'fsdp'
    is pure ZeRO-3: every leaf on its largest dim over ('data', 'model'),
    no tensor parallelism."""
    names = tuple(path)
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    axes: list = [None] * ndim
    sizes = dict(mesh.shape)
    offset = 1 if names and names[0] in ("blocks", "enc_blocks") else 0

    def divides(d, axis):
        return axis in sizes and shape[d] % sizes[axis] == 0

    if layout == "fsdp":
        total = sizes.get("data", 1) * sizes.get("model", 1)
        order = _largest_first(shape)
        for d in order:
            if d >= offset and shape[d] % total == 0 and shape[d] >= total:
                axes[d] = ("data", "model")
                return tuple(axes)
        for d in order:                      # fall back to 'data' only
            if d >= offset and divides(d, "data") \
                    and shape[d] >= sizes.get("data", 1):
                axes[d] = "data"
                return tuple(axes)
        return tuple(axes)

    in_moe = "moe" in names and "shared" not in names
    md = _model_dim(names, ndim - offset)
    if md is not None:
        md = md % (ndim - offset) + offset
        if divides(md, "model"):
            axes[md] = "model"

    if fsdp and "data" in sizes:
        if moe_fsdp == "ef" and in_moe and names[-1] in ("w_gate", "w_up",
                                                         "w_down"):
            ef_dim = ndim - 1 if names[-1] in ("w_gate", "w_up") else ndim - 2
            if axes[ef_dim] is None and divides(ef_dim, "data"):
                axes[ef_dim] = "data"
                return tuple(axes)
        for d in _largest_first(shape):
            if d >= offset and axes[d] is None and divides(d, "data") \
                    and shape[d] >= sizes["data"]:
                axes[d] = "data"
                break
    return tuple(axes)


def params_shardings(params, mesh, fsdp: bool = True, moe_fsdp: str = "auto",
                     layout: str = "tp"):
    """Spec tree for a params (or moment) tree; leaves need ``.shape``
    (tensors on any device, ``meta`` included)."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, leaf.shape, mesh, fsdp=fsdp,
                                      moe_fsdp=moe_fsdp, layout=layout),
        params)


def replicated(mesh=None) -> Spec:
    return ()


def opt_state_shardings(opt_state, mesh, fsdp: bool = True,
                        moe_fsdp: str = "auto", layout: str = "tp"):
    """'m'/'v' moment trees get their params' rules (so an expanded state
    re-shards as the expanded params do); 'step' and other scalars are
    replicated."""
    out = {}
    for k, v in opt_state.items():
        if k in ("m", "v"):
            out[k] = params_shardings(v, mesh, fsdp=fsdp, moe_fsdp=moe_fsdp,
                                      layout=layout)
        else:
            out[k] = tree_map_with_path(lambda p, _: replicated(mesh), v) \
                if isinstance(v, dict) else replicated(mesh)
    return out


def batch_axes(batch_size: int, mesh, layout: str = "tp") -> Tuple[str, ...]:
    """The DP axes dim 0 of a batch leaf goes over: the largest contiguous
    run of ('pod', 'data') (with 'model' under the fsdp layout) whose
    extent divides ``batch_size``; () replicates."""
    dp_names = ("pod", "data") if layout == "tp" else ("pod", "data",
                                                       "model")
    sizes = dict(mesh.shape)
    dp_full = tuple(a for a in dp_names if a in sizes)
    cands = [dp_full[i:j] for i in range(len(dp_full))
             for j in range(i + 1, len(dp_full) + 1)]
    cands.sort(key=lambda c: -int(np.prod([sizes[a] for a in c])))
    for cand in cands:
        if batch_size % int(np.prod([sizes[a] for a in cand])) == 0:
            return cand
    return ()


def batch_shardings(batch_specs, mesh, layout: str = "tp"):
    """Every batch input over the DP axes on dim 0 (``batch_axes``)."""
    def one(_, leaf):
        axes: list = [None] * len(leaf.shape)
        if leaf.shape:
            cand = batch_axes(leaf.shape[0], mesh, layout)
            if cand:
                axes[0] = cand
        return tuple(axes)
    return tree_map_with_path(one, batch_specs)


_PAGED = ("k_pages", "v_pages", "latent_pages", "k_scales", "v_scales",
          "latent_scales")


def cache_shardings(cache_specs, mesh):
    """KV caches and recurrent states: the batch dim (after the leading
    super-block axis, which is never sharded) over the DP axes, then the
    longest remaining dim over 'model'.  Paged pool leaves have no batch
    dim and keep their page dim whole: only their trailing dims are
    candidates for 'model'."""
    sizes = dict(mesh.shape)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_total = int(np.prod([sizes[a] for a in dp])) if dp else 1

    def one(path, leaf):
        paged = bool(path) and path[-1] in _PAGED
        shape = tuple(leaf.shape)
        axes: list = [None] * len(shape)
        if not paged and dp and len(shape) >= 2 \
                and shape[1] % dp_total == 0 and shape[1] >= dp_total:
            axes[1] = dp
        if "model" in sizes:
            for d in sorted(range(2, len(shape)), key=lambda d: -shape[d]):
                if shape[d] % sizes["model"] == 0 \
                        and shape[d] >= sizes["model"]:
                    axes[d] = "model"
                    break
        return tuple(axes)
    return tree_map_with_path(one, cache_specs)


# ---------------------------------------------------------------------------
# Reading a spec
# ---------------------------------------------------------------------------


def dim_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry as a tuple (None -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def same_spec(a: Spec, b: Spec) -> bool:
    """Specs equal dim by dim, a one-axis tuple equal to its bare name and
    trailing Nones ignored (JAX's ``PartitionSpec`` normalizations)."""
    a = [dim_axes(e) for e in a]
    b = [dim_axes(e) for e in b]
    n = max(len(a), len(b))
    return a + [()] * (n - len(a)) == b + [()] * (n - len(b))


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a spec shards over."""
    return tuple(a for e in spec for a in dim_axes(e))


# Leaves whose last dim packs two halves that their layer splits over
# 'model' half by half: Mamba's in_proj (xs | z) and MLA's wkv_b (K | V).
_PACKED = ("in_proj", "wkv_b")


def held_parts(path, spec: Spec, mesh, last: int) -> int:
    """2 where the leaf at ``path``, whole last dim ``last``, is held
    packed: its last dim is split over 'model' alone, and its two halves
    each split evenly; else 1.
    A packed leaf's 'model' rank r holds [half 0's chunk r | half 1's
    chunk r] (``pack``), so a rank's Mamba channels get their xs and z
    columns and a rank's MLA heads their K and V columns, where the
    reference's contiguous split would give rank 0 all of xs (or K).
    The whole leaf, and so every checkpoint, keeps the reference's
    layout: ``pack`` is applied where a whole leaf is cut into shards and
    ``unpack`` where shards are put back together."""
    if not path or path[-1] not in _PACKED or not spec \
            or dim_axes(spec[-1]) != ("model",):
        return 1
    m = dict(mesh.shape).get("model", 1)
    return 2 if m > 1 and last % (2 * m) == 0 else 1


def pack(x, parts: int, n: int):
    """Whole leaf (torch or numpy) -> the held order of its last dim for
    ``n`` 'model' ranks: each rank's chunk of every part, rank by rank.
    The identity for ``parts`` 1."""
    if parts == 1:
        return x
    lead, last = tuple(x.shape[:-1]), x.shape[-1]
    y = x.reshape(lead + (parts, n, last // (parts * n))).swapaxes(-3, -2)
    return y.reshape(lead + (last,))


def unpack(x, parts: int, n: int):
    """Inverse of :func:`pack`."""
    if parts == 1:
        return x
    lead, last = tuple(x.shape[:-1]), x.shape[-1]
    y = x.reshape(lead + (n, parts, last // (parts * n))).swapaxes(-3, -2)
    return y.reshape(lead + (last,))


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    sizes = dict(mesh.shape)
    out = list(shape)
    for d, e in enumerate(spec):
        n = int(np.prod([sizes[a] for a in dim_axes(e)]))
        out[d] //= n
    return tuple(out)


def placements(spec: Spec, mesh) -> tuple:
    """The spec as ``torch.distributed.tensor`` placements, one per mesh
    axis: ``Shard(dim)`` where the axis shards ``dim``, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dims = [d for d, e in enumerate(spec) if axis in dim_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)
