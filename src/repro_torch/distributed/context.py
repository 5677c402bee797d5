"""The mesh the model code runs under (the reference's ``set_active_mesh``/
``maybe_shard`` and its activation layout).

A trainer or server on a mesh runs the model code inside ``mesh_scope``
with a :class:`MeshContext`, and the layers and the optimizer ask this
module what to do with their leaves.  ``materialize`` gathers a subtree's
FSDP shards (and the 'model' shards of a leaf whose layer computes it
whole) with autograd gathers, so a super-block's leaves are gathered
before its forward and, under remat, again in its backward;
``model_group`` is the group a layer's all-reduces go over.  The
optimizer's helpers (``full_matrices``, ``local_matrices``,
``leaf_sq_sum``) give a leaf's whole matrices, a rank's slice and a
squared norm counted once per element.  With no mesh every
helper is the identity and the single-device code runs unchanged.

Under the 'tp' layout a layer computes on its rank's share of 'model'
where the reference's rule splits its leaves there and the dim divides
(``keeps_model_split``):

  * ``attn_tp``: MHA/GQA on H/model whole query heads, over KV/model KV
    heads where they divide 'model', or over the one KV head those query
    heads read where 'model' is a multiple of KV (``kv_shared``);
  * ``mla_tp``: MLA on H/model query heads and KV/model heads (``wq`` and
    ``wkv_b`` column shards, ``wo`` its row shard);
  * ``mlp_tp``: the dense feed-forward and RWKV6's channel mix (``cm_k``,
    ``cm_v``) on d_ff columns;
  * ``moe_ep``: the MoE's E/model experts, ``shared_tp`` its shared
    experts' d_ff columns;
  * ``mamba_tp``: Mamba on d_inner/model channels (``in_proj``,
    ``dt_proj``, ``out_proj``);
  * ``rwkv_tp``: RWKV6's time mix on H/model heads (``w_r``, ``w_k``,
    ``w_v``, ``w_g``, ``w_b``, ``w_o``);
  * ``vocab_tp``: the embedding, head and loss on vocab rows.

The encoder-decoder takes the same rules: its encoder's ``attn``, its
decoder's ``self_attn`` and ``cross_attn``, both stacks' ``mlp`` and the
tied embedding.

Leaves the rule splits over 'model' along a dim that is not their
layer's compute split are gathered whole and used whole or sliced in the
layer: the MoE ``router`` (D x E: every rank routes every token),
Mamba's ``x_proj`` (its columns are dt|B|C; a rank takes its channels'
rows), RWKV6's ``w_a`` (the decay LoRA's rank dim), MLA's ``wkv_a``
(the latent has no head axis), and under ``kv_shared`` attention's
``wk`` and ``wv`` (the rank takes its KV head's columns).  Each passes
through ``collectives.copy_to_model`` before its slice, so the gradient
every rank leaves on its part is summed over 'model' and the held shard
keeps the whole of it.  Two leaves are held packed
(``sharding.held_parts``): Mamba's ``in_proj`` and MLA's ``wkv_b``, so a
rank's shard holds both halves of its channels or heads.

The layout ('tp': batch over the DP axes, tensor parallelism over
'model'; 'fsdp': batch over every axis, no tensor parallelism) is the
context's own field, set by the trainer's or server's ``layout``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import dim_axes, held_parts, unpack
from repro_torch.tree import tree_map_with_path


@dataclasses.dataclass
class MeshContext:
    """The mesh a trainer or server runs the model under.  ``specs``
    ({path: spec} of the leaves as the rank holds them) is set where some
    leaf is held split over an axis its layer does not compute on (FSDP
    shards, the fsdp layout's ZeRO-3, a served leaf under the server's
    ``fsdp``, ``layout`` or ``moe_fsdp``): ``materialize`` then gathers
    them.  Without it every leaf is held as the layers use it.
    ``serving``: a server's context, whose forwards take no gradient and
    compute no batch statistic (``dp_mean`` is the identity)."""
    mesh: object
    layout: str
    specs: Optional[Dict[Tuple[str, ...], tuple]] = None
    serving: bool = False

    def __post_init__(self):
        if self.layout not in ("tp", "fsdp"):
            raise ValueError(f"layout {self.layout!r} (tp or fsdp)")


_ACTIVE: list = []


@contextlib.contextmanager
def mesh_scope(ctx: Optional[MeshContext]):
    """Run the enclosed model code under ``ctx`` (None: no mesh)."""
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[MeshContext]:
    return _ACTIVE[-1] if _ACTIVE else None


def dp_axes(mesh, layout: str = "tp") -> Tuple[str, ...]:
    """The mesh's data-parallel axes: 'pod' and 'data', and 'model' too
    under the fsdp layout."""
    names = ("pod", "data") if layout == "tp" else ("pod", "data", "model")
    return tuple(a for a in names if a in mesh.shape)


def model_group(cfg):
    """The 'model' group tensor-parallel layers reduce over (None: no
    tensor parallelism: no mesh, the fsdp layout or one 'model' rank)."""
    ctx = active_mesh()
    if ctx is None or ctx.layout != "tp":
        return None
    return ctx.mesh.group(("model",))


def tp_size(cfg) -> int:
    return 1 if model_group(cfg) is None else \
        active_mesh().mesh.shape["model"]


def tp_rank() -> int:
    return active_mesh().mesh.coords.get("model", 0)


def attn_tp(cfg) -> bool:
    """MHA/GQA attention on the rank's H/model query heads: over its
    KV/model KV heads where KV divides 'model', or over the one KV head
    they read where 'model' is a multiple of KV (``kv_shared``).  Query
    heads that do not divide 'model' compute whole; MLA is
    ``mla_tp``'s."""
    m, kv = tp_size(cfg), cfg.num_kv_heads
    return (m > 1 and cfg.attention != "none" and not cfg.mla_kv_lora_rank
            and cfg.num_heads % m == 0 and (kv % m == 0 or m % kv == 0))


def kv_shared(cfg) -> bool:
    """``attn_tp`` with fewer KV heads than 'model' ranks: m/KV ranks
    share each KV head.  Their ``wk``/``wv`` are gathered whole and each
    rank takes the columns of ``kv_head``."""
    return attn_tp(cfg) and cfg.num_kv_heads < tp_size(cfg)


def kv_head(cfg) -> int:
    """Under ``kv_shared``, the KV head the rank's query heads
    [r H/m, (r+1) H/m) read: r // (m/KV)."""
    return tp_rank() // (tp_size(cfg) // cfg.num_kv_heads)


def mlp_tp(cfg) -> bool:
    """The dense feed-forward on the rank's d_ff columns."""
    m = tp_size(cfg)
    return m > 1 and cfg.d_ff % m == 0


def vocab_tp(cfg) -> bool:
    """Vocab-parallel embedding, head and loss on the rank's vocab rows."""
    m = tp_size(cfg)
    return m > 1 and cfg.vocab_size % m == 0


def moe_ep(cfg) -> bool:
    """Expert parallelism: the rank's E/model experts (the reference's
    rule puts the expert stacks' expert dim on 'model')."""
    m = tp_size(cfg)
    return m > 1 and cfg.moe is not None and cfg.moe.num_experts % m == 0


def shared_tp(cfg) -> bool:
    """The MoE's shared experts on the rank's d_ff columns (they follow the
    dense feed-forward's rule)."""
    m = tp_size(cfg)
    if m == 1 or cfg.moe is None or not cfg.moe.num_shared_experts:
        return False
    ef = cfg.moe.expert_ffn_dim or cfg.d_ff
    return (ef * cfg.moe.num_shared_experts) % m == 0


def mamba_tp(cfg) -> bool:
    """Mamba on the rank's d_inner/model channels."""
    m = tp_size(cfg)
    return (m > 1 and cfg.ssm is not None and cfg.ssm.kind == "mamba"
            and (cfg.ssm.expand * cfg.d_model) % m == 0)


def rwkv_tp(cfg) -> bool:
    """RWKV6's time mix on the rank's H/model heads."""
    m = tp_size(cfg)
    return (m > 1 and cfg.ssm is not None and cfg.ssm.kind == "rwkv6"
            and (cfg.d_model // cfg.ssm.head_dim) % m == 0)


def mla_tp(cfg) -> bool:
    """MLA on the rank's query heads and KV/model latent-derived heads."""
    m = tp_size(cfg)
    return (m > 1 and cfg.attention == "mla" and bool(cfg.mla_kv_lora_rank)
            and cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0)


def tp_local_cfg(cfg):
    """``cfg`` with a rank's share of the heads (attention under
    ``attn_tp``; one KV head under ``kv_shared``): the shapes its local
    projections and cache have."""
    m = tp_size(cfg)
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // m,
                               num_kv_heads=max(cfg.num_kv_heads // m, 1),
                               head_dim=cfg.head_dim)


_FFN = ("w_gate", "w_up", "w_down")
# The attention dicts: a decoder-only layer's, the encoder's, and the
# encoder-decoder's decoder self- and cross-attention.
_ATTN = ("attn", "self_attn", "cross_attn")


def keeps_model_split(path: Tuple[str, ...], cfg) -> bool:
    """Whether a leaf's layer computes on its 'model' shard (else the leaf
    is gathered over 'model' and computed whole)."""
    if tp_size(cfg) == 1:
        return False
    last = path[-1]
    if len(path) == 1 and last in ("embed", "lm_head"):
        return vocab_tp(cfg)
    in_attn = any(a in path for a in _ATTN)
    if in_attn and last in ("wk", "wv") and kv_shared(cfg):
        return False
    if in_attn and last in ("wq", "wk", "wv", "wo"):
        return attn_tp(cfg) or mla_tp(cfg)
    if "attn" in path and last == "wkv_b":
        return mla_tp(cfg)
    if "mlp" in path and last in _FFN:
        return mlp_tp(cfg)
    if "moe" in path and last in _FFN:
        return shared_tp(cfg) if "shared" in path else moe_ep(cfg)
    if "mamba" in path and last in ("in_proj", "dt_proj", "out_proj"):
        return mamba_tp(cfg)
    if "rwkv_tm" in path and last in ("w_r", "w_k", "w_v", "w_g", "w_b",
                                      "w_o"):
        return rwkv_tp(cfg)
    if "rwkv_tm" in path and last in ("cm_k", "cm_v"):
        return mlp_tp(cfg)
    return False


def materialize(tree, cfg, prefix: Tuple[str, ...] = ()):
    """The leaves of ``tree`` (at ``prefix`` in the params) as the layers
    use them: FSDP shards gathered over the DP axes, and over 'model'
    where the leaf's layer computes it whole (a packed leaf then
    unpacked).  The backward all-reduces
    each leaf's gradient over the DP axes, scales it by 1/DP (the loss is
    a mean over the DP ranks' rows) and keeps the rank's slice; a
    serving context gathers alone.  A super-block's slice of a stacked
    leaf (its leading axis indexed away) takes the stacked leaf's spec
    without its stack entry.  The identity where the context holds no
    specs."""
    ctx = active_mesh()
    if ctx is None or ctx.specs is None:
        return tree
    mesh = ctx.mesh
    dp = dp_axes(mesh, ctx.layout)
    group = None if ctx.serving else mesh.group(dp)
    ndp = mesh.axes_size(dp)
    scale = 1.0 / ndp if ndp > 1 and not ctx.serving else 1.0

    def one(path, x):
        full = prefix + path
        spec = ctx.specs[full]
        if len(spec) == x.ndim + 1:
            spec = spec[1:]
        keep = keeps_model_split(full, cfg)
        gathers = []
        for d, e in enumerate(spec):
            axes = tuple(a for a in dim_axes(e)
                         if not (keep and a == "model"))
            n = mesh.axes_size(axes)
            if n > 1:
                gathers.append((d, mesh.group(axes), n,
                                mesh.axes_index(axes)))
        out = coll.gather_shards(x, gathers, group, scale)
        if any("model" in dim_axes(spec[d]) for d, *_ in gathers):
            out = unpack(out, held_parts(full, spec, mesh, out.shape[-1]),
                         mesh.shape["model"])
        return out

    return tree_map_with_path(one, tree)


def dp_mean(x: torch.Tensor) -> torch.Tensor:
    """On a training mesh, a batch statistic ``x`` of the rank's rows made
    the statistic of the whole batch: the mean over the DP ranks
    (``collectives.mean_over_group``).  The identity elsewhere, serving
    included."""
    ctx = active_mesh()
    if ctx is None or ctx.specs is None or ctx.serving:
        return x
    axes = dp_axes(ctx.mesh, ctx.layout)
    n = ctx.mesh.axes_size(axes)
    return x if n == 1 else coll.mean_over_group(x, ctx.mesh.group(axes), n)


def _leaf_axes(path) -> Tuple[Tuple[str, ...], Optional[tuple]]:
    """(axes the held leaf at ``path`` is split over with more than one
    rank, its spec); ((), None) without a training mesh."""
    ctx = active_mesh()
    if ctx is None or ctx.specs is None:
        return (), None
    spec = ctx.specs[tuple(path)]
    axes = tuple(a for e in spec for a in dim_axes(e)
                 if ctx.mesh.shape[a] > 1)
    return axes, spec


def _matrix_spec(spec):
    """A spec with every dim but the trailing two (the matrix) unsplit."""
    return (None,) * (len(spec) - 2) + tuple(spec[-2:])


def full_matrices(path, x: torch.Tensor) -> torch.Tensor:
    """The held leaf with its trailing two dims whole: each matrix of a
    stack gathered, the leading dims (the layer stack, an expert stack
    split over 'model') left as the rank holds them (no autograd)."""
    axes, spec = _leaf_axes(path)
    if not axes:
        return x
    return coll.unshard_leaf(x, _matrix_spec(spec), active_mesh().mesh,
                             path)


def local_matrices(path, full: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`full_matrices`: the rank's shard of each matrix."""
    axes, spec = _leaf_axes(path)
    if not axes:
        return full
    return coll.shard_leaf(full, _matrix_spec(spec), active_mesh().mesh,
                           path)


def full_shape(path, x: torch.Tensor) -> Tuple[int, ...]:
    axes, spec = _leaf_axes(path)
    if not axes:
        return tuple(x.shape)
    mesh = active_mesh().mesh
    return tuple(s * mesh.axes_size(dim_axes(e)) if e is not None else s
                 for s, e in zip(x.shape, spec))


def leaf_sq_sum(path, sq: torch.Tensor) -> torch.Tensor:
    """A held leaf's partial sum of squares ``sq`` (any shape, e.g. one
    per layer) summed over the ranks that split the leaf: each element
    counted once, however many ranks replicate it."""
    axes, _ = _leaf_axes(path)
    if not axes:
        return sq
    return coll.all_reduce(sq, active_mesh().mesh.group(axes))


def split_over_mesh(path) -> bool:
    """Whether the held leaf at ``path`` is split over more than one rank."""
    return bool(_leaf_axes(path)[0])
