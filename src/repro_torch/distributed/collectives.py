"""Collectives of the mesh, int8 gradient compression with error feedback,
and step-time watermarks (``repro/distributed/collectives.py``).

The mesh's collectives are explicit calls on plain local tensors: every
rank holds its shards as contiguous tensors and the compute between two
collectives is ordinary PyTorch (the hand kernels get contiguous local
CUDA tensors, as on one device).  ``all_reduce`` and ``all_gather``
return new tensors; a ``group`` of None (one rank) makes each of them the
identity.  The autograd forms carry the mesh through a
backward pass:

  * ``gather_shards``: all-gather a leaf's shards (FSDP's gather of a
    super-block's leaves, or a 'model' gather where a layer computes a
    leaf whole); its backward sums the gradient over the DP group, scales
    it by 1/DP and keeps the rank's slice: a reduce-scatter where one dim
    is split over exactly the DP axes, else an all-reduce and a slice;
  * ``copy_to_model`` (identity forward, all-reduce over 'model'
    backward) and ``reduce_from_model`` (all-reduce forward, identity
    backward): the two ends of a tensor-parallel region (Megatron's f and
    g);
  * ``gather_from_model``: all-gather along a dim (vocab-parallel logits
    made whole), backward the rank's slice;
  * ``sum_over_model`` (all-reduce both ways: a partial sum that feeds
    rank-local work, Mamba's ``x_proj`` and RWKV6's ``ln_x``) and
    ``split_to_model`` (the rank's chunk of a whole leaf, backward an
    all-gather: ``conv_w``, ``u``, a LayerNorm's scale, ...).

``exchange`` is continuous serving's one collective an iteration on a
mesh, where every rank runs the scheduler: the slot blocks' sampled
tokens (and accepted counts) made whole, with rank 0's clock reading and
pending cancels so that every rank takes the same decisions.

``AgreedPlane`` (``agreed_plane``) makes a fault plane's every decision
the mesh's: a site's outcome is all-reduced, so every rank raises the
same kind (a crash over a fault) or none, and no rank retries, contains
or unwinds, and so enters its collectives, alone.  The trainer and the
server wrap their planes in it on a mesh; the NULL plane stays one no-op
call a site, with no collective.

Two ranks that share a card talk over gloo, which took CUDA tensors in
every collective used here (all-reduce, its max, all-gather, reduce-scatter
and broadcast; ``tools/gloo_cuda_probe.py`` on torch 2.11.0+cu128), so no
collective is staged through host memory by hand.  NCCL takes them all.

The int8 compression (``compress_int8`` ... ``decompress_grads``) is the
reference's library code over ``core.quant``; the trainer does not call
it (neither does the reference's).
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Deque, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import quant
from repro_torch.train import faults as faults_lib
from repro_torch.tree import tree_map

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` (identity for None)."""
    if group is None:
        return x
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim`` in group rank
    order (identity for None)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` (group rank order) of the group's
    sum of ``x``."""
    n = dist.get_world_size(group)
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    with warnings.catch_warnings():   # renamed in later torch releases
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def exchange(blocks, clock: float, group, take, device, words=()):
    """The continuous scheduler's per-iteration exchange on a mesh: ONE
    all-gather over ``group`` of each rank's row blocks (integer or bool
    tensors, rows first, of one shape on every rank: a slot block's
    sampled tokens, active flags and accepted counts), its clock reading
    and ``words`` (int64 values, as many on every rank: the scheduler's
    pending cancels), packed into one int64 tensor on ``device``.
    Returns (each block of the group ranks ``take`` concatenated along
    rows, in that order, in its own dtype; group rank 0's clock; the
    bitwise OR of every rank's words), the same on every rank.  A
    ``group`` of None returns the blocks, the clock and the words as
    given."""
    words = [int(w) for w in words]
    if group is None:
        return list(blocks), clock, words
    stamp = torch.tensor([clock], dtype=torch.float64).view(torch.int64)
    tail = torch.cat([stamp, torch.tensor(words, dtype=torch.int64)])
    src = torch.cat([b.reshape(-1).to(device, torch.int64) for b in blocks]
                    + [tail.to(device)])
    parts = all_gather(src[None], group, 0)                # (ranks, L)
    out, off = [], 0
    for b in blocks:
        n = b.numel()
        out.append(torch.cat([parts[r, off:off + n].reshape(b.shape)
                              for r in take]).to(b.dtype))
        off += n
    head = parts[:, off:].cpu()
    words = [0] * (head.shape[1] - 1)
    for row in head[:, 1:].tolist():
        words = [a | b for a, b in zip(words, row)]
    return out, float(head[0, :1].view(torch.float64)[0]), words


# ---------------------------------------------------------------------------
# Fault decisions agreed over the mesh
# ---------------------------------------------------------------------------


def agree_code(mesh, code: int) -> int:
    """The largest of every rank's ``code`` (0 on every rank: 0)."""
    return int(all_reduce(torch.tensor([code], dtype=torch.int64),
                          mesh.group(mesh.axis_names), "max")[0])


def agreed(mesh, site: str, fn):
    """Run ``fn`` on this rank; if it raised a ``FaultError`` or a
    ``CrashError`` on any rank, raise on every rank (a crash over a
    fault), so every rank retries, contains or unwinds together."""
    err = None
    try:
        fn()
    except (faults_lib.FaultError, faults_lib.CrashError) as e:
        err = e
    code = agree_code(mesh, 0 if err is None else
                      2 if isinstance(err, faults_lib.CrashError) else 1)
    if code == 0:
        return
    kind = faults_lib.CrashError if code == 2 else faults_lib.FaultError
    raise err if isinstance(err, kind) else kind(site, 0)


class AgreedPlane:
    """A fault plane whose every decision is agreed over the mesh
    (``agreed``): no rank runs an operation, and its collectives,
    alone.  Its counts, tape and draws are the wrapped plane's."""

    def __init__(self, plane, mesh):
        self.plane = plane
        self.mesh = mesh

    def fire(self, site: str) -> None:
        agreed(self.mesh, site, lambda: self.plane.fire(site))

    def __getattr__(self, name):
        return getattr(self.plane, name)


def agreed_plane(plane, mesh):
    """``plane`` as a mesh runs it: wrapped in :class:`AgreedPlane` on a
    mesh; the NULL plane, a plane off a mesh and a plane already agreed
    as they are."""
    if mesh is None or plane is faults_lib.NULL \
            or isinstance(plane, AgreedPlane):
        return plane
    return AgreedPlane(plane, mesh)


def take_slice(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """The i-th of n equal chunks of ``x`` along ``dim``, contiguous."""
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size).contiguous()


# ---------------------------------------------------------------------------
# Autograd forms
# ---------------------------------------------------------------------------


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gathers, reduce_group, scale):
        ctx.gathers, ctx.reduce_group, ctx.scale = gathers, reduce_group, \
            scale
        for dim, group, _, _ in gathers:
            x = all_gather(x, group, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        group = ctx.reduce_group
        rs = next((e for e in ctx.gathers if e[1] is group), None) \
            if group is not None else None
        g = reduce_scatter(g, group, rs[0]) if rs is not None \
            else all_reduce(g, group)
        if ctx.scale != 1.0:
            g = g * ctx.scale
        for e in ctx.gathers:
            if e is not rs:
                g = take_slice(g, e[0], e[2], e[3])
        return g, None, None, None


def gather_shards(x: torch.Tensor, gathers, reduce_group,
                  scale: float = 1.0) -> torch.Tensor:
    """``gathers``: (dim, group, ranks, index) per gathered dim.  Backward:
    all-reduce over ``reduce_group``, times ``scale``, the rank's slice
    of every gathered dim."""
    if not gathers and reduce_group is None:
        return x
    return _GatherShards.apply(x, tuple(gathers), reduce_group, scale)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        return all_reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, dist.get_world_size(group)
        ctx.i = dist.get_rank(group)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return take_slice(g, ctx.dim, ctx.n, ctx.i), None, None


class _MeanOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        return all_reduce(x, group) * (1.0 / n)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return take_slice(x, dim, dist.get_world_size(group),
                          dist.get_rank(group))

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def mean_over_group(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of ``x`` over the group's n ranks; the backward passes the
    gradient through unscaled, so after the DP mean of the gradients each
    rank's share counts 1/n (a batch statistic of a loss every rank
    computes alike)."""
    return x if group is None else _MeanOverGroup.apply(x, group, n)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group, "sum")


def gather_from_model(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else _GatherFromModel.apply(x, group, dim)


def sum_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every 'model' rank's partial ``x``, in both directions:
    the forward's sum feeds work each rank keeps to its own channels or
    heads (Mamba's dt/B/C from ``x_proj``'s row shards, RWKV6's ``ln_x``
    statistics), so each rank's gradient of it is partial and the
    backward sums those too."""
    return x if group is None else _SumOverModel.apply(x, group)


def split_to_model(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The rank's chunk along ``dim`` of a tensor every 'model' rank holds
    whole (a replicated leaf a layer uses per channel or head); the
    backward all-gathers the chunks' gradients, so every rank holds the
    whole gradient, each element from the one rank that used it."""
    return x if group is None else _SplitToModel.apply(x, group, dim)


# ---------------------------------------------------------------------------
# int8 gradient compression + error feedback
# ---------------------------------------------------------------------------
# Per-tensor symmetric int8 over the shared quantizer (``core.quant``), so
# an all-reduce payload is one int8 tensor + one f32 scalar per leaf.


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization.  Returns (q, scale)."""
    return quant.quantize(x, axis=None, dtype=torch.int8)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return quant.dequantize(q, scale, dtype)


def init_error_feedback(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_grads_with_ef(grads, ef_state):
    """Quantize grads to int8 with error feedback: e' = (g+e) - deq(q(g+e)).
    Returns (tree of (q, scale), new error-feedback tree)."""
    if isinstance(grads, dict):
        pairs = {k: compress_grads_with_ef(grads[k], ef_state[k])
                 for k in grads}
        return ({k: c for k, (c, _) in pairs.items()},
                {k: e for k, (_, e) in pairs.items()})
    corrected = grads.float() + ef_state
    q, scale = compress_int8(corrected)
    return (q, scale), corrected - decompress_int8(q, scale)


def decompress_grads(comp, dtype=torch.float32):
    if isinstance(comp, dict):
        return {k: decompress_grads(v, dtype) for k, v in comp.items()}
    return decompress_int8(comp[0], comp[1], dtype)


# ---------------------------------------------------------------------------
# Straggler detection (host-side watermarks)
# ---------------------------------------------------------------------------


class StragglerMonitor:
    """Tracks per-step wall time; flags steps slower than ``threshold`` x the
    rolling median.

    ``hang_deadline_s`` adds a hard ceiling: a step that exceeds it raises
    ``train.faults.HangError`` (a ``train.step`` FaultError) from ``stop``
    instead of silently counting as slow, so a stuck step surfaces as a
    fault the trainer's containment can log and move past.  The measured
    ``dt`` is recorded in ``last_dt`` before raising.  The caller stops the
    clock after the step's device work has finished (a synchronize): a
    step only queued on the card would never trip the deadline.  On a mesh
    ``agree`` (dt -> dt) makes every rank see one time, the slowest
    rank's, so every rank takes the same branch."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 hang_deadline_s: Optional[float] = None, agree=None):
        self.times: Deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.hang_deadline_s = hang_deadline_s
        self.agree = agree
        self._t0: Optional[float] = None
        self.flagged = 0
        self.hangs = 0
        self.last_dt = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> Tuple[float, bool]:
        dt = time.perf_counter() - self._t0
        if self.agree is not None:
            dt = self.agree(dt)
        self.last_dt = dt
        slow = False
        if len(self.times) >= 10:
            med = sorted(self.times)[len(self.times) // 2]
            slow = dt > self.threshold * med
            self.flagged += int(slow)
        self.times.append(dt)
        if self.hang_deadline_s is not None and dt > self.hang_deadline_s:
            self.hangs += 1
            raise faults_lib.HangError("train.step", self.hangs, dt,
                                       self.hang_deadline_s)
        return dt, slow


# ---------------------------------------------------------------------------
# Whole leaves <-> a rank's shards
# ---------------------------------------------------------------------------


def shard_leaf(full: torch.Tensor, spec, mesh, path) -> torch.Tensor:
    """This rank's shard of a whole leaf under ``spec`` (a new contiguous
    tensor where any dim is split, else ``full`` itself).  ``path`` names
    the leaf: a packed leaf (``sharding.held_parts``) is packed first."""
    from repro_torch.distributed.sharding import dim_axes, held_parts, pack
    parts = held_parts(path, spec, mesh, full.shape[-1] if full.ndim else 0)
    x = pack(full, parts, mesh.shape.get("model", 1))
    for d, e in enumerate(spec):
        axes = dim_axes(e)
        n = mesh.axes_size(axes)
        if n > 1:
            x = take_slice(x, d, n, mesh.axes_index(axes))
    return x


def unshard_leaf(x: torch.Tensor, spec, mesh, path) -> torch.Tensor:
    """The whole leaf from this rank's shard: an all-gather over the axes
    of every split dim (no autograd), a packed leaf unpacked."""
    from repro_torch.distributed.sharding import dim_axes, held_parts, unpack
    for d, e in enumerate(spec):
        axes = dim_axes(e)
        if mesh.axes_size(axes) > 1:
            x = all_gather(x, mesh.group(axes), d)
    parts = held_parts(path, spec, mesh, x.shape[-1] if x.ndim else 0)
    return unpack(x, parts, mesh.shape.get("model", 1))
