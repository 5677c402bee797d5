"""Counting one step of the port: FLOPs by unit, HBM bytes, collective
bytes and peak live bytes (the counterpart of ``repro/roofline/
hlo_cost.py``, which walks the reference's compiled HLO).

``StepCounter`` is a ``TorchDispatchMode``: every aten op the step runs
passes through it, on the meta device, the CPU or the card alike.

  * Products: ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot`` and
    convolutions (and their backward) count their exact FLOPs, 2·M·N·K,
    under the unit of their dtype (``f32``: TF32 is off in the port's
    engines, so an f32 product runs on the CUDA cores; ``bf16``: the
    tensor cores).
  * Every other op counts prod(result shape) FLOPs under ``f32`` (the
    CUDA cores' rate, the only one the card's table gives besides the
    tensor cores'), the reference walker's rule.  Views and reshapes are
    free, as are the ``empty`` factories.
  * Bytes: each op reads its tensor operands once and writes its results
    once.  Eager PyTorch does not fuse, so this is the port's traffic.
  * Collectives: the ``c10d`` ops count their result bytes under the
    reference's kinds (``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``); a broadcast is a chain of
    permutes.
  * Peak live bytes: the storages the step makes, each counted once
    whatever views share it, from its first op to its release (a weak
    reference to the C++ storage says when).  Storages that existed
    before the count (the arguments) are not in it: the peak is the
    dry run's ``temp`` term.

Kernel regions.  Each kernel wrapper of the port enters
``kernel_region(name, **dims)`` on both of its paths: the CUDA launch and
the plain version.  Inside a region no op is counted, and the region adds
its kernel's work function (``WORK[name]``) instead: the function's
FLOPs, the FLOPs its route runs by unit, and its bytes with each input
read once and each output written once (those go under ``kernel_bytes``,
as the reference keeps its kernel regions' bytes apart).  So a step reads
the same whatever implements each kernel: the meta device and the CPU
run the plain versions, which compute work the kernels never do (the
full S x S of causal attention), and the count does not see it.  Regions
nest (``newton_schulz`` over its ``ns_fused`` and ``matmul`` launches):
every entry is counted in ``regions``, the outermost one's work alone.
Storages a region makes count toward the peak only where they outlive
it (outputs, and state saved for the backward), as on the card, where
a kernel's temporaries stay on chip.  A plain path whose backward is a
kernel on the card (flash attention, WKV, the scan) runs under an active
counter through ``counted_plain``: its forward without the autograd
graph and its backward, a recompute and autograd of the plain version,
inside the backward kernel's region; the values are the same.  On meta
tensors, which hold no values, ``counted_plain`` makes the kernel's
outputs and gradients empty instead of running the plain version.

The work functions are also the one place ``chip_smoke.py`` takes each
kernel's bound from (``Work.bounds``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import Counter, defaultdict
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (HW_HBM_BW, HW_PEAK_BF16_FLOPS,
                                      HW_PEAK_F32_FLOPS, HW_PEAK_TF32_FLOPS)

# FLOP/s of each unit.  'tf32x3' counts an f32 product that a kernel runs
# as three TF32 products on the tensor cores (3xTF32), at a third of the
# TF32 peak.
UNIT_RATES = {"f32": HW_PEAK_F32_FLOPS, "bf16": HW_PEAK_BF16_FLOPS,
              "tf32": HW_PEAK_TF32_FLOPS, "tf32x3": HW_PEAK_TF32_FLOPS / 3}


def unit_seconds(by_unit: Dict[str, float]) -> float:
    """Seconds of ``by_unit`` FLOPs, each unit at its peak."""
    return sum(f / UNIT_RATES[u] for u, f in by_unit.items())


def bound(by_unit: Dict[str, float], nbytes: float) -> dict:
    """The least time of work doing ``by_unit`` FLOPs and moving
    ``nbytes``: the larger of the two, in ms, and which one sets it."""
    op_ms = unit_seconds(by_unit) * 1e3
    byte_ms = nbytes / HW_HBM_BW * 1e3
    return dict(bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes")


@dataclasses.dataclass(frozen=True)
class Work:
    """One kernel call's work: ``flops`` the function's (its full
    products), ``by_unit`` the FLOPs its route runs by unit (a symmetric
    product's upper half, say), ``bytes`` each input read once and each
    output written once."""
    flops: float
    by_unit: Dict[str, float]
    bytes: float

    def bound(self) -> dict:
        """The route's bound (``bound_ms``, ``bound_by``)."""
        return bound(self.by_unit, self.bytes)

    def bounds(self) -> dict:
        """The route's bound and the f32 FMA bound of the full products
        (``f32_bound_ms``, ``f32_bound_by``)."""
        f32 = bound({"f32": self.flops}, self.bytes)
        return dict(**self.bound(), f32_bound_ms=f32["bound_ms"],
                    f32_bound_by=f32["bound_by"])


def _tc_unit(itemsize: int) -> str:
    """The unit of a tensor-core kernel's products: 3xTF32 over f32
    inputs, bf16 over 2-byte ones."""
    return "tf32x3" if itemsize == 4 else "bf16"


def visible_pairs(S_q: int, S_k: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs one row and head of attention sees: every pair
    without the causal mask, else the causal pairs within ``window`` when
    it is > 0 (causal attention has S_q == S_k)."""
    if not causal:
        return S_q * S_k
    if window <= 0 or window >= S_q:
        return S_q * (S_q + 1) // 2
    return window * (window + 1) // 2 + (S_q - window) * window


def flash_attention(B, S_q, S_k, H, KV, hd, causal=True, window=0,
                    itemsize=4, with_lse=False) -> Work:
    """The forward: QKᵀ and PV over the visible pairs; q, k, v in, the
    output (and each row's f32 logsumexp) out."""
    flops = 4 * hd * B * H * visible_pairs(S_q, S_k, causal, window)
    q = B * S_q * H * hd
    kv = B * S_k * KV * hd
    nbytes = itemsize * (2 * q + 2 * kv) + (4 * B * H * S_q if with_lse
                                             else 0)
    return Work(flops, {_tc_unit(itemsize): flops}, nbytes)


def flash_attention_bwd(B, S_q, S_k, H, KV, hd, causal=True, window=0,
                        itemsize=4) -> Work:
    """The backward: five products a visible pair (S = QKᵀ again, dV, dP,
    dQ, dK); q, k, v, the output, its gradient and the f32 logsumexp in,
    dq, dk, dv out."""
    flops = 10 * hd * B * H * visible_pairs(S_q, S_k, causal, window)
    q = B * S_q * H * hd
    kv = B * S_k * KV * hd
    nbytes = itemsize * (4 * q + 4 * kv) + 4 * B * H * S_q
    return Work(flops, {_tc_unit(itemsize): flops}, nbytes)


def paged_attention(B, H, KV, hd, live, pages, q_itemsize=4,
                    page_itemsize=4, quantized=False) -> Work:
    """One decode step over the pool: ``live`` the slots the rows attend
    (each row's cursor + 1, summed), ``pages`` the pages they span.  K and
    V of every live slot (and their f32 scales over 1-byte pages), q in
    and the output out, the block table's live entries and the cursors.
    Its products run on the CUDA cores."""
    flops = 4 * live * H * hd
    nbytes = (2 * live * KV * hd * page_itemsize
              + (2 * live * KV * 4 if quantized else 0)
              + 2 * B * H * hd * q_itemsize
              + 4 * pages + 4 * B)
    return Work(flops, {"f32": flops}, nbytes)


def ns_fused(L, n, m, steps=5, itemsize=4) -> Work:
    """The whole Newton–Schulz chain of a stack (L, n, m), n <= m: per
    step G = X Xᵀ, G Gᵀ and P X, the first two over their symmetric upper
    half on the card; X in and out."""
    flops = L * steps * (4 * n * n * m + 2 * n ** 3)
    half = n * (n + 1) // 2
    route = L * steps * (2 * half * m + 2 * half * n + 2 * n * n * m)
    return Work(flops, {"tf32x3": route}, 2 * itemsize * L * n * m)


def matmul(M, N, K, symmetric=False, with_d=False, itemsize=4) -> Work:
    """(M, K) @ (K, N), or the symmetric x xᵀ (one operand, its upper
    half computed); ``with_d``: a distinct (M, N) operand of the fused
    update read too."""
    flops = 2 * M * N * K
    if symmetric:
        route = 2 * (M * (M + 1) // 2) * K
        nbytes = itemsize * (M * K + M * N)
    else:
        route = flops
        nbytes = itemsize * (M * K + K * N + M * N)
    if with_d:
        nbytes += itemsize * M * N
    return Work(flops, {"tf32x3": route}, nbytes)


def newton_schulz(shape, steps=5, itemsize=4) -> Work:
    """``kernels.newton_schulz.ops.newton_schulz`` of one matrix or a stack
    ``shape`` as the card routes it: transposed to n <= m, the fused chain
    for the stack, or per matrix the large route, its norm (a read of X,
    a read and a write of the scaled copy) and per step the symmetric
    Gram, G Gᵀ with b G in its epilogue and P X with a X in its
    epilogue."""
    from repro_torch.kernels.newton_schulz.ops import route
    *lead, n_in, n_out = shape
    L = math.prod(lead)
    n, m = min(n_in, n_out), max(n_in, n_out)
    if route(n, m) == "fused":
        return ns_fused(L, n, m, steps, itemsize)
    parts = [matmul(n, n, m, symmetric=True),
             matmul(n, n, n, symmetric=True),
             matmul(n, m, n)]
    norm = 3 * n * m
    flops = L * (norm + steps * sum(w.flops for w in parts))
    route_flops = L * steps * sum(w.by_unit["tf32x3"] for w in parts)
    nbytes = L * (3 * 4 * n * m + steps * sum(w.bytes for w in parts))
    return Work(flops, {"f32": L * norm, "tf32x3": route_flops}, nbytes)


def wkv(B, S, H, hd, itemsize=4, u_itemsize=4) -> Work:
    """The RWKV6 recurrence: 4 operations a state entry a step, run as
    3xTF32 products in the chunked form.  r, k, v (``itemsize``), the f32
    decays w and u in, y out, the f32 state in and out."""
    flops = 4 * hd * hd * B * S * H
    x = B * S * H * hd
    nbytes = (4 * x * itemsize + x * 4 + H * hd * u_itemsize
              + 2 * B * H * hd * hd * 4)
    return Work(flops, {"tf32x3": flops}, nbytes)


def wkv_bwd(B, S, H, hd, chunk_steps, itemsize=4) -> Work:
    """The WKV backward: per state entry and step the state re-run twice
    (3 operations), dr, dw and dk as FMAs (6), dv's multiply and its sum
    (2), G's multiply and FMA (3), 17 f32 operations on the CUDA cores.
    r, k, v, dy, w and the forward's chunk states (one a ``chunk_steps``
    steps) in, dr, dk, dv, dw out, the state's gradient in and out, u in
    and its gradient out."""
    flops = 17 * B * S * H * hd * hd
    x = B * S * H * hd
    chunks = B * H * -(-S // chunk_steps) * hd * hd
    nbytes = (4 * x * itemsize + x * 4 + 3 * x * itemsize + x * 4
              + chunks * 4 + 2 * B * H * hd * hd * 4 + 2 * H * hd * 4)
    return Work(flops, {"f32": flops}, nbytes)


def selective_scan(B, S, d, N, itemsize=4, h0=True, final=True) -> Work:
    """The Mamba scan: per state update dt·A, (dt u)·B_n, the update FMA
    and the y FMA (6 operations, CUDA cores).  u, dt, B, C (``itemsize``),
    the f32 A and D in, y out, the f32 initial state in (``h0``) and the
    final one out (``final``)."""
    flops = 6 * B * S * d * N
    nbytes = ((3 * B * S * d + 2 * B * S * N) * itemsize
              + (d * N + d) * 4 + (h0 + final) * B * d * N * 4)
    return Work(flops, {"f32": flops}, nbytes)


def selective_scan_bwd(B, S, d, N, save_steps, itemsize=4) -> Work:
    """The scan backward: per state entry and step two re-runs of the
    state and the step back, ~28 f32 operations.  u, dt, dy, B, C in, du,
    ddt out, the forward's saved states (one a ``save_steps`` steps), the
    state's gradient in and out, the per-block dB and dC partials and the
    dA, dD partials out, A and D in."""
    flops = 28 * B * S * d * N
    nblk = -(-d // 64)
    saved = B * -(-S // save_steps) * d * N
    nbytes = (3 * B * S * d * itemsize + 2 * B * S * N * itemsize
              + 2 * B * S * d * itemsize
              + saved * 4 + 2 * B * d * N * 4
              + 2 * B * nblk * S * N * 4
              + B * d * N * 4 + B * d * 4 + d * N * 4 + d * 4)
    return Work(flops, {"f32": flops}, nbytes)


def paged_prefill_attention(B, C, ctx_total, H, KV, hd, itemsize=4) -> Work:
    """A chunk's C queries a row at positions ctx_len.. over the row's
    pages (plain on every device): the causal pairs over ctx_len + C keys
    a row, ``ctx_total`` the rows' ctx_len summed; q and the visible K and
    V in, the output out."""
    pairs = H * (C * ctx_total + B * C * (C + 1) // 2)
    flops = 4 * hd * pairs
    nbytes = itemsize * (2 * B * C * H * hd
                         + 2 * (ctx_total + B * C) * KV * hd)
    return Work(flops, {"f32": flops}, nbytes)


WORK: Dict[str, Callable[..., Work]] = {
    "flash_attention": flash_attention,
    "flash_attention_bwd": flash_attention_bwd,
    "paged_attention": paged_attention,
    "paged_prefill_attention": paged_prefill_attention,
    "newton_schulz": newton_schulz,
    "ns_fused": ns_fused,
    "matmul": matmul,
    "wkv": wkv,
    "wkv_bwd": wkv_bwd,
    "selective_scan": selective_scan,
    "selective_scan_bwd": selective_scan_bwd,
}


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

_PRODUCTS = ("mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot")
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "detach", "lift_fresh",
         "alias", "_local_scalar_dense"}
# c10d op -> the reference's collective kind
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
}


def _tensors(tree, out=None) -> list:
    """The tensors in nested tuples, lists and dicts."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _product_flops(name: str, args, out) -> float:
    if name in ("mm", "bmm"):
        a = args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if name in ("addmm", "baddbmm"):
        a = args[1]
        return 2.0 * out.numel() * a.shape[-1]
    if name == "mv":
        return 2.0 * args[0].numel()
    if name == "addmv":
        return 2.0 * args[1].numel()
    return 2.0 * args[0].numel()                     # dot


def _conv_flops(out_shape, w_shape) -> float:
    # (C_out, C_in / groups, *kernel): each output entry C_in/groups x
    # prod(kernel) multiply-adds.
    return 2.0 * math.prod(out_shape) * math.prod(w_shape[1:])


def _op_unit(t: torch.Tensor) -> str:
    return "bf16" if t.dtype in (torch.bfloat16, torch.float16) else "f32"


_VIEWS: dict = {}


def _is_view(func) -> bool:
    """An op whose results alias its operands without writing them."""
    if func not in _VIEWS:
        returns = func._schema.returns
        _VIEWS[func] = bool(returns) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in returns)
    return _VIEWS[func]


@dataclasses.dataclass
class Count:
    """One step's count.  ``flops`` every op's and region's FLOPs,
    ``by_unit`` those FLOPs as the card runs them by unit, ``bytes`` the
    ops' HBM bytes outside kernel regions, ``kernel_bytes`` the regions',
    ``coll`` collective result bytes by kind, ``regions`` the entries of
    each kernel region, ``peak_bytes`` the most bytes the step's own
    storages held at once, ``ops`` the ops counted."""
    flops: float = 0.0
    by_unit: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    bytes: float = 0.0
    kernel_bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    regions: Counter = dataclasses.field(default_factory=Counter)
    peak_bytes: int = 0
    ops: int = 0


_ACTIVE: list = []                  # the counters entered, innermost last


def counting() -> bool:
    """Whether a ``StepCounter`` is active in this process."""
    return bool(_ACTIVE)


class StepCounter(TorchDispatchMode):
    """``with StepCounter() as c: step(...)``; then ``c.count``."""

    def __init__(self):
        super().__init__()
        self.count = Count()
        self.depth = 0              # kernel regions entered, nested
        self._live: dict = {}       # storage key -> (weak ref, bytes)
        self._live_bytes = 0
        self._pending: list = []    # storages made inside the regions

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    # -- kernel regions --------------------------------------------------------

    def enter_region(self, name: str, dims: dict) -> None:
        self.count.regions[name] += 1
        self.depth += 1             # a callable dim's own ops go uncounted
        if self.depth == 1:
            dims = {k: (v() if callable(v) else v) for k, v in dims.items()}
            w = WORK[name](**dims)
            self.count.flops += w.flops
            for u, f in w.by_unit.items():
                self.count.by_unit[u] += f
            self.count.kernel_bytes += w.bytes

    def exit_region(self) -> None:
        self.depth -= 1
        if self.depth == 0:
            pending, self._pending = self._pending, []
            for ref, nbytes, key in pending:
                if not ref.expired():
                    self._track(key, ref, nbytes)

    # -- storages --------------------------------------------------------------

    def _track(self, key, ref, nbytes) -> None:
        self._live[key] = (ref, nbytes)
        self._live_bytes += nbytes
        if self._live_bytes > self.count.peak_bytes:
            # Frees are found lazily: a poll only where the running sum
            # could pass the peak.
            for k in [k for k, (r, _) in self._live.items() if r.expired()]:
                self._live_bytes -= self._live.pop(k)[1]
            self.count.peak_bytes = max(self.count.peak_bytes,
                                        self._live_bytes)

    def _new_storages(self, outs, ins) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            seen.add(key)
            ref = StorageWeakRef(st)
            if self.depth:
                self._pending.append((ref, st.nbytes(), key))
            else:
                self._track(key, ref, st.nbytes())

    # -- ops -------------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func.__name__.split(".")[0]
        if ns == "c10d":
            if self.depth == 0 and name in _COLLECTIVES:
                self.count.coll[_COLLECTIVES[name]] += sum(
                    _nbytes(t) for t in _tensors(args[0]))
            return out
        if _is_view(func):
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self._new_storages(outs, ins)
        if self.depth or not outs or name in _FREE:
            return out
        c = self.count
        c.ops += 1
        if name in _PRODUCTS:
            flops, unit = _product_flops(name, args, outs[0]), \
                _op_unit(outs[0])
        elif name == "convolution":
            flops, unit = _conv_flops(outs[0].shape, args[1].shape), \
                _op_unit(outs[0])
        elif name == "convolution_backward":
            mask = args[-1]
            per = _conv_flops(args[0].shape, args[2].shape)
            flops, unit = per * (bool(mask[0]) + bool(mask[1])), \
                _op_unit(args[0])
        else:
            flops, unit = float(outs[0].numel()), "f32"
        c.flops += flops
        c.by_unit[unit] += flops
        c.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                     for t in outs)
        return out


def _counter() -> Optional[StepCounter]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def kernel_region(name: str, **dims):
    """Mark a kernel call: under an active counter its ops are not counted
    and ``WORK[name](**dims)`` is (dims may be callables, evaluated only
    then).  A no-op otherwise."""
    c = _counter()
    if c is None:
        yield
        return
    c.enter_region(name, dims)
    try:
        yield
    finally:
        c.exit_region()


class _Plain(torch.autograd.Function):
    """A plain version whose backward runs inside the backward kernel's
    region: the forward without the autograd graph, the backward a
    recompute and autograd of the plain version."""

    @staticmethod
    def forward(ctx, fn, bwd, saved, *xs):
        ctx.fn, ctx.bwd, ctx.n = fn, bwd, len(xs)
        ctx.save_for_backward(*xs, *saved(*xs))
        with torch.no_grad():
            out = fn(*xs)
        ctx.single = isinstance(out, torch.Tensor)
        return out if ctx.single else tuple(out)

    @staticmethod
    def backward(ctx, *gouts):
        need = ctx.needs_input_grad[3:]
        name, dims = ctx.bwd
        with kernel_region(name, **dims), torch.enable_grad():
            leaves = [x.detach().requires_grad_(r)
                      for x, r in zip(ctx.saved_tensors[:ctx.n], need)]
            out = ctx.fn(*leaves)
            outs = (out,) if ctx.single else tuple(out)
            pairs = [(o, g) for o, g in zip(outs, gouts)
                     if g is not None and o.requires_grad]
            want = [x for x in leaves if x.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], want, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(want))
            res = []
            for x in leaves:
                g = next(grads) if x.requires_grad else None
                if x.requires_grad and g is None:
                    g = torch.zeros_like(x)
                res.append(None if g is None else g.contiguous())
        return (None, None, None) + tuple(res)


class _Shaped(torch.autograd.Function):
    """A kernel call on the meta device: outputs of the kernel's shapes,
    gradients of the inputs' in the backward kernel's region (meta tensors
    hold no values, so the plain version has nothing to compute)."""

    @staticmethod
    def forward(ctx, like, bwd, saved, *xs):
        ctx.bwd, ctx.n = bwd, len(xs)
        ctx.save_for_backward(*xs, *saved(*xs))
        out = like(*xs)
        return out if isinstance(out, torch.Tensor) else tuple(out)

    @staticmethod
    def backward(ctx, *gouts):
        name, dims = ctx.bwd
        with kernel_region(name, **dims):
            grads = tuple(
                torch.empty_like(x, memory_format=torch.contiguous_format)
                if need else None for x, need in
                zip(ctx.saved_tensors[:ctx.n], ctx.needs_input_grad[3:]))
        return (None, None, None) + grads


def counted_plain(fn: Callable, xs, bwd_name: str, like: Callable,
                  saved: Callable, **bwd_dims):
    """``fn(*xs)``, a plain version whose kernel counterpart has a backward
    kernel; ``like(*xs)`` gives empty outputs of the kernel's shapes and
    ``saved(*xs)`` empty tensors of the state the kernel saves for its
    backward beside the inputs (a logsumexp, chunk states).  On meta
    tensors ``like`` stands in for ``fn`` and the backward gives empty
    gradients inside ``bwd_name``'s region (``_Shaped``); under an active
    counter with the autograd graph on, the backward runs inside that
    region (``_Plain``); else ``fn(*xs)`` as it is.  Either Function
    holds the inputs and ``saved`` until the backward, as the kernel's
    does.  ``xs`` may hold None (passed through)."""
    idx = [i for i, x in enumerate(xs) if x is not None]
    full = list(xs)

    def call(f):
        def inner(*ts):
            for i, t in zip(idx, ts):
                full[i] = t
            return f(*full)
        return inner

    grad = torch.is_grad_enabled() and any(xs[i].requires_grad for i in idx)
    if all(xs[i].is_meta for i in idx):
        if not grad:
            return like(*xs)
        return _Shaped.apply(call(like), (bwd_name, bwd_dims), call(saved),
                             *[xs[i] for i in idx])
    if not (counting() and grad):
        return fn(*xs)
    return _Plain.apply(call(fn), (bwd_name, bwd_dims), call(saved),
                        *[xs[i] for i in idx])
