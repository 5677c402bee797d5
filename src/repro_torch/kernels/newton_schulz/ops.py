"""Public Newton–Schulz entry point used by Muon (``repro/kernels/
newton_schulz/ops.py``), and the two kernels behind it.

``newton_schulz(m, steps, force)`` orthogonalizes the trailing two dims of
``m`` (one matrix, or a stack of them along a leading axis written out
where the reference vmaps).  It keeps the reference's routing: a matrix is
transposed to n <= m, and ``_fits_fused`` (the reference's budget, applied
to the dims padded to 128 as the reference pads them) decides between

* ``ns_fused``: the whole chain for a stack (L, n, m) in one call, the
  counterpart of the Pallas ``ns_fused`` kernel;
* ``_ns_large``: per matrix, the quintic composed from ``matmul``, the
  counterpart of the Pallas tiled matmul (GPT-2's tied embedding takes it).

Dispatch is by the tensors' device: on a CUDA tensor ``ns_fused`` and
``matmul`` launch the hand-written Hopper kernels (``csrc/
newton_schulz.cu``: one GEMM on the tensor cores in 3xTF32) or raise; on a
CPU tensor they run their plain versions.  ``force="kernel"`` takes that
route on any device (on the CPU it runs the route's plain versions, as the
reference's ``force='pallas'`` runs interpret mode off the TPU);
``force="ref"`` runs ``newton_schulz_ref`` per matrix; ``"auto"`` is the
route on a CUDA tensor and the reference on the CPU.  ``gemm_plan`` decides
each product's launch (symmetric tiles, split-K, workspace) in plain
Python, so that the CPU tests check it.

``newton_schulz``, ``ns_fused``, ``matmul`` and the fused-update GEMM
enter their regions of ``roofline.torch_cost`` on every path:
``newton_schulz``'s counts the card's route (the chain, or the large
route's GEMMs and norm) whichever path ran, and the launches inside it
count as entries of their own regions.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.newton_schulz.ref import NS_COEFFS, newton_schulz_ref
from repro_torch.roofline import torch_cost

# Calls of the CUDA ns_fused chain (one per stacked leaf: a norm pass and 3
# GEMMs per iteration) and of the CUDA matmul (the public ``matmul`` and the
# large route's fused products), in this process; the chip smoke run resets
# and reads them to show that training went through the kernels.  They
# count wrapper calls: a split-K product is two device launches (the GEMM
# and its reduction) and counts once.
NS_FUSED_LAUNCHES = 0
MATMUL_LAUNCHES = 0

EPS = 1e-7
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NORM_PARTS = 32                  # NORM_PARTS in the .cu

# Budget for the fused path, the reference's: matrix + gram + temps in f32
# must fit the TPU's VMEM.  Kept so that the same leaves take the same
# route; on the card the fused chain has no such limit.
_VMEM_BUDGET = 96 * 2**20


# The GEMM's tiling (BM, BN, BK in the .cu) and the card it plans for.
_BM = _BN = 128
_BK = 32
_SMS = 132              # SMs of an H100 SXM
_BLOCKS_PER_SM = 1      # resident GEMM blocks per SM: a block takes 170-184
                        # KB of the SM's 228 KB of shared memory
_MIN_SPLIT_K = 256      # the least K a split-K slice takes
_MAX_SPLITS = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One GEMM launch: ``tiles`` output tiles per matrix (the upper
    triangle's when symmetric), K cut into ``splits`` slices of ``k_split``
    (the last one shorter), and the split-K workspace in f32 elements (0
    when splits == 1)."""
    tiles: int
    splits: int
    k_split: int
    workspace: int


def gemm_plan(batch: int, M: int, N: int, K: int,
              symmetric: bool = False) -> GemmPlan:
    """The launch of a batched (M, K) @ (K, N) product.

    A grid of fewer blocks than about two waves of the card's SMs cuts K:
    each split count S up to K / _MIN_SPLIT_K is costed as waves (of
    _SMS * _BLOCKS_PER_SM resident blocks) times k-slices per split, and
    the smallest S within 5% of the cheapest is taken.  Symmetric products
    launch the upper triangle's tiles only."""
    tm, tn = _cdiv(M, _BM), _cdiv(N, _BN)
    if symmetric and M != N:
        raise ValueError(f"a symmetric product is square, got {M}x{N}")
    tiles = tm * (tm + 1) // 2 if symmetric else tm * tn
    blocks = batch * tiles
    k_slices = _cdiv(K, _BK)
    splits, k_split = 1, k_slices * _BK
    if blocks < 2 * _SMS:
        slots = _SMS * _BLOCKS_PER_SM
        options = []
        for s in range(1, max(1, min(_MAX_SPLITS, K // _MIN_SPLIT_K)) + 1):
            ks = _cdiv(k_slices, s)             # k-slices per split
            s_eff = _cdiv(k_slices, ks)         # no split left empty
            options.append((_cdiv(blocks * s_eff, slots) * ks, s_eff, ks))
        best = min(cost for cost, _, _ in options)
        _, splits, ks = next(o for o in options if o[0] <= 1.05 * best)
        k_split = ks * _BK
    return GemmPlan(tiles=tiles, splits=splits, k_split=k_split,
                    workspace=(batch * splits * tiles * _BM * _BN
                               if splits > 1 else 0))


def ns_fused_plans(L: int, n: int, m: int) -> tuple:
    """The plans of the chain's three products on a stack (L, n, m):
    G = X X^T, G G^T (both symmetric) and P X."""
    return (gemm_plan(L, n, n, m, symmetric=True),
            gemm_plan(L, n, n, n, symmetric=True),
            gemm_plan(L, n, m, n))


def _fits_fused(n: int, m: int) -> bool:
    mat = n * m * 4
    gram = n * n * 4
    return 3 * mat + 2 * gram < _VMEM_BUDGET


def _padded(d: int, mult: int = 128) -> int:
    return d + (-d) % mult


def route(n_in: int, n_out: int) -> str:
    """'fused' or 'large': the path a (n_in, n_out) matrix takes, decided
    as the reference decides it (transposed to n <= m, padded to 128)."""
    n, m = min(n_in, n_out), max(n_in, n_out)
    return "fused" if _fits_fused(_padded(n), _padded(m)) else "large"


def _library() -> ctypes.CDLL:
    lib = _build.load("newton_schulz")
    if lib.ns_gemm.argtypes is None:
        # Pointers and the stream as c_void_p: ctypes would cut a bare int
        # to 32 bits.
        lib.ns_gemm.restype = ctypes.c_int
        lib.ns_gemm.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                + [ctypes.c_longlong] * 8
                                + [ctypes.c_int] * 4
                                + [ctypes.c_float] * 2
                                + [ctypes.c_int, ctypes.c_void_p])
        lib.ns_fused.restype = ctypes.c_int
        lib.ns_fused.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                                 + [ctypes.c_float] * 4
                                 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return lib


def _check_cuda(name: str, tensors):
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} kernel: every operand must lie on one "
                             f"CUDA device, got {t.device}")
        if t.dtype not in _DTYPE_CODES or t.dtype != tensors[0].dtype:
            raise ValueError(f"{name} kernel: dtype {t.dtype} (float32 or "
                             "bfloat16, all operands alike)")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: operands must be contiguous")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _workspace(plans, device) -> torch.Tensor | None:
    size = max(p.workspace for p in plans)
    return (torch.empty((size,), dtype=torch.float32, device=device)
            if size else None)


# ---------------------------------------------------------------------------
# ns_fused: the whole Newton–Schulz chain for a stack of matrices
# ---------------------------------------------------------------------------


def _check_stack(x):
    if x.ndim != 3 or x.shape[1] > x.shape[2]:
        raise ValueError(f"ns_fused: x must be (L, n, m) with n <= m, got "
                         f"{tuple(x.shape)}")


def ns_fused_cuda(x: torch.Tensor, steps: int = 5,
                  eps: float = EPS) -> torch.Tensor:
    """Launch the chain on the current stream: x (L, n, m), n <= m, float32
    or bfloat16 -> the orthogonalized stack in x's dtype."""
    global NS_FUSED_LAUNCHES
    _check_stack(x)
    _check_cuda("ns_fused", (x,))
    L, n, m = x.shape
    lib = _library()
    f32 = dict(dtype=torch.float32, device=x.device)
    xa, xb = torch.empty((L, n, m), **f32), torch.empty((L, n, m), **f32)
    g, p = torch.empty((L, n, n), **f32), torch.empty((L, n, n), **f32)
    partial = torch.empty((L * _NORM_PARTS,), **f32)
    plans = ns_fused_plans(L, n, m)
    ws = _workspace(plans, x.device)
    splits = [v for pl in plans for v in (pl.splits, pl.k_split)]
    a, b, c = NS_COEFFS
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ns_fused(x.data_ptr(), xa.data_ptr(), xb.data_ptr(),
                           g.data_ptr(), p.data_ptr(), partial.data_ptr(),
                           None if ws is None else ws.data_ptr(),
                           L, n, m, int(steps), float(eps), a, b, c,
                           *splits, _DTYPE_CODES[x.dtype], stream)
    _raise_on(err, f"ns_fused (L={L} n={n} m={m} {x.dtype})")
    NS_FUSED_LAUNCHES += 1
    out = xa if steps % 2 == 0 else xb
    return out.to(x.dtype)


def ns_fused_ref(x: torch.Tensor, steps: int = 5,
                 eps: float = EPS) -> torch.Tensor:
    """The plain version, on any device: the reference's fused body per
    matrix of the stack."""
    _check_stack(x)
    a, b, c = NS_COEFFS
    out = []
    for xi in x.float():
        xi = xi / (torch.sqrt(torch.sum(xi * xi)) + eps)
        for _ in range(steps):
            gram = xi @ xi.T
            poly = b * gram + c * (gram @ gram)
            xi = a * xi + poly @ xi
        out.append(xi)
    return torch.stack(out).to(x.dtype)


def ns_fused(x: torch.Tensor, steps: int = 5, eps: float = EPS,
             force: str = "auto") -> torch.Tensor:
    """x: (L, n, m) with n <= m -> Newton–Schulz of each matrix."""
    if force not in ("auto", "kernel", "ref"):
        raise ValueError(f"force={force!r} (auto|kernel|ref)")
    _check_stack(x)
    L, n, m = x.shape
    with torch_cost.kernel_region("ns_fused", L=L, n=n, m=m, steps=steps,
                                  itemsize=x.element_size()):
        if force == "kernel" or (force == "auto" and x.is_cuda):
            return ns_fused_cuda(x, steps, eps)
        return ns_fused_ref(x, steps, eps)


# ---------------------------------------------------------------------------
# matmul: (M, K) @ (K, N) with an f32 accumulator
# ---------------------------------------------------------------------------


def _check_matmul(x, y, trans_b: bool):
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError("matmul: x and y must be matrices")
    K2 = y.shape[1] if trans_b else y.shape[0]
    if x.shape[1] != K2:
        raise ValueError(f"matmul: x {tuple(x.shape)} @ "
                         f"{'y.T' if trans_b else 'y'} {tuple(y.shape)}")


def _same(x: torch.Tensor, y: torch.Tensor) -> bool:
    return (x.data_ptr() == y.data_ptr() and x.shape == y.shape
            and x.stride() == y.stride() and x.dtype == y.dtype)


def matmul_cuda(x: torch.Tensor, y: torch.Tensor, trans_b: bool = False,
                d: torch.Tensor | None = None, alpha: float = 1.0,
                beta: float = 0.0) -> torch.Tensor:
    """Launch the GEMM on the current stream: alpha * x (M, K) @ y (K, N)
    + beta * d, or x @ y.T for y (N, K) with ``trans_b`` (y.T is never
    materialized); d (M, N) or None.  With ``trans_b`` and y the same
    tensor as x the product x @ x.T is symmetric: the upper tiles are
    computed and mirrored, and d must then be symmetric too.  f32
    accumulation, the output in x's dtype."""
    global MATMUL_LAUNCHES
    _check_matmul(x, y, trans_b)
    _check_cuda("matmul", (x, y) if d is None else (x, y, d))
    M, K = x.shape
    N = y.shape[0] if trans_b else y.shape[1]
    if d is not None and d.shape != (M, N):
        raise ValueError(f"matmul: d {tuple(d.shape)}, expected {(M, N)}")
    sym = trans_b and _same(x, y)
    plan = gemm_plan(1, M, N, K, symmetric=sym)
    lib = _library()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = _workspace((plan,), x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ns_gemm(x.data_ptr(), y.data_ptr(),
                          None if d is None else d.data_ptr(), out.data_ptr(),
                          None if ws is None else ws.data_ptr(),
                          1, M, N, K, K, y.shape[1], N, N, 0, 0, 0, 0,
                          int(trans_b), int(sym), plan.splits, plan.k_split,
                          float(alpha), float(beta),
                          _DTYPE_CODES[x.dtype], stream)
    _raise_on(err, f"matmul (M={M} N={N} K={K} {x.dtype})")
    MATMUL_LAUNCHES += 1
    return out


def matmul_ref(x: torch.Tensor, y: torch.Tensor,
               trans_b: bool = False) -> torch.Tensor:
    """The plain version, on any device."""
    _check_matmul(x, y, trans_b)
    yf = y.float().T if trans_b else y.float()
    return (x.float() @ yf).to(x.dtype)


def matmul(x: torch.Tensor, y: torch.Tensor, *, trans_b: bool = False,
           force: str = "auto") -> torch.Tensor:
    if force not in ("auto", "kernel", "ref"):
        raise ValueError(f"force={force!r} (auto|kernel|ref)")
    _check_matmul(x, y, trans_b)
    with torch_cost.kernel_region("matmul", **_gemm_dims(x, y, trans_b)):
        if force == "kernel" or (force == "auto" and x.is_cuda):
            return matmul_cuda(x, y, trans_b)
        return matmul_ref(x, y, trans_b)


def _gemm_dims(x, y, trans_b, d=None) -> dict:
    """The GEMM's work dims (``torch_cost.matmul``); ``d`` counts where it
    is not one of the operands."""
    N = y.shape[0] if trans_b else y.shape[1]
    return dict(M=x.shape[0], N=N, K=x.shape[1],
                symmetric=trans_b and _same(x, y),
                with_d=d is not None and not (_same(d, x) or _same(d, y)),
                itemsize=x.element_size())


def _gemm(x: torch.Tensor, y: torch.Tensor, *, trans_b: bool = False,
          d: torch.Tensor | None = None, alpha: float = 1.0,
          beta: float = 0.0) -> torch.Tensor:
    """alpha * x @ op(y) + beta * d with the update fused into the GEMM's
    epilogue on a CUDA tensor (counted as a ``matmul`` call); the plain
    form on the CPU."""
    with torch_cost.kernel_region("matmul", **_gemm_dims(x, y, trans_b, d)):
        if x.is_cuda:
            return matmul_cuda(x, y, trans_b, d, alpha, beta)
        out = alpha * matmul_ref(x.float(), y.float(), trans_b)
        if d is not None:
            out = out + beta * d.float()
        return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _ns_large(x: torch.Tensor, steps: int) -> torch.Tensor:
    """NS of one f32 matrix (n <= m) via the GEMM for matrices too large to
    fuse: per iteration G = x x^T (symmetric), c G G^T + b G (G is
    symmetric: G G^T is G G) and P x + a x, the updates in the GEMM's
    epilogue.  The norm is plain tensor code, as the reference leaves it to
    XLA."""
    a, b, c = NS_COEFFS
    x = x / (torch.linalg.norm(x) + EPS)
    for _ in range(steps):
        gram = matmul(x, x, trans_b=True)
        poly = _gemm(gram, gram, trans_b=True, d=gram, alpha=c, beta=b)
        x = _gemm(poly, x, d=x, beta=a)
    return x


def newton_schulz(m: torch.Tensor, steps: int = 5,
                  force: str = "auto") -> torch.Tensor:
    """Orthogonalize the trailing two dims of ``m`` (n_in, n_out) or
    (L, n_in, n_out); returns m's shape and dtype."""
    if force not in ("auto", "kernel", "ref"):
        raise ValueError(f"force={force!r} (auto|kernel|ref)")
    if m.ndim not in (2, 3):
        raise ValueError(f"newton_schulz: m must be 2-D or 3-D, got "
                         f"{tuple(m.shape)}")
    with torch_cost.kernel_region("newton_schulz", shape=tuple(m.shape),
                                  steps=steps, itemsize=m.element_size()):
        if m.is_meta:                   # no values: the shape alone
            return torch.empty_like(m)
        return _newton_schulz(m, steps, force)


def _newton_schulz(m: torch.Tensor, steps: int, force: str) -> torch.Tensor:
    stack = m if m.ndim == 3 else m[None]
    if force == "ref" or (force == "auto" and not m.is_cuda):
        y = torch.stack([newton_schulz_ref(a, steps) for a in stack])
        return y.reshape(m.shape)
    transpose = stack.shape[1] > stack.shape[2]
    x = stack.transpose(1, 2) if transpose else stack
    if route(stack.shape[1], stack.shape[2]) == "fused":
        y = ns_fused(x.contiguous(), steps)
    else:
        y = torch.stack([_ns_large(xi.float().contiguous(), steps)
                         for xi in x])
    if transpose:
        y = y.transpose(1, 2)
    return y.reshape(m.shape).to(m.dtype)
