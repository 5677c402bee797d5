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
newton_schulz.cu``) or raise; on a CPU tensor they run their plain
versions.  ``force="kernel"`` takes that route on any device (on the CPU it
runs the route's plain versions, as the reference's ``force='pallas'`` runs
interpret mode off the TPU); ``force="ref"`` runs ``newton_schulz_ref`` per
matrix; ``"auto"`` is the route on a CUDA tensor and the reference on the
CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.newton_schulz.ref import NS_COEFFS, newton_schulz_ref

# Calls of the CUDA ns_fused chain (one per stacked leaf: a norm pass and 3
# GEMM launches per iteration) and launches of the CUDA matmul, in this
# process; the chip smoke run resets and reads them to show that training
# went through the kernels.
NS_FUSED_LAUNCHES = 0
MATMUL_LAUNCHES = 0

EPS = 1e-7
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NORM_PARTS = 32                  # NORM_PARTS in the .cu

# Budget for the fused path, the reference's: matrix + gram + temps in f32
# must fit the TPU's VMEM.  Kept so that the same leaves take the same
# route; on the card the fused chain has no such limit.
_VMEM_BUDGET = 96 * 2**20


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
        lib.ns_gemm.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                + [ctypes.c_longlong] * 8 + [ctypes.c_int]
                                + [ctypes.c_float] * 2
                                + [ctypes.c_int, ctypes.c_void_p])
        lib.ns_fused.restype = ctypes.c_int
        lib.ns_fused.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                 + [ctypes.c_float] * 4
                                 + [ctypes.c_int, ctypes.c_void_p])
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
    a, b, c = NS_COEFFS
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ns_fused(x.data_ptr(), xa.data_ptr(), xb.data_ptr(),
                           g.data_ptr(), p.data_ptr(), partial.data_ptr(),
                           L, n, m, int(steps), float(eps), a, b, c,
                           _DTYPE_CODES[x.dtype], stream)
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


def matmul_cuda(x: torch.Tensor, y: torch.Tensor,
                trans_b: bool = False) -> torch.Tensor:
    """Launch the GEMM on the current stream: x (M, K) @ y (K, N), or
    x @ y.T for y (N, K) with ``trans_b`` (y.T is never materialized);
    f32 accumulation, the output in x's dtype."""
    global MATMUL_LAUNCHES
    _check_matmul(x, y, trans_b)
    _check_cuda("matmul", (x, y))
    M, K = x.shape
    N = y.shape[0] if trans_b else y.shape[1]
    lib = _library()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ns_gemm(x.data_ptr(), y.data_ptr(), None, out.data_ptr(),
                          1, M, N, K, K, y.shape[1], 0, N, 0, 0, 0, 0,
                          int(trans_b), 1.0, 0.0, _DTYPE_CODES[x.dtype],
                          stream)
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
    if force == "kernel" or (force == "auto" and x.is_cuda):
        return matmul_cuda(x, y, trans_b)
    return matmul_ref(x, y, trans_b)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _ns_large(x: torch.Tensor, steps: int) -> torch.Tensor:
    """NS of one f32 matrix (n <= m) via ``matmul`` for matrices too large
    to fuse.  The norm and the elementwise updates are plain tensor code,
    as the reference leaves them to XLA."""
    a, b, c = NS_COEFFS
    x = x / (torch.linalg.norm(x) + EPS)
    for _ in range(steps):
        gram = matmul(x, x, trans_b=True)
        poly = b * gram + c * matmul(gram, gram)
        x = a * x + matmul(poly, x)
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
