"""Public selective-scan entry points of the Mamba blocks
(``repro/kernels/mamba_scan/ops.py``).

Dispatch is by the tensors' device: CUDA tensors launch the hand-written
Hopper kernel (``csrc/selective_scan.cu``) or raise; CPU tensors take the
plain version the reference's non-TPU path takes: the per-step recurrence
for S < 64, the chunked form otherwise.  ``force="kernel"``, ``"ref"`` or
``"chunked"`` pins a path for tests and the chip smoke run.

Where the reference runs its Pallas kernel only in the full-sequence
forward (``selective_scan``) and always the plain forms in the serving
prefill (``selective_scan_with_state``, since its kernel keeps the state in
VMEM scratch and never emits it), the port's kernel reads an initial state
and writes the final one, so both entry points run it on the card.

The kernel has no backward.  A CUDA input that requires grad raises,
naming the ROADMAP item that brings it; on the CPU autograd differentiates
the plain versions, as ``jax.grad`` differentiates the reference's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import ref

# Launches of the CUDA kernel in this process (one per call); the chip
# smoke run resets and reads it to show the forward used it.
KERNEL_LAUNCHES = 0

KERNEL_STATE_DIMS = (4, 16)        # the smoke configs' and jamba's
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FORCES = ("auto", "kernel", "ref", "chunked")
_BACKWARD = ("ROADMAP queue A item 18 (the selective-scan backward): the "
             "CUDA scan kernel has no gradient yet; training Mamba layers "
             "on the card waits for it")


def _library() -> ctypes.CDLL:
    lib = _build.load("mamba_scan")
    fn = lib.selective_scan_fwd
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p: ctypes would cut a bare int
        # to 32 bits.
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
    return lib


def _check(u, dt, A, Bm, Cm, Dp, h0):
    if u.ndim != 3:
        raise ValueError(f"selective_scan: u must be (B, S, d), got "
                         f"{tuple(u.shape)}")
    B, S, d = u.shape
    if A.ndim != 2 or A.shape[0] != d:
        raise ValueError(f"selective_scan: A {tuple(A.shape)}, expected "
                         f"({d}, N)")
    N = A.shape[1]
    want = {"dt": (B, S, d), "Bm": (B, S, N), "Cm": (B, S, N), "Dp": (d,)}
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm), ("Dp", Dp)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"selective_scan: {name} {tuple(t.shape)}, "
                             f"expected {want[name]}")
    if h0 is not None and tuple(h0.shape) != (B, d, N):
        raise ValueError(f"selective_scan: h0 {tuple(h0.shape)}, expected "
                         f"{(B, d, N)}")


def selective_scan_cuda(u, dt, A, Bm, Cm, Dp, h0=None,
                        final_state: bool = True):
    """Launch the CUDA kernel on the current stream; returns (y in u.dtype,
    final state (B, d, N) float32 or None), new tensors.  Raises on what the
    kernel does not take: non-CUDA or mixed devices, u/dt/Bm/Cm not all
    float32 or all bfloat16, A or h0 not float32, N other than 4 or 16,
    non-contiguous or misaligned inputs, or a refused launch.  ``Dp`` (d,)
    is cast to float32 here."""
    global KERNEL_LAUNCHES
    _check(u, dt, A, Bm, Cm, Dp, h0)
    B, S, d = u.shape
    N = A.shape[1]
    Df = Dp.to(torch.float32).contiguous()
    named = [("u", u), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
             ("Dp", Df)] + ([("h0", h0)] if h0 is not None else [])
    for name, t in named:
        if not t.is_cuda or t.device != u.device:
            raise ValueError(f"selective_scan kernel: {name} must lie on "
                             f"u's CUDA device, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"selective_scan kernel: {name} must be "
                             "contiguous and 16-byte aligned")
    if u.dtype not in _DTYPE_CODES or any(
            t.dtype != u.dtype for t in (dt, Bm, Cm)):
        raise ValueError(f"selective_scan kernel: u/dt/Bm/Cm dtypes "
                         f"{u.dtype}/{dt.dtype}/{Bm.dtype}/{Cm.dtype} (all "
                         "float32 or all bfloat16)")
    if A.dtype != torch.float32 or (h0 is not None
                                    and h0.dtype != torch.float32):
        raise ValueError(f"selective_scan kernel: A {A.dtype} and h0 "
                         f"{None if h0 is None else h0.dtype} must be "
                         "float32")
    if N not in KERNEL_STATE_DIMS:
        raise ValueError(f"selective_scan kernel: state dim {N} (built for "
                         f"{KERNEL_STATE_DIMS})")
    lib = _library()
    y = torch.empty_like(u)
    h_out = (torch.empty((B, d, N), dtype=torch.float32, device=u.device)
             if final_state else None)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.selective_scan_fwd(
            u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), Df.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            None if h_out is None else h_out.data_ptr(),
            B, S, d, N, _DTYPE_CODES[u.dtype], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error "
                           f"{err} (B={B} S={S} d={d} N={N} {u.dtype})")
    KERNEL_LAUNCHES += 1
    return y, h_out


def _on_kernel(force: str, u) -> bool:
    if force not in _FORCES:
        raise ValueError(f"force={force!r} ({'|'.join(_FORCES)})")
    return force == "kernel" or (force == "auto" and u.is_cuda)


def _no_grad(*tensors):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(_BACKWARD)


def selective_scan_with_state(u, dt, A, Bm, Cm, Dp, h0=None, *,
                              force: str = "auto"):
    """Returns (y (B, S, d) in u.dtype, final state (B, d, N) float32): the
    serving prefill, whose final state seeds decode."""
    if _on_kernel(force, u):
        _no_grad(u, dt, A, Bm, Cm, Dp, h0)
        return selective_scan_cuda(u, dt, A, Bm.contiguous(),
                                   Cm.contiguous(), Dp, h0)
    if force == "ref" or (force == "auto" and u.shape[1] < 64):
        return ref.selective_scan_ref(u, dt, A, Bm, Cm, Dp, h0=h0)
    return ref.selective_scan_chunked(u, dt, A, Bm, Cm, Dp, h0=h0)


def selective_scan(u, dt, A, Bm, Cm, Dp, *, force: str = "auto"):
    """Returns y (B, S, d) in u.dtype, from a zero state: the full-sequence
    forward (training, evaluation).  The kernel writes no final state
    here."""
    if _on_kernel(force, u):
        _no_grad(u, dt, A, Bm, Cm, Dp)
        y, _ = selective_scan_cuda(u, dt, A, Bm.contiguous(),
                                   Cm.contiguous(), Dp, final_state=False)
        return y
    return selective_scan_with_state(u, dt, A, Bm, Cm, Dp, force=force)[0]
