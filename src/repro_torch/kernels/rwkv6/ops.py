"""Public WKV entry point of RWKV6 time mixing
(``repro/kernels/rwkv6/ops.py``).

Dispatch is by the tensors' device: CUDA tensors launch the hand-written
Hopper kernel (``csrc/wkv.cu``) or raise; CPU tensors take the plain
version the reference's non-TPU path takes: the per-step recurrence for
S < 64, the chunked closed form otherwise.  ``force="kernel"``, ``"ref"``
or ``"chunked"`` pins a path for tests and the chip smoke run.

The kernel has no backward.  A CUDA input that requires grad raises,
naming the ROADMAP item that brings it; on the CPU autograd differentiates
the plain version, as ``jax.grad`` differentiates the reference's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6 import ref

# Launches of the CUDA kernel in this process (one per call); the chip
# smoke run resets and reads it to show the prefill used it.
KERNEL_LAUNCHES = 0

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BACKWARD = ("ROADMAP queue A item 16 (the WKV backward): the CUDA WKV kernel "
             "has no gradient yet; training RWKV6 on the card waits for it")


def _library() -> ctypes.CDLL:
    lib = _build.load("rwkv6")
    fn = lib.wkv_fwd
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p: ctypes would cut a bare int
        # to 32 bits.
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
    return lib


def _check(r, k, v, w, u, state):
    if r.ndim != 4:
        raise ValueError(f"wkv: r must be (B, S, H, hd), got {tuple(r.shape)}")
    B, _, H, hd = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"wkv: {name} {tuple(t.shape)} does not match r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"wkv: u {tuple(u.shape)}, expected {(H, hd)}")
    if tuple(state.shape) != (B, H, hd, hd):
        raise ValueError(f"wkv: state {tuple(state.shape)}, expected "
                         f"{(B, H, hd, hd)}")


def wkv_cuda(r, k, v, w, u, state):
    """Launch the CUDA kernel on the current stream; returns (y in r.dtype,
    final state float32), both new tensors.  Raises on what the kernel does
    not take: non-CUDA or mixed devices, r/k/v not all float32 or all
    bfloat16, w or state not float32, head dims other than 16/32/64/128,
    non-contiguous or misaligned inputs, or a refused launch.  ``u`` (H, hd)
    is cast to float32 here."""
    global KERNEL_LAUNCHES
    _check(r, k, v, w, u, state)
    B, S, H, hd = r.shape
    uf = u.to(torch.float32).contiguous()
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", uf),
                    ("state", state)):
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"wkv kernel: {name} must lie on r's CUDA "
                             f"device, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"wkv kernel: {name} must be contiguous and "
                             "16-byte aligned")
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise ValueError(f"wkv kernel: r/k/v dtypes {r.dtype}/{k.dtype}/"
                         f"{v.dtype} (all float32 or all bfloat16)")
    if w.dtype != torch.float32 or state.dtype != torch.float32:
        raise ValueError(f"wkv kernel: w {w.dtype} and state {state.dtype} "
                         "must be float32")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"wkv kernel: head dim {hd} (built for "
                         f"{KERNEL_HEAD_DIMS})")
    lib = _library()
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          w.data_ptr(), uf.data_ptr(), state.data_ptr(),
                          y.data_ptr(), s_out.data_ptr(), B, S, H, hd,
                          _DTYPE_CODES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv kernel launch failed: CUDA error {err} "
                           f"(B={B} S={S} H={H} hd={hd} {r.dtype})")
    KERNEL_LAUNCHES += 1
    return y, s_out


def wkv(r, k, v, w, u, state, *, force: str = "auto"):
    """Returns (y (B,S,H,hd) in r.dtype, final state (B,H,hd,hd) float32)."""
    if force not in ("auto", "kernel", "ref", "chunked"):
        raise ValueError(f"force={force!r} (auto|kernel|ref|chunked)")
    if force == "kernel" or (force == "auto" and r.is_cuda):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, w, u, state)):
            raise NotImplementedError(_BACKWARD)
        return wkv_cuda(r, k, v, w, u, state)
    if force == "ref" or (force == "auto" and r.shape[1] < 64):
        return ref.wkv_ref(r, k, v, w, u, state)
    return ref.wkv_chunked(r, k, v, w, u, state)
