"""Public flash-attention entry point used by the port's models
(``repro/kernels/flash_attention/ops.py``).

Dispatch is by the tensors' device: CUDA tensors launch the hand-written
Hopper kernel (``csrc/flash_attention.cu``) or raise; CPU tensors take the
plain PyTorch version (``naive_attention`` up to 256 positions, else
``blocked_attention``, as the reference picks).  ``force="kernel"`` or
``force="ref"`` pins a path for tests and the chip smoke run.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

# Launches of the CUDA kernel in this process; the chip smoke run resets it
# and reads it to show that the serving path went through the kernel.
KERNEL_LAUNCHES = 0

KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p: ctypes would cut a bare int
        # to 32 bits.
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} query heads not a multiple "
                         f"of {k.shape[2]} kv heads")


def flash_attention_cuda(q, k, v, *, causal=True, window=0,
                         logit_softcap=0.0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Raises on what the
    kernel does not take: non-CUDA or mixed devices, dtypes other than
    float32/bfloat16, head dims other than 64/128, non-contiguous or
    misaligned inputs, or a refused launch."""
    global KERNEL_LAUNCHES
    _check(q, k, v)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} must lie on "
                             f"q's CUDA device, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention kernel: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must be "
                             "contiguous and 16-byte aligned")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} "
                         "(float32 and bfloat16 only)")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {hd} "
                         f"(built for {KERNEL_HEAD_DIMS})")
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, KV, hd, _DTYPE_CODES[q.dtype], int(bool(causal)),
            int(window), float(logit_softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} (B={B} S={S} H={H} KV={KV} hd={hd} "
                           f"{q.dtype})")
    KERNEL_LAUNCHES += 1
    return out


def flash_attention_ref(q, k, v, *, causal=True, window=0, logit_softcap=0.0):
    """The plain PyTorch version, on any device."""
    _check(q, k, v)
    fn = ref.naive_attention if q.shape[1] <= 256 else ref.blocked_attention
    return fn(q, k, v, causal=causal, window=window,
              logit_softcap=logit_softcap)


def flash_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                    force: str = "auto"):
    """q: (B,S,H,hd); k,v: (B,S,KV,hd) -> (B,S,H,hd)."""
    if force not in ("auto", "kernel", "ref"):
        raise ValueError(f"force={force!r} (auto|kernel|ref)")
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap)
    if force == "kernel" or (force == "auto" and q.is_cuda):
        return flash_attention_cuda(q, k, v, **kw)
    return flash_attention_ref(q, k, v, **kw)
