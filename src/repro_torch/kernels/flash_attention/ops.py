"""Public flash-attention entry point used by the port's models
(``repro/kernels/flash_attention/ops.py``), for the serving paths (prefill)
and for training (forward and backward).

Dispatch is by the tensors' device: CUDA tensors launch the hand-written
Hopper kernels or raise; CPU tensors take the plain PyTorch version
(``naive_attention`` up to 256 positions, else ``blocked_attention``, as the
reference picks), whose gradient is autograd's.  ``force="kernel"`` or
``force="ref"`` pins a path for tests and the chip smoke run.

On the card, a call whose inputs require grad (training, under autograd)
goes through ``FlashAttentionFn``: the forward kernel
(``csrc/flash_attention.cu``) also writes each row's logsumexp, and the
backward launches the hand-written backward (``csrc/flash_attention_bwd.cu``;
the reference has no TPU counterpart, JAX differentiates its attention
itself).  Every other call (the serving paths) runs the forward alone, with
no logsumexp.

Keys may outnumber queries (S_k != S_q) in non-causal attention: the
encoder-decoder's cross-attention, decoder queries over every encoder
frame.  Causal attention at S_k != S_q has no caller and raises.

Both paths enter the ``flash_attention`` kernel region of
``roofline.torch_cost`` (and the backward ``flash_attention_bwd``), so a
counted step reads the kernels' work whichever path ran; the plain path's
output is contiguous, as the kernel's is.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref
from repro_torch.roofline import torch_cost

# Launches of the CUDA forward kernel, and calls of the CUDA backward (each
# one dQ launch, which also writes D = rowsum(dO * o), then one dK/dV
# launch), in this process; the chip smoke run resets them and reads them
# to show that the serving and training paths went through the kernels.
KERNEL_LAUNCHES = 0
BWD_LAUNCHES = 0

KERNEL_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p: ctypes would cut a bare int
        # to 32 bits.
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        bwd = lib.flash_attention_bwd
        bwd.restype = ctypes.c_int
        bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                        + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _check(q, k, v, causal):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if causal and k.shape[1] != S:
        raise ValueError(f"flash_attention: causal attention over "
                         f"{k.shape[1]} keys for {S} queries (non-causal "
                         "only at S_k != S_q)")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} query heads not a multiple "
                         f"of {k.shape[2]} kv heads")


def _check_cuda(q, named):
    """Raise on what the kernels do not take: non-CUDA or mixed devices,
    dtypes other than float32/bfloat16 or mixed, head dims other than
    64/128/256, non-contiguous or misaligned tensors."""
    hd = q.shape[-1]
    for name, t in named:
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


def flash_attention_cuda(q, k, v, *, causal=True, window=0,
                         logit_softcap=0.0, with_lse=False):
    """Launch the forward kernel on the current stream; returns the output,
    or ``(out, lse)`` with ``with_lse`` (lse (B, H, S_q) float32, each
    row's logsumexp, for the backward).  Raises on what the kernel does not
    take (see ``_check_cuda``) or on a refused launch."""
    global KERNEL_LAUNCHES
    _check(q, k, v, causal)
    _check_cuda(q, (("q", q), ("k", k), ("v", v)))
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    lib = _library()
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, S, Sk, H, KV, hd, _DTYPE_CODES[q.dtype], int(bool(causal)),
            int(window), float(logit_softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} (B={B} S={S} Sk={Sk} H={H} KV={KV} "
                           f"hd={hd} {q.dtype})")
    KERNEL_LAUNCHES += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal=True,
                             window=0, logit_softcap=0.0):
    """Launch the backward kernels on the current stream: (dq, dk, dv) of
    the attention whose forward gave ``out`` and ``lse``, for the upstream
    gradient ``dout``.  Raises as ``flash_attention_cuda`` does."""
    global BWD_LAUNCHES
    _check(q, k, v, causal)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention backward: out {tuple(out.shape)} "
                         f"/ dout {tuple(dout.shape)} differ from q "
                         f"{tuple(q.shape)}")
    _check_cuda(q, (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)))
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention backward: lse must be float32 "
                         f"({B}, {H}, {S}) on {q.device}")
    lib = _library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # D of every row, written by the dQ launch for the dK/dV launch.
    dsum = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, Sk, H, KV, hd,
            _DTYPE_CODES[q.dtype], int(bool(causal)), int(window),
            float(logit_softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err} (B={B} S={S} Sk={Sk} H={H} KV={KV} "
                           f"hd={hd} {q.dtype})")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The CUDA forward with the CUDA backward as its gradient.  Saves q, k,
    v, the output and the per-row logsumexp; the backward recomputes the
    probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        logit_softcap=logit_softcap,
                                        with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window,
                      logit_softcap=logit_softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with torch_cost.kernel_region("flash_attention_bwd",
                                      **_work_dims(q, k, ctx.kw)):
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse,
                                                  dout.contiguous(),
                                                  **ctx.kw)
        return dq, dk, dv, None, None, None


def _work_dims(q, k, kw) -> dict:
    """The kernels' work dims (``torch_cost.flash_attention``)."""
    B, S, H, hd = q.shape
    return dict(B=B, S_q=S, S_k=k.shape[1], H=H, KV=k.shape[2], hd=hd,
                causal=bool(kw["causal"]), window=int(kw["window"]),
                itemsize=q.element_size())


def flash_attention_ref(q, k, v, *, causal=True, window=0, logit_softcap=0.0):
    """The plain PyTorch version, on any device: the naive one up to 256
    queries, else the blocked one, as the reference picks by q's length."""
    _check(q, k, v, causal)
    fn = ref.naive_attention if q.shape[1] <= 256 else ref.blocked_attention
    return fn(q, k, v, causal=causal, window=window,
              logit_softcap=logit_softcap)


def flash_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                    force: str = "auto"):
    """q: (B,S_q,H,hd); k,v: (B,S_k,KV,hd) -> (B,S_q,H,hd), S_k == S_q
    unless non-causal.  Differentiable on every path: on the card through
    ``FlashAttentionFn``, on the CPU through autograd of the plain
    version."""
    if force not in ("auto", "kernel", "ref"):
        raise ValueError(f"force={force!r} (auto|kernel|ref)")
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap)
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    dims = _work_dims(q, k, kw)
    with torch_cost.kernel_region("flash_attention", with_lse=grad, **dims):
        if force == "kernel" or (force == "auto" and q.is_cuda):
            if grad:
                return FlashAttentionFn.apply(q, k, v, causal, window,
                                              logit_softcap)
            return flash_attention_cuda(q, k, v, **kw)
        return torch_cost.counted_plain(
            lambda q, k, v: flash_attention_ref(q, k, v, **kw).contiguous(),
            (q, k, v), "flash_attention_bwd",
            like=lambda q, k, v: torch.empty_like(q),
            saved=lambda q, k, v: (torch.empty(
                q.shape[:1] + q.shape[2:3] + q.shape[1:2],
                dtype=torch.float32, device=q.device),), **dims)
