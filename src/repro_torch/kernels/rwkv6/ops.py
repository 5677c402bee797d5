"""Public WKV entry point of RWKV6 time mixing
(``repro/kernels/rwkv6/ops.py``).

Dispatch is by the tensors' device: CUDA tensors launch the hand-written
Hopper kernel (``csrc/wkv.cu``: the chunked form with its products on the
tensor cores in 3xTF32) or raise; CPU tensors take the plain version the
reference's non-TPU path takes: the per-step recurrence for S < 64, the
chunked closed form otherwise.  ``force="kernel"``, ``"ref"`` or
``"chunked"`` pins a path for tests and the chip smoke run.

A CUDA input that requires grad (with grad enabled) goes through
``WKVFunction``: the forward kernel also writes the state at every chunk
start, and the backward is a kernel of its own (``csrc/wkv_bwd.cu``), which
re-runs each chunk from its start state.  On the CPU autograd
differentiates the plain version, as ``jax.grad`` differentiates the
reference's.  Nothing on the card falls back to the plain version.

Both paths enter the ``wkv`` region of ``roofline.torch_cost`` (and the
backward ``wkv_bwd``), so a counted step reads the kernels' work.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6 import ref
from repro_torch.roofline import torch_cost

# Launches of the CUDA kernels in this process (one per call): the forward
# (inference and training) and the backward; the chip smoke run resets and
# reads them to show the prefill and the training steps used them.
KERNEL_LAUNCHES = 0
BWD_LAUNCHES = 0

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# Each entry point's (pointer, int) argument counts; the stream follows as
# a pointer.  Pointers as c_void_p: ctypes would cut a bare int to 32 bits.
_ENTRIES = {"wkv_fwd": (8, 5), "wkv_fwd_save": (9, 5), "wkv_bwd": (15, 5),
            "wkv_chunk_steps": (0, 1), "wkv_bwd_scratch_floats": (0, 1)}


def chunk_steps(hd: int) -> int:
    """Steps of a chunk at head dim ``hd``: ``Cfg<T, hd>::C`` in
    ``csrc/wkv.cu`` (its ``wkv_chunk_steps``), one chunk state saved a
    chunk for the backward."""
    return 16 if hd >= 128 else 32


def _work_dims(r, u) -> dict:
    """The kernels' work dims (``torch_cost.wkv``/``wkv_bwd``)."""
    B, S, H, hd = r.shape
    return dict(B=B, S=S, H=H, hd=hd, itemsize=r.element_size())


def _entry(name: str):
    """Entry point ``name`` of the built library, its signature set on
    first use (a library built from another checkout's sources may export
    only some of them)."""
    fn = getattr(_build.load("rwkv6"), name)
    if fn.argtypes is None:
        n_ptr, n_int = _ENTRIES[name]
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + ([ctypes.c_void_p] if n_ptr else []))
    return fn


def _check_device(names_tensors, r, what="wkv kernel"):
    for name, t in names_tensors:
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"{what}: {name} must lie on r's CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             "aligned")


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
    if state is not None and tuple(state.shape) != (B, H, hd, hd):
        raise ValueError(f"wkv: state {tuple(state.shape)}, expected "
                         f"{(B, H, hd, hd)}")


def wkv_cuda(r, k, v, w, u, state, save_chunks: bool = False):
    """Launch the CUDA kernel on the current stream; returns (y in r.dtype,
    final state float32), both new tensors, and with ``save_chunks`` also
    the state at every chunk start, (B, H, ceil(S / C), hd, hd) float32
    (the backward's input).  Raises on what the kernel does not take:
    non-CUDA or mixed devices, r/k/v not all float32 or all bfloat16, w or
    state not float32, head dims other than 16/32/64/128, non-contiguous or
    misaligned inputs, or a refused launch.  ``u`` (H, hd) is cast to
    float32 here."""
    global KERNEL_LAUNCHES
    _check(r, k, v, w, u, state)
    B, S, H, hd = r.shape
    uf = u.to(torch.float32).contiguous()
    _check_device((("r", r), ("k", k), ("v", v), ("w", w), ("u", uf),
                   ("state", state)), r)
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
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    chunks = None
    if save_chunks:
        C = _entry("wkv_chunk_steps")(hd)
        chunks = torch.empty((B, H, -(-S // C), hd, hd), dtype=torch.float32,
                             device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                uf.data_ptr(), state.data_ptr(), y.data_ptr(),
                s_out.data_ptr())
        tail = (B, S, H, hd, _DTYPE_CODES[r.dtype], stream)
        err = (_entry("wkv_fwd_save")(*args, chunks.data_ptr(), *tail)
               if save_chunks else _entry("wkv_fwd")(*args, *tail))
    if err != 0:
        raise RuntimeError(f"wkv kernel launch failed: CUDA error {err} "
                           f"(B={B} S={S} H={H} hd={hd} {r.dtype})")
    KERNEL_LAUNCHES += 1
    return (y, s_out, chunks) if save_chunks else (y, s_out)


def wkv_bwd_cuda(r, k, v, w, u, chunks, dy, ds_final=None):
    """Launch the backward kernel on the current stream: from the forward's
    inputs, its chunk states (``wkv_cuda(..., save_chunks=True)``), dy
    (B,S,H,hd) in r's dtype and the final state's gradient (None: zero),
    returns (dr, dk, dv in r's dtype, dw float32, du in u's dtype, the
    initial state's gradient float32).  du's per-(b, h) partials are summed
    over b here, in a fixed order.  Raises on what the kernel does not
    take, as ``wkv_cuda`` does."""
    global BWD_LAUNCHES
    _check(r, k, v, w, u, ds_final)
    B, S, H, hd = r.shape
    if S == 0:
        ds0 = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                           device=r.device) if ds_final is None
               else ds_final.float().clone())
        return (torch.zeros_like(r), torch.zeros_like(k), torch.zeros_like(v),
                torch.zeros_like(w), torch.zeros_like(u), ds0)
    uf = u.to(torch.float32).contiguous()
    dy = dy.contiguous()
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", uf),
             ("chunks", chunks), ("dy", dy)]
    if ds_final is not None:
        ds_final = ds_final.contiguous()
        named.append(("ds_final", ds_final))
    _check_device(named, r, "wkv backward kernel")
    if r.dtype not in _DTYPE_CODES or any(t.dtype != r.dtype
                                          for t in (k, v, dy)):
        raise ValueError(f"wkv backward kernel: r/k/v/dy dtypes {r.dtype}/"
                         f"{k.dtype}/{v.dtype}/{dy.dtype} (all float32 or "
                         "all bfloat16)")
    if any(t.dtype != torch.float32 for t in (w, chunks)) or (
            ds_final is not None and ds_final.dtype != torch.float32):
        raise ValueError("wkv backward kernel: w, the chunk states and "
                         "ds_final must be float32")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"wkv backward kernel: head dim {hd} (built for "
                         f"{KERNEL_HEAD_DIMS})")
    if tuple(chunks.shape) != (B, H, -(-S // _entry("wkv_chunk_steps")(hd)),
                               hd, hd):
        raise ValueError(f"wkv backward kernel: chunk states "
                         f"{tuple(chunks.shape)} do not match S={S}")
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dw = torch.empty_like(w)
    du_part = torch.empty((B, H, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    scratch = torch.empty(B * H * _entry("wkv_bwd_scratch_floats")(hd),
                          dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _entry("wkv_bwd")(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            uf.data_ptr(), chunks.data_ptr(), dy.data_ptr(),
            None if ds_final is None else ds_final.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du_part.data_ptr(), ds0.data_ptr(), scratch.data_ptr(),
            B, S, H, hd, _DTYPE_CODES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv backward kernel launch failed: CUDA error "
                           f"{err} (B={B} S={S} H={H} hd={hd} {r.dtype})")
    BWD_LAUNCHES += 1
    return dr, dk, dv, dw, du_part.sum(0).to(u.dtype), ds0


class WKVFunction(torch.autograd.Function):
    """The kernel's forward (saving the chunk states) and backward, for
    CUDA inputs that require grad."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        y, s_out, chunks = wkv_cuda(r, k, v, w, u, state, save_chunks=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, chunks)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, chunks = ctx.saved_tensors
        with torch_cost.kernel_region(
                "wkv_bwd", chunk_steps=chunk_steps(r.shape[-1]),
                **_work_dims(r, u)):
            if dy is None:
                dy = torch.zeros_like(r)
            return wkv_bwd_cuda(r, k, v, w, u, chunks, dy, ds)


def wkv(r, k, v, w, u, state, *, force: str = "auto"):
    """Returns (y (B,S,H,hd) in r.dtype, final state (B,H,hd,hd) float32)."""
    if force not in ("auto", "kernel", "ref", "chunked"):
        raise ValueError(f"force={force!r} (auto|kernel|ref|chunked)")
    dims = _work_dims(r, u)
    with torch_cost.kernel_region("wkv", u_itemsize=u.element_size(),
                                  **dims):
        if force == "kernel" or (force == "auto" and r.is_cuda):
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (r, k, v, w, u, state)):
                return WKVFunction.apply(r, k, v, w, u, state)
            return wkv_cuda(r, k, v, w, u, state)
        plain = (ref.wkv_ref if force == "ref"
                 or (force == "auto" and r.shape[1] < 64)
                 else ref.wkv_chunked)
        return torch_cost.counted_plain(
            plain, (r, k, v, w, u, state), "wkv_bwd", like=_like,
            saved=_saved, chunk_steps=chunk_steps(r.shape[-1]), **dims)


def _like(r, k, v, w, u, state):
    """Empty (y, final state) of ``wkv``'s shapes and dtypes."""
    return torch.empty_like(r), torch.empty_like(state, dtype=torch.float32)


def _saved(r, k, v, w, u, state):
    """Empty chunk states of the shape the training forward saves."""
    B, S, H, hd = r.shape
    return (torch.empty((B, H, -(-S // chunk_steps(hd)), hd, hd),
                        dtype=torch.float32, device=r.device),)
