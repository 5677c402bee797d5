"""Public selective-scan entry points of the Mamba blocks
(``repro/kernels/mamba_scan/ops.py``).

Dispatch is by the tensors' device: CUDA tensors launch the hand-written
Hopper kernel (``csrc/selective_scan.cu``: cp.async staging, pipelined
steps, y out as 16-byte rows) or raise; CPU tensors take the
plain version the reference's non-TPU path takes: the per-step recurrence
for S < 64, the chunked form otherwise.  ``force="kernel"``, ``"ref"`` or
``"chunked"`` pins a path for tests and the chip smoke run.

Where the reference runs its Pallas kernel only in the full-sequence
forward (``selective_scan``) and always the plain forms in the serving
prefill (``selective_scan_with_state``, since its kernel keeps the state in
VMEM scratch and never emits it), the port's kernel reads an initial state
and writes the final one, so both entry points run it on the card.

A CUDA input that requires grad (with grad enabled) goes through
``ScanFunction``: the forward kernel also writes h every 64 steps, and the
backward is a kernel of its own (``csrc/selective_scan_bwd.cu``), which
re-runs each 64-step chunk from its saved state; it gives the gradients of
h0 and of the final state on ``selective_scan_with_state``.  On the CPU
autograd differentiates the plain versions, as ``jax.grad`` differentiates
the reference's.  Nothing on the card falls back to the plain version.

Both paths enter the ``selective_scan`` region of ``roofline.torch_cost``
(and the backward ``selective_scan_bwd``), so a counted step reads the
kernels' work.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import ref
from repro_torch.roofline import torch_cost

# Launches of the CUDA kernels in this process (one per call): the forward
# (inference and training) and the backward; the chip smoke run resets and
# reads them to show the forward and the training steps used them.
KERNEL_LAUNCHES = 0
BWD_LAUNCHES = 0

KERNEL_STATE_DIMS = (4, 16)        # the smoke configs' and jamba's
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FORCES = ("auto", "kernel", "ref", "chunked")
# Steps between the states the training forward saves: ``SAVE`` in
# ``csrc/selective_scan.cu`` (its ``selective_scan_save_steps``).
SAVE_STEPS = 64


def _work_dims(u, Bm) -> dict:
    """The kernels' work dims (``torch_cost.selective_scan``/``_bwd``)."""
    B, S, d = u.shape
    return dict(B=B, S=S, d=d, N=Bm.shape[-1], itemsize=u.element_size())


# Each entry point's (pointer, int) argument counts; the stream follows as
# a pointer.  Pointers as c_void_p: ctypes would cut a bare int to 32 bits.
_ENTRIES = {"selective_scan_fwd": (9, 5), "selective_scan_fwd_save": (10, 5),
            "selective_scan_bwd": (17, 5), "selective_scan_save_steps": (0, 0),
            "selective_scan_bwd_scratch_floats": (0, 1)}


def _entry(name: str):
    """Entry point ``name`` of the built library, its signature set on
    first use (a library built from another checkout's sources may export
    only some of them)."""
    fn = getattr(_build.load("mamba_scan"), name)
    if fn.argtypes is None:
        n_ptr, n_int = _ENTRIES[name]
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + ([ctypes.c_void_p] if n_ptr else []))
    return fn


def _check_device(named, u, what="selective_scan kernel"):
    for name, t in named:
        if not t.is_cuda or t.device != u.device:
            raise ValueError(f"{what}: {name} must lie on u's CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             "aligned")


def _check_dtypes(u, dt, A, Bm, Cm, h0, what="selective_scan kernel"):
    if u.dtype not in _DTYPE_CODES or any(
            t.dtype != u.dtype for t in (dt, Bm, Cm)):
        raise ValueError(f"{what}: u/dt/Bm/Cm dtypes "
                         f"{u.dtype}/{dt.dtype}/{Bm.dtype}/{Cm.dtype} (all "
                         "float32 or all bfloat16)")
    if A.dtype != torch.float32 or (h0 is not None
                                    and h0.dtype != torch.float32):
        raise ValueError(f"{what}: A {A.dtype} and h0 "
                         f"{None if h0 is None else h0.dtype} must be "
                         "float32")
    if A.shape[1] not in KERNEL_STATE_DIMS:
        raise ValueError(f"{what}: state dim {A.shape[1]} (built for "
                         f"{KERNEL_STATE_DIMS})")


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
                        final_state: bool = True, save_states: bool = False):
    """Launch the CUDA kernel on the current stream; returns (y in u.dtype,
    final state (B, d, N) float32 or None), new tensors, and with
    ``save_states`` also h at every 64th step, (B, ceil(S / 64), d, N)
    float32 (the backward's input).  Raises on what the kernel does not
    take: non-CUDA or mixed devices, u/dt/Bm/Cm not all float32 or all
    bfloat16, A or h0 not float32, N other than 4 or 16, non-contiguous or
    misaligned inputs, or a refused launch.  ``Dp`` (d,) is cast to float32
    here."""
    global KERNEL_LAUNCHES
    _check(u, dt, A, Bm, Cm, Dp, h0)
    B, S, d = u.shape
    N = A.shape[1]
    Df = Dp.to(torch.float32).contiguous()
    _check_device([("u", u), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                   ("Dp", Df)] + ([("h0", h0)] if h0 is not None else []), u)
    _check_dtypes(u, dt, A, Bm, Cm, h0)
    y = torch.empty_like(u)
    h_out = (torch.empty((B, d, N), dtype=torch.float32, device=u.device)
             if final_state else None)
    saved = None
    if save_states:
        K = _entry("selective_scan_save_steps")()
        saved = torch.empty((B, -(-S // K), d, N), dtype=torch.float32,
                            device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        args = (u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), Df.data_ptr(),
                None if h0 is None else h0.data_ptr(), y.data_ptr(),
                None if h_out is None else h_out.data_ptr())
        tail = (B, S, d, N, _DTYPE_CODES[u.dtype], stream)
        err = (_entry("selective_scan_fwd_save")(*args, saved.data_ptr(),
                                                 *tail)
               if save_states else _entry("selective_scan_fwd")(*args, *tail))
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error "
                           f"{err} (B={B} S={S} d={d} N={N} {u.dtype})")
    KERNEL_LAUNCHES += 1
    return (y, h_out, saved) if save_states else (y, h_out)


def selective_scan_bwd_cuda(u, dt, A, Bm, Cm, Dp, saved, dy, dh_final=None):
    """Launch the backward kernel on the current stream: from the forward's
    inputs, its saved states (``selective_scan_cuda(..., save_states=
    True)``), dy (B, S, d) in u's dtype and the final state's gradient
    (None: zero), returns (du, ddt, dA, dB, dC, dD, dh0) in the dtypes of
    (u, dt, A, Bm, Cm, Dp) and float32 for dh0.  The kernel's per-block and
    per-row partials are summed here, each by one ``torch.sum`` (a fixed
    order).  Raises on what the kernel does not take, as
    ``selective_scan_cuda`` does."""
    global BWD_LAUNCHES
    _check(u, dt, A, Bm, Cm, Dp, dh_final)
    B, S, d = u.shape
    N = A.shape[1]
    if S == 0:
        dh0 = (torch.zeros((B, d, N), dtype=torch.float32, device=u.device)
               if dh_final is None else dh_final.float().clone())
        return (torch.zeros_like(u), torch.zeros_like(dt),
                torch.zeros_like(A), torch.zeros_like(Bm),
                torch.zeros_like(Cm), torch.zeros_like(Dp), dh0)
    Df = Dp.to(torch.float32).contiguous()
    dy = dy.contiguous()
    named = [("u", u), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
             ("Dp", Df), ("saved", saved), ("dy", dy)]
    if dh_final is not None:
        dh_final = dh_final.contiguous()
        named.append(("dh_final", dh_final))
    what = "selective_scan backward kernel"
    _check_device(named, u, what)
    _check_dtypes(u, dt, A, Bm, Cm, dh_final, what)
    if dy.dtype != u.dtype or saved.dtype != torch.float32:
        raise ValueError(f"{what}: dy {dy.dtype} (u's dtype) and the saved "
                         f"states {saved.dtype} (float32)")
    K = _entry("selective_scan_save_steps")()
    if tuple(saved.shape) != (B, -(-S // K), d, N):
        raise ValueError(f"{what}: saved states {tuple(saved.shape)} do not "
                         f"match S={S}")
    nblk = -(-d // 64)
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    dA_part = torch.empty((B, d, N), **f32)
    dD_part = torch.empty((B, d), **f32)
    dB_part = torch.empty((B, nblk, S, N), **f32)
    dC_part = torch.empty((B, nblk, S, N), **f32)
    dh0 = torch.empty((B, d, N), **f32)
    scratch = torch.empty(
        B * nblk * 64 * _entry("selective_scan_bwd_scratch_floats")(N),
        **f32)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = _entry("selective_scan_bwd")(
            u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), Df.data_ptr(), saved.data_ptr(), dy.data_ptr(),
            None if dh_final is None else dh_final.data_ptr(), du.data_ptr(),
            ddt.data_ptr(), dA_part.data_ptr(), dD_part.data_ptr(),
            dB_part.data_ptr(), dC_part.data_ptr(), dh0.data_ptr(),
            scratch.data_ptr(), B, S, d, N, _DTYPE_CODES[u.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} (B={B} "
                           f"S={S} d={d} N={N} {u.dtype})")
    BWD_LAUNCHES += 1
    return (du, ddt, dA_part.sum(0).to(A.dtype),
            dB_part.sum(1).to(Bm.dtype), dC_part.sum(1).to(Cm.dtype),
            dD_part.sum(0).to(Dp.dtype), dh0)


class ScanFunction(torch.autograd.Function):
    """The kernel's forward (saving h every 64 steps) and backward, for
    CUDA inputs that require grad.  Returns (y, final state) with
    ``final_state``, else y."""

    @staticmethod
    def forward(ctx, u, dt, A, Bm, Cm, Dp, h0, final_state):
        y, h_out, saved = selective_scan_cuda(u, dt, A, Bm, Cm, Dp, h0,
                                              final_state, save_states=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u, dt, A, Bm, Cm, Dp, saved)
        ctx.has_h0 = h0 is not None
        return (y, h_out) if final_state else y

    @staticmethod
    def backward(ctx, dy, dh=None):
        u, dt, A, Bm, Cm, Dp, saved = ctx.saved_tensors
        with torch_cost.kernel_region("selective_scan_bwd",
                                      save_steps=SAVE_STEPS,
                                      **_work_dims(u, Bm)):
            if dy is None:
                dy = torch.zeros_like(u)
            du, ddt, dA, dB, dC, dD, dh0 = selective_scan_bwd_cuda(
                u, dt, A, Bm, Cm, Dp, saved, dy, dh)
        return (du, ddt, dA, dB, dC, dD, dh0 if ctx.has_h0 else None, None)


def _grad_wanted(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _on_kernel(force: str, u) -> bool:
    if force not in _FORCES:
        raise ValueError(f"force={force!r} ({'|'.join(_FORCES)})")
    return force == "kernel" or (force == "auto" and u.is_cuda)


def selective_scan_with_state(u, dt, A, Bm, Cm, Dp, h0=None, *,
                              force: str = "auto"):
    """Returns (y (B, S, d) in u.dtype, final state (B, d, N) float32): the
    serving prefill, whose final state seeds decode."""
    dims = _work_dims(u, Bm)
    with torch_cost.kernel_region("selective_scan", h0=h0 is not None,
                                  **dims):
        if _on_kernel(force, u):
            Bm, Cm = Bm.contiguous(), Cm.contiguous()
            if _grad_wanted(u, dt, A, Bm, Cm, Dp, h0):
                return ScanFunction.apply(u, dt, A, Bm, Cm, Dp, h0, True)
            return selective_scan_cuda(u, dt, A, Bm, Cm, Dp, h0)
        return _plain(u, dt, A, Bm, Cm, Dp, h0, force, dims)


def _plain(u, dt, A, Bm, Cm, Dp, h0, force, dims):
    """The plain forms (the per-step one for S < 64 or forced, else the
    chunked one): (y, final state)."""
    plain = (ref.selective_scan_ref if force == "ref"
             or (force == "auto" and u.shape[1] < 64)
             else ref.selective_scan_chunked)
    return torch_cost.counted_plain(
        lambda u, dt, A, Bm, Cm, Dp, h0: plain(u, dt, A, Bm, Cm, Dp, h0=h0),
        (u, dt, A, Bm, Cm, Dp, h0), "selective_scan_bwd", like=_like,
        saved=_saved, save_steps=SAVE_STEPS, **dims)


def _saved(u, dt, A, Bm, Cm, Dp, h0):
    """Empty states of the shape the training forward saves."""
    B, S, d = u.shape
    return (torch.empty((B, -(-S // SAVE_STEPS), d, A.shape[-1]),
                        dtype=torch.float32, device=u.device),)


def _like(u, dt, A, Bm, Cm, Dp, h0):
    """Empty (y, final state) of the scan's shapes and dtypes."""
    return torch.empty_like(u), torch.empty(
        (u.shape[0], u.shape[2], A.shape[-1]), dtype=torch.float32,
        device=u.device)


def selective_scan(u, dt, A, Bm, Cm, Dp, *, force: str = "auto"):
    """Returns y (B, S, d) in u.dtype, from a zero state: the full-sequence
    forward (training, evaluation).  The kernel writes no final state
    here."""
    dims = _work_dims(u, Bm)
    with torch_cost.kernel_region("selective_scan", h0=False, final=False,
                                  **dims):
        if _on_kernel(force, u):
            Bm, Cm = Bm.contiguous(), Cm.contiguous()
            if _grad_wanted(u, dt, A, Bm, Cm, Dp):
                return ScanFunction.apply(u, dt, A, Bm, Cm, Dp, None, False)
            y, _ = selective_scan_cuda(u, dt, A, Bm, Cm, Dp,
                                       final_state=False)
            return y
        return _plain(u, dt, A, Bm, Cm, Dp, None, force, dims)[0]
