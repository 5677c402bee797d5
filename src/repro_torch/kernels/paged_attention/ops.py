"""Public paged-attention entry points used by the port's models
(``repro/kernels/paged_attention/ops.py``).

Dispatch is by the tensors' device: CUDA tensors launch the hand-written
Hopper decode kernel (``csrc/paged_attention.cu``) or raise; CPU tensors
take the plain gather-then-masked-attention version (``ref.py``).
``force="kernel"`` or ``force="ref"`` pins a path for tests and the chip
smoke run.

``paged_attention_decode`` writes the new token's K/V into the pool in
place and then attends, on every device: the reference's TPU branch.  The
reference's other backends defer the write (``pending``) and select the new
K/V into the gathered context instead; both give the same attention input,
and the port keeps one discipline.  Chunked prefill is plain gather +
masked attention on every device, as in the reference, which wrote no
kernel for it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import ref

# Launches of the CUDA kernel in this process (one per call: both passes);
# the chip smoke run resets and reads it to show the decode path used it.
KERNEL_LAUNCHES = 0

KERNEL_HEAD_DIMS = (64, 128)
MAX_GROUP = 8                     # query heads per kv head (MAXG in the .cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TARGET_CTAS = 2 * 132            # two CTAs per H100 SM for pass 1


def _library() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p: ctypes would cut a bare int
        # to 32 bits.
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _check(q, k_pages, v_pages, block_table, index):
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_attention: q must be (B, 1, H, hd), got "
                         f"{tuple(q.shape)}")
    B, _, H, hd = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[3] != hd:
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % k_pages.shape[2]:
        raise ValueError(f"paged_attention: {H} query heads not a multiple "
                         f"of {k_pages.shape[2]} kv heads")
    if block_table.ndim != 2 or block_table.shape[0] != B:
        raise ValueError(f"paged_attention: block table "
                         f"{tuple(block_table.shape)} for batch {B}")
    if index.ndim != 1 or index.shape[0] != B:
        raise ValueError(f"paged_attention: cursor {tuple(index.shape)} for "
                         f"batch {B}")


def split_plan(B: int, KV: int, NB: int, bs: int):
    """(n_split, tokens per split) of pass 1: enough CTAs for the card
    (B·KV·n_split >= ~2x132) with at least one page per split, and splits
    that start on page boundaries."""
    n_split = max(1, min(NB, -(-_TARGET_CTAS // (B * KV))))
    pages = -(-NB // n_split)
    return -(-NB // pages), pages * bs


def paged_attention_cuda(q, k_pages, v_pages, block_table, index, *,
                         logit_softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Raises on what the
    kernel does not take: non-CUDA or mixed devices, dtypes other than
    float32/bfloat16, head dims other than 64/128, more than 8 query heads
    per kv head, non-contiguous or misaligned inputs, or a refused launch.
    The table and cursor are cast to int32 here if they are not already."""
    global KERNEL_LAUNCHES
    _check(q, k_pages, v_pages, block_table, index)
    B, _, H, hd = q.shape
    NP, bs, KV, _ = k_pages.shape
    NB = block_table.shape[1]
    table = block_table.to(torch.int32).contiguous()
    cursor = index.to(torch.int32).contiguous()
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", table), ("index", cursor)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention kernel: {name} must lie on "
                             f"q's CUDA device, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_attention kernel: {name} must be "
                             "contiguous and 16-byte aligned")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged_attention kernel: dtypes q {q.dtype}, pages "
                         f"{k_pages.dtype} (float32 and bfloat16 only)")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError("paged_attention kernel: k and v pages differ in "
                         "dtype")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head dim {hd} "
                         f"(built for {KERNEL_HEAD_DIMS})")
    if H // KV > MAX_GROUP:
        raise ValueError(f"paged_attention kernel: {H // KV} query heads per "
                         f"kv head (at most {MAX_GROUP})")
    n_split, tok_per_split = split_plan(B, KV, NB, bs)
    lib = _library()
    out = torch.empty_like(q)
    ws = torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), cursor.data_ptr(), out.data_ptr(),
            ws.data_ptr(), B, H, KV, hd, bs, NB, n_split, tok_per_split,
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
            float(logit_softcap), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{err} (B={B} H={H} KV={KV} hd={hd} bs={bs} "
                           f"NB={NB} NP={NP} {q.dtype}/{k_pages.dtype})")
    KERNEL_LAUNCHES += 1
    return out


def paged_attention(q, k_pages, v_pages, block_table, index, *,
                    k_scales=None, v_scales=None,
                    logit_softcap: float = 0.0, force: str = "auto"):
    """q: (B,1,H,hd); pages (NP,bs,KV,hd); block_table (B,NB); index (B,)
    -> (B,1,H,hd): slots ``s <= index[b]`` of row b are attended."""
    if force not in ("auto", "kernel", "ref"):
        raise ValueError(f"force={force!r} (auto|kernel|ref)")
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(ref._QUANT)
    if force == "kernel" or (force == "auto" and q.is_cuda):
        return paged_attention_cuda(q, k_pages, v_pages, block_table, index,
                                    logit_softcap=logit_softcap)
    return ref.paged_attention_ref(q, k_pages, v_pages, block_table, index,
                                   logit_softcap=logit_softcap)


def paged_attention_decode(q, k_pages, v_pages, k_new, v_new, page, off,
                           block_table, index, *, k_scales=None,
                           v_scales=None, logit_softcap: float = 0.0,
                           force: str = "auto"):
    """Write + attend for one decode step over the paged pool.

    q: (B,1,H,hd); k_new/v_new: (B,KV,hd), the new token's K/V; page/off:
    (B,) physical write coordinates (masked rows already redirected to the
    trash page).  The write lands in ``k_pages``/``v_pages`` in place (the
    reference returns an updated pool); returns ``(out, {"k_pages",
    "v_pages"})`` with the same pool tensors."""
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(ref._QUANT)
    k_pages[page, off] = k_new.to(k_pages.dtype)
    v_pages[page, off] = v_new.to(v_pages.dtype)
    out = paged_attention(q, k_pages, v_pages, block_table, index,
                          logit_softcap=logit_softcap, force=force)
    return out, {"k_pages": k_pages, "v_pages": v_pages}


def paged_prefill_attention(q, k_pages, v_pages, block_table, ctx_len, *,
                            k_scales=None, v_scales=None,
                            logit_softcap: float = 0.0):
    """Chunked prefill: C queries at positions ctx_len..ctx_len+C-1 over the
    row's pages (which already hold the chunk's own K/V).  Plain gather +
    masked attention on every device."""
    return ref.paged_prefill_attention_ref(
        q, k_pages, v_pages, block_table, ctx_len, k_scales=k_scales,
        v_scales=v_scales, logit_softcap=logit_softcap)

