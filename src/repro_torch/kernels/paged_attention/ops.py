"""Public paged-attention entry points used by the port's models
(``repro/kernels/paged_attention/ops.py``).

Dispatch is by the tensors' device: CUDA tensors launch the hand-written
Hopper decode kernel (``csrc/paged_attention.cu``) or raise; CPU tensors
take the plain gather-then-masked-attention version (``ref.py``).
``force="kernel"`` or ``force="ref"`` pins a path for tests and the chip
smoke run.

``paged_attention_decode`` writes the new token's K/V into the pool in
place and then attends, on every device: the reference's TPU branch.
Quantized pools (int8/fp8 pages with per-slot-per-head f32 scales,
``k_scales``/``v_scales``) quantize the new K/V per head
(``core.quant.quantize``, ``axis=-1``) and write values and scales through
the same (page, offset); the kernel dequantizes in registers.  The
reference's other backends defer the write (``pending``) and select the new
K/V into the gathered context instead; both give the same attention input,
and the port keeps one discipline.  Chunked prefill is plain gather +
masked attention on every device, as in the reference, which wrote no
kernel for it.

``paged_attention`` enters the ``paged_attention`` region of
``roofline.torch_cost`` on both paths, and ``paged_prefill_attention`` the
``paged_prefill_attention`` one: a counted step reads their work (the
slots attended), not the plain gather's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import ref
from repro_torch.roofline import torch_cost

# Launches of the CUDA kernel in this process (one per call, a single
# device kernel); the chip smoke run resets and reads it to show the decode
# path used it.
KERNEL_LAUNCHES = 0

KERNEL_HEAD_DIMS = (64, 128, 256)
MAX_CLUSTER = 8                   # the portable thread-block cluster size
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
if quant.fp8_dtype() is not None:
    _KV_CODES[quant.fp8_dtype()] = 3
_INDEX_CODES = {torch.int32: 0, torch.int64: 1}
_TARGET_CTAS = 2 * 132            # about two CTAs per H100 SM


def _library() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p: ctypes would cut a bare int
        # to 32 bits.
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    return lib


def _check(q, k_pages, v_pages, block_table, index, k_scales=None,
           v_scales=None):
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
    want = tuple(k_pages.shape[:3]) + (1,)
    if quant.is_quantized(k_pages.dtype) != (k_scales is not None) \
            or (k_scales is None) != (v_scales is None):
        raise ValueError(f"paged_attention: {k_pages.dtype} pages take "
                         f"{'both' if quant.is_quantized(k_pages.dtype) else 'no'}"
                         " scale pages")
    for t in (k_scales, v_scales):
        if t is not None and (tuple(t.shape) != want
                              or t.dtype != torch.float32):
            raise ValueError(f"paged_attention: scales {tuple(t.shape)} "
                             f"{t.dtype}, expected {want} float32")


def split_plan(B: int, KV: int, NB: int) -> int:
    """The cluster size n_split: the CTAs of one (row, kv head), which
    split the row's live pages among them and merge on chip.  Enough CTAs
    for about two per SM (B·KV·n_split >= 2x132), at most 8 (the portable
    cluster size), and cut so that a full table gives every rank at least
    one page (``rank_tokens``); 1 once B·KV alone reaches 2x132.  When
    B·KV·8 < 132 (B = KV = 1) the other SMs idle."""
    n = max(1, min(MAX_CLUSTER, NB, -(-_TARGET_CTAS // (B * KV))))
    return -(-NB // -(-NB // n))


def rank_tokens(cursor: int, NB: int, bs: int, n_split: int):
    """The kernel's split of one row: [(t0, t1) per rank], the tokens each
    CTA of the cluster reads.  The row's ceil(live / bs) live pages (live =
    cursor + 1 slots) go to the ranks in order, ceil(live pages / n_split)
    each, so every range starts on a page boundary, the ranges cover the
    live slots in rank order, trailing ranks of a short row are empty and
    no rank reads past the cursor."""
    live = min(max(cursor + 1, 0), NB * bs)
    pages = -(-live // bs)
    per = -(-pages // n_split)
    out = []
    for r in range(n_split):
        p0 = min(r * per, pages)
        p1 = min(p0 + per, pages)
        out.append((p0 * bs, min(p1 * bs, live)))
    return out


def paged_attention_cuda(q, k_pages, v_pages, block_table, index, *,
                         k_scales=None, v_scales=None,
                         logit_softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Raises on what the
    kernel does not take: non-CUDA or mixed devices, q other than
    float32/bfloat16, pages other than float32/bfloat16/int8/fp8 (the
    1-byte pages with float32 scale pages (NP, bs, KV, 1), the float pages
    without), head dims other than 64/128, tables of NB pages with
    NB·bs·bs >= 2^32, non-contiguous or misaligned inputs, or a refused
    launch (the C function's ``cudaError_t``: among others, G = H/KV query
    heads per kv head and a table whose shared memory passes what a block
    can use, which ``cudaFuncSetAttribute`` refuses).  One call is one
    device kernel: no workspace, and no cast of an int32 table or of an
    int32 or int64 cursor (the engine's int64 cursor is read as it is;
    another integer dtype is cast)."""
    global KERNEL_LAUNCHES
    _check(q, k_pages, v_pages, block_table, index, k_scales, v_scales)
    B, _, H, hd = q.shape
    NP, bs, KV, _ = k_pages.shape
    NB = block_table.shape[1]
    table = block_table.to(torch.int32).contiguous()
    cursor = (index if index.dtype in _INDEX_CODES
              else index.to(torch.int32)).contiguous()
    scales = [("k_scales", k_scales), ("v_scales", v_scales)] \
        if k_scales is not None else []
    for name, t in [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", table), ("index", cursor)] + scales:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention kernel: {name} must lie on "
                             f"q's CUDA device, got {t.device}")
        # Pages are copied 16 bytes at a time; the rest is read by element.
        align = 16 if name.endswith("pages") else t.element_size()
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"paged_attention kernel: {name} must be "
                             f"contiguous and {align}-byte aligned")
    if q.dtype not in _Q_CODES or k_pages.dtype not in _KV_CODES:
        raise ValueError(f"paged_attention kernel: dtypes q {q.dtype}, pages "
                         f"{k_pages.dtype} (q float32/bfloat16; pages "
                         "float32/bfloat16/int8/float8_e4m3fn)")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError("paged_attention kernel: k and v pages differ in "
                         "dtype")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head dim {hd} "
                         f"(built for {KERNEL_HEAD_DIMS})")
    if NB * bs * bs >= 2 ** 32:
        raise ValueError(f"paged_attention kernel: {NB} pages of {bs} slots "
                         "(NB·bs·bs must stay below 2^32)")
    n_split = split_plan(B, KV, NB)
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            None if k_scales is None else k_scales.data_ptr(),
            None if v_scales is None else v_scales.data_ptr(),
            table.data_ptr(), cursor.data_ptr(), out.data_ptr(), B, H, KV,
            hd, bs, NB, n_split, _Q_CODES[q.dtype], _KV_CODES[k_pages.dtype],
            _INDEX_CODES[cursor.dtype], float(logit_softcap), stream, None)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{err} (B={B} H={H} KV={KV} hd={hd} bs={bs} "
                           f"NB={NB} NP={NP} n_split={n_split} "
                           f"{q.dtype}/{k_pages.dtype})")
    KERNEL_LAUNCHES += 1
    return out


def paged_attention(q, k_pages, v_pages, block_table, index, *,
                    k_scales=None, v_scales=None,
                    logit_softcap: float = 0.0, force: str = "auto"):
    """q: (B,1,H,hd); pages (NP,bs,KV,hd); block_table (B,NB); index (B,)
    -> (B,1,H,hd): slots ``s <= index[b]`` of row b are attended.  int8/fp8
    pages come with their f32 scale pages ``k_scales``/``v_scales``
    (NP,bs,KV,1)."""
    if force not in ("auto", "kernel", "ref"):
        raise ValueError(f"force={force!r} (auto|kernel|ref)")
    with torch_cost.kernel_region(
            "paged_attention", **_work_dims(q, k_pages, block_table,
                                            index)):
        if force == "kernel" or (force == "auto" and q.is_cuda):
            return paged_attention_cuda(
                q, k_pages, v_pages, block_table, index, k_scales=k_scales,
                v_scales=v_scales, logit_softcap=logit_softcap)
        _check(q, k_pages, v_pages, block_table, index, k_scales, v_scales)
        return ref.paged_attention_ref(
            q, k_pages, v_pages, block_table, index, k_scales=k_scales,
            v_scales=v_scales, logit_softcap=logit_softcap)


def _work_dims(q, k_pages, block_table, index) -> dict:
    """The kernel's work dims (``torch_cost.paged_attention``): the slots
    the rows attend (each row's cursor + 1, at most its table's), read
    from the cursors only under an active counter."""
    B, _, H, hd = q.shape
    _, bs, KV, _ = k_pages.shape
    cap = block_table.shape[1] * bs

    def lens():
        return (index.long() + 1).clamp(0, cap).tolist()
    return dict(B=B, H=H, KV=KV, hd=hd, live=lambda: sum(lens()),
                pages=lambda: sum(-(-c // bs) for c in lens()),
                q_itemsize=q.element_size(),
                page_itemsize=k_pages.element_size(),
                quantized=quant.is_quantized(k_pages.dtype))


def paged_attention_decode(q, k_pages, v_pages, k_new, v_new, page, off,
                           block_table, index, *, k_scales=None,
                           v_scales=None, logit_softcap: float = 0.0,
                           force: str = "auto"):
    """Write + attend for one decode step over the paged pool.

    q: (B,1,H,hd); k_new/v_new: (B,KV,hd), the new token's K/V; page/off:
    (B,) physical write coordinates (masked rows already redirected to the
    trash page).  With ``k_scales``/``v_scales`` ((NP,bs,KV,1) f32: int8 or
    fp8 pages) the new K/V is quantized per head and its scales land at the
    same coordinates.  The writes land in the pool in place (the reference
    returns an updated pool); returns ``(out, cache)`` with the same pool
    tensors, the scale pages included when given."""
    cache = {"k_pages": k_pages, "v_pages": v_pages}
    if k_scales is not None:
        k_w, k_s = quant.quantize(k_new, axis=-1, dtype=k_pages.dtype)
        v_w, v_s = quant.quantize(v_new, axis=-1, dtype=v_pages.dtype)
        k_scales[page, off] = k_s
        v_scales[page, off] = v_s
        cache.update(k_scales=k_scales, v_scales=v_scales)
    else:
        k_w, v_w = k_new.to(k_pages.dtype), v_new.to(v_pages.dtype)
    k_pages[page, off] = k_w
    v_pages[page, off] = v_w
    out = paged_attention(q, k_pages, v_pages, block_table, index,
                          k_scales=k_scales, v_scales=v_scales,
                          logit_softcap=logit_softcap, force=force)
    return out, cache


def paged_prefill_attention(q, k_pages, v_pages, block_table, ctx_len, *,
                            k_scales=None, v_scales=None,
                            logit_softcap: float = 0.0):
    """Chunked prefill: C queries at positions ctx_len..ctx_len+C-1 over the
    row's pages (which already hold the chunk's own K/V, quantized with
    their scales by the caller when ``k_scales``/``v_scales`` are given).
    Plain gather + masked attention on every device."""
    B, C, H, hd = q.shape
    with torch_cost.kernel_region(
            "paged_prefill_attention", B=B, C=C,
            ctx_total=lambda: int(torch.as_tensor(ctx_len).expand(B).sum()),
            H=H, KV=k_pages.shape[2], hd=hd, itemsize=q.element_size()):
        return ref.paged_prefill_attention_ref(
            q, k_pages, v_pages, block_table, ctx_len, k_scales=k_scales,
            v_scales=v_scales, logit_softcap=logit_softcap)

