"""Plain PyTorch paged-attention math (``repro/kernels/paged_attention/
ref.py``).

The serving cache is a pool of fixed-size token pages plus a per-row block
table (``repro_torch.train.kv_pool``); attention reads through the table
instead of a contiguous per-row KV buffer.

``masked_gqa_attention`` is the grouped-query masked-attention math shared
by the contiguous decode (``models.attention.attn_decode``) and both paged
paths below, so paged-vs-contiguous greedy parity holds by construction:
the two layouts differ only in where the keys come from.
``paged_attention_ref`` gathers each row's pages into its logical
contiguous layout and runs that math; it is the plain version the CUDA
decode kernel (``ops.paged_attention``) is held against.
``paged_prefill_attention_ref`` is the chunked prefill's attention, plain on
every device as in the reference, and ``paged_mla_attention_ref`` the
read of an MLA layer's latent pool (up-projected in the gather), plain on
every device too: the reference wrote no kernel for it.

Quantized pool storage (``kv_dtype`` int8/fp8): pages hold quantized values
plus per-slot-per-head float32 scale pages (``repro_torch.core.quant``,
trailing keepdim so the scales ride the same block-table gathers as their
pages).  Every path here takes optional ``*_scales`` and dequantizes in the
gather: the float context is ``q.float() * scale``, the plain version the
kernel's quantized branch is held against.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _softcap(x, cap: float):
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def masked_gqa_attention(q, k, v, valid, logit_softcap: float = 0.0):
    """Grouped-query attention with an explicit validity mask.

    q: (B, C, H, hd); k, v: (B, S, KV, hd); valid: (B, C, S) bool.
    Returns (B, C, H, hd): scores in the compute dtype, softmax in float32.
    """
    B, C, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, C, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k) / math.sqrt(hd)
    scores = _softcap(scores, logit_softcap)
    scores = torch.where(valid[:, None, None, :, :], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, C, H, hd)


def masked_gqa_attention_per_query(q, k, v, valid,
                                   logit_softcap: float = 0.0):
    """Grouped-query attention where every query has its own key set.

    q: (B, C, H, hd); k, v: (B, C, S, KV, hd), key s of query c being that
    query's s-th context entry; valid: (B, C, S) bool.  Returns
    (B, C, H, hd).  The math of ``masked_gqa_attention``, the key axis
    reduced in the same (slot) order: the speculative verify gathers, for
    each query, the ring state a sequential sliding-window decode at its
    position attends to, laid out in ring-slot order."""
    B, C, H, hd = q.shape
    KV = k.shape[3]
    G = H // KV
    qg = q.reshape(B, C, KV, G, hd)
    scores = torch.einsum("bqkgh,bqskh->bkgqs", qg, k) / math.sqrt(hd)
    scores = _softcap(scores, logit_softcap)
    scores = torch.where(valid[:, None, None, :, :], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bqskh->bqkgh", probs, v)
    return out.reshape(B, C, H, hd)


def gather_pages(pages, block_table):
    """pages: (NP, bs, ...); block_table: (B, NB) -> (B, NB * bs, ...).

    Row b's logical token t lives at ``pages[block_table[b, t // bs],
    t % bs]``; pages past the row's cursor (free or trash entries) land
    beyond it and are masked by the caller."""
    B, NB = block_table.shape
    g = pages[block_table.long()]                  # (B, NB, bs, ...)
    return g.reshape((B, NB * pages.shape[1]) + tuple(pages.shape[2:]))


def gather_dequant(pages, scales, block_table, dtype):
    """Gather pages through the table into ``dtype``; with ``scales``
    (quantized storage) dequantize in the gather: the (B, S, ...) context
    is ``pages.float() * scales``, the scale pages gathered through the
    same table, so a shared (radix) page dequantizes alike in every row."""
    g = gather_pages(pages, block_table)
    if scales is None:
        return g.to(dtype)
    s = gather_pages(scales, block_table)
    return (g.float() * s).to(dtype)


def _cursor(index, B: int, device):
    idx = torch.as_tensor(index, device=device)
    return idx.expand(B) if idx.ndim == 0 else idx


def paged_attention_ref(q, k_pages, v_pages, block_table, index, *,
                        k_scales=None, v_scales=None,
                        logit_softcap: float = 0.0):
    """Decode through the block table.

    q: (B, 1, H, hd); k_pages/v_pages: (NP, bs, KV, hd); block_table:
    (B, NB); index: (B,) — slot s of row b is valid iff ``s <= index[b]``
    (the new token's K/V is already written at slot ``index[b]``).
    Returns (B, 1, H, hd) in q's dtype."""
    k = gather_dequant(k_pages, k_scales, block_table, q.dtype)
    v = gather_dequant(v_pages, v_scales, block_table, q.dtype)
    S = k.shape[1]
    idx = _cursor(index, q.shape[0], q.device)
    valid = (torch.arange(S, device=q.device)[None, :]
             <= idx[:, None])[:, None, :]                       # (B, 1, S)
    return masked_gqa_attention(q, k, v, valid, logit_softcap)


def paged_prefill_attention_ref(q, k_pages, v_pages, block_table, ctx_len, *,
                                k_scales=None, v_scales=None,
                                logit_softcap: float = 0.0):
    """Chunked-prefill attention through the block table.

    q: (B, C, H, hd), the chunk's queries at absolute positions
    ``ctx_len + arange(C)``; the pages already hold the chunk's own K/V.
    ``ctx_len`` is a scalar or a per-row (B,) vector.  Query t sees slots
    ``s <= t``: the prefilled context plus the in-chunk causal triangle.
    Returns (B, C, H, hd)."""
    B, C = q.shape[0], q.shape[1]
    k = gather_dequant(k_pages, k_scales, block_table, q.dtype)
    v = gather_dequant(v_pages, v_scales, block_table, q.dtype)
    S = k.shape[1]
    ctx = _cursor(ctx_len, B, q.device)
    qpos = ctx[:, None] + torch.arange(C, device=q.device)[None, :]  # (B, C)
    valid = (torch.arange(S, device=q.device)[None, None, :]
             <= qpos[:, :, None])                                    # (B,C,S)
    return masked_gqa_attention(q, k, v, valid, logit_softcap)


def paged_mla_attention_ref(q, latent_pages, block_table, valid, wkv_b,
                            num_kv_heads: int, *, rotate_fn=None,
                            latent_new=None, index=None, latent_scales=None,
                            logit_softcap: float = 0.0):
    """MLA attention through the block table: the pages hold compressed
    pre-RoPE latent rows (NP, bs, r), up-projected to K/V in the gather.

    q: (B, C, H, hd); valid: (B, C, S) with S = NB * bs; wkv_b:
    (r, 2 KV hd).  The gathered latents are dequantized with
    ``latent_scales`` (int8/fp8 pages); ``latent_new`` (B, r) with
    ``index`` (B,) selects a new token's latent into slot ``index[b]``
    before the up-projection (the reference's deferred pool write; pass the
    quantize-dequantize round trip for quantized pages).  ``rotate_fn``
    rotates the re-derived keys (B, S, KV, hd) at their absolute slot
    positions 0..S-1: the pages hold pre-RoPE latents.  Returns
    (B, C, H, hd)."""
    lat = gather_dequant(latent_pages, latent_scales, block_table, q.dtype)
    B, S = lat.shape[0], lat.shape[1]
    if latent_new is not None:
        at_new = (torch.arange(S, device=q.device)[None, :]
                  == _cursor(index, B, q.device)[:, None])[..., None]
        lat = torch.where(at_new, latent_new.to(q.dtype)[:, None], lat)
    k, v = mla_kv(lat, wkv_b, num_kv_heads, rotate_fn)
    return masked_gqa_attention(q, k, v, valid, logit_softcap)


def mla_kv(lat, wkv_b, num_kv_heads: int, rotate_fn=None):
    """K and V (B, S, KV, hd) of an MLA layer, up-projected from latents
    (B, S, r) through ``wkv_b`` (r, 2 KV hd); ``rotate_fn``, when given,
    rotates the keys."""
    B, S = lat.shape[0], lat.shape[1]
    k, v = (lat @ wkv_b).chunk(2, dim=-1)                 # (B, S, KV hd)
    hd = k.shape[-1] // num_kv_heads
    k = k.reshape(B, S, num_kv_heads, hd)
    v = v.reshape(B, S, num_kv_heads, hd)
    return (k if rotate_fn is None else rotate_fn(k)), v
