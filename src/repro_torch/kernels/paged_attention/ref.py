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
every device as in the reference.

Quantized pages (int8/fp8 with per-slot scales) come with ROADMAP queue A
item 10; passing scales raises.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30

_QUANT = ("ROADMAP queue A item 10 (prefix sharing + quantized pages): "
          "quantized KV pages (k_scales/v_scales) are not ported yet")


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


def gather_pages(pages, block_table):
    """pages: (NP, bs, ...); block_table: (B, NB) -> (B, NB * bs, ...).

    Row b's logical token t lives at ``pages[block_table[b, t // bs],
    t % bs]``; pages past the row's cursor (free or trash entries) land
    beyond it and are masked by the caller."""
    B, NB = block_table.shape
    g = pages[block_table.long()]                  # (B, NB, bs, ...)
    return g.reshape((B, NB * pages.shape[1]) + tuple(pages.shape[2:]))


def gather_dequant(pages, scales, block_table, dtype):
    """Gather pages through the table into ``dtype``.  Float pages only."""
    if scales is not None:
        raise NotImplementedError(_QUANT)
    return gather_pages(pages, block_table).to(dtype)


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
