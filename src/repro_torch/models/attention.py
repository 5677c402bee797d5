"""Attention layers and the contiguous KV cache (``repro/models/
attention.py``, the MHA/GQA branches with global and sliding-window
attention and the logit softcap).

Full-sequence attention routes through ``kernels.flash_attention.ops``
(the Hopper kernel for CUDA tensors, the plain version on the CPU).  Decode
against the contiguous cache attends one new token with the plain masked
GQA math shared with the paged path.  The paged pool (``init_paged_kv_cache``)
is read by ``attn_decode_paged`` through ``kernels.paged_attention.ops``
(the Hopper decode kernel on the card) and written by ``attn_prefill_chunk``
one prefill chunk at a time, and by ``attn_verify_chunk`` one speculation
round at a time (γ+1 positions a row, read back with the plain gather).  An
int8/fp8 pool quantizes every write per slot and head (``core.quant``) and
keeps the f32 scales in scale pages beside the pages.

Sliding-window layers (``window > 0``, gemma2/gemma3's local layers) keep
a per-row ring of ``min(max_len, window)`` slots instead: position t lives
at slot ``t % W``.  Prefill fills it as a token-by-token decode would leave
it (``_fill_cache``), decode writes at ``index % W`` and attends to the
ring's filled slots, a prefill chunk unrolls the ring into logical order
beside the chunk's keys and advances it, and the speculative verify scores
each query against the exact ring a sequential decode would hold, with the
ring advance deferred to ``spec_ring_commit``.  Rings are never paged:
they are O(window) per row already.

The reference returns new caches from pure functions and donates the old
buffers; here the preallocated cache is written in place (slice and index
assignment) and the same dict is returned, so callers keep one buffer.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.models.common import (apply_norm, apply_rope, dense_init,
                                       norm_init)

_MLA = ("ROADMAP queue A item 12 (remaining architectures): MLA latent "
        "attention is not ported yet")
_MROPE = ("ROADMAP queue A item 12 (remaining architectures): M-RoPE "
          "(qwen2-vl) is not ported yet")


def _is_mla(cfg: ModelConfig) -> bool:
    return cfg.attention == "mla" and bool(cfg.mla_kv_lora_rank)


def attn_init(generator, cfg: ModelConfig, dtype=torch.float32, device="cuda"):
    if _is_mla(cfg):
        raise NotImplementedError(_MLA)
    D, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {"wq": dense_init(generator, D, Q, dtype, device=device),
         "wk": dense_init(generator, D, KV, dtype, device=device),
         "wv": dense_init(generator, D, KV, dtype, device=device),
         "wo": dense_init(generator, Q, D, dtype, device=device)}
    if cfg.qk_norm:
        p["q_norm"] = norm_init(cfg.head_dim, "rmsnorm", device)
        p["k_norm"] = norm_init(cfg.head_dim, "rmsnorm", device)
    return p


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, window: int = 0, device="cuda"):
    """Per-layer KV cache: zeros of (batch, S, KV, hd) for k and v, with
    S = max_len, or for a sliding-window layer (``window > 0``) the ring
    S = min(max_len, window)."""
    if _is_mla(cfg):
        raise NotImplementedError(_MLA)
    S = min(max_len, window) if window > 0 else max_len
    shape = (batch, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                        dtype=torch.bfloat16, device="cuda"):
    """Per-layer paged KV pool: ``num_blocks`` pages of ``block_size``
    tokens plus one trailing *trash* page (id ``num_blocks``) that free
    rows' block tables point at.  Rows address it through a
    ``(B, max_blocks)`` block table (``repro_torch.train.kv_pool``).

    Quantized storage (``dtype`` int8/fp8): pages hold quantized values
    and the dict gains float32 scale leaves with the same leading (page,
    slot) dims plus a trailing keepdim, one scale per slot per kv head.
    Keyed by physical page, the scales go wherever their page goes: trash
    redirection, the copy-on-write clone, radix prefix sharing."""
    if _is_mla(cfg):
        raise NotImplementedError(_MLA)
    shape = (num_blocks + 1, block_size, cfg.num_kv_heads, cfg.head_dim)
    c = {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
         "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    if quant.is_quantized(dtype):
        c["k_scales"] = torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                    device=device)
        c["v_scales"] = torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                    device=device)
    return c


def _split_heads(x, n: int, hd: int):
    return x.reshape(x.shape[:-1] + (n, hd))


def _project_qkv(p, cfg: ModelConfig, x):
    """Returns q, k, v of shapes (B,S,H,hd) / (B,S,KV,hd)."""
    if _is_mla(cfg):
        raise NotImplementedError(_MLA)
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], H, hd)
    k = _split_heads(x @ p["wk"], KVH, hd)
    v = _split_heads(x @ p["wv"], KVH, hd)
    return q, k, v


def _qk_norm(p, cfg: ModelConfig, q, k):
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm")
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    return q, k


def _position_encode(cfg: ModelConfig, q, k, positions, span: int = 0):
    """RoPE at ``positions`` (B, S), the rotation table covering
    ``max_seq_len``, the positions of a longer training sequence and
    ``span``, the positions a cache holds (its slots, or its block
    table's); a speculative round's positions past the cache clamp.  The
    caches store the rotated keys, as the reference's do."""
    if cfg.position == "mrope":
        raise NotImplementedError(_MROPE)
    if cfg.position == "rope":
        n = max(cfg.max_seq_len, positions.shape[-1], span)
        q = apply_rope(q, positions, cfg.rope_theta, n)
        k = apply_rope(k, positions, cfg.rope_theta, n)
    # 'absolute' is added at the embedding layer; 'none' is a no-op.
    return q, k


def attn_apply(p, cfg: ModelConfig, x: torch.Tensor, positions, window: int,
               causal: bool = True, cache=None):
    """x: (B, S, D) -> (B, S, D).

    With ``cache`` (serve prefill) the decode cache is filled alongside the
    forward with the same keys and values ``attn_decode`` would have
    written token by token, and the return becomes ``(out, cache)``."""
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _qk_norm(p, cfg, q, k)
    q, k = _position_encode(cfg, q, k, positions,
                            0 if cache is None else cache["k"].shape[1])
    if cache is not None:
        _fill_cache(cache["k"], k)
        _fill_cache(cache["v"], v)
    # The kernel takes contiguous (B,S,heads,hd) tensors; the projections'
    # reshapes are views of contiguous matmul outputs, so this copies nothing.
    out = fa_ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window, logit_softcap=cfg.attn_logit_softcap)
    out = out.reshape(out.shape[:2] + (cfg.q_dim,))
    out = out @ p["wo"]
    return (out, cache) if cache is not None else out


def _fill_cache(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Write a prefill sequence ``new`` (B, S, ...) at absolute positions
    0..S-1 into the preallocated cache ``buf`` (B, Sc, ...), in place.  For
    S <= Sc that is slots 0..S-1; for a ring (sliding window, Sc < S) each
    slot s keeps the last token t with t ≡ s (mod Sc), gathered: the state
    a token-by-token decode of the same prompt leaves."""
    S, Sc = new.shape[1], buf.shape[1]
    if S <= Sc:
        buf[:, :S] = new.to(buf.dtype)
        return buf
    slots = torch.arange(Sc, device=new.device)
    last = S - 1 - ((S - 1 - slots) % Sc)
    buf.copy_(new[:, last].to(buf.dtype))
    return buf


def attn_prefill(p, cfg: ModelConfig, x: torch.Tensor, cache, positions,
                 window: int):
    """Prefill = ``attn_apply`` with the cache filled; see there."""
    return attn_apply(p, cfg, x, positions, window, cache=cache)


def attn_decode(p, cfg: ModelConfig, x: torch.Tensor, cache,
                cache_index: torch.Tensor, positions,
                window: int, write_mask=None) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, D); cache per ``init_kv_cache``; cache_index: (B,) — the
    number of tokens already in each row's cache.  Each row writes its new
    K/V at its own slot (before attending) and attends to slots <= its
    cursor over the whole cache; a sliding-window layer (``window > 0``)
    writes its ring at ``index % W`` and attends to the ring's filled
    slots, ``slot <= min(index, W - 1)``.  Rows with ``write_mask ==
    False`` (inactive continuous-batching slots) write back what their
    slot held, so their cache row stays byte-identical: the reference's
    per-row freeze select.  A cursor at or past a full cache's end (a
    speculative draft proposing past a row's limit) writes nothing, as the
    reference's scatter drops it; that row's output is never used.
    Returns (out (B,1,D), cache)."""
    B = x.shape[0]
    cache_index = torch.as_tensor(cache_index, device=x.device).long()
    cache_index = cache_index.expand(B) if cache_index.ndim == 0 \
        else cache_index
    bidx = torch.arange(B, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x)
    q, k_new = _qk_norm(p, cfg, q, k_new)
    q, k_new = _position_encode(cfg, q, k_new, positions,
                                cache["k"].shape[1])

    k_buf, v_buf = cache["k"], cache["v"]
    S = k_buf.shape[1]
    if window > 0:                       # ring: every cursor has its slot
        slot = cache_index % S
        keep = torch.ones_like(cache_index, dtype=torch.bool)
    else:
        # Clamp the slot and write its old value back where the write
        # drops: no index past the end reaches torch, and no check syncs
        # the card.
        keep = cache_index < S
        slot = cache_index.clamp(max=S - 1)
    if write_mask is not None:
        keep = keep & write_mask
    keep = keep[:, None, None]
    k_w = torch.where(keep, k_new[:, 0].to(k_buf.dtype), k_buf[bidx, slot])
    v_w = torch.where(keep, v_new[:, 0].to(v_buf.dtype), v_buf[bidx, slot])
    k_buf[bidx, slot] = k_w
    v_buf[bidx, slot] = v_w
    k = k_buf.to(x.dtype)
    v = v_buf.to(x.dtype)

    filled = cache_index.clamp(max=S - 1) if window > 0 else cache_index
    valid = torch.arange(S, device=x.device)[None, :] <= filled[:, None]
    out = paged_ref.masked_gqa_attention(q, k, v, valid[:, None, :],
                                         cfg.attn_logit_softcap)
    out = out.reshape(B, 1, cfg.q_dim) @ p["wo"]
    return out, cache


def attn_decode_paged(p, cfg: ModelConfig, x: torch.Tensor, cache,
                      block_table, cache_index, positions,
                      write_mask=None) -> Tuple[torch.Tensor, dict]:
    """Single-token decode against the paged pool (full-attention layers).

    x: (B, 1, D); cache: ``init_paged_kv_cache`` pool (shared, not per
    row); block_table: (B, NB) int32; cache_index: (B,) cursor.  Each row
    writes its new K/V at page ``table[b, idx // bs]``, offset
    ``idx % bs``; rows with ``write_mask == False`` (inactive slots) are
    redirected to the trash page, so a frozen slot's pages never change.
    The write lands in place before attention reads through the table
    (the Hopper kernel on the card).  Returns (out (B,1,D), cache)."""
    if _is_mla(cfg):
        raise NotImplementedError(_MLA)
    B = x.shape[0]
    bidx = torch.arange(B, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x)
    q, k_new = _qk_norm(p, cfg, q, k_new)
    bs = cache["k_pages"].shape[1]
    q, k_new = _position_encode(cfg, q, k_new, positions,
                                block_table.shape[1] * bs)
    trash = cache["k_pages"].shape[0] - 1
    page = block_table[bidx, cache_index // bs]
    if write_mask is not None:
        page = torch.where(write_mask, page, trash)
    off = cache_index % bs
    out, cache = pa_ops.paged_attention_decode(
        q.contiguous(), cache["k_pages"], cache["v_pages"], k_new[:, 0],
        v_new[:, 0], page, off, block_table, cache_index,
        k_scales=cache.get("k_scales"), v_scales=cache.get("v_scales"),
        logit_softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, 1, cfg.q_dim) @ p["wo"]
    return out, cache


def attn_prefill_chunk(p, cfg: ModelConfig, x: torch.Tensor, cache, ctx_len,
                       positions, window: int,
                       block_table=None) -> Tuple[torch.Tensor, dict]:
    """One prefill chunk: x (B, C, D) at absolute positions
    ``ctx_len .. ctx_len + C - 1``.

    Global layers (``window == 0``): the chunk's K/V is written into the
    paged pool through ``block_table`` (in place), then the chunk attends
    through the table: context + in-chunk causal triangle in one
    ``slot <= q_pos`` rule.  A quantized pool takes the chunk's K/V
    quantized per slot and head, values and scales through the same
    (page, offset).  Sliding-window layers keep their per-row ring
    (``cache`` is the B=1 carry's ring): see ``_ring_prefill_chunk``."""
    if _is_mla(cfg):
        raise NotImplementedError(_MLA)
    B, C, _ = x.shape
    q, k_new, v_new = _project_qkv(p, cfg, x)
    q, k_new = _qk_norm(p, cfg, q, k_new)
    if window > 0:
        q, k_new = _position_encode(cfg, q, k_new, positions)
        out = _ring_prefill_chunk(cfg, q, k_new, v_new, cache, ctx_len)
        return out.reshape(B, C, cfg.q_dim) @ p["wo"], cache
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    bs = k_pages.shape[1]
    q, k_new = _position_encode(cfg, q, k_new, positions,
                                block_table.shape[1] * bs)
    pos = ctx_len + torch.arange(C, device=x.device)       # (C,) slots
    page = block_table[:, pos // bs]                       # (B, C)
    off = (pos % bs)[None, :].expand(B, C)
    ks, vs = cache.get("k_scales"), cache.get("v_scales")
    if ks is not None:                               # quantized pool
        k_w, k_s = quant.quantize(k_new, axis=-1, dtype=k_pages.dtype)
        v_w, v_s = quant.quantize(v_new, axis=-1, dtype=v_pages.dtype)
        ks[page, off] = k_s
        vs[page, off] = v_s
    else:
        k_w, v_w = k_new.to(k_pages.dtype), v_new.to(v_pages.dtype)
    k_pages[page, off] = k_w
    v_pages[page, off] = v_w
    out = pa_ops.paged_prefill_attention(
        q, k_pages, v_pages, block_table, ctx_len, k_scales=ks, v_scales=vs,
        logit_softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, C, cfg.q_dim) @ p["wo"]
    return out, cache


def _ring_prefill_chunk(cfg: ModelConfig, q, k_new, v_new, cache,
                        ctx_len: int):
    """A chunk (queries q (B, C, H, hd) at ``ctx_len + arange(C)``) against
    a ring cache (B, W, KV, hd).  The ring is unrolled into its logical
    order (entry j holds position ctx_len - W + j, at slot (ctx_len + j) %
    W) beside the chunk's keys, attention is masked to
    ``0 <= q_pos - k_pos < W``, and the ring then advances as a token-by-
    token decode would leave it: slot s keeps the last chunk token i with
    (ctx_len + i) % W == s.  Returns the attention (B, C, H, hd)."""
    B, C = q.shape[0], q.shape[1]
    W = cache["k"].shape[1]
    dev = q.device
    j = torch.arange(W, device=dev)
    slots = (ctx_len + j) % W
    ctx_abs = ctx_len - W + j
    keys = torch.cat([cache["k"][:, slots].to(q.dtype), k_new], dim=1)
    vals = torch.cat([cache["v"][:, slots].to(q.dtype), v_new], dim=1)
    k_abs = torch.cat([ctx_abs, ctx_len + torch.arange(C, device=dev)])
    q_pos = ctx_len + torch.arange(C, device=dev)
    d = q_pos[:, None] - k_abs[None, :]                    # (C, W + C)
    valid = (d >= 0) & (d < W) & (k_abs >= 0)[None, :]
    out = paged_ref.masked_gqa_attention(
        q, keys, vals, valid[None].expand(B, C, W + C),
        cfg.attn_logit_softcap)
    r = (j - ctx_len) % W
    i_last = r + W * torch.div(C - 1 - r, W, rounding_mode="floor")
    written = r < C
    i_safe = torch.where(written, i_last, torch.zeros_like(i_last))
    sel = written[None, :, None, None]
    for key, new in (("k", k_new), ("v", v_new)):
        ring = cache[key]
        ring.copy_(torch.where(sel, new[:, i_safe].to(ring.dtype), ring))
    return out


def attn_verify_chunk(p, cfg: ModelConfig, x: torch.Tensor, cache, index,
                      positions, window: int, block_table,
                      write_mask=None) -> Tuple[torch.Tensor, dict]:
    """Multi-token verify forward of self-speculative decoding (the paged
    full-attention branch of the reference's ``attn_verify_chunk``).

    x: (B, C, D), each row's [current token, γ draft tokens] at absolute
    positions ``index[b] .. index[b] + C - 1`` (``index`` (B,) is the per-row
    cursor).  The chunk's K/V is written through the block table as
    ``attn_prefill_chunk`` writes it, at per-row offsets and under a (B, C)
    ``write_mask``: masked writes (inactive rows, positions at or past the
    row's limit) go to the trash page, and a block index past the table's
    width is clamped first (those positions are always masked).  A
    quantized pool takes the chunk quantized per slot and head.  Rejected
    positions need no masking: their K/V lies past the rewound cursor, is
    never read (validity is ``slot <= position``) and is rewritten before
    the cursor reaches it again, so rollback is cursor and page
    bookkeeping alone.  Attention is the plain gather over the table, on
    every device, as in the reference.

    Sliding-window layers must not advance their ring in place (a rejected
    token's write would destroy the entry it displaced, which rollback
    still needs).  Each query instead gathers the exact ring a sequential
    decode at its position would see: per slot s, the latest position
    ``t <= q_pos`` with ``t ≡ s (mod W)``, from the ring (t < cursor) or
    from the chunk's own K/V (t >= cursor, round-tripped through the
    cache's dtype as a ring write would be), laid out in ring-slot order,
    so that the softmax reduces in the decode step's key order.  The ring
    advance is deferred: the returned cache carries the chunk's K/V under
    ``pending`` for ``spec_ring_commit``."""
    if _is_mla(cfg):
        raise NotImplementedError(_MLA)
    B, C, _ = x.shape
    q, k_new, v_new = _project_qkv(p, cfg, x)
    q, k_new = _qk_norm(p, cfg, q, k_new)
    if window > 0:
        q, k_new = _position_encode(cfg, q, k_new, positions)
        return _ring_verify(p, cfg, q, k_new, v_new, cache, index)
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    bs = k_pages.shape[1]
    q, k_new = _position_encode(cfg, q, k_new, positions,
                                block_table.shape[1] * bs)
    trash = k_pages.shape[0] - 1
    pos = index[:, None] + torch.arange(C, device=x.device)[None, :]  # (B,C)
    blk = (pos // bs).clamp(max=block_table.shape[1] - 1)
    page = torch.gather(block_table, 1, blk).long()
    if write_mask is not None:
        page = torch.where(write_mask, page, trash)
    off = pos % bs
    ks, vs = cache.get("k_scales"), cache.get("v_scales")
    if ks is not None:                               # quantized pool
        k_w, k_s = quant.quantize(k_new, axis=-1, dtype=k_pages.dtype)
        v_w, v_s = quant.quantize(v_new, axis=-1, dtype=v_pages.dtype)
        ks[page, off] = k_s
        vs[page, off] = v_s
    else:
        k_w, v_w = k_new.to(k_pages.dtype), v_new.to(v_pages.dtype)
    k_pages[page, off] = k_w
    v_pages[page, off] = v_w
    out = pa_ops.paged_prefill_attention(
        q, k_pages, v_pages, block_table, index, k_scales=ks, v_scales=vs,
        logit_softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, C, cfg.q_dim) @ p["wo"]
    return out, cache


def _ring_verify(p, cfg: ModelConfig, q, k_new, v_new, cache, index):
    """The sliding-window branch of ``attn_verify_chunk``: (out (B, C, D),
    {k, v, "pending": {k, v}}), the ring itself left as it was."""
    B, C = q.shape[0], q.shape[1]
    ring_k, ring_v = cache["k"], cache["v"]
    W = ring_k.shape[1]
    dev = q.device
    pos = index[:, None] + torch.arange(C, device=dev)[None, :]     # (B, C)
    # Per (row, query c, ring slot s): the position the decode step's ring
    # would hold at slot s when decoding position pos[b, c].
    t = pos[:, :, None] - ((pos[:, :, None]
                            - torch.arange(W, device=dev)[None, None, :]) % W)
    from_ring = t < index[:, None, None]
    ci = (t - index[:, None, None]).clamp(0, C - 1)                 # (B,C,W)
    pend_k, pend_v = k_new.to(ring_k.dtype), v_new.to(ring_v.dtype)
    rows = torch.arange(B, device=dev)[:, None, None]
    sel = from_ring[..., None, None]
    keys = torch.where(sel, ring_k.to(q.dtype)[:, None],
                       pend_k.to(q.dtype)[rows, ci])
    vals = torch.where(sel, ring_v.to(q.dtype)[:, None],
                       pend_v.to(q.dtype)[rows, ci])
    out = paged_ref.masked_gqa_attention_per_query(
        q, keys, vals, t >= 0, cfg.attn_logit_softcap)
    out = out.reshape(B, C, cfg.q_dim) @ p["wo"]
    return out, {"k": ring_k, "v": ring_v,
                 "pending": {"k": pend_k, "v": pend_v}}


def spec_ring_commit(k, v, pend_k, pend_v, index, acc):
    """Apply a verify step's deferred ring advance for the accepted prefix,
    in place.

    k/v: (n_super, B, W, KV, hd) rings; pend_k/pend_v: (n_super, B, C, KV,
    hd), the chunk K/V from ``attn_verify_chunk``; index: (B,) the cursor
    the verify ran at; acc: (B,) accepted tokens a row (0 for inactive
    rows, whose ring is untouched).  Slot s receives the last accepted
    chunk token i < acc with ``(index + i) % W == s`` (``_fill_cache``'s
    rule per row), so the ring ends as a token-by-token decode of the
    accepted tokens would leave it."""
    W, C = k.shape[2], pend_k.shape[2]
    dev = k.device
    r = (torch.arange(W, device=dev)[None, :] - index[:, None]) % W  # (B,W)
    written = r < acc[:, None]
    i_last = r + W * torch.div(acc[:, None] - 1 - r, W,
                               rounding_mode="floor")
    i_safe = torch.where(written, i_last, torch.zeros_like(i_last))
    i_safe = i_safe.clamp(0, C - 1)
    rows = torch.arange(k.shape[1], device=dev)[:, None]
    keep = written[None, :, :, None, None]
    for ring, pend in ((k, pend_k), (v, pend_v)):
        ring.copy_(torch.where(keep, pend[:, rows, i_safe].to(ring.dtype),
                               ring))
    return k, v
