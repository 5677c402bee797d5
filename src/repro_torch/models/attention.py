"""Attention layers and the contiguous KV cache (``repro/models/
attention.py``: MHA/GQA and MLA, global and sliding-window attention, the
logit softcap, RoPE and M-RoPE).

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

On a mesh (``distributed.context.attn_tp``, and ``mla_tp`` for MLA)
every attention path, prefill, decode, the paged decode, a prefill chunk
and the verify, runs on the rank's heads, and the caches it writes, pool
pages and rings, hold the rank's KV heads: KV/model of them, or the one
its query heads read where 'model' is a multiple of KV
(``kv_shared``); an MLA layer's latent caches have no head axis and
stay whole, each rank up-projecting its own heads from them.

Sliding-window layers (``window > 0``, gemma2/gemma3's local layers) keep
a per-row ring of ``min(max_len, window)`` slots instead: position t lives
at slot ``t % W``.  Prefill fills it as a token-by-token decode would leave
it (``_fill_cache``), decode writes at ``index % W`` and attends to the
ring's filled slots, a prefill chunk unrolls the ring into logical order
beside the chunk's keys and advances it, and the speculative verify scores
each query against the exact ring a sequential decode would hold, with the
ring advance deferred to ``spec_ring_commit``.  Rings are never paged:
they are O(window) per row already.

MLA layers (``attention="mla"`` with ``mla_kv_lora_rank`` r > 0,
``deepseekv3-0.3b``) project x to an r-wide latent (``wkv_a``) and up to K
and V (``wkv_b``).  Their caches hold the pre-RoPE latent rows, r values
a token (one scale a slot in an int8/fp8 pool) where K/V would hold
2 KV hd: the contiguous cache a (B, S, r) buffer, the pool (pages, bs, r)
pages.  Every read up-projects the latents it attends over and rotates the
re-derived keys at their absolute slot positions through the rope table
(``paged_ref.paged_mla_attention_ref`` through a block table).  The
reference wrote no Pallas kernel for that read, and its TPU run takes the
same plain path: so does the port, on every device.  An MLA sliding-window
ring is refused, as the reference refuses it.

The reference returns new caches from pure functions and donates the old
buffers; here the preallocated cache is written in place (slice and index
assignment) and the same dict is returned, so callers keep one buffer.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.distributed import collectives as coll
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.distributed.context import (attn_tp, kv_head, kv_shared,
                                            mla_tp, model_group,
                                            tp_local_cfg)
from repro_torch.models.common import (apply_mrope, apply_norm, apply_rope,
                                       dense_init, norm_init)


def _is_mla(cfg: ModelConfig) -> bool:
    return cfg.attention == "mla" and bool(cfg.mla_kv_lora_rank)


def _refuse_mla_ring(cfg: ModelConfig, window: int):
    if _is_mla(cfg) and window > 0:
        raise NotImplementedError(
            f"{cfg.name}: MLA sliding-window rings are not served")


def attn_init(generator, cfg: ModelConfig, dtype=torch.float32, device="cuda"):
    """wq, wk, wv, wo (MLA: wq, the latent down- and up-projections
    wkv_a (D, r) and wkv_b (r, 2 KV hd), wo), and the qk-norm scales."""
    D, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    if _is_mla(cfg):
        r = cfg.mla_kv_lora_rank
        p = {"wq": dense_init(generator, D, Q, dtype, device=device),
             "wkv_a": dense_init(generator, D, r, dtype, device=device),
             "wkv_b": dense_init(generator, r, 2 * KV, dtype, device=device),
             "wo": dense_init(generator, Q, D, dtype, device=device)}
    else:
        p = {"wq": dense_init(generator, D, Q, dtype, device=device),
             "wk": dense_init(generator, D, KV, dtype, device=device),
             "wv": dense_init(generator, D, KV, dtype, device=device),
             "wo": dense_init(generator, Q, D, dtype, device=device)}
    if cfg.qk_norm:
        p["q_norm"] = norm_init(cfg.head_dim, "rmsnorm", device)
        p["k_norm"] = norm_init(cfg.head_dim, "rmsnorm", device)
    return p


def head_params(p, cfg: ModelConfig):
    """(p, cfg) as a layer on the rank's heads uses them under ``attn_tp``
    or ``mla_tp``: the leaves every rank holds whole but uses for its
    heads alone, the qk-norm scales and MLA's ``wkv_a`` (the latent and
    its caches stay whole), pass through ``copy_to_model`` (their
    gradients are partial per rank and are summed once); under
    ``kv_shared`` so do the gathered ``wk`` and ``wv``, cut to the columns
    of the rank's KV head.  ``cfg`` becomes ``tp_local_cfg``: a cache made
    for it holds the rank's KV heads.  Otherwise (p, cfg) as given."""
    if not (attn_tp(cfg) or mla_tp(cfg)):
        return p, cfg
    group = model_group(cfg)
    p = dict(p)
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = {k: coll.copy_to_model(v, group)
                       for k, v in p[name].items()}
    if "wkv_a" in p:
        p["wkv_a"] = coll.copy_to_model(p["wkv_a"], group)
    if kv_shared(cfg):
        lo = kv_head(cfg) * cfg.head_dim
        for name in ("wk", "wv"):
            p[name] = coll.copy_to_model(p[name], group)[
                ..., lo:lo + cfg.head_dim]
    return p, tp_local_cfg(cfg)


def _tensor_parallel(fn=None, *, sources: int = 0):
    """``fn(p, cfg, x, ...)`` on the rank's heads under ``attn_tp`` or
    ``mla_tp``: the input, and the ``sources`` positional arguments after
    it (a cross-attention's encoder output), enter the region through
    ``copy_to_model`` (their gradients are all-reduced over 'model'), q/k/v
    are the rank's column shards (H/model query heads and their KV/model
    KV heads, or their one KV head under ``kv_shared``, so the flash
    kernel runs on the local heads; an MLA layer's ``wkv_b`` is packed,
    its shard the rank's K and V columns), ``wo`` its row shard, and the
    partial outputs are all-reduced over 'model'.  ``p`` and ``cfg``
    inside are ``head_params``'.  Otherwise ``fn`` as is."""
    if fn is None:
        return functools.partial(_tensor_parallel, sources=sources)

    @functools.wraps(fn)
    def run(p, cfg, x, *args, **kwargs):
        if not (attn_tp(cfg) or mla_tp(cfg)):
            return fn(p, cfg, x, *args, **kwargs)
        group = model_group(cfg)
        p, local = head_params(p, cfg)
        args = tuple(coll.copy_to_model(a, group) if i < sources else a
                     for i, a in enumerate(args))
        res = fn(p, local, coll.copy_to_model(x, group), *args, **kwargs)
        if isinstance(res, tuple):
            return (coll.reduce_from_model(res[0], group),) + res[1:]
        return coll.reduce_from_model(res, group)
    return run


def cache_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config a layer's caches are made for: a rank's share of the KV
    heads under ``attn_tp`` (its one KV head under ``kv_shared``), else
    ``cfg``."""
    return tp_local_cfg(cfg) if attn_tp(cfg) else cfg


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, window: int = 0, device="cuda"):
    """Per-layer KV cache: zeros of (batch, S, KV, hd) for k and v, with
    S = max_len, or for a sliding-window layer (``window > 0``) the ring
    S = min(max_len, window); an MLA layer's is the pre-RoPE latent,
    (batch, S, r)."""
    S = min(max_len, window) if window > 0 else max_len
    if _is_mla(cfg):
        return {"latent": torch.zeros((batch, S, cfg.mla_kv_lora_rank),
                                      dtype=dtype, device=device)}
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
    redirection, the copy-on-write clone, radix prefix sharing.

    An MLA layer pages its pre-RoPE latent rows: ``latent_pages``
    (pages, bs, r), and in an int8/fp8 pool ``latent_scales`` (pages, bs,
    1), one scale a slot."""
    if _is_mla(cfg):
        shape = (num_blocks + 1, block_size, cfg.mla_kv_lora_rank)
        c = {"latent_pages": torch.zeros(shape, dtype=dtype, device=device)}
        if quant.is_quantized(dtype):
            c["latent_scales"] = torch.zeros(shape[:2] + (1,),
                                             dtype=torch.float32,
                                             device=device)
        return c
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
    """Returns q, k, v of shapes (B,S,H,hd) / (B,S,KV,hd), and an MLA
    layer's latent (B,S,r) (else None), from which its k and v come."""
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], H, hd)
    if _is_mla(cfg):
        latent = x @ p["wkv_a"]
        return (q,) + paged_ref.mla_kv(latent, p["wkv_b"], KVH) + (latent,)
    k = _split_heads(x @ p["wk"], KVH, hd)
    v = _split_heads(x @ p["wv"], KVH, hd)
    return q, k, v, None


def _qk_norm(p, cfg: ModelConfig, q, k):
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm")
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    return q, k


def _position_encode(cfg: ModelConfig, q, k, positions, span: int = 0):
    """RoPE at ``positions`` (B, S), or M-RoPE at (3, B, S) ids, the
    rotation table covering ``max_seq_len``, the positions of a longer
    training sequence and ``span``, the positions a cache holds (its
    slots, or its block table's); a speculative round's positions past
    the cache clamp.  The caches store the rotated keys, as the
    reference's do (MLA's store pre-RoPE latents: ``_rotate_slots``)."""
    if cfg.position in ("rope", "mrope"):
        n = max(cfg.max_seq_len, positions.shape[-1], span)
        rot = apply_rope if cfg.position == "rope" else apply_mrope
        q = rot(q, positions, cfg.rope_theta, n)
        k = rot(k, positions, cfg.rope_theta, n)
    # 'absolute' is added at the embedding layer; 'none' is a no-op.
    return q, k


def _rotate_slots(cfg: ModelConfig, S: int):
    """The rotation of keys re-derived from S cached latent slots at their
    absolute positions 0..S-1 (None without RoPE), from the table the
    queries were rotated with (the cache's span is S)."""
    if cfg.position != "rope":
        return None

    def rot(k):
        pos = torch.arange(S, device=k.device)[None, :]
        return apply_rope(k, pos, cfg.rope_theta, max(cfg.max_seq_len, S))
    return rot


def _cache_span(cache) -> int:
    """Slots of a contiguous cache (K/V or MLA latent)."""
    return (cache["latent"] if "latent" in cache else cache["k"]).shape[1]


@_tensor_parallel
def attn_apply(p, cfg: ModelConfig, x: torch.Tensor, positions, window: int,
               causal: bool = True, cache=None):
    """x: (B, S, D) -> (B, S, D).

    With ``cache`` (serve prefill) the decode cache is filled alongside the
    forward with the same keys and values ``attn_decode`` would have
    written token by token (an MLA layer's pre-RoPE latents), and the
    return becomes ``(out, cache)``.  ``causal=False`` attends over every
    position (the encoder's self-attention)."""
    q, k, v, latent = _project_qkv(p, cfg, x)
    q, k = _qk_norm(p, cfg, q, k)
    q, k = _position_encode(cfg, q, k, positions,
                            0 if cache is None else _cache_span(cache))
    if cache is not None and latent is not None:
        _fill_cache(cache["latent"], latent)
    elif cache is not None:
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


@_tensor_parallel
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
    reference's scatter drops it; that row's output is never used.  An MLA
    layer writes its latent and attends over K/V up-projected from the
    whole latent cache, the keys rotated at their slot positions.
    Returns (out (B,1,D), cache)."""
    B = x.shape[0]
    cache_index = torch.as_tensor(cache_index, device=x.device).long()
    cache_index = cache_index.expand(B) if cache_index.ndim == 0 \
        else cache_index
    bidx = torch.arange(B, device=x.device)
    q, k_new, v_new, latent = _project_qkv(p, cfg, x)
    q, k_new = _qk_norm(p, cfg, q, k_new)
    S = _cache_span(cache)
    q, k_new = _position_encode(cfg, q, k_new, positions, S)

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
    new = {"latent": latent} if latent is not None \
        else {"k": k_new, "v": v_new}
    for key, t in new.items():
        buf = cache[key]
        kept = keep.reshape((-1,) + (1,) * (buf.ndim - 2))
        buf[bidx, slot] = torch.where(kept, t[:, 0].to(buf.dtype),
                                      buf[bidx, slot])
    if latent is not None:
        k, v = paged_ref.mla_kv(cache["latent"].to(x.dtype), p["wkv_b"],
                                cfg.num_kv_heads, _rotate_slots(cfg, S))
    else:
        k = cache["k"].to(x.dtype)
        v = cache["v"].to(x.dtype)

    filled = cache_index.clamp(max=S - 1) if window > 0 else cache_index
    valid = torch.arange(S, device=x.device)[None, :] <= filled[:, None]
    out = paged_ref.masked_gqa_attention(q, k, v, valid[:, None, :],
                                         cfg.attn_logit_softcap)
    out = out.reshape(B, 1, cfg.q_dim) @ p["wo"]
    return out, cache


def _mla_pool_attend(p, cfg: ModelConfig, q, latent, cache, block_table,
                     page, off, valid):
    """An MLA layer's pool write and read: the latents (any leading shape
    matching ``page``/``off``) go to (page, offset) in place, quantized per
    slot with their scales in an int8/fp8 pool; then the queries q
    (B, C, H, hd) attend through the table under ``valid`` (B, C, S),
    the gathered latents dequantized, up-projected and their keys rotated
    at slot positions (``paged_ref.paged_mla_attention_ref``)."""
    lp, ls = cache["latent_pages"], cache.get("latent_scales")
    if ls is not None:
        lat_w, lat_s = quant.quantize(latent, axis=-1, dtype=lp.dtype)
        ls[page, off] = lat_s
    else:
        lat_w = latent.to(lp.dtype)
    lp[page, off] = lat_w
    return paged_ref.paged_mla_attention_ref(
        q, lp, block_table, valid, p["wkv_b"], cfg.num_kv_heads,
        rotate_fn=_rotate_slots(cfg, valid.shape[-1]), latent_scales=ls,
        logit_softcap=cfg.attn_logit_softcap)


@_tensor_parallel
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
    (the Hopper kernel on the card).  An MLA layer writes its latent (and
    scale) the same way and attends through ``_mla_pool_attend``, plain on
    every device.  Returns (out (B,1,D), cache)."""
    B = x.shape[0]
    bidx = torch.arange(B, device=x.device)
    q, k_new, v_new, latent = _project_qkv(p, cfg, x)
    q, k_new = _qk_norm(p, cfg, q, k_new)
    pages = cache["latent_pages" if latent is not None else "k_pages"]
    bs = pages.shape[1]
    q, k_new = _position_encode(cfg, q, k_new, positions,
                                block_table.shape[1] * bs)
    trash = pages.shape[0] - 1
    page = block_table[bidx, cache_index // bs]
    if write_mask is not None:
        page = torch.where(write_mask, page, trash)
    off = cache_index % bs
    if latent is not None:
        S = block_table.shape[1] * bs
        valid = (torch.arange(S, device=x.device)[None, :]
                 <= cache_index[:, None])[:, None, :]           # (B, 1, S)
        out = _mla_pool_attend(p, cfg, q, latent[:, 0], cache, block_table,
                               page, off, valid)
        return out.reshape(B, 1, cfg.q_dim) @ p["wo"], cache
    out, cache = pa_ops.paged_attention_decode(
        q.contiguous(), cache["k_pages"], cache["v_pages"], k_new[:, 0],
        v_new[:, 0], page, off, block_table, cache_index,
        k_scales=cache.get("k_scales"), v_scales=cache.get("v_scales"),
        logit_softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, 1, cfg.q_dim) @ p["wo"]
    return out, cache


@_tensor_parallel
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
    (``cache`` is the B=1 carry's ring): see ``_ring_prefill_chunk``.  An
    MLA layer writes the chunk's latents through the table and attends
    over the up-projected pool (``_mla_pool_attend``); its window ring is
    refused, as in the reference."""
    _refuse_mla_ring(cfg, window)
    B, C, _ = x.shape
    q, k_new, v_new, latent = _project_qkv(p, cfg, x)
    q, k_new = _qk_norm(p, cfg, q, k_new)
    if window > 0:
        q, k_new = _position_encode(cfg, q, k_new, positions)
        out = _ring_prefill_chunk(cfg, q, k_new, v_new, cache, ctx_len)
        return out.reshape(B, C, cfg.q_dim) @ p["wo"], cache
    bs = cache["latent_pages" if latent is not None else "k_pages"].shape[1]
    q, k_new = _position_encode(cfg, q, k_new, positions,
                                block_table.shape[1] * bs)
    pos = ctx_len + torch.arange(C, device=x.device)       # (C,) slots
    page = block_table[:, pos // bs]                       # (B, C)
    off = (pos % bs)[None, :].expand(B, C)
    if latent is not None:
        S = block_table.shape[1] * bs
        valid = (torch.arange(S, device=x.device)[None, None, :]
                 <= pos[None, :, None]).expand(B, C, S)
        out = _mla_pool_attend(p, cfg, q, latent, cache, block_table, page,
                               off, valid)
        return out.reshape(B, C, cfg.q_dim) @ p["wo"], cache
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
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


@_tensor_parallel
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
    ``pending`` for ``spec_ring_commit``.  An MLA layer writes the chunk's
    latents as a global layer writes K/V and attends over the up-projected
    pool (``_mla_pool_attend``); its window ring is refused, as in the
    reference."""
    _refuse_mla_ring(cfg, window)
    B, C, _ = x.shape
    q, k_new, v_new, latent = _project_qkv(p, cfg, x)
    q, k_new = _qk_norm(p, cfg, q, k_new)
    if window > 0:
        q, k_new = _position_encode(cfg, q, k_new, positions)
        return _ring_verify(p, cfg, q, k_new, v_new, cache, index)
    pages = cache["latent_pages" if latent is not None else "k_pages"]
    bs = pages.shape[1]
    q, k_new = _position_encode(cfg, q, k_new, positions,
                                block_table.shape[1] * bs)
    trash = pages.shape[0] - 1
    pos = index[:, None] + torch.arange(C, device=x.device)[None, :]  # (B,C)
    blk = (pos // bs).clamp(max=block_table.shape[1] - 1)
    page = torch.gather(block_table, 1, blk).long()
    if write_mask is not None:
        page = torch.where(write_mask, page, trash)
    off = pos % bs
    if latent is not None:
        S = block_table.shape[1] * bs
        valid = (torch.arange(S, device=x.device)[None, None, :]
                 <= pos[:, :, None])                             # (B, C, S)
        out = _mla_pool_attend(p, cfg, q, latent, cache, block_table, page,
                               off, valid)
        return out.reshape(B, C, cfg.q_dim) @ p["wo"], cache
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
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
