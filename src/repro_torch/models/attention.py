"""Attention layers and the contiguous KV cache (``repro/models/
attention.py``, the MHA/GQA branches with global attention).

Full-sequence attention routes through ``kernels.flash_attention.ops``
(the Hopper kernel for CUDA tensors, the plain version on the CPU).  Decode
against the contiguous cache attends one new token with the plain masked
GQA math shared with the paged path.  The paged pool (``init_paged_kv_cache``)
is read by ``attn_decode_paged`` through ``kernels.paged_attention.ops``
(the Hopper decode kernel on the card) and written by ``attn_prefill_chunk``
one prefill chunk at a time.

The reference returns new caches from pure functions and donates the old
buffers; here the preallocated cache is written in place (slice and index
assignment) and the same dict is returned, so callers keep one buffer.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.models.common import apply_norm, dense_init, norm_init

_MLA = ("ROADMAP queue A item 12 (remaining architectures): MLA latent "
        "attention is not ported yet")
_WINDOW = ("ROADMAP queue A item 12 (remaining architectures): sliding-window "
           "ring caches are not ported yet")
_ROPE = ("ROADMAP queue A item 12 (remaining architectures): rotary position "
         "encodings are not ported yet")
_QUANT_POOL = ("ROADMAP queue A item 10 (prefix sharing + quantized pages): "
               "int8/fp8 KV pages are not ported yet")


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
    """Per-layer KV cache: zeros of (batch, max_len, KV, hd) for k and v."""
    if window > 0:
        raise NotImplementedError(_WINDOW)
    if _is_mla(cfg):
        raise NotImplementedError(_MLA)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                        dtype=torch.bfloat16, device="cuda"):
    """Per-layer paged KV pool: ``num_blocks`` pages of ``block_size``
    tokens plus one trailing *trash* page (id ``num_blocks``) that free
    rows' block tables point at.  Rows address it through a
    ``(B, max_blocks)`` block table (``repro_torch.train.kv_pool``).
    Float dtypes only."""
    if _is_mla(cfg):
        raise NotImplementedError(_MLA)
    if not dtype.is_floating_point or dtype.itemsize < 2:
        raise NotImplementedError(_QUANT_POOL)
    shape = (num_blocks + 1, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


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


def _position_encode(cfg: ModelConfig, q, k, positions):
    if cfg.position in ("rope", "mrope"):
        raise NotImplementedError(_ROPE)
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
    q, k = _position_encode(cfg, q, k, positions)
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
    """Write a prefill sequence ``new`` (B, S, ...) at slots 0..S-1 of the
    preallocated cache ``buf`` (B, Sc, ...), in place."""
    S, Sc = new.shape[1], buf.shape[1]
    if S > Sc:
        raise NotImplementedError(_WINDOW)
    buf[:, :S] = new.to(buf.dtype)
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
    cursor over the whole cache.  Rows with ``write_mask == False``
    (inactive continuous-batching slots) write back what their slot held,
    so their cache row stays byte-identical: the reference's per-row
    freeze select.  Returns (out (B,1,D), cache)."""
    if window > 0:
        raise NotImplementedError(_WINDOW)
    B = x.shape[0]
    cache_index = torch.as_tensor(cache_index, device=x.device).long()
    cache_index = cache_index.expand(B) if cache_index.ndim == 0 \
        else cache_index
    bidx = torch.arange(B, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x)
    q, k_new = _qk_norm(p, cfg, q, k_new)
    q, k_new = _position_encode(cfg, q, k_new, positions)

    k_buf, v_buf = cache["k"], cache["v"]
    S = k_buf.shape[1]
    k_w, v_w = k_new[:, 0].to(k_buf.dtype), v_new[:, 0].to(v_buf.dtype)
    if write_mask is not None:
        keep = write_mask[:, None, None]
        k_w = torch.where(keep, k_w, k_buf[bidx, cache_index])
        v_w = torch.where(keep, v_w, v_buf[bidx, cache_index])
    k_buf[bidx, cache_index] = k_w
    v_buf[bidx, cache_index] = v_w
    k = k_buf.to(x.dtype)
    v = v_buf.to(x.dtype)

    valid = torch.arange(S, device=x.device)[None, :] <= cache_index[:, None]
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
    q, k_new = _position_encode(cfg, q, k_new, positions)
    bs = cache["k_pages"].shape[1]
    trash = cache["k_pages"].shape[0] - 1
    page = block_table[bidx, cache_index // bs]
    if write_mask is not None:
        page = torch.where(write_mask, page, trash)
    off = cache_index % bs
    out, cache = pa_ops.paged_attention_decode(
        q.contiguous(), cache["k_pages"], cache["v_pages"], k_new[:, 0],
        v_new[:, 0], page, off, block_table, cache_index,
        logit_softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, 1, cfg.q_dim) @ p["wo"]
    return out, cache


def attn_prefill_chunk(p, cfg: ModelConfig, x: torch.Tensor, cache, ctx_len,
                       positions, window: int,
                       block_table=None) -> Tuple[torch.Tensor, dict]:
    """One prefill chunk: x (B, C, D) at absolute positions
    ``ctx_len .. ctx_len + C - 1``.  The chunk's K/V is written into the
    paged pool through ``block_table`` (in place), then the chunk attends
    through the table: context + in-chunk causal triangle in one
    ``slot <= q_pos`` rule.  Global attention over float pages only."""
    if window > 0:
        raise NotImplementedError(_WINDOW)
    if _is_mla(cfg):
        raise NotImplementedError(_MLA)
    B, C, _ = x.shape
    q, k_new, v_new = _project_qkv(p, cfg, x)
    q, k_new = _qk_norm(p, cfg, q, k_new)
    q, k_new = _position_encode(cfg, q, k_new, positions)
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    bs = k_pages.shape[1]
    pos = ctx_len + torch.arange(C, device=x.device)       # (C,) slots
    page = block_table[:, pos // bs]                       # (B, C)
    off = (pos % bs)[None, :].expand(B, C)
    k_pages[page, off] = k_new.to(k_pages.dtype)
    v_pages[page, off] = v_new.to(v_pages.dtype)
    out = pa_ops.paged_prefill_attention(
        q, k_pages, v_pages, block_table, ctx_len,
        logit_softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, C, cfg.q_dim) @ p["wo"]
    return out, cache
