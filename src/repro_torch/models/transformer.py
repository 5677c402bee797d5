"""Stacked decoder-only LM (``repro/models/transformer.py``: attention
blocks with a dense or MoE feed-forward, Mamba blocks with or without an
MoE feed-forward, and RWKV6 blocks).

Layers are grouped into super-blocks of ``cfg.pattern_period`` layers; every
leaf of ``params["blocks"]`` carries a leading ``n_super`` axis, as in the
reference, so progressive depth expansion stays a concat on dim 0.  Where
the reference scans that axis with ``jax.lax.scan`` the port loops over it
in Python; each step indexes views, so nothing is copied.  The block-free
model (``n_super == 0``, the paper's zero-layer source) is embedding, final
norm and head.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_norm, cross_entropy,
                                       dense_init, embed_init, normal,
                                       norm_init, softcap)
from repro_torch.tree import leaves_with_path, tree_map

_KIND = ("ROADMAP queue A item 12 (remaining architectures): {what} is not "
         "ported yet")
CARRY_NOT_PORTED = ("ROADMAP queue A item 17 (recurrent carries in "
                    "continuous batching): RWKV6 and Mamba layers serve "
                    "batch to completion only")


def _check_layer(cfg: ModelConfig, i: int):
    """Admit the ported layer kinds: attention, Mamba and RWKV6."""
    kind = cfg.layer_kind(i)
    if kind not in ("attn", "mamba", "rwkv"):
        raise NotImplementedError(_KIND.format(what=f"block kind {kind!r}"))


def has_recurrent_layers(cfg: ModelConfig) -> bool:
    """Whether any layer keeps per-row recurrent state instead of K/V."""
    return any(cfg.layer_kind(i) != "attn" for i in range(cfg.pattern_period))


def _check_attention(cfg: ModelConfig, i: int):
    """Admit the layers whose per-row state lives in the paged pool."""
    _check_layer(cfg, i)
    if cfg.layer_kind(i) != "attn":
        raise NotImplementedError(CARRY_NOT_PORTED)


def _tree_index(tree, s: int):
    """Super-block ``s`` of a stacked tree (views, no copies)."""
    return tree_map(lambda x: x[s], tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _ffn_init(generator, cfg: ModelConfig, i: int, dtype, device):
    if cfg.layer_is_moe(i):
        return {"moe": mlp_mod.moe_init(generator, cfg, dtype, device)}
    return {"mlp": mlp_mod.mlp_init(generator, cfg, dtype, device=device)}


def _layer_init(generator, cfg: ModelConfig, layer_in_period: int, dtype,
                device):
    """One layer's params; the structure depends only on the position in
    the period.  A Mamba layer has a feed-forward only where it is MoE."""
    i = layer_in_period
    _check_layer(cfg, i)
    kind = cfg.layer_kind(i)
    p = {"ln1": norm_init(cfg.d_model, cfg.norm, device)}
    if kind == "rwkv":
        p["rwkv_tm"] = ssm_mod.rwkv_init(generator, cfg, dtype, device)
        p["ln2"] = norm_init(cfg.d_model, cfg.norm, device)
    elif kind == "mamba":
        p["mamba"] = ssm_mod.mamba_init(generator, cfg, dtype, device)
        if cfg.layer_is_moe(i):
            p["ln2"] = norm_init(cfg.d_model, cfg.norm, device)
            p.update(_ffn_init(generator, cfg, i, dtype, device))
    else:
        p["attn"] = attn.attn_init(generator, cfg, dtype, device)
        p["ln2"] = norm_init(cfg.d_model, cfg.norm, device)
        p.update(_ffn_init(generator, cfg, i, dtype, device))
    return p


def superblock_init(generator, cfg: ModelConfig, dtype=torch.float32,
                    device="cuda"):
    return {f"layer{i}": _layer_init(generator, cfg, i, dtype, device)
            for i in range(cfg.pattern_period)}


def lm_init(generator, cfg: ModelConfig, dtype=torch.float32, num_layers=None,
            device="cuda"):
    """Initialize the full LM at depth ``num_layers`` (default
    cfg.num_layers).  Draws come from ``generator`` (a seeded
    ``torch.Generator``) in a fixed order, so a seed fixes the weights on
    every device; the values differ from the reference's threefry draws."""
    L = cfg.num_layers if num_layers is None else num_layers
    period = cfg.pattern_period
    if L % period:
        raise ValueError(f"depth {L} not a multiple of period {period}")
    n_super = L // period
    params = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                                  dtype, device),
              "final_norm": norm_init(cfg.d_model, cfg.norm, device)}
    if cfg.position == "absolute":
        params["pos_embed"] = normal(generator, (cfg.max_seq_len, cfg.d_model),
                                     0.01, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                       dtype, device=device)
    if n_super > 0:
        params["blocks"] = _stack_superblocks(
            [dict(leaves_with_path(superblock_init(generator, cfg, dtype,
                                                   device)))
             for _ in range(n_super)])
    return params


def _stack_superblocks(flats) -> dict:
    """Stack super-blocks, each a {path: leaf} dict, into one tree whose
    leaves carry a leading n_super axis.  Leaf by leaf, dropping each
    super-block's copy as it is stacked, so at most one leaf exists twice
    at any moment; one super-block is a view (``unsqueeze(0)``), no copy."""
    out: dict = {}
    for path in list(flats[0]):
        parts = [flat.pop(path) for flat in flats]
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (parts[0].unsqueeze(0) if len(parts) == 1
                          else torch.stack(parts))
        del parts
    return out


def num_superblocks(params) -> int:
    if "blocks" not in params:
        return 0
    leaf = params["blocks"]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _ffn_residual(lp, cfg: ModelConfig, i: int, x):
    """x + the layer's feed-forward (dense or MoE) of ln2(x); returns
    (x, aux) with aux = aux_loss + router_zloss of an MoE layer, else 0.
    A Mamba layer without a feed-forward returns x unchanged."""
    aux = torch.zeros((), device=x.device)
    if "ln2" not in lp:
        return x, aux
    h = apply_norm(lp["ln2"], x, cfg.norm)
    if cfg.layer_is_moe(i):
        y, a = mlp_mod.moe_apply(lp["moe"], cfg, h)
        return x + y, aux + a["aux_loss"] + a["router_zloss"]
    return x + mlp_mod.mlp_apply(lp["mlp"], cfg, h), aux


def _apply_layer(lp, cfg: ModelConfig, i: int, x, positions):
    """One layer, full-sequence.  Returns (x, aux_loss)."""
    h = apply_norm(lp["ln1"], x, cfg.norm)
    kind = cfg.layer_kind(i)
    if kind == "rwkv":
        x = x + ssm_mod.rwkv_time_mix(lp["rwkv_tm"], cfg, h)
        h = apply_norm(lp["ln2"], x, cfg.norm)
        x = x + ssm_mod.rwkv_channel_mix(lp["rwkv_tm"], cfg, h)
        return x, torch.zeros((), device=x.device)
    if kind == "mamba":
        x = x + ssm_mod.mamba_apply(lp["mamba"], cfg, h)
    else:
        x = x + attn.attn_apply(lp["attn"], cfg, h, positions,
                                window=cfg.layer_window(i))
    return _ffn_residual(lp, cfg, i, x)


def embed_tokens(params, cfg: ModelConfig, tokens, offset: int = 0):
    """Token embedding (+ learned absolute positions offset..offset+S-1).
    tokens: (B, S)."""
    x = params["embed"][tokens]
    if cfg.position == "absolute":
        S = tokens.shape[1]
        if offset + S > params["pos_embed"].shape[0]:
            raise ValueError(f"positions {offset}..{offset + S - 1} exceed "
                             f"max_seq_len {params['pos_embed'].shape[0]}")
        x = x + params["pos_embed"][offset:offset + S]
    return x


def _positions_for(cfg: ModelConfig, B: int, S: int, device):
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _head(params, cfg: ModelConfig, x):
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(x @ head, cfg.final_logit_softcap)


def lm_apply(params, cfg: ModelConfig, tokens,
             positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), aux_loss scalar)."""
    x = embed_tokens(params, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = _positions_for(cfg, B, S, x.device)
    aux = torch.zeros((), device=x.device)
    for s in range(num_superblocks(params)):
        sb = _tree_index(params["blocks"], s)
        for i in range(cfg.pattern_period):
            x, a = _apply_layer(sb[f"layer{i}"], cfg, i, x, positions)
            aux = aux + a
    return _head(params, cfg, x), aux


def lm_loss(params, cfg: ModelConfig, tokens, labels, mask=None):
    """Returns (loss + aux, {"ce": loss, "aux": aux}).  The reference's
    ``embeds`` (frontend) and ``remat`` arguments come with ROADMAP queue
    A items 12 and 15."""
    logits, aux = lm_apply(params, cfg, tokens)
    loss = cross_entropy(logits, labels, mask)
    return loss + aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill fills the cache, decode takes one token per row
# ---------------------------------------------------------------------------


def lm_init_cache(params, cfg: ModelConfig, batch_size: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda"):
    """Cache tree mirroring the super-block stack (leading n_super axis).
    Attention layers hold K/V in ``dtype``; RWKV6 layers (tm_x, cm_x, wkv)
    and Mamba layers (conv, ssm) hold their recurrent state in float32
    whatever ``dtype`` is, as the reference keeps it."""
    n_super = num_superblocks(params)
    if n_super == 0:
        return {}
    out = {}
    for i in range(cfg.pattern_period):
        _check_layer(cfg, i)
        if cfg.layer_kind(i) == "rwkv":
            one = ssm_mod.rwkv_init_state(cfg, batch_size, device="meta")
        elif cfg.layer_kind(i) == "mamba":
            one = ssm_mod.mamba_init_state(cfg, batch_size, device="meta")
        else:
            one = attn.init_kv_cache(cfg, batch_size, max_len, dtype,
                                     window=cfg.layer_window(i),
                                     device="meta")
        out[f"layer{i}"] = {k: torch.zeros((n_super,) + tuple(t.shape),
                                           dtype=t.dtype, device=device)
                            for k, t in one.items()}
    return out


def lm_init_paged_cache(params, cfg: ModelConfig, batch_size: int,
                        num_blocks: int, block_size: int, max_len: int,
                        dtype=torch.bfloat16, kv_dtype=None, device="cuda"):
    """Paged serve cache (leading n_super axis, like ``lm_init_cache``).

    Global-attention layers hold one pool of ``num_blocks`` pages (+1 trash
    page) addressed per row through the engine's block table; their leaves
    carry no batch dim.  ``kv_dtype`` overrides the pool's storage dtype
    (float only).  ``batch_size`` and ``max_len`` size the per-row state of
    window and recurrent layers, which come with ROADMAP queue A items 12
    (window rings) and 17 (recurrent carries)."""
    del batch_size, max_len
    n_super = num_superblocks(params)
    if n_super == 0:
        return {}
    pool_dtype = dtype if kv_dtype is None else kv_dtype
    out = {}
    for i in range(cfg.pattern_period):
        _check_attention(cfg, i)
        if cfg.layer_window(i) > 0:
            raise NotImplementedError(
                _KIND.format(what="a sliding-window ring beside the pool"))
        one = attn.init_paged_kv_cache(cfg, num_blocks, block_size,
                                       pool_dtype, device="meta")
        out[f"layer{i}"] = {k: torch.zeros((n_super,) + tuple(t.shape),
                                           dtype=pool_dtype, device=device)
                            for k, t in one.items()}
    return out


def lm_init_prefill_carry(params, cfg: ModelConfig, max_len: int,
                          dtype=torch.bfloat16, device="cuda"):
    """B=1 chunked-prefill carry: the per-row state a prefilling request
    threads between chunks.  Paged global-attention layers carry nothing
    ({}): their K/V goes straight into the shared pool."""
    del max_len, dtype, device
    if num_superblocks(params) == 0:
        return {}
    for i in range(cfg.pattern_period):
        _check_attention(cfg, i)
    return {f"layer{i}": {} for i in range(cfg.pattern_period)}


def _write(cache_l: dict, new: dict):
    """Write a layer's new recurrent state into its cache views."""
    for key, t in new.items():
        cache_l[key].copy_(t)


def _prefill_layer(lp, cache_l, cfg: ModelConfig, i: int, x, positions):
    """One layer over the full prompt, filling its decode cache in place
    (the train-path math; aux losses dropped)."""
    h = apply_norm(lp["ln1"], x, cfg.norm)
    kind = cfg.layer_kind(i)
    if kind == "mamba":
        y, state = ssm_mod.mamba_prefill(lp["mamba"], cfg, h, cache_l)
        _write(cache_l, state)
        return _ffn_residual(lp, cfg, i, x + y)[0], cache_l
    if kind == "rwkv":
        y, state = ssm_mod.rwkv_time_mix_prefill(lp["rwkv_tm"], cfg, h,
                                                 cache_l)
        x = x + y
        h = apply_norm(lp["ln2"], x, cfg.norm)
        y, state = ssm_mod.rwkv_channel_mix_prefill(lp["rwkv_tm"], cfg, h,
                                                    state)
        _write(cache_l, state)
        return x + y, cache_l
    y, cache_l = attn.attn_prefill(lp["attn"], cfg, h, cache_l, positions,
                                   window=cfg.layer_window(i))
    return _ffn_residual(lp, cfg, i, x + y)[0], cache_l


def lm_prefill(params, cfg: ModelConfig, tokens, cache, positions=None,
               last_only: bool = False) -> Tuple[torch.Tensor, dict]:
    """Full-sequence prefill: one forward through the train-path math that
    also fills the decode cache.  Returns (logits (B, S, V), cache ready for
    decode at per-row cursor S).  ``last_only`` normalises and projects the
    last position alone and returns (B, 1, V) logits: the serving step
    samples from nothing else, and the full head is S times its work."""
    x = embed_tokens(params, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = _positions_for(cfg, B, S, x.device)
    for s in range(num_superblocks(params)):
        sb = _tree_index(params["blocks"], s)
        cache_sb = _tree_index(cache, s)      # views into the stacked cache
        for i in range(cfg.pattern_period):
            x, _ = _prefill_layer(sb[f"layer{i}"], cache_sb[f"layer{i}"], cfg,
                                  i, x, positions)
    return _head(params, cfg, x[:, -1:] if last_only else x), cache


def lm_prefill_chunk(params, cfg: ModelConfig, tokens, cache, carry,
                     block_table, ctx_len: int):
    """One chunked-prefill step: tokens (B, C) at absolute positions
    ``ctx_len .. ctx_len + C - 1``.  K/V lands in the shared pool of
    ``cache`` through ``block_table`` (B, NB), in place; ``carry`` (the
    B=1 per-row state of window and recurrent layers) is empty for the
    global-attention layers served here and returned as is.  Returns
    (last-position logits (B, 1, V), cache, carry): only the final
    chunk's logits are sampled, so the head runs on one position."""
    B, C = tokens.shape
    x = embed_tokens(params, cfg, tokens, offset=ctx_len)
    positions = (ctx_len + torch.arange(C, device=x.device))[None, :].expand(
        B, C)
    for s in range(num_superblocks(params)):
        sb = _tree_index(params["blocks"], s)
        cache_sb = _tree_index(cache, s)
        for i in range(cfg.pattern_period):
            lp = sb[f"layer{i}"]
            h = apply_norm(lp["ln1"], x, cfg.norm)
            y, _ = attn.attn_prefill_chunk(
                lp["attn"], cfg, h, cache_sb[f"layer{i}"], ctx_len,
                positions, window=cfg.layer_window(i),
                block_table=block_table)
            x = _ffn_residual(lp, cfg, i, x + y)[0]
    return _head(params, cfg, x[:, -1:]), cache, carry


def _decode_layer(lp, cache_l, cfg: ModelConfig, i: int, x, index, positions,
                  block_table=None, write_mask=None):
    h = apply_norm(lp["ln1"], x, cfg.norm)
    kind = cfg.layer_kind(i)
    if kind != "attn" and (write_mask is not None
                           or block_table is not None):
        raise NotImplementedError(CARRY_NOT_PORTED)
    if kind == "mamba":
        y, state = ssm_mod.mamba_decode(lp["mamba"], cfg, h, cache_l)
        _write(cache_l, state)
        return _ffn_residual(lp, cfg, i, x + y)[0], cache_l
    if kind == "rwkv":
        y, state = ssm_mod.rwkv_decode(lp["rwkv_tm"], cfg, h, cache_l)
        x = x + y
        h = apply_norm(lp["ln2"], x, cfg.norm)
        y, state = ssm_mod.rwkv_channel_mix_decode(lp["rwkv_tm"], cfg, h,
                                                   state)
        _write(cache_l, state)
        return x + y, cache_l
    if "k_pages" in cache_l:
        y, cache_l = attn.attn_decode_paged(lp["attn"], cfg, h, cache_l,
                                            block_table, index, positions,
                                            write_mask=write_mask)
    else:
        y, cache_l = attn.attn_decode(lp["attn"], cfg, h, cache_l, index,
                                      positions, window=cfg.layer_window(i),
                                      write_mask=write_mask)
    return _ffn_residual(lp, cfg, i, x + y)[0], cache_l


def lm_decode_step(params, cfg: ModelConfig, tokens, cache, index,
                   positions=None, block_table=None, write_mask=None):
    """tokens: (B, 1) -> (logits (B, 1, V), cache).  ``index`` (B,) is the
    number of tokens already in each row's cache (the absolute position of
    that row's new token); a scalar broadcasts.  The cache is updated in
    place.

    With a paged cache (``lm_init_paged_cache``) attention reads and writes
    the shared pool through ``block_table`` (B, NB); the cursor is cast to
    int32 once here for every layer's kernel.  Rows with
    ``write_mask == False`` leave the cache as it was: contiguous rows
    write their slot's old value back, pool writes go to the trash page."""
    B = tokens.shape[0]
    index = torch.as_tensor(index, device=tokens.device).long()
    if index.ndim == 0:
        index = index.expand(B)
    attn_index = index if block_table is None else index.to(torch.int32)
    x = params["embed"][tokens]
    if cfg.position == "absolute":
        # The reference clamps an index past max_seq_len; torch indexing
        # fails instead (on the card as a device-side assert).  Checking
        # here would sync with the card every token, so callers keep
        # index < max_seq_len (ServeEngine checks it per request).
        x = x + params["pos_embed"][index][:, None, :]
    if positions is None:
        positions = index[:, None]
    for s in range(num_superblocks(params)):
        sb = _tree_index(params["blocks"], s)
        cache_sb = _tree_index(cache, s)
        for i in range(cfg.pattern_period):
            x, _ = _decode_layer(sb[f"layer{i}"], cache_sb[f"layer{i}"], cfg,
                                 i, x, attn_index, positions,
                                 block_table=block_table,
                                 write_mask=write_mask)
    return _head(params, cfg, x), cache
