"""Stacked decoder-only LM (``repro/models/transformer.py``: attention
blocks (MHA/GQA or MLA) with a dense or MoE feed-forward, Mamba blocks with
or without an MoE feed-forward, and RWKV6 blocks; a vision frontend's
precomputed embeddings prepended to the text, positioned by M-RoPE ids).

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
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.distributed.context import (materialize, model_group,
                                            tp_rank, vocab_tp)
from repro_torch.models.common import (apply_norm, cross_entropy,
                                       dense_init, embed_init, normal,
                                       norm_init, softcap,
                                       vocab_parallel_cross_entropy)
from repro_torch.tree import leaves_with_path, tree_map

_KIND = ("{what}: the port's blocks are attention, Mamba and RWKV6, the "
         "kinds of every config of the reference registry")


def _check_layer(cfg: ModelConfig, i: int):
    """Admit the ported layer kinds: attention, Mamba and RWKV6."""
    kind = cfg.layer_kind(i)
    if kind not in ("attn", "mamba", "rwkv"):
        raise NotImplementedError(_KIND.format(what=f"block kind {kind!r}"))


def _is_ring(cfg: ModelConfig, i: int) -> bool:
    """A sliding-window attention layer: its cache is a per-row ring."""
    return cfg.layer_kind(i) == "attn" and cfg.layer_window(i) > 0


def _recurrent_state(cfg: ModelConfig, i: int, batch: int):
    """Shapes (meta tensors) of one recurrent layer's per-row state."""
    if cfg.layer_kind(i) == "rwkv":
        return ssm_mod.rwkv_init_state(cfg, batch, device="meta")
    return ssm_mod.mamba_init_state(cfg, batch, device="meta")


def _stacked_zeros(one: dict, n_super: int, device) -> dict:
    """Zeros of ``one``'s shapes and dtypes behind a leading n_super axis."""
    return {k: torch.zeros((n_super,) + tuple(t.shape), dtype=t.dtype,
                           device=device) for k, t in one.items()}


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
    return x + mlp_mod.mlp_apply_tp(lp["mlp"], cfg, h), aux


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


def embed_tokens(params, cfg: ModelConfig, tokens, embeds=None,
                 offset: int = 0):
    """Token embedding (+ learned absolute positions offset..offset+S-1),
    with a frontend's precomputed embeddings ``embeds`` (B, N, D), when
    given, prepended.  tokens: (B, S).  The gather is ``F.embedding``: the
    same forward bits as indexing, and a backward that sums each row's
    gradient in a fixed order on every device, where indexing's
    ``index_put_`` accumulates in thread order on the CPU (two identical
    steps may then differ)."""
    x = _embed_lookup(params, cfg, tokens)
    if cfg.position == "absolute":
        S = tokens.shape[1]
        if offset + S > params["pos_embed"].shape[0]:
            raise ValueError(f"positions {offset}..{offset + S - 1} exceed "
                             f"max_seq_len {params['pos_embed'].shape[0]}")
        x = x + params["pos_embed"][offset:offset + S]
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def _embed_lookup(params, cfg: ModelConfig, tokens):
    """Embedding rows of ``tokens``; under ``vocab_tp`` the rank holds
    vocab rows [r V/m, (r+1) V/m): ids outside them look up zeros and the
    partial rows are all-reduced over 'model'."""
    w = params["embed"]
    if not vocab_tp(cfg):
        return F.embedding(tokens, w)
    n = w.shape[0]
    local = tokens - tp_rank() * n
    inside = (local >= 0) & (local < n)
    x = F.embedding(local.clamp(0, n - 1), w) * inside[..., None].to(w.dtype)
    return coll.reduce_from_model(x, model_group(cfg))


def _pos_embed(params, pos):
    """Learned positions at ``pos`` (any shape), clamped to the table as
    the reference's gather clamps: a speculative round reads positions up
    to ``cursor + γ``, past ``max_seq_len`` near a row's limit, whose
    logits are never in play.  Torch indexing past the end would fail (on
    the card as a device-side assert), and a check would sync every step."""
    table = params["pos_embed"]
    return table[pos.clamp(max=table.shape[0] - 1)]


def _positions_for(cfg: ModelConfig, B: int, S: int, device, offset=0):
    """Positions offset..offset+S-1 of every row: (B, S), or for M-RoPE
    the (3, B, S) ids of text (t = h = w = position), the reference's
    text-only stub ids."""
    return _mrope_ids(cfg, (offset + torch.arange(S, device=device))[
        None, :].expand(B, S))


def _mrope_ids(cfg: ModelConfig, pos):
    """``pos`` (B, S) as M-RoPE's (3, B, S) text ids under
    ``position='mrope'``, else unchanged."""
    return pos[None].expand((3,) + tuple(pos.shape)) \
        if cfg.position == "mrope" else pos


def _head(params, cfg: ModelConfig, x, whole_vocab: bool = True):
    """Final norm and head.  Under ``vocab_tp`` the rank computes its vocab
    columns (gathered over 'model' when ``whole_vocab``; the loss takes
    them as they are)."""
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    group = model_group(cfg) if vocab_tp(cfg) else None
    if group is not None:
        x = coll.copy_to_model(x, group)
    logits = softcap(x @ head, cfg.final_logit_softcap)
    if group is not None and whole_vocab:
        logits = coll.gather_from_model(logits, group, -1)
    return logits


def _materialize_top(params, cfg: ModelConfig):
    """The non-block leaves as the layers use them (``materialize``)."""
    top = materialize({k: v for k, v in params.items() if k != "blocks"},
                      cfg)
    return {**params, **top}


def _block(params, cfg: ModelConfig, s: int):
    """Super-block ``s``'s leaves as the layers use them: a serving mesh's
    held shards gathered for this super-block alone (``materialize``)."""
    return materialize(_tree_index(params["blocks"], s), cfg, ("blocks",))


def _apply_superblock(sb, cfg: ModelConfig, x, positions):
    """One super-block, full-sequence.  Returns (x, its aux losses)."""
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.pattern_period):
        x, a = _apply_layer(sb[f"layer{i}"], cfg, i, x, positions)
        aux = aux + a
    return x, aux


# Ops whose outputs the 'dots' policy keeps: the matrix products with no
# batch dimension, the counterpart of the reference's
# dots_with_no_batch_dims_saveable.  ``torch.einsum`` runs such a product
# as a bmm over a batch of one; a bmm over a real batch (the attention's
# scores on the CPU, the MoE experts) is recomputed, as the reference
# recomputes its batched dot_generals.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    keep = op in _DOTS or (op is torch.ops.aten.bmm.default
                           and args[0].shape[0] == 1)
    return (CheckpointPolicy.MUST_SAVE if keep
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(remat):
    """Normalize the reference's knob: False/None/'off' -> None (no
    checkpointing), True/'nothing' -> 'nothing', 'dots' -> 'dots'."""
    if remat in (False, None, "off"):
        return None
    if remat is True or remat == "nothing":
        return "nothing"
    if remat == "dots":
        return "dots"
    raise ValueError(f"remat={remat!r} (False, True, 'nothing' or 'dots')")


def _checkpointed(fn, policy: str):
    """``fn`` with each call's activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant): 'nothing' keeps no
    activation inside the call, 'dots' keeps the outputs of the matrix
    products (a selective-checkpoint context) and recomputes the rest.
    The recomputation runs the same deterministic kernels on the same
    inputs, so loss, gradients and updates are those of remat off."""
    from torch.utils import checkpoint as ckpt
    if policy == "dots":
        import functools
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                          context_fn=ctx)
    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)


def lm_apply(params, cfg: ModelConfig, tokens, embeds=None, positions=None,
             remat=False, whole_vocab: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S_total, V), aux_loss scalar), S_total the
    frontend embeds' N plus the text's S.  ``remat`` (False,
    True/'nothing' or 'dots') checkpoints each super-block's body, as the
    reference checkpoints its scan body.  On a training mesh each
    super-block's shards are gathered inside its body (again in the
    backward under remat); ``whole_vocab=False`` leaves vocab-parallel
    logits on the rank's vocab columns."""
    params = _materialize_top(params, cfg)
    x = embed_tokens(params, cfg, tokens, embeds)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = _positions_for(cfg, B, S, x.device)

    def body(sb, x):
        sb = materialize(sb, cfg, ("blocks",))
        return _apply_superblock(sb, cfg, x, positions)

    policy = remat_policy(remat)
    if policy is not None and torch.is_grad_enabled():
        body = _checkpointed(body, policy)
    aux = torch.zeros((), device=x.device)
    for s in range(num_superblocks(params)):
        x, a = body(_tree_index(params["blocks"], s), x)
        aux = aux + a
    return _head(params, cfg, x, whole_vocab), aux


def lm_loss(params, cfg: ModelConfig, tokens, labels, embeds=None,
            mask=None, remat=False):
    """Returns (loss + aux, {"ce": loss, "aux": aux}).  With frontend
    ``embeds`` the loss covers the text tail only."""
    logits, aux = lm_apply(params, cfg, tokens, embeds=embeds, remat=remat,
                           whole_vocab=False)
    if embeds is not None:
        logits = logits[:, embeds.shape[1]:]
    loss = token_loss(logits, cfg, labels, mask)
    return loss + aux, {"ce": loss, "aux": aux}


def token_loss(logits, cfg: ModelConfig, labels, mask=None):
    """Mean cross entropy of ``logits`` (B, S, V), or under ``vocab_tp`` of
    the rank's vocab columns (``_head(whole_vocab=False)``)."""
    if vocab_tp(cfg):
        return vocab_parallel_cross_entropy(
            logits, labels, model_group(cfg), tp_rank() * logits.shape[-1],
            mask)
    return cross_entropy(logits, labels, mask)


# ---------------------------------------------------------------------------
# Serving: prefill fills the cache, decode takes one token per row
# ---------------------------------------------------------------------------


def lm_init_cache(params, cfg: ModelConfig, batch_size: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda"):
    """Cache tree mirroring the super-block stack (leading n_super axis).
    Attention layers hold K/V in ``dtype``; RWKV6 layers (tm_x, cm_x, wkv)
    and Mamba layers (conv, ssm) hold their recurrent state in float32
    whatever ``dtype`` is, as the reference keeps it.  On a mesh each
    holds what the rank computes (``lm_init_paged_cache``)."""
    n_super = num_superblocks(params)
    if n_super == 0:
        return {}
    out = {}
    for i in range(cfg.pattern_period):
        _check_layer(cfg, i)
        if cfg.layer_kind(i) != "attn":
            one = _recurrent_state(cfg, i, batch_size)
        else:
            one = attn.init_kv_cache(attn.cache_cfg(cfg), batch_size,
                                     max_len, dtype,
                                     window=cfg.layer_window(i),
                                     device="meta")
        out[f"layer{i}"] = _stacked_zeros(one, n_super, device)
    return out


def lm_init_paged_cache(params, cfg: ModelConfig, batch_size: int,
                        num_blocks: int, block_size: int, max_len: int,
                        dtype=torch.bfloat16, kv_dtype=None, device="cuda"):
    """Paged serve cache (leading n_super axis, like ``lm_init_cache``).

    Global-attention layers hold one pool of ``num_blocks`` pages (+1 trash
    page) addressed per row through the engine's block table; their leaves
    carry no batch dim.  ``kv_dtype`` overrides the pool's storage dtype;
    int8/fp8 pools add float32 scale leaves, which stay float32.  Mamba and
    RWKV6 layers keep their O(1) recurrent state per row
    (``batch_size`` rows) in float32, which ``kv_dtype`` never touches:
    it is not the paged working set.  Sliding-window layers keep a ring of
    ``min(max_len, window)`` slots per row in ``dtype`` beside the pool
    (already O(window) a row: paging them buys less than a page);
    ``kv_dtype`` applies to the pool leaves only.  Under tensor
    parallelism (``attn_tp``) the pool and the rings hold the rank's KV
    heads (``attn.cache_cfg``), and Mamba and RWKV6 states the rank's
    channels and heads (``mamba_tp``, ``rwkv_tp``)."""
    n_super = num_superblocks(params)
    if n_super == 0:
        return {}
    pool_dtype = dtype if kv_dtype is None else kv_dtype
    out = {}
    for i in range(cfg.pattern_period):
        _check_layer(cfg, i)
        if cfg.layer_kind(i) != "attn":
            one = _recurrent_state(cfg, i, batch_size)
        elif _is_ring(cfg, i):
            one = attn.init_kv_cache(attn.cache_cfg(cfg), batch_size,
                                     max_len, dtype,
                                     window=cfg.layer_window(i),
                                     device="meta")
        else:
            one = attn.init_paged_kv_cache(attn.cache_cfg(cfg), num_blocks,
                                           block_size, pool_dtype,
                                           device="meta")
        out[f"layer{i}"] = _stacked_zeros(one, n_super, device)
    return out


def lm_init_prefill_carry(params, cfg: ModelConfig, max_len: int,
                          dtype=torch.bfloat16, device="cuda"):
    """B=1 chunked-prefill carry: the per-row state a prefilling request
    threads between chunks (leading n_super axis): the rings of
    sliding-window layers (in ``dtype``) and the recurrent states of Mamba
    and RWKV6 layers (float32).  Paged global-attention layers carry
    nothing ({}): their K/V goes straight into the shared pool."""
    n_super = num_superblocks(params)
    if n_super == 0:
        return {}
    out = {}
    for i in range(cfg.pattern_period):
        _check_layer(cfg, i)
        if _is_ring(cfg, i):
            one = attn.init_kv_cache(attn.cache_cfg(cfg), 1, max_len, dtype,
                                     window=cfg.layer_window(i),
                                     device="meta")
        elif cfg.layer_kind(i) == "attn":
            one = {}
        else:
            one = _recurrent_state(cfg, i, 1)
        out[f"layer{i}"] = _stacked_zeros(one, n_super, device)
    return out


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


def lm_prefill(params, cfg: ModelConfig, tokens, cache, embeds=None,
               positions=None, last_only: bool = False
               ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence prefill: one forward through the train-path math that
    also fills the decode cache.  Returns (logits (B, S, V), cache ready for
    decode at per-row cursor S; S counts frontend ``embeds``).
    ``last_only`` normalises and projects the last position alone and
    returns (B, 1, V) logits: the serving step samples from nothing else,
    and the full head is S times its work."""
    params = _materialize_top(params, cfg)
    x = embed_tokens(params, cfg, tokens, embeds)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = _positions_for(cfg, B, S, x.device)
    for s in range(num_superblocks(params)):
        sb = _block(params, cfg, s)
        cache_sb = _tree_index(cache, s)      # views into the stacked cache
        for i in range(cfg.pattern_period):
            x, _ = _prefill_layer(sb[f"layer{i}"], cache_sb[f"layer{i}"], cfg,
                                  i, x, positions)
    return _head(params, cfg, x[:, -1:] if last_only else x), cache


def lm_prefill_chunk(params, cfg: ModelConfig, tokens, cache, carry,
                     block_table, ctx_len: int):
    """One chunked-prefill step: tokens (B, C) at absolute positions
    ``ctx_len .. ctx_len + C - 1``.  K/V lands in the shared pool of
    ``cache`` through ``block_table`` (B, NB), in place; sliding-window
    layers attend over and advance the B=1 ``carry``'s ring, and Mamba and
    RWKV6 layers thread it through ``mamba_prefill`` and
    ``rwkv_*_prefill`` exactly as the full prefill threads its cache, in
    place (on the card: one scan or WKV launch per layer, from the
    carried state).  The chunks of a binary decomposition are exact (never
    padded), so the carry sees only real tokens.  Returns (last-position
    logits (B, 1, V), cache, carry): only the final chunk's logits are
    sampled, so the head runs on one position."""
    B, C = tokens.shape
    params = _materialize_top(params, cfg)
    x = embed_tokens(params, cfg, tokens, offset=ctx_len)
    positions = _positions_for(cfg, B, C, x.device, ctx_len)
    for s in range(num_superblocks(params)):
        sb = _block(params, cfg, s)
        cache_sb = _tree_index(cache, s)
        carry_sb = _tree_index(carry, s)
        for i in range(cfg.pattern_period):
            lp = sb[f"layer{i}"]
            if cfg.layer_kind(i) != "attn":
                x, _ = _prefill_layer(lp, carry_sb[f"layer{i}"], cfg, i, x,
                                      positions)
                continue
            h = apply_norm(lp["ln1"], x, cfg.norm)
            layer_cache = (carry_sb if _is_ring(cfg, i) else cache_sb)
            y, _ = attn.attn_prefill_chunk(
                lp["attn"], cfg, h, layer_cache[f"layer{i}"], ctx_len,
                positions, window=cfg.layer_window(i),
                block_table=block_table)
            x = _ffn_residual(lp, cfg, i, x + y)[0]
    return _head(params, cfg, x[:, -1:]), cache, carry


def _recurrent_step(lp, cfg: ModelConfig, i: int, x, state):
    """One Mamba or RWKV6 layer over one token per row, x (B, 1, D):
    the decode math, returning (x, new state) without writing it."""
    h = apply_norm(lp["ln1"], x, cfg.norm)
    if cfg.layer_kind(i) == "mamba":
        y, state = ssm_mod.mamba_decode(lp["mamba"], cfg, h, state)
        return _ffn_residual(lp, cfg, i, x + y)[0], state
    y, state = ssm_mod.rwkv_decode(lp["rwkv_tm"], cfg, h, state)
    x = x + y
    h = apply_norm(lp["ln2"], x, cfg.norm)
    y, state = ssm_mod.rwkv_channel_mix_decode(lp["rwkv_tm"], cfg, h, state)
    return x + y, state


def _frozen(new: dict, old: dict, write_mask) -> dict:
    """Rows with ``write_mask`` False keep ``old`` bit for bit."""
    if write_mask is None:
        return new
    out = {}
    for key, t in new.items():
        keep = write_mask.reshape((-1,) + (1,) * (t.ndim - 1))
        out[key] = torch.where(keep, t, old[key])
    return out


def _decode_layer(lp, cache_l, cfg: ModelConfig, i: int, x, index, positions,
                  block_table=None, write_mask=None):
    if cfg.layer_kind(i) != "attn":
        x, state = _recurrent_step(lp, cfg, i, x, cache_l)
        _write(cache_l, _frozen(state, cache_l, write_mask))
        return x, cache_l
    h = apply_norm(lp["ln1"], x, cfg.norm)
    if "k_pages" in cache_l or "latent_pages" in cache_l:
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
    write their slot's old value back, pool writes go to the trash page,
    and Mamba and RWKV6 rows keep their state bit for bit (a select
    against the old state before the in-place write)."""
    B = tokens.shape[0]
    index = torch.as_tensor(index, device=tokens.device).long()
    if index.ndim == 0:
        index = index.expand(B)
    attn_index = index if block_table is None else index.to(torch.int32)
    params = _materialize_top(params, cfg)
    x = _embed_lookup(params, cfg, tokens)
    if cfg.position == "absolute":
        x = x + _pos_embed(params, index)[:, None, :]
    if positions is None:
        positions = _mrope_ids(cfg, index[:, None])
    for s in range(num_superblocks(params)):
        sb = _block(params, cfg, s)
        cache_sb = _tree_index(cache, s)
        for i in range(cfg.pattern_period):
            x, _ = _decode_layer(sb[f"layer{i}"], cache_sb[f"layer{i}"], cfg,
                                 i, x, attn_index, positions,
                                 block_table=block_table,
                                 write_mask=write_mask)
    return _head(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Self-speculative decoding: the multi-token verify forward
# ---------------------------------------------------------------------------

def _replay_layer(lp, cache_l, ring_l, cfg: ModelConfig, i: int, x):
    """A Mamba or RWKV6 layer over a (B, C) verify chunk, replayed as C
    single-token decode steps with the exact decode math (so the replay is
    bitwise sequential decode).  ``ring_l`` leaves (C+1, B, ...) receive
    the pre-round state (entry 0) and the state after every step; the
    cache itself is left as it was, for ``lm_spec_commit``."""
    for key, t in cache_l.items():
        ring_l[key][0].copy_(t)
    state, outs = cache_l, []
    for t in range(x.shape[1]):
        xt, state = _recurrent_step(lp, cfg, i, x[:, t:t + 1], state)
        for key, v in state.items():
            ring_l[key][t + 1].copy_(v)
        outs.append(xt)
    return torch.cat(outs, dim=1)


def _verify_layer(lp, cache_l, pend_l, cfg: ModelConfig, i: int, x, index,
                  positions, block_table, write_mask):
    """One attention layer over a (B, C) verify chunk at per-row offsets
    ``index``: a global layer scored through the block table, a window
    layer against its ring, whose chunk K/V goes into ``pend_l`` (leaves
    (B, C, KV, hd)) for the deferred ring commit."""
    h = apply_norm(lp["ln1"], x, cfg.norm)
    y, cache_l = attn.attn_verify_chunk(lp["attn"], cfg, h, cache_l, index,
                                        positions, cfg.layer_window(i),
                                        block_table, write_mask=write_mask)
    for key, t in cache_l.get("pending", {}).items():
        pend_l[key].copy_(t)
    return _ffn_residual(lp, cfg, i, x + y)[0], cache_l


def lm_verify(params, cfg: ModelConfig, tokens, cache, index, block_table,
              write_mask):
    """Speculative-decoding verify forward: score all C = γ+1 positions of
    ``tokens`` (B, C) = [current token, γ draft proposals] in one pass,
    row b's chunk at absolute positions ``index[b] .. index[b] + C - 1``.
    K/V goes into the paged pool through ``block_table`` (B, NB), in place;
    ``write_mask`` (B, C) sends inactive rows and positions at or past a
    row's limit to the trash page.  Sliding-window layers score each query
    against the ring a sequential decode would hold and leave the ring as
    it was; their chunk K/V (leaves (n_super, B, C, KV, hd)) goes under
    ``"pending"`` for the deferred ring commit.  Mamba and RWKV6 layers
    replay the chunk as C decode steps into a (C+1)-deep checkpoint ring
    per layer (entry 0 the pre-round state), which the returned cache
    carries under ``"pending"`` too; their state leaves are not written
    here.  :func:`lm_spec_commit` resolves both.  Returns (logits
    (B, C, V), cache)."""
    B, C = tokens.shape
    index = torch.as_tensor(index, device=tokens.device).long()
    if index.ndim == 0:
        index = index.expand(B)
    pos = index[:, None] + torch.arange(C, device=tokens.device)[None, :]
    params = _materialize_top(params, cfg)
    x = _embed_lookup(params, cfg, tokens)
    if cfg.position == "absolute":
        x = x + _pos_embed(params, pos)
    rings = {}                 # leaves (n_super, C+1, B, ...)
    pend = {}                  # leaves (n_super, B, C, KV, hd)
    for i in range(cfg.pattern_period):
        ln = f"layer{i}"
        if ln in cache and cfg.layer_kind(i) != "attn":
            rings[ln] = {k: t.new_empty((t.shape[0], C + 1) + t.shape[1:])
                         for k, t in cache[ln].items()}
        elif ln in cache and _is_ring(cfg, i):
            pend[ln] = {k: t.new_empty(t.shape[:2] + (C,) + t.shape[3:])
                        for k, t in cache[ln].items()}
    for s in range(num_superblocks(params)):
        sb = _block(params, cfg, s)
        cache_sb = _tree_index(cache, s)
        for i in range(cfg.pattern_period):
            ln = f"layer{i}"
            if ln in rings:
                x = _replay_layer(sb[ln], cache_sb[ln],
                                  _tree_index(rings[ln], s), cfg, i, x)
                continue
            x, _ = _verify_layer(sb[ln], cache_sb[ln],
                                 _tree_index(pend[ln], s) if ln in pend
                                 else {}, cfg, i, x, index,
                                 _mrope_ids(cfg, pos), block_table,
                                 write_mask)
    out = dict(cache)
    for ln, ring in {**rings, **pend}.items():
        out[ln] = {**cache[ln], "pending": ring}
    return _head(params, cfg, x), out


def lm_spec_commit(cache, index, acc):
    """Resolve a verify forward's deferred per-row advances for the ``acc``
    accepted tokens of each row, in place, and drop the ``pending``
    entries.  Sliding-window layers commit the accepted prefix of their
    chunk K/V into their rings (``attn.spec_ring_commit``).  Mamba and
    RWKV6 layers write checkpoint ``acc[b]`` of their ring into row b's
    state (entry 0 is the pre-round state, so ``acc == 0``, an inactive
    row, is an exact freeze).  Paged pool leaves pass through: rejected
    positions there lie past the rewound cursor (never read, always
    rewritten first), so rollback costs them nothing."""
    rows = torch.arange(acc.shape[0], device=acc.device)
    out = {}
    for ln, lc in cache.items():
        if "pending" in lc:
            lc = dict(lc)
            pend = lc.pop("pending")
            if "k" in lc and "k" in pend:      # a ring's chunk K/V
                attn.spec_ring_commit(lc["k"], lc["v"], pend["k"],
                                      pend["v"], index, acc)
            else:
                for key, ck in pend.items():   # (n_super, C+1, B, ...)
                    lc[key].copy_(ck[:, acc, rows])
        out[ln] = lc
    return out
