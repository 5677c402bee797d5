"""Encoder-decoder transformer, the whisper backbone
(``repro/models/encdec.py``).

The audio conv frontend is a stub: callers supply precomputed frame
embeddings (B, T_enc, d_model).  Encoder layers are bidirectional
self-attention; decoder layers are causal self-attention, cross-attention
over every encoder frame and the feed-forward.  Both stacks keep the
reference's tree: ``enc_blocks`` and ``blocks`` hold one layer's dict a
slice of a leading stacked axis (no super-block keys), so depth expansion
stays a concat on dim 0 for both.  Self- and cross-attention run through
the flash kernels on the card (the cross-attention non-causal at
S_k = T_enc != S_q); decoding attends over the precomputed cross K/V with
the plain einsum math, as the reference does.

On a mesh (``distributed.context``) every layer takes the decoder-only
rules: self- and cross-attention on the rank's heads (``attn_tp``: the
encoder output enters the cross-attention through ``copy_to_model``, each
rank's heads giving it a partial gradient), the feed-forward on the
rank's d_ff columns (``mlp_tp``), the tied embedding, head and loss on
its vocab rows (``vocab_tp``); the decode cache's cross K/V hold the
rank's KV heads.  Each layer's held shards are gathered for that layer
alone (``materialize``), the top leaves once.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import materialize
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer
from repro_torch.models.common import (apply_norm, embed_init, norm_init,
                                       normal, resolve_device,
                                       sinusoidal_positions)
from repro_torch.tree import leaves_with_path, tree_map

# The top leaves the encoder reads; the decoder reads the others.
_ENC_TOP = ("enc_pos", "enc_final_norm")


def _enc_layer_init(generator, cfg: ModelConfig, dtype, device):
    return {"ln1": norm_init(cfg.d_model, cfg.norm, device),
            "attn": attn.attn_init(generator, cfg, dtype, device),
            "ln2": norm_init(cfg.d_model, cfg.norm, device),
            "mlp": mlp_mod.mlp_init(generator, cfg, dtype, device=device)}


def _dec_layer_init(generator, cfg: ModelConfig, dtype, device):
    return {"ln1": norm_init(cfg.d_model, cfg.norm, device),
            "self_attn": attn.attn_init(generator, cfg, dtype, device),
            "ln_x": norm_init(cfg.d_model, cfg.norm, device),
            "cross_attn": attn.attn_init(generator, cfg, dtype, device),
            "ln2": norm_init(cfg.d_model, cfg.norm, device),
            "mlp": mlp_mod.mlp_init(generator, cfg, dtype, device=device)}


def encoder_depth(cfg: ModelConfig, num_layers: int) -> int:
    """The encoder's depth at decoder depth ``num_layers``: it scales with
    it, num_encoder_layers · L / num_layers, as the reference scales it."""
    return cfg.num_encoder_layers * num_layers // max(cfg.num_layers, 1)


def _stack(init, n: int):
    return transformer._stack_superblocks(
        [dict(leaves_with_path(init())) for _ in range(n)])


def encdec_init(generator, cfg: ModelConfig, dtype=torch.float32,
                num_layers=None, device="cuda"):
    """``num_layers`` is the decoder's depth (default cfg.num_layers); the
    encoder's is ``encoder_depth``.  Draws come from ``generator`` in a
    fixed order (embedding, positions, encoder layers, decoder layers), so
    a seed fixes the weights on every device; the values differ from the
    reference's threefry draws.  ``enc_pos`` is the sinusoidal table."""
    L = cfg.num_layers if num_layers is None else num_layers
    Le = encoder_depth(cfg, L)
    dev = torch.device(device)
    params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                            device),
        "pos_embed": normal(generator, (cfg.max_seq_len, cfg.d_model), 0.01,
                            dtype, device),
        "enc_pos": (torch.empty((cfg.encoder_seq_len, cfg.d_model),
                                dtype=dtype, device=dev)
                    if dev.type == "meta" else sinusoidal_positions(
                        cfg.encoder_seq_len, cfg.d_model, dev).to(dtype)),
        "enc_final_norm": norm_init(cfg.d_model, cfg.norm, device),
        "final_norm": norm_init(cfg.d_model, cfg.norm, device),
    }
    if Le > 0:
        params["enc_blocks"] = _stack(
            lambda: _enc_layer_init(generator, cfg, dtype, device), Le)
    if L > 0:
        params["blocks"] = _stack(
            lambda: _dec_layer_init(generator, cfg, dtype, device), L)
    return params


def _cross_kv(p, cfg: ModelConfig, enc_out):
    """The cross-attention's K and V of ``enc_out`` (B, T_enc, D): each
    (B, T_enc, KV, hd)."""
    shape = enc_out.shape[:2] + (cfg.num_kv_heads, cfg.head_dim)
    return ((enc_out @ p["wk"]).reshape(shape),
            (enc_out @ p["wv"]).reshape(shape))


@attn._tensor_parallel(sources=1)
def _cross_attend(p, cfg: ModelConfig, x, enc_out):
    """Decoder-to-encoder attention: full and non-causal, over every one of
    the T_enc frames (the flash kernel at S_k = T_enc on the card)."""
    q = (x @ p["wq"]).reshape(x.shape[:2] + (cfg.num_heads, cfg.head_dim))
    k, v = _cross_kv(p, cfg, enc_out)
    out = fa_ops.flash_attention(q, k, v, causal=False, window=0)
    return out.reshape(x.shape[:2] + (cfg.q_dim,)) @ p["wo"]


@attn._tensor_parallel
def _cross_decode(p, cfg: ModelConfig, x, k, v):
    """One new token a row (x (B, 1, D)) over the cached cross K/V, every
    frame valid, with the plain masked-attention math."""
    B = x.shape[0]
    q = (x @ p["wq"]).reshape(B, 1, cfg.num_heads, cfg.head_dim)
    valid = torch.ones((B, 1, k.shape[1]), dtype=torch.bool,
                       device=x.device)
    y = paged_ref.masked_gqa_attention(q, k, v, valid)
    return y.reshape(B, 1, cfg.q_dim) @ p["wo"]


def _layers(stack):
    """The layers of a stacked tree, each a dict of views."""
    n = next(t for _, t in leaves_with_path(stack)).shape[0]
    return [tree_map(lambda x: x[i], stack) for i in range(n)]


def _layer(lp, cfg: ModelConfig, stack: str):
    """One layer's leaves as its layers use them (its held shards gathered
    for it alone, ``materialize``)."""
    return materialize(lp, cfg, (stack,))


def _decoder_top(params, cfg: ModelConfig):
    """``params`` with the decoder's top leaves (embedding, positions,
    final norm) as the layers use them."""
    top = {k: v for k, v in params.items()
           if k not in _ENC_TOP + ("enc_blocks", "blocks")}
    return {**params, **materialize(top, cfg)}


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_enc, D) stub frontend embeddings -> encoder output,
    through bidirectional self-attention (``attn_apply(causal=False)``)."""
    top = materialize({k: params[k] for k in _ENC_TOP}, cfg)
    T = frames.shape[1]
    x = frames + top["enc_pos"][:T]
    if "enc_blocks" in params:
        positions = torch.arange(T, device=x.device)[None, :]
        for lp in _layers(params["enc_blocks"]):
            lp = _layer(lp, cfg, "enc_blocks")
            h = apply_norm(lp["ln1"], x, cfg.norm)
            x = x + attn.attn_apply(lp["attn"], cfg, h, positions, window=0,
                                    causal=False)
            h = apply_norm(lp["ln2"], x, cfg.norm)
            x = x + mlp_mod.mlp_apply_tp(lp["mlp"], cfg, h)
    return apply_norm(top["enc_final_norm"], x, cfg.norm)


def encdec_apply(params, cfg: ModelConfig, tokens, frames, remat=False,
                 whole_vocab: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S); frames: (B, T_enc, D).  Returns (logits (B, S, V),
    aux = 0).  ``remat`` checkpoints each decoder layer, as the reference
    checkpoints its scan body (on a training mesh the layer's shards are
    gathered inside it, again in the backward); ``whole_vocab=False``
    leaves vocab-parallel logits on the rank's vocab columns."""
    enc_out = encode(params, cfg, frames)
    params = _decoder_top(params, cfg)
    S = tokens.shape[1]
    x = transformer.embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, device=x.device)[None, :]

    def body(lp, x):
        lp = _layer(lp, cfg, "blocks")
        h = apply_norm(lp["ln1"], x, cfg.norm)
        x = x + attn.attn_apply(lp["self_attn"], cfg, h, positions, window=0)
        h = apply_norm(lp["ln_x"], x, cfg.norm)
        x = x + _cross_attend(lp["cross_attn"], cfg, h, enc_out)
        h = apply_norm(lp["ln2"], x, cfg.norm)
        return x + mlp_mod.mlp_apply_tp(lp["mlp"], cfg, h)

    policy = transformer.remat_policy(remat)
    if policy is not None and torch.is_grad_enabled():
        body = transformer._checkpointed(body, policy)
    if "blocks" in params:
        for lp in _layers(params["blocks"]):
            x = body(lp, x)
    return (transformer._head(params, cfg, x, whole_vocab),
            torch.zeros((), device=x.device))


def encdec_loss(params, cfg: ModelConfig, tokens, labels, frames, mask=None,
                remat=False):
    """Returns (loss, {"ce": loss, "aux": 0})."""
    logits, aux = encdec_apply(params, cfg, tokens, frames, remat=remat,
                               whole_vocab=False)
    loss = transformer.token_loss(logits, cfg, labels, mask)
    return loss, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def encdec_init_cache(params, cfg: ModelConfig, batch: int, max_len: int,
                      enc_out: torch.Tensor, dtype=torch.bfloat16,
                      device="cuda"):
    """Per decoder layer (leading stacked axis): the self-attention's K/V
    cache (``attn.init_kv_cache``) and the cross-attention's K/V of
    ``enc_out`` (B, T_enc, D), computed once here; on a mesh both hold
    the rank's KV heads (``attn.cache_cfg``)."""
    if "blocks" not in params:
        return {}
    dev = resolve_device(device)
    layers = _layers(params["blocks"])
    self_one = attn.init_kv_cache(attn.cache_cfg(cfg), batch, max_len, dtype,
                                  device="meta")
    cache = {"self": {k: torch.zeros((len(layers),) + tuple(t.shape),
                                     dtype=dtype, device=dev)
                      for k, t in self_one.items()}}
    kv = [_cross_kv(*attn.head_params(materialize(
              lp["cross_attn"], cfg, ("blocks", "cross_attn")), cfg), enc_out)
          for lp in layers]
    for i, key in enumerate(("cross_k", "cross_v")):
        cache[key] = torch.stack([t[i] for t in kv]).to(device=dev,
                                                        dtype=dtype)
    return cache


def encdec_decode_step(params, cfg: ModelConfig, tokens, cache, index):
    """tokens: (B, 1) -> (logits (B, 1, V), cache), the self-attention
    caches written in place.  ``index`` (B,) is each row's decode cursor
    (a scalar broadcasts).  The cross-attention attends over the cached
    encoder K/V with the plain masked-attention math, every frame valid."""
    B = tokens.shape[0]
    index = torch.as_tensor(index, device=tokens.device).long()
    if index.ndim == 0:
        index = index.expand(B)
    params = _decoder_top(params, cfg)
    x = transformer._embed_lookup(params, cfg, tokens) \
        + transformer._pos_embed(params, index)[:, None, :]
    positions = index[:, None]
    if "blocks" in params:
        for i, lp in enumerate(_layers(params["blocks"])):
            lp = _layer(lp, cfg, "blocks")
            c = tree_map(lambda t: t[i], cache)
            h = apply_norm(lp["ln1"], x, cfg.norm)
            y, _ = attn.attn_decode(lp["self_attn"], cfg, h, c["self"], index,
                                    positions, window=0)
            x = x + y
            h = apply_norm(lp["ln_x"], x, cfg.norm)
            x = x + _cross_decode(lp["cross_attn"], cfg, h,
                                  c["cross_k"].to(x.dtype),
                                  c["cross_v"].to(x.dtype))
            h = apply_norm(lp["ln2"], x, cfg.norm)
            x = x + mlp_mod.mlp_apply_tp(lp["mlp"], cfg, h)
    return transformer._head(params, cfg, x), cache
