"""Model facade: the uniform init/apply/cache/decode/prefill handles over
the model zoo (``repro/models/registry.py``), ``ParamModule``, the
``nn.Module`` that holds a parameter tree so ``.to(device)`` and
``state_dict()`` work on it, and ``input_specs``/``decode_input_specs``
(meta-tensor stand-ins for the dry run; nothing is allocated)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Callable        # (generator, cfg, dtype=..., num_layers=None, device=...) -> params
    # (params, cfg, batch, remat=False) -> (loss, {"ce", "aux"}); batch
    # holds tokens, labels and optionally mask, a frontend's embeds (the
    # loss then covers the text tail) or an encoder-decoder's frames.
    loss: Callable
    # (params, cfg, tokens, embeds=None) -> (logits, aux); an
    # encoder-decoder's (params, cfg, tokens, frames).
    apply: Callable
    init_cache: Callable  # (params, cfg, batch_size, max_len, dtype, device) -> cache
    # (params, cfg, tokens(B,1), cache, index(B,)) -> (logits, cache); the
    # cache is written in place.
    decode_step: Callable
    # (params, cfg, tokens, cache, last_only=False) -> (logits (B,S,V) or
    # (B,1,V), cache ready for decode at per-row cursor = prompt length).
    prefill: Optional[Callable] = None
    # (params, cfg, batch_size, num_blocks, block_size, max_len, dtype,
    #  kv_dtype, device) -> paged serve cache (pool + trash page).
    init_paged_cache: Optional[Callable] = None
    # (params, cfg, max_len, dtype, device) -> B=1 chunked-prefill carry.
    init_prefill_carry: Optional[Callable] = None
    # (params, cfg, tokens(B,C), cache, carry, block_table, ctx_len) ->
    # (last logits (B,1,V), cache, carry); the pool is written in place.
    prefill_chunk: Optional[Callable] = None
    # (params, cfg, tokens(B,C), cache, index(B,), block_table(B,NB),
    #  write_mask(B,C)) -> (logits (B,C,V), cache): the speculative verify.
    verify: Optional[Callable] = None
    # (cache, index(B,), acc(B,)) -> cache: commit each row's accepted prefix.
    spec_commit: Optional[Callable] = None


def _lm_loss(params, cfg, batch, remat=False):
    return transformer.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                               embeds=batch.get("embeds"),
                               mask=batch.get("mask"), remat=remat)


def _encdec_loss(params, cfg, batch, remat=False):
    return encdec.encdec_loss(params, cfg, batch["tokens"], batch["labels"],
                              batch["frames"], mask=batch.get("mask"),
                              remat=remat)


def _encdec_init_cache(params, cfg, batch_size, max_len, dtype=torch.bfloat16,
                       device="cuda", enc_out=None):
    """The decoder's caches over ``enc_out`` (zeros of (B, T_enc, D) when
    none is given, as the reference defaults it)."""
    if enc_out is None:
        enc_out = torch.zeros((batch_size, cfg.encoder_seq_len, cfg.d_model),
                              dtype=dtype, device=device)
    return encdec.encdec_init_cache(params, cfg, batch_size, max_len,
                                    enc_out, dtype, device)


def get_model(cfg: ModelConfig) -> ModelApi:
    """Every architecture of the reference registry.  An encoder-decoder
    (whisper) has the reference's narrower API: no prefill, no paged or
    speculative serving, so ``ServeEngine`` refuses it; its ``apply`` takes
    ``(params, cfg, tokens, frames)`` and its batches carry ``frames``."""
    if cfg.is_encoder_decoder:
        return ModelApi(init=encdec.encdec_init, loss=_encdec_loss,
                        apply=encdec.encdec_apply,
                        init_cache=_encdec_init_cache,
                        decode_step=encdec.encdec_decode_step)
    return ModelApi(init=transformer.lm_init, loss=_lm_loss,
                    apply=transformer.lm_apply,
                    init_cache=transformer.lm_init_cache,
                    decode_step=transformer.lm_decode_step,
                    prefill=transformer.lm_prefill,
                    init_paged_cache=transformer.lm_init_paged_cache,
                    init_prefill_carry=transformer.lm_init_prefill_carry,
                    prefill_chunk=transformer.lm_prefill_chunk,
                    verify=transformer.lm_verify,
                    spec_commit=transformer.lm_spec_commit)


class ParamModule(nn.Module):
    """Holds a nested dict of tensors as frozen parameters of nested
    modules, so ``state_dict()`` keys follow the tree ('blocks.layer0.
    attn.wq') and ``.to()`` moves every leaf.  ``tree()`` returns the dict
    the model functions take, sharing storage with the module."""

    def __init__(self, params: dict):
        super().__init__()
        for key, val in params.items():
            if isinstance(val, dict):
                self.add_module(key, ParamModule(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(torch.as_tensor(val),
                                      requires_grad=False))

    def tree(self) -> dict:
        out = {name: p for name, p in self.named_parameters(recurse=False)}
        for name, child in self.named_children():
            out[name] = child.tree()
        return out


# ---------------------------------------------------------------------------
# Dry-run input specs (meta tensors: never allocates)
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Inputs for a train step or a prefill, the reference's shapes and
    dtypes: int32 tokens and labels, an encoder-decoder's f32 frames, and
    a frontend's f32 embeds (the patch or frame embeddings supplied
    directly) ahead of a shorter text."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32
    if cfg.is_encoder_decoder:
        return {"tokens": _meta((B, S), tok), "labels": _meta((B, S), tok),
                "frames": _meta((B, cfg.encoder_seq_len, cfg.d_model),
                                torch.float32)}
    specs = {}
    s_text = S
    if cfg.frontend != "none" and cfg.num_frontend_embeds > 0:
        s_text = S - cfg.num_frontend_embeds
        specs["embeds"] = _meta((B, cfg.num_frontend_embeds, cfg.d_model),
                                torch.float32)
    specs["tokens"] = _meta((B, s_text), tok)
    specs["labels"] = _meta((B, s_text), tok)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Inputs for one serve step: a single new token and the per-row
    cursor."""
    B = shape.global_batch
    return {"tokens": _meta((B, 1), torch.int32),
            "index": _meta((B,), torch.int32)}
