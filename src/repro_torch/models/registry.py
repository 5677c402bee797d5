"""Model facade: the uniform init/apply/cache/decode/prefill handles over
the model zoo (``repro/models/registry.py``), and ``ParamModule``, the
``nn.Module`` that holds a parameter tree so ``.to(device)`` and
``state_dict()`` work on it."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Callable        # (generator, cfg, dtype=..., num_layers=None, device=...) -> params
    # (params, cfg, batch, remat=False) -> (loss, {"ce", "aux"}); batch
    # holds tokens, labels and optionally mask.
    loss: Callable
    apply: Callable       # (params, cfg, tokens) -> (logits, aux)
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
                               mask=batch.get("mask"), remat=remat)


# What each model family of the reference registry still waits for.
_FAMILY_WAITS_FOR = {
    "moe": "MLA latent attention (queue A item 12)",
    "audio": "the encoder-decoder model (queue A item 12)",
    "vlm": "M-RoPE and frontend embeds (queue A item 12)",
}


def _ported(cfg: ModelConfig) -> bool:
    """Dense decoders, MoE decoders without MLA, Mamba/attention hybrids
    (with MoE feed-forwards), and all-recurrent (RWKV6 or Mamba) stacks."""
    if cfg.is_encoder_decoder:
        return False
    if cfg.family == "moe":
        return cfg.attention != "mla"
    return cfg.family in ("dense", "hybrid") or (
        cfg.family == "ssm"
        and all(b in ("rwkv", "mamba") for b in cfg.block_pattern))


def get_model(cfg: ModelConfig) -> ModelApi:
    if not _ported(cfg):
        waits = _FAMILY_WAITS_FOR.get(
            "audio" if cfg.is_encoder_decoder else cfg.family,
            "its ROADMAP queue A item")
        raise NotImplementedError(
            f"ROADMAP: {cfg.name} (family {cfg.family!r}) is not ported yet; "
            f"it waits for {waits}")
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
