"""Serving steps (``repro/train/steps.py``: ``_sample``,
``make_prefill_step`` and the batch-to-completion ``make_serve_decode_step``).

The reference jits each step and donates the cache; here each step is a
plain callable run under ``torch.inference_mode()`` that writes the cache
in place.  The sampled token, the cursor and the generator stay on the
step's device, so the decode loop never waits for the host.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry


def _sample(logits, temp: Optional[float], generator: Optional[torch.Generator],
            sample: bool):
    """logits (B, V) -> next token (B,) int64.  Greedy is argmax (first
    maximum, as ``jnp.argmax``).  Sampling draws from softmax(logits / temp)
    with ``generator``; its draws are not the reference's
    ``jax.random.categorical`` bits, only the same distribution."""
    if not sample:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temp, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def make_prefill_step(cfg: ModelConfig, sample: bool = False) -> Callable:
    """(params, prompts (B,P), cache, temp, generator) ->
           (next_token (B,1), last_logits (B,1,V), cache, index (B,)).

    One forward fills the whole cache and samples the first generated
    token; ``index`` is the per-row decode cursor (= P)."""
    api = registry.get_model(cfg)
    if api.prefill is None:
        raise NotImplementedError(f"{cfg.name}: no prefill path for this arch")

    @torch.inference_mode()
    def step(params, prompts, cache, temp, generator):
        logits, cache = api.prefill(params, cfg, prompts, cache)
        last = logits[:, -1:]
        nxt = _sample(last[:, 0], temp, generator, sample)
        index = torch.full((prompts.shape[0],), prompts.shape[1],
                           dtype=torch.long, device=prompts.device)
        return nxt[:, None], last, cache, index

    return step


def make_serve_decode_step(cfg: ModelConfig, sample: bool = False) -> Callable:
    """Fused decode + sampling, batch to completion:
        (params, token (B,1), cache, index (B,), temp, generator) ->
            (next_token (B,1), logits (B,1,V), cache, index + 1)."""
    api = registry.get_model(cfg)

    @torch.inference_mode()
    def step(params, tokens, cache, index, temp, generator):
        logits, cache = api.decode_step(params, cfg, tokens, cache, index)
        nxt = _sample(logits[:, -1], temp, generator, sample)
        return nxt[:, None], logits, cache, index + 1

    return step
