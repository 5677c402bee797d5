"""Serving steps (``repro/train/steps.py``: ``_sample``,
``make_prefill_step``, ``make_serve_decode_step`` with its masked and paged
continuous-batching forms, and the admit and chunked-prefill steps).

The reference jits each step and donates the cache; here each step is a
plain callable run under ``torch.inference_mode()`` that writes the cache
in place.  The sampled token, the cursor and the generator stay on the
step's device, so the decode loop never waits for the host.  The small
per-row state a step hands back (tokens, active) is always a new tensor:
the continuous scheduler still holds the previous step's pair when it
dispatches the next one (dispatch-then-fetch), as the reference leaves
those buffers undonated.
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
        # The head sees the last position only: no (B, P, V) logits.
        last, cache = api.prefill(params, cfg, prompts, cache,
                                  last_only=True)
        nxt = _sample(last[:, 0], temp, generator, sample)
        index = torch.full((prompts.shape[0],), prompts.shape[1],
                           dtype=torch.long, device=prompts.device)
        return nxt[:, None], last, cache, index

    return step


def _is_paged_leaf(path) -> bool:
    """Pool leaves (k_pages/v_pages) have no batch dim: per-row admit logic
    skips them (their per-row no-op is the trash-page write redirect
    inside ``attn_decode_paged``).  ``path`` is a tuple of dict keys."""
    return any(k in ("k_pages", "v_pages") for k in path)


def _leaves(tree, path=()):
    """(path, tensor) pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def make_serve_decode_step(cfg: ModelConfig, sample: bool = False,
                           masked: bool = False,
                           paged: bool = False) -> Callable:
    """Fused decode + sampling.

    Batch to completion (``masked=False``):
        (params, token (B,1), cache, index (B,), temp, generator) ->
            (next_token (B,1), logits (B,1,V), cache, index + 1)

    Continuous batching (``masked=True``):
        (params, token (B,1), cache, index (B,), active (B,) bool,
         limit (B,), eos, temp, generator[, table (B,NB)]) ->
            (next_token (B,1), logits (B,1,V), cache, index', active')

    Inactive rows are exact no-ops: their sampled token is 0, their cursor
    does not advance, and their cache is left as it was (contiguous rows
    write their slot's old value back; paged rows write to the trash page).
    A row deactivates itself when it samples ``eos`` (-1 disables) or when
    its cursor reaches its ``limit`` (= prompt_len + max_new_tokens - 1;
    the prefill emits token #1).  Logits of inactive rows are garbage.
    With ``paged=True`` (masked only) attention reads and writes the shared
    pool through ``table``.  ``next_token``, ``index'`` and ``active'`` are
    new tensors; the inputs are never written."""
    api = registry.get_model(cfg)
    if paged and not masked:
        raise ValueError("paged decode is the continuous (masked) path")

    if not masked:
        @torch.inference_mode()
        def step(params, tokens, cache, index, temp, generator):
            logits, cache = api.decode_step(params, cfg, tokens, cache,
                                            index)
            nxt = _sample(logits[:, -1], temp, generator, sample)
            return nxt[:, None], logits, cache, index + 1
        return step

    @torch.inference_mode()
    def masked_step(params, tokens, cache, index, active, limit, eos, temp,
                    generator, table=None):
        kw = dict(write_mask=active)
        if paged:
            kw["block_table"] = table
        logits, cache = api.decode_step(params, cfg, tokens, cache, index,
                                        **kw)
        nxt = _sample(logits[:, -1], temp, generator, sample)
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        new_index = index + active.to(index.dtype)
        new_active = active & (nxt != eos) & (new_index < limit)
        return nxt[:, None], logits, cache, new_index, new_active

    return masked_step


def _set_row(tokens, index, active, limit, row: int, row_tok, row_len: int,
             row_limit: int):
    """Arm slot ``row``: first token, cursor = prompt length, limit, and
    active iff the budget leaves a decode step (max_new == 1 admits an
    already finished row, which stays inactive).  tokens/active come back
    as new tensors (the overlapped fetch may hold the old ones); the cursor
    and limit are written in place."""
    tokens = tokens.clone()
    tokens[row] = row_tok[0].to(tokens.dtype)
    active = active.clone()
    active[row] = row_len < row_limit
    index[row] = row_len
    limit[row] = row_limit
    return tokens, index, active, limit


def make_admit_step() -> Callable:
    """(cache, tokens, index, active, limit, row_cache, row_tok (1,1),
        row_len, row_limit, row) -> (cache, tokens, index, active, limit).

    Scatters ONE freshly prefilled request (a B=1 contiguous cache + its
    first sampled token) into batch slot ``row`` of the live decode state.
    The cache row is overwritten whole, in place; other rows are never
    touched, so admission never perturbs requests in flight."""

    @torch.inference_mode()
    def admit(cache, tokens, index, active, limit, row_cache, row_tok,
              row_len: int, row_limit: int, row: int):
        rows = dict(_leaves(row_cache))
        for path, big in _leaves(cache):
            big[:, row] = rows[path][:, 0].to(big.dtype)
        return (cache,) + _set_row(tokens, index, active, limit, row,
                                   row_tok, row_len, row_limit)

    return admit


def make_prefill_chunk_step(cfg: ModelConfig, final: bool = False,
                            sample: bool = False) -> Callable:
    """One chunked-prefill step over the paged serve state.

    Non-final chunk:
        (params, tokens (1,C), cache, carry, table_row (1,NB), ctx_len,
         temp, generator) -> (cache, carry)
    Final chunk also samples the request's first token on the device:
        (...) -> (first_token (1,1), cache, carry)

    ``cache`` is the live batch's pool: the chunk writes its K/V straight
    into it through the request's block-table row, so admission never
    copies pages.  ``carry`` is the request's B=1 per-row state."""
    api = registry.get_model(cfg)
    if api.prefill_chunk is None:
        raise NotImplementedError(f"{cfg.name}: no chunked-prefill path")

    @torch.inference_mode()
    def step(params, tokens, cache, carry, table, ctx_len: int, temp,
             generator):
        logits, cache, carry = api.prefill_chunk(params, cfg, tokens, cache,
                                                 carry, table, ctx_len)
        if not final:
            return cache, carry
        nxt = _sample(logits[:, 0], temp, generator, sample)
        return nxt[:, None], cache, carry

    return step


def make_paged_admit_step() -> Callable:
    """(cache, tokens, index, active, limit, carry, row_tok (1,1), row_len,
        row_limit, row) -> (cache, tokens, index, active, limit).

    Paged admission: the request's pages are already in the pool (chunked
    prefill wrote them through the block table), so only the small per-row
    state moves.  Every per-row cache leaf is zeroed at ``row`` and then
    overwritten by the carry where the carry covers it, so a readmitted
    slot is byte-identical to a fresh one; pool leaves are untouched."""

    @torch.inference_mode()
    def admit(cache, tokens, index, active, limit, carry, row_tok,
              row_len: int, row_limit: int, row: int):
        rows = dict(_leaves(carry))
        for path, big in _leaves(cache):
            if _is_paged_leaf(path):
                continue
            big[:, row] = 0
            if path in rows:
                big[:, row] = rows[path][:, 0].to(big.dtype)
        return (cache,) + _set_row(tokens, index, active, limit, row,
                                   row_tok, row_len, row_limit)

    return admit
