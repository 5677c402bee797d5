"""Train, eval and serving steps (``repro/train/steps.py``:
``make_train_step``, ``make_eval_step``, ``_sample``, ``make_prefill_step``,
``make_serve_decode_step`` with its masked and paged continuous-batching
forms, and the admit and chunked-prefill steps).

The train step takes gradients with autograd and lets the optimizer write
params and moments in place, where the reference jits the step and donates
them.  The reference jits each serving step and donates the cache; here
each serving step is a plain callable run under ``torch.inference_mode()``
that writes the cache in place.  The sampled token, the cursor and the generator stay on the
step's device, so the decode loop never waits for the host.  The small
per-row state a step hands back (tokens, active) is always a new tensor:
the continuous scheduler still holds the previous step's pair when it
dispatches the next one (dispatch-then-fetch), as the reference leaves
those buffers undonated.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.optim.base import Optimizer
from repro_torch.tree import leaves_with_path

_SENTINELS = ("ROADMAP queue A item 11 (fault tolerance): the train step's "
              "sentinels and NaN injection are not ported yet")
_REMAT = ("ROADMAP queue A item 15 (activation checkpointing): remat={remat!r} "
          "is not ported yet; the port trains with remat off")


def _microbatch(batch, grad_accum: int):
    """(B, ...) -> grad_accum microbatches of B/grad_accum rows, in order
    (the reference's reshape to (grad_accum, B/grad_accum, ...))."""
    out = []
    for i in range(grad_accum):
        mb = {}
        for k, x in batch.items():
            b = x.shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} not divisible by grad_accum "
                                 f"{grad_accum}")
            n = b // grad_accum
            mb[k] = x[i * n:(i + 1) * n]
        out.append(mb)
    return out


def make_train_step(cfg: ModelConfig, opt: Optimizer, schedule: Callable,
                    remat=False, grad_accum: int = 1,
                    sentinels: bool = False, inject=None) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    The schedule is evaluated inside the step from the global step counter
    (float32), so the same schedule spans the expansion boundary.  With
    ``grad_accum > 1`` the batch is split into ``grad_accum`` microbatches
    whose gradients, losses and metrics are summed in order and scaled by
    1/grad_accum, as the reference's scan does.  Gradients are taken with
    respect to the stacked param leaves themselves (detached aliases that
    share their storage), and the optimizer updates those leaves in place.
    Metrics: loss, lr, ce, aux (0-d tensors on the params' device)."""
    if remat not in (False, None, "off"):
        raise NotImplementedError(_REMAT.format(remat=remat))
    if sentinels or inject:
        raise NotImplementedError(_SENTINELS)
    api = registry.get_model(cfg)

    def loss_and_grads(flat, batch):
        leaves = {k: v.detach().requires_grad_() for k, v in flat.items()}
        with torch.enable_grad():
            loss, metrics = api.loss(bridge.unflatten(leaves), cfg, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves.values())]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def step_fn(params, opt_state, batch, step):
        flat = bridge.flatten(params)
        dev = next(iter(flat.values())).device
        lr = schedule(step).to(dev)
        if grad_accum <= 1:
            loss, metrics, grads = loss_and_grads(flat, batch)
        else:
            grads = [torch.zeros_like(p) for p in flat.values()]
            loss = torch.zeros((), device=dev)
            metrics = None
            for mb in _microbatch(batch, grad_accum):
                l, m, g = loss_and_grads(flat, mb)
                grads = [a + b for a, b in zip(grads, g)]
                loss = loss + l
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
            inv = 1.0 / grad_accum
            grads = [g * inv for g in grads]
            loss = loss * inv
            metrics = {k: v * inv for k, v in metrics.items()}
        grad_tree = bridge.unflatten(dict(zip(flat, grads)))
        params, opt_state = opt.update(grad_tree, opt_state, params, lr)
        return params, opt_state, {"loss": loss, "lr": lr, **metrics}

    return step_fn


def make_eval_step(cfg: ModelConfig) -> Callable:
    """(params, batch) -> mean cross entropy (0-d tensor), no autograd."""
    api = registry.get_model(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = api.loss(params, cfg, batch)
        return metrics["ce"]

    return eval_step


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
        rows = dict(leaves_with_path(row_cache))
        for path, big in leaves_with_path(cache):
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
        rows = dict(leaves_with_path(carry))
        for path, big in leaves_with_path(cache):
            if _is_paged_leaf(path):
                continue
            big[:, row] = 0
            if path in rows:
                big[:, row] = rows[path][:, 0].to(big.dtype)
        return (cache,) + _set_row(tokens, index, active, limit, row,
                                   row_tok, row_len, row_limit)

    return admit
