"""Train, eval and serving steps (``repro/train/steps.py``:
``make_train_step``, ``make_eval_step``, ``_sample``, ``make_prefill_step``,
``make_serve_decode_step`` with its masked and paged continuous-batching
forms, the admit, row-scatter and chunked-prefill steps, the copy-on-write
page copy, and self-speculative decoding's draft loop, verify and the
draft's recurrent rollback).

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

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.models import registry, transformer
from repro_torch.distributed.context import (MeshContext, dp_axes,
                                            leaf_sq_sum, mesh_scope)
from repro_torch.optim.base import Optimizer
from repro_torch.tree import leaves_with_path, tree_map


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


def _global_norm(paths, leaves) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in order, of float32 squared sums (on a
    mesh each leaf's sum over its whole: every element once)."""
    total = sum(leaf_sq_sum(path, torch.sum(torch.square(x.float())))
                for path, x in zip(paths, leaves))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _dp_mean(ctx: Optional[MeshContext], x: torch.Tensor) -> torch.Tensor:
    """A rank's mean over its rows -> the mean over the DP ranks' rows."""
    if ctx is None:
        return x
    axes = dp_axes(ctx.mesh, ctx.layout)
    n = ctx.mesh.axes_size(axes)
    if n == 1:
        return x
    return coll.all_reduce(x, ctx.mesh.group(axes)) * (1.0 / n)


def _scoped(ctx: Optional[MeshContext], fn: Callable) -> Callable:
    """``fn`` run under ``mesh_scope(ctx)`` (``fn`` itself without one)."""
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        with mesh_scope(ctx):
            return fn(*args, **kwargs)
    return run


def make_train_step(cfg: ModelConfig, opt: Optimizer, schedule: Callable,
                    remat=False, grad_accum: int = 1,
                    sentinels: bool = False, nan_policy: str = "warn",
                    spike_factor: float = 10.0,
                    inject: Optional[dict] = None,
                    mesh: Optional[MeshContext] = None) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    The schedule is evaluated inside the step from the global step counter
    (float32), so the same schedule spans the expansion boundary.  With
    ``grad_accum > 1`` the batch is split into ``grad_accum`` microbatches
    whose gradients, losses and metrics are summed in order and scaled by
    1/grad_accum, as the reference's scan does.  Gradients are taken with
    respect to the stacked param leaves themselves (detached aliases that
    share their storage), and the optimizer updates those leaves in place.
    Metrics: loss, lr, ce, aux (0-d tensors on the params' device).
    ``remat`` (False, True/'nothing' or 'dots') checkpoints each
    super-block of the loss forward (``transformer.lm_apply``); the step's
    loss, gradients and update are bit for bit those of remat off.

    With ``sentinels=True`` the step becomes ``(params, opt_state, batch,
    step, gnorm_ema) -> (..., metrics)`` and the metrics gain the
    reference's health scalars: ``grad_norm`` and ``update_norm`` (global
    L2 norms of the gradient and of new - old params), ``bad`` (1.0 for a
    non-finite loss or grad norm, or ``grad_norm > spike_factor *
    gnorm_ema`` once the EMA operand is > 0) and ``gnorm_ema`` (the
    updated EMA; a bad step leaves it).  The optimizer writes params and
    momenta in place, so ``bad`` is decided on the host BEFORE it runs:
    the loss and grad norm are read back (the engine reads the metrics
    every step anyway).  Under ``nan_policy`` 'skip' or 'rollback' a bad
    step then never touches params or momenta, which stay bit-identical to
    their pre-step values; its ``update_norm`` is that of the update it
    would have applied, computed on clones.  'warn' applies the update.
    A healthy step keeps one clone of the params for ``update_norm``.

    ``inject`` ({step: 'nan'|'spike'}) injects numerical faults at the
    named global steps: the loss and grads times NaN, or the grads times
    1e4.

    ``mesh`` (a ``MeshContext`` with the leaves' specs): params, moments
    and gradients are the rank's shards and ``batch`` its rows.  The
    forward gathers each super-block's shards (an encoder-decoder's each
    layer's; ``distributed.context.materialize``), the gradients come
    back all-reduced over the DP axes to the shards, the
    loss and metrics are means over the DP ranks, and the global norms
    count every element once."""
    transformer.remat_policy(remat)          # raises on an unknown knob
    api = registry.get_model(cfg)
    inject = dict(inject or {})

    def loss_and_grads(flat, batch):
        leaves = {k: v.detach().requires_grad_() for k, v in flat.items()}
        with torch.enable_grad():
            tree = bridge.unflatten(leaves)
            loss, metrics = api.loss(tree, cfg, batch, remat=remat)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves.values())]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def forward(params, batch, step):
        """(flat params, lr, loss, metrics, grads as a list in flat order)."""
        flat = bridge.flatten(params)
        dev = next(iter(flat.values())).device
        lr = schedule(step).to(dev)
        if grad_accum <= 1:
            loss, metrics, grads = loss_and_grads(flat, batch)
            return (flat, lr, _dp_mean(mesh, loss),
                    {k: _dp_mean(mesh, v) for k, v in metrics.items()},
                    grads)
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
        return (flat, lr, _dp_mean(mesh, loss * inv),
                {k: _dp_mean(mesh, v * inv) for k, v in metrics.items()},
                [g * inv for g in grads])

    def step_fn(params, opt_state, batch, step):
        flat, lr, loss, metrics, grads = forward(params, batch, step)
        grad_tree = bridge.unflatten(dict(zip(flat, grads)))
        params, opt_state = opt.update(grad_tree, opt_state, params, lr)
        return params, opt_state, {"loss": loss, "lr": lr, **metrics}

    def sentinel_fn(params, opt_state, batch, step, gnorm_ema):
        flat, lr, loss, metrics, grads = forward(params, batch, step)
        kind = inject.get(int(step))
        if kind == "nan":
            loss = loss * float("nan")
            grads = [g * float("nan") for g in grads]
        elif kind == "spike":
            grads = [g * 1e4 for g in grads]
        paths = [tuple(bridge.parse_keystr(k)) for k in flat]
        gnorm = _global_norm(paths, grads)
        loss_v, gnorm_v = torch.stack([loss.float(), gnorm]).cpu().numpy()
        ema = np.float32(gnorm_ema)
        ema_live = ema > 0.0
        bad = bool(not (np.isfinite(loss_v) and np.isfinite(gnorm_v))
                   or (ema_live and gnorm_v > np.float32(spike_factor) * ema))
        skip = bad and nan_policy in ("skip", "rollback")
        old = list(flat.values())
        if skip:       # the would-be update, on clones: nothing is written
            new_p, new_s = opt.update(
                bridge.unflatten(dict(zip(flat, grads))),
                tree_map(torch.clone, opt_state),
                tree_map(torch.clone, params), lr)
        else:
            old = [p.clone() for p in old]
            params, opt_state = new_p, new_s = opt.update(
                bridge.unflatten(dict(zip(flat, grads))), opt_state, params,
                lr)
        upd = _global_norm(paths, [n.float() - o.float() for n, o in
                                   zip(bridge.flatten(new_p).values(), old)])
        if bad:
            new_ema = ema
        elif ema_live:
            new_ema = np.float32(0.9) * ema + np.float32(0.1) * gnorm_v
        else:
            new_ema = gnorm_v
        return params, opt_state, {
            "loss": loss, "lr": lr, **metrics, "grad_norm": gnorm,
            "update_norm": upd, "bad": torch.tensor(float(bad)),
            "gnorm_ema": torch.tensor(new_ema, dtype=torch.float32)}

    return _scoped(mesh, sentinel_fn if sentinels else step_fn)


def make_eval_step(cfg: ModelConfig,
                   mesh: Optional[MeshContext] = None) -> Callable:
    """(params, batch) -> mean cross entropy (0-d tensor), no autograd; on
    a mesh (``make_train_step``'s) the mean over the DP ranks' rows."""
    api = registry.get_model(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = api.loss(params, cfg, batch)
        return _dp_mean(mesh, metrics["ce"])

    return _scoped(mesh, eval_step)


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
    """Pool leaves (k_pages/v_pages, MLA latent_pages and, under quantized
    storage, their per-slot scale leaves k_scales/v_scales/latent_scales)
    have no batch dim: per-row admit logic skips them (their per-row no-op
    is the trash-page write redirect inside ``attn_decode_paged``).
    Listing the scale leaves here keeps scales in lockstep with their
    pages: the copy-on-write clone copies them with the page, admission
    leaves them alone, and the pool's bytes a token count them.  ``path``
    is a tuple of dict keys."""
    return any(k in ("k_pages", "v_pages", "latent_pages", "k_scales",
                     "v_scales", "latent_scales") for k in path)


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

    scatter = make_row_scatter_step()

    @torch.inference_mode()
    def admit(cache, tokens, index, active, limit, row_cache, row_tok,
              row_len: int, row_limit: int, row: int):
        return (scatter(cache, row_cache, row),) + _set_row(
            tokens, index, active, limit, row, row_tok, row_len, row_limit)

    return admit


def make_row_scatter_step() -> Callable:
    """(cache, row_cache, row) -> cache.

    Writes a B=1 cache tree into batch slot ``row`` of ``cache`` (both
    stacked, batch on dim 1), in place: the contiguous admission's cache
    half, and the speculative admission's draft half (the target's paged
    admission owns tokens, cursor, active and limit)."""

    @torch.inference_mode()
    def scatter(cache, row_cache, row: int):
        rows = dict(leaves_with_path(row_cache))
        for path, big in leaves_with_path(cache):
            big[:, row] = rows[path][:, 0].to(big.dtype)
        return cache

    return scatter


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


def make_page_copy_step() -> Callable:
    """(cache, src, dst) -> cache.

    Copy-on-write clone: page ``src`` is copied into page ``dst`` in every
    pool leaf (pages and scales; page axis 1, after the superblock axis),
    in place; nothing else moves.  Used when a prefix-cache hit must write
    into its last shared page (the exact-boundary one-token rerun): a page
    with refcount > 1 is never written, the row writes its private clone
    instead.  A plain index copy, as in the reference."""

    @torch.inference_mode()
    def copy(cache, src: int, dst: int):
        for path, leaf in leaves_with_path(cache):
            if _is_paged_leaf(path):
                leaf[:, dst] = leaf[:, src]
        return cache

    return copy


# ---------------------------------------------------------------------------
# Self-speculative decoding (depth-truncated draft + multi-token verify)
# ---------------------------------------------------------------------------


def make_draft_loop_step(cfg: ModelConfig, gamma: int,
                         sample: bool = False, ring_layers=(),
                         rec_layers=()) -> Callable:
    """The draft loop of one speculation round: γ+1 masked draft decode
    steps over the draft's contiguous cache.

    Greedy:
        (draft_params, token (B,1), cache, index (B,), active (B,),
         generator) -> (verify_tokens (B, γ+1), cache, ring)
    Sampling also returns the draft's post-temperature proposal
    distributions, the verify's accept-ratio denominator:
        (draft_params, token, cache, index, active, temp, generator) ->
            (verify_tokens, probs (B, γ, V), cache, ring)

    Row b of ``verify_tokens`` is [current token, d_1 .. d_γ]: each step's
    input token, so the last step's proposal is dropped while its cache
    write still lands (no hole at ``cursor + γ`` after a fully accepted
    round).  Inactive rows are exact no-ops (``write_mask``: their slot is
    written back unchanged, their state kept, their cursor stays).  There
    is no eos or limit termination: the draft proposes unconditionally and
    the verify owns termination, so near a row's limit the draft runs
    positions past ``max_len`` and ``max_seq_len``; those writes drop and
    those position reads clamp (``attn_decode``, ``transformer._pos_embed``).
    A full-attention draft rolls back by its cursor alone: its slots past
    the accepted prefix are invalid until rewritten.  The layers named in
    ``ring_layers`` and ``rec_layers`` cannot, and ``ring`` holds copies of
    their state that the steps' in-place writes cannot touch, from which
    ``make_draft_rollback_step`` rewinds each row: for a sliding-window
    layer its ring buffers as of round start (leaves (n_super, B, W, KV,
    hd)); for a Mamba or RWKV6 layer a (γ+2)-deep checkpoint ring of its
    state (leaves (γ+2, n_super, B, ...); entry 0 the pre-round state,
    entry j the state after draft step j).  ``ring`` is {} without
    either."""
    api = registry.get_model(cfg)
    if gamma < 1:
        raise ValueError(f"gamma {gamma} < 1")

    def checkpoint(ring, cache, j: int):
        for ln in rec_layers:
            for key, t in cache[ln].items():
                ring[ln][key][j].copy_(t)

    @torch.inference_mode()
    def run(params, tokens, cache, index, active, temp, generator):
        ring = {ln: {k: t.new_empty((gamma + 2,) + t.shape)
                     for k, t in cache[ln].items()} for ln in rec_layers}
        checkpoint(ring, cache, 0)
        ring.update({ln: {k: t.clone() for k, t in cache[ln].items()}
                     for ln in ring_layers})
        inputs, probs = [], []
        tok, idx = tokens, index
        for step in range(gamma + 1):
            inputs.append(tok[:, 0])
            logits, cache = api.decode_step(params, cfg, tok, cache, idx,
                                            write_mask=active)
            checkpoint(ring, cache, step + 1)
            if step == gamma:
                break                # the last proposal is never verified
            last = logits[:, -1]
            if sample:
                p = torch.softmax(last.float() / temp, dim=-1)
                nxt = torch.multinomial(p, 1, generator=generator)[:, 0]
                probs.append(p)
            else:
                nxt = torch.argmax(last, dim=-1)
            tok = torch.where(active, nxt, torch.zeros_like(nxt))[:, None]
            idx = idx + active.to(idx.dtype)
        vt = torch.stack(inputs, dim=1)
        if sample:
            return vt, torch.stack(probs, dim=1), cache, ring
        return vt, cache, ring

    if sample:
        return run

    def greedy(params, tokens, cache, index, active, generator):
        return run(params, tokens, cache, index, active, None, generator)

    return greedy


def narrowest_window_below(cfg: ModelConfig, n: int) -> int:
    """The smallest sliding window of ``cfg``'s attention layers that is
    below ``n`` (a speculation round's γ + 1 ring writes), or 0."""
    windows = [cfg.layer_window(i) for i in range(cfg.pattern_period)
               if cfg.layer_kind(i) == "attn"]
    return min((w for w in windows if 0 < w < n), default=0)


def make_draft_rollback_step(cfg: ModelConfig, gamma: int, ring_layers=(),
                             rec_layers=()) -> Callable:
    """(draft_cache, ring, index (B,), acc (B,)) -> draft_cache.

    Rolls the draft's per-row state back to the verify's accepted prefix,
    in place.  Sliding-window rings (``ring_layers``): the draft loop wrote
    positions ``index .. index + γ`` into them; slots whose latest write
    was a rejected position (offset ``r`` in [acc, γ]) are restored from
    the pre-round copy.  With γ + 1 <= W each slot was written at most
    once, so that copy is exactly what a sequential decode rolled back to
    ``index + acc`` would hold.  Mamba and RWKV6 layers (``rec_layers``):
    row b's state becomes checkpoint ``acc[b]`` of the draft loop's ring,
    the state a sequential decode of exactly the accepted tokens would
    carry.  An inactive row (``acc == 0``) had every draft write frozen,
    so its restore is a no-op.  Full-attention draft leaves need nothing:
    their slots past the rewound cursor are invalid until rewritten."""
    w = narrowest_window_below(cfg, gamma + 1)
    if w:
        raise ValueError(
            f"gamma {gamma} + 1 draft writes exceed a sliding window {w}: a "
            "speculation round may not overwrite a draft ring slot twice")
    ring_layers, rec_layers = tuple(ring_layers), tuple(rec_layers)

    @torch.inference_mode()
    def rollback(cache, ring, index, acc):
        rows = torch.arange(acc.shape[0], device=acc.device)
        for ln in rec_layers:
            for key, ck in ring[ln].items():     # (γ+2, n_super, B, ...)
                cache[ln][key].copy_(ck.transpose(0, 1)[:, acc, rows])
        for ln in ring_layers:
            for key, old in ring[ln].items():    # (n_super, B, W, KV, hd)
                cur = cache[ln][key]
                W = cur.shape[2]
                r = (torch.arange(W, device=cur.device)[None, :]
                     - index[:, None]) % W
                restore = (r < gamma + 1) & (r >= acc[:, None])
                cur.copy_(torch.where(restore[None, :, :, None, None], old,
                                      cur))
        return cache

    return rollback


def make_verify_step(cfg: ModelConfig, gamma: int,
                     sample: bool = False) -> Callable:
    """One multi-token target forward that scores, accepts and commits a
    speculation round.

    Greedy:
        (params, tokens (B,C), cache, index (B,), active (B,), limit (B,),
         table (B,NB), eos, generator) ->
            (out_tokens (B,C), acc (B,), next_token (B,1), cache,
             new_index, new_active)
    Sampling also takes the draft's proposal distributions and the
    temperature:
        (..., table, eos, draft_probs (B,γ,V), temp, generator) -> (same)

    ``tokens`` is each row's [current token, γ proposals], C = γ+1.  The
    forward (``ModelApi.verify``) writes all C K/V entries through the
    block table (positions at or past a row's limit, and every position of
    an inactive row, to the trash page) and returns logits at every
    position.

    Greedy accept: targets ``g = argmax(logits)``; n matched proposals mean
    positions 0..n saw the sequential greedy prefix, so the emitted tokens
    are ``g[:, :n+1]`` and the stream equals non-speculative greedy
    decode.  Sampling: proposal j is accepted with probability
    ``min(1, p_t(d_j) / p_d(d_j))`` (the u's drawn first), the first
    rejection resamples from the normalized residual ``max(p_t - p_d, 0)``
    and full acceptance draws the bonus from ``p_t[γ]``, so the emitted
    distribution is sequential sampling's.  The draws come from
    ``generator``, not the reference's threefry bits.

    The accepted count is clamped per row as masked decode would stop: at
    the first emitted ``eos`` (-1 disables) and at the row's ``limit``
    cursor; inactive rows emit nothing (``acc == 0``).  The pool needs no
    device rollback (``ModelApi.spec_commit`` passes it through): the host
    releases rejected pages with ``KVBlockPool.truncate_row``.  Every
    output is a new tensor; the inputs are never written."""
    api = registry.get_model(cfg)
    if api.verify is None:
        raise NotImplementedError(f"{cfg.name}: no verify path for this arch")
    if gamma < 1:
        raise ValueError(f"gamma {gamma} < 1")
    C = gamma + 1

    @torch.inference_mode()
    def body(params, tokens, cache, index, active, limit, table, eos,
             draft_probs, temp, generator):
        B, dev = tokens.shape[0], tokens.device
        idx_c = torch.arange(C, device=dev)[None, :]
        wmask = active[:, None] & (index[:, None] + idx_c < limit[:, None])
        logits, cache = api.verify(params, cfg, tokens, cache, index, table,
                                   wmask)
        if not sample:
            emitted = torch.argmax(logits, dim=-1)
            match = (tokens[:, 1:] == emitted[:, :gamma]).long()
            n = torch.cumprod(match, dim=1).sum(dim=1)
        else:
            p_t = torch.softmax(logits.float() / temp, dim=-1)
            d = tokens[:, 1:]                                  # (B, γ)
            pt_d = torch.gather(p_t[:, :gamma], 2, d[..., None])[..., 0]
            pd_d = torch.gather(draft_probs, 2, d[..., None])[..., 0]
            u = torch.rand((B, gamma), generator=generator, device=dev)
            accept = (u * pd_d < pt_d).long()
            n = torch.cumprod(accept, dim=1).sum(dim=1)
            # Resample at position n: the residual after a rejection,
            # p_t[γ] after full acceptance (draft_probs padded with zeros
            # there, so the same formula degenerates to p_t[γ]).
            rows = torch.arange(B, device=dev)
            pd_full = torch.cat([draft_probs,
                                 torch.zeros_like(draft_probs[:, :1])], 1)
            pt_n, pd_n = p_t[rows, n], pd_full[rows, n]
            res = torch.clamp(pt_n - pd_n, min=0.0)
            mass = res.sum(dim=-1, keepdim=True)
            res = torch.where(mass > 0, res / mass.clamp(min=1e-30), pt_n)
            x_star = torch.multinomial(res, 1, generator=generator)
            pad_d = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
            emitted = torch.where(
                idx_c < n[:, None], pad_d,
                torch.where(idx_c == n[:, None], x_star,
                            torch.zeros_like(pad_d)))
        is_eos = emitted == eos
        k_eos = torch.where(is_eos.any(dim=1),
                            torch.argmax(is_eos.to(torch.uint8), dim=1) + 1,
                            C)
        acc = torch.minimum(torch.minimum(n + 1, limit - index), k_eos)
        acc = torch.where(active, acc, torch.zeros_like(acc))
        emit = idx_c < acc[:, None]
        eos_in = (is_eos & emit).any(dim=1)
        new_index = index + acc
        new_active = active & ~eos_in & (new_index < limit)
        out_tokens = torch.where(emit, emitted, torch.zeros_like(emitted))
        nxt = torch.gather(emitted, 1, (acc - 1).clamp(0, C - 1)[:, None])
        nxt = torch.where(new_active[:, None], nxt, torch.zeros_like(nxt))
        cache = api.spec_commit(cache, index, acc)
        return out_tokens, acc, nxt, cache, new_index, new_active

    if sample:
        return body

    def greedy(params, tokens, cache, index, active, limit, table, eos,
               generator):
        return body(params, tokens, cache, index, active, limit, table, eos,
                    None, None, generator)

    return greedy
