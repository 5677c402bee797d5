"""Feed-forward layers: dense (GeLU / SwiGLU) and Mixture-of-Experts
(``repro/models/mlp.py``).

The MoE keeps the reference's capacity-based dispatch (GShard style, in
independent token groups): every shape is static, compute is proportional
to top_k, and the tokens that overflow an expert's capacity are the
reference's, because the dispatch sorts with a stable sort as
``jnp.argsort`` does.  The grouped expert products are batched matrix
products (``torch.bmm`` over the expert axis), as the reference leaves
its einsums to XLA outside any kernel.

On a mesh (``distributed.context.moe_ep``) each 'model' rank runs its
E/model experts: the tokens are whole on every rank of a 'model' group,
every rank routes them alike, fills only its experts' slots and combines
its share of each token's choices; the shared experts run on the rank's
d_ff columns (``shared_tp``), and one all-reduce over 'model' sums both
partials.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import (dp_mean, mlp_tp, model_group,
                                            moe_ep, shared_tp, tp_rank,
                                            tp_size)
from repro_torch.models.common import activate, dense_init


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

def mlp_init(generator, cfg: ModelConfig, dtype=torch.float32,
             d_ff: Optional[int] = None, device="cuda"):
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    if cfg.activation == "swiglu":
        return {"w_gate": dense_init(generator, D, Fd, dtype, device=device),
                "w_up": dense_init(generator, D, Fd, dtype, device=device),
                "w_down": dense_init(generator, Fd, D, dtype, device=device)}
    return {"w_up": dense_init(generator, D, Fd, dtype, device=device),
            "w_down": dense_init(generator, Fd, D, dtype, device=device)}


def mlp_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = activate(x @ p["w_up"], "gelu")
    return h @ p["w_down"]


def mlp_apply_tp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """A layer's dense feed-forward; under ``mlp_tp`` on the rank's d_ff
    columns (w_gate/w_up column shards, w_down its row shard) with the
    partial outputs all-reduced over 'model'."""
    if not mlp_tp(cfg):
        return mlp_apply(p, cfg, x)
    group = model_group(cfg)
    return coll.reduce_from_model(
        mlp_apply(p, cfg, coll.copy_to_model(x, group)), group)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def moe_init(generator, cfg: ModelConfig, dtype=torch.float32, device="cuda"):
    """Draws in the reference's key order: router, then each expert of
    w_gate, w_up and w_down, then the shared experts."""
    m = cfg.moe
    D = cfg.d_model
    ef = m.expert_ffn_dim or cfg.d_ff
    E = m.num_experts

    def dense(i, o):
        return dense_init(generator, i, o, dtype, device=device)

    def expert_stack(i, o):
        # Filled expert by expert: no list of E matrices beside the stack.
        out = torch.empty((E, i, o), dtype=dtype, device=device)
        for e in range(E):
            out[e] = dense(i, o)
        return out

    p = {"router": dense(D, E),
         "w_gate": expert_stack(D, ef),
         "w_up": expert_stack(D, ef),
         "w_down": expert_stack(ef, D)}
    if m.num_shared_experts:
        sf = ef * m.num_shared_experts
        p["shared"] = {"w_gate": dense(D, sf), "w_up": dense(D, sf),
                       "w_down": dense(sf, D)}
    return p


def _capacity(tokens_per_group: int, m: MoEConfig) -> int:
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.num_experts)
    return max(4, c)


def _num_groups(B: int, S: int, num_groups: int) -> int:
    T = B * S
    if num_groups <= 0:
        num_groups = min(16, B) if T >= 16 else 1
    while T % num_groups:
        num_groups //= 2
    return max(1, num_groups)


def _experts(p, buf):
    """SwiGLU of every expert over its capacity slots.  buf: (G, E, C, D)
    -> (G, E, C, D); one batched product per weight over the E experts,
    with the groups' slots side by side."""
    G, E, C, D = buf.shape
    xe = buf.transpose(0, 1).reshape(E, G * C, D)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    out = torch.bmm(h, p["w_down"])                       # (E, G*C, D)
    return out.reshape(E, G, C, D).transpose(0, 1)


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor,
              num_groups: int = 0) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (y, aux) with aux = {'aux_loss', 'router_zloss'}.

    Tokens are dispatched in ``num_groups`` independent groups, each with
    its own capacity C per expert.  Per group: top-k experts per token, a
    stable sort of the (token, choice) pairs by expert, and a position
    within the expert; pairs past C are dropped (their writes land in the
    buffer's extra slot E*C, which is then cut off)."""
    m = cfg.moe
    B, S, D = x.shape
    G = _num_groups(B, S, num_groups)
    Tg = B * S // G
    C = _capacity(Tg, m)
    E, K = m.num_experts, m.top_k
    dev = x.device

    xf = x.reshape(G, Tg, D)
    logits = torch.einsum("gtd,de->gte", xf, p["router"])
    probs = torch.softmax(logits.float(), dim=-1)
    weights, ids = torch.topk(probs, K, dim=-1)                # (G, Tg, K)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    flat_ids = ids.reshape(G, Tg * K)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, order)
    counts = torch.zeros((G, E), dtype=torch.long, device=dev).scatter_add_(
        1, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, dim=-1) - counts             # exclusive
    pos = torch.arange(Tg * K, device=dev) - torch.gather(starts, 1,
                                                          sorted_ids)
    tok_idx = order // K
    rows = torch.arange(G, device=dev)[:, None]
    # The experts [lo, lo + El) this rank runs: its E/model under moe_ep,
    # else all.  Every rank routes alike and fills only its experts'
    # slots.  The dispatched tokens and the combine weights enter the
    # rank-local region through copy_to_model: their gradients are
    # partial per rank (its experts' choices) and are summed; the router,
    # aux and z-loss paths stay whole, alike on every rank, and are not.
    ep = moe_ep(cfg)
    El = E // tp_size(cfg) if ep else E
    lo = tp_rank() * El if ep else 0
    keep = (pos < C) & (sorted_ids >= lo) & (sorted_ids < lo + El)
    slot = torch.where(keep, (sorted_ids - lo) * C + pos, El * C)
    n_slots = El * C
    src = coll.copy_to_model(xf, model_group(cfg) if ep else None)
    weights = coll.copy_to_model(weights, model_group(cfg) if ep else None)
    buffer = torch.zeros((G, n_slots + 1, D), dtype=x.dtype, device=dev)
    buffer[rows, slot] = src[rows, tok_idx]
    out = _experts(p, buffer[:, :n_slots].reshape(G, -1, C, D))
    out = out.reshape(G, n_slots, D)

    gathered = torch.where(keep[..., None],
                           out[rows, torch.clamp(slot, max=n_slots - 1)],
                           torch.zeros((), dtype=out.dtype, device=dev))
    y = torch.empty((G, Tg * K, D), dtype=x.dtype, device=dev)
    y[rows, order] = gathered.to(x.dtype)
    y = torch.einsum("gtkd,gtk->gtd", y.reshape(G, Tg, K, D),
                     weights.to(x.dtype))

    # Load-balancing auxiliary loss (Switch-style) and router z-loss.  On
    # a training mesh the expert shares are the whole batch's (dp_mean).
    me = dp_mean(probs.mean(dim=(0, 1)))                       # (E,)
    ce = dp_mean(counts.float().mean(dim=0) / (Tg * K))
    aux_loss = m.aux_loss_coef * E * torch.sum(me * ce)
    zloss = m.router_zloss * torch.mean(
        torch.square(torch.logsumexp(logits.float(), dim=-1)))

    # Terms held whole and terms partial over 'model' (the rank's experts
    # under moe_ep, the shared experts' d_ff columns under shared_tp): one
    # all-reduce sums the partial ones.
    whole, partial = [], []
    (partial if ep else whole).append(y.reshape(B, S, D))
    if m.num_shared_experts:
        stp = shared_tp(cfg)
        sp = p["shared"]
        xs = coll.copy_to_model(x, model_group(cfg) if stp else None)
        h = F.silu(xs @ sp["w_gate"]) * (xs @ sp["w_up"])
        (partial if stp else whole).append(h @ sp["w_down"])
    if partial:
        whole.append(coll.reduce_from_model(sum(partial[1:], partial[0]),
                                            model_group(cfg)))
    y = sum(whole[1:], whole[0])
    return y, {"aux_loss": aux_loss, "router_zloss": zloss}
