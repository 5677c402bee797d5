"""Feed-forward layers: dense (GeLU / SwiGLU) and Mixture-of-Experts
(``repro/models/mlp.py``).

The MoE keeps the reference's capacity-based dispatch (GShard style, in
independent token groups): every shape is static, compute is proportional
to top_k, and the tokens that overflow an expert's capacity are the
reference's, because the dispatch sorts with a stable sort as
``jnp.argsort`` does.  The grouped expert products are batched matrix
products (``torch.bmm`` over the expert axis), as the reference leaves
its einsums to XLA outside any kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
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
    keep = pos < C
    slot = torch.where(keep, sorted_ids * C + pos, E * C)
    tok_idx = order // K

    rows = torch.arange(G, device=dev)[:, None]
    buffer = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=dev)
    buffer[rows, slot] = xf[rows, tok_idx]
    out = _experts(p, buffer[:, :E * C].reshape(G, E, C, D))
    out = out.reshape(G, E * C, D)

    gathered = torch.where(keep[..., None],
                           out[rows, torch.clamp(slot, max=E * C - 1)],
                           torch.zeros((), dtype=out.dtype, device=dev))
    y = torch.empty((G, Tg * K, D), dtype=x.dtype, device=dev)
    y[rows, order] = gathered.to(x.dtype)
    y = torch.einsum("gtkd,gtk->gtd", y.reshape(G, Tg, K, D),
                     weights.to(x.dtype))

    # Load-balancing auxiliary loss (Switch-style) and router z-loss.
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = counts.float().mean(dim=0) / (Tg * K)
    aux_loss = m.aux_loss_coef * E * torch.sum(me * ce)
    zloss = m.router_zloss * torch.mean(
        torch.square(torch.logsumexp(logits.float(), dim=-1)))

    y = y.reshape(B, S, D)
    if m.num_shared_experts:
        sp = p["shared"]
        h = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
        y = y + h @ sp["w_down"]
    return y, {"aux_loss": aux_loss, "router_zloss": zloss}
