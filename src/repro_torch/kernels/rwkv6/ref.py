"""Plain PyTorch versions of the RWKV6 (Finch) WKV recurrence
(``repro/kernels/rwkv6/ref.py``)::

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)

r, k, v, w: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd) [key x value].
Both forms compute in float32 and return ``y`` in ``r.dtype`` and the final
state in float32.  They are differentiable by autograd (the CPU training
path) and run on any device (the card compares its kernel with them).
"""
from __future__ import annotations

import torch


def wkv_ref(r, k, v, w, u, state):
    """The per-step recurrence, one time step at a time."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    st = state.float()
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # (B, H, K, V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], st + uf * kv))
        st = st * wf[:, t, :, :, None] + kv
    if not ys:
        return r.new_zeros((B, 0, H, hd)), st.clone()
    return torch.stack(ys, dim=1).to(r.dtype), st


def wkv_chunked(r, k, v, w, u, state, chunk: int = 64):
    """The exact chunked closed form (the reference's TPU kernel math):
    within a chunk of length C, with cum_t = sum_{s<=t} log w_s,

        y_t = (r_t ⊙ exp(cum_{t-1})) S_0
              + sum_{s<t} (r_t ⊙ exp(cum_{t-1} - cum_s)) · k_s v_s
              + (r_t ⊙ u) · k_t v_t,

    and the state is carried to the chunk's end.  ``chunk`` is halved
    until it divides S.

    The pairwise decays are taken for every (t, s) and the pairs s >= t
    masked after the sum over channels; their exponents cum_{t-1} - cum_s
    are positive, so they are clamped at 0 first: with strong decays (w
    near 0, floored at 1e-30) they would reach e^{+69 per step}, overflow
    to inf, and inf * 0 makes the whole row NaN, as the reference's
    ``wkv_chunked`` does (ROADMAP queue C).  Below the diagonal, where
    every exponent is non-positive, nothing changes."""
    B, S, H, hd = r.shape
    chunk = min(chunk, S)
    while chunk and S % chunk:
        chunk //= 2
    if S == 0:
        return r.new_zeros((B, 0, H, hd)), state.float().clone()
    n = S // chunk

    def to_chunks(x):
        return x.float().reshape(B, n, chunk, H, hd)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, w))
    uf = u.float()
    tri = torch.tril(torch.ones((chunk, chunk), device=r.device), -1)
    eye = torch.eye(chunk, device=r.device)
    s0 = state.float()
    ys = []
    for c in range(n):
        rt, kt, vt, wt = rc[:, c], kc[:, c], vc[:, c], wc[:, c]
        logw = torch.log(torch.clamp(wt, min=1e-30))
        cum = torch.cumsum(logw, dim=1)                  # inclusive over time
        cum_prev = cum - logw
        y = torch.einsum("bthk,bhkv->bthv", rt * torch.exp(cum_prev), s0)
        decay = torch.exp(torch.clamp(cum_prev[:, :, None] - cum[:, None, :],
                                      max=0.0))            # (B,t,s,H,hd)
        att = torch.einsum("bthk,btshk,bshk->bhts", rt, decay, kt) * tri
        diag = torch.einsum("bthk,bthk->bth", rt * uf[None, None], kt)
        att = att + torch.einsum("bth,ts->bhts", diag, eye)
        ys.append(y + torch.einsum("bhts,bshv->bthv", att, vt))
        carry = torch.exp(cum[:, -1][:, None] - cum)     # (B, chunk, H, hd)
        s0 = s0 * torch.exp(cum[:, -1])[..., :, None] + \
            torch.einsum("bshk,bshv->bhkv", kt * carry, vt)
    return torch.cat(ys, dim=1).to(r.dtype), s0


@torch.no_grad()
def wkv_bwd_ref(r, k, v, w, u, s0, dy, ds_final=None):
    """The backward of ``wkv_ref`` as its explicit reverse recurrence (the
    plain version of ``csrc/wkv_bwd.cu``, not autograd).  With P_t the
    state before step t and G_t = dL/dP_t (G_S = ``ds_final``, zero when
    None), step t back gives

        G_t  = diag(w_t) G_{t+1} + r_t dy_t^T
        dr_t = P_t dy_t + (u ⊙ k_t)(v_t · dy_t)
        dk_t = G_{t+1} v_t + (r_t ⊙ u)(v_t · dy_t)
        dv_t = G_{t+1}^T k_t + (r_t · (u ⊙ k_t)) dy_t
        dw_t = Σ_j G_{t+1}[:, j] ⊙ P_t[:, j]
        du  += Σ_b r_t ⊙ k_t (v_t · dy_t)

    Both recurrences run step by step, every P_t and G_{t+1} kept (P_t is
    never rebuilt as (P_{t+1} - k_t v_t^T) / w_t, which a decay of 0
    forbids); the products over them then run over all steps at once.
    Returns (dr, dk, dv, dw, du, ds0) in the dtypes of (r, k, v, w, u, s0),
    computed in float32."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf, yf = (x.float() for x in (r, k, v, w, dy))
    uf = u.float()
    P = torch.empty((S, B, H, hd, hd), dtype=torch.float32, device=r.device)
    Gn = torch.empty_like(P)                  # G_{t+1}
    st = s0.float()
    for t in range(S):
        P[t] = st
        st = (st * wf[:, t, :, :, None]
              + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    G = (torch.zeros_like(st) if ds_final is None
         else ds_final.float().clone())
    for t in reversed(range(S)):
        Gn[t] = G
        G = (G * wf[:, t, :, :, None]
             + rf[:, t, :, :, None] * yf[:, t, :, None, :])
    vdy = (vf * yf).sum(-1, keepdim=True)                  # (B, S, H, 1)
    rku = (rf * uf * kf).sum(-1, keepdim=True)
    dr = torch.einsum("tbhkv,bthv->bthk", P, yf) + uf * kf * vdy
    dk = torch.einsum("tbhkv,bthv->bthk", Gn, vf) + rf * uf * vdy
    dv = torch.einsum("tbhkv,bthk->bthv", Gn, kf) + rku * yf
    dw = (Gn * P).sum(-1).permute(1, 0, 2, 3)
    du = (rf * kf * vdy).sum((0, 1))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dw.to(w.dtype).contiguous(), du.to(u.dtype), G.to(s0.dtype))
