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

    and the state is carried to the chunk's end.  Every exp is of a
    non-positive number.  ``chunk`` is halved until it divides S."""
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
        decay = torch.exp(cum_prev[:, :, None] - cum[:, None, :])  # (B,t,s,H,hd)
        att = torch.einsum("bthk,btshk,bshk->bhts", rt, decay, kt) * tri
        diag = torch.einsum("bthk,bthk->bth", rt * uf[None, None], kt)
        att = att + torch.einsum("bth,ts->bhts", diag, eye)
        ys.append(y + torch.einsum("bhts,bshv->bthv", att, vt))
        carry = torch.exp(cum[:, -1][:, None] - cum)     # (B, chunk, H, hd)
        s0 = s0 * torch.exp(cum[:, -1])[..., :, None] + \
            torch.einsum("bshk,bshv->bhkv", kt * carry, vt)
    return torch.cat(ys, dim=1).to(r.dtype), s0
