"""Plain PyTorch versions of the Mamba selective scan
(``repro/kernels/mamba_scan/ref.py``)::

    h_t = exp(dt_t ⊙ A) h_{t-1} + (dt_t u_t) ⊗ B_t
    y_t = C_t · h_t + D ⊙ u_t

u, dt: (B, S, d); A: (d, N); Bm, Cm: (B, S, N); Dp: (d,); the state h:
(B, d, N).  Both forms compute in float32, start from ``h0`` (zeros when
absent) and return ``y`` in ``u.dtype`` and the final state in float32.
They are differentiable by autograd (the CPU training path) and run on any
device (the card compares its kernel with them).
"""
from __future__ import annotations

import torch


def _start(u, A, h0):
    B, _, d = u.shape
    if h0 is None:
        return torch.zeros((B, d, A.shape[1]), dtype=torch.float32,
                           device=u.device)
    return h0.float()


def _finish(ys, u, Dp):
    """y + D ⊙ u in float32, then cast to u's dtype."""
    return (ys + Dp.float() * u.float()).to(u.dtype)


def selective_scan_ref(u, dt, A, Bm, Cm, Dp, h0=None):
    """The per-step recurrence, one time step at a time."""
    S = u.shape[1]
    uf, dtf, Bf, Cf = (x.float() for x in (u, dt, Bm, Cm))
    Af = A.float()
    h = _start(u, A, h0)
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t, :, None] * Af[None])          # (B, d, N)
        dbx = (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        h = h * da + dbx
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    if not ys:
        return u.new_zeros(u.shape), h.clone()
    return _finish(torch.stack(ys, dim=1), u, Dp), h


def _doubling_scan(g, x):
    """Inclusive scan along dim 1 under the reference's ``combine``
    ((ga, xa), (gb, xb)) -> (ga gb, xa gb + xb), by Hillis–Steele
    doubling: log2(C) elementwise steps.  Only products of decays are
    formed (no logs, no cumulative sums), so a decay that underflows to 0
    stays exactly 0."""
    C = g.shape[1]
    off = 1
    while off < C:
        x = torch.cat([x[:, :off], x[:, :-off] * g[:, off:] + x[:, off:]],
                      dim=1)
        g = torch.cat([g[:, :off], g[:, :-off] * g[:, off:]], dim=1)
        off *= 2
    return g, x


def selective_scan_chunked(u, dt, A, Bm, Cm, Dp, chunk: int = 128, h0=None):
    """The exact chunked form: a loop over chunks of ``chunk`` steps
    (halved until it divides S), an inclusive scan within each chunk, and
    one state carried between chunks.  A chunk holds (B, chunk, d, N)
    float32 intermediates."""
    B, S, d = u.shape
    chunk = min(chunk, S)
    while chunk and S % chunk:
        chunk //= 2
    h = _start(u, A, h0)
    if S == 0:
        return u.new_zeros(u.shape), h.clone()
    Af = A.float()
    uf, dtf, Bf, Cf = (x.float() for x in (u, dt, Bm, Cm))
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        dt_c = dtf[:, sl]
        da = torch.exp(dt_c[..., None] * Af[None, None])       # (B, C, d, N)
        dbx = (dt_c * uf[:, sl])[..., None] * Bf[:, sl, None, :]
        gains, states = _doubling_scan(da, dbx)
        h_seq = gains * h[:, None] + states
        ys.append(torch.einsum("bcdn,bcn->bcd", h_seq, Cf[:, sl]))
        h = h_seq[:, -1]
    return _finish(torch.cat(ys, dim=1), u, Dp), h
