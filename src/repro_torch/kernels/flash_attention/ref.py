"""Plain PyTorch versions of flash attention (``repro/kernels/flash_attention/
ref.py``): the CUDA kernel's references and its path on the CPU.

``naive_attention`` — materializes the full score matrix; the test oracle.
``blocked_attention`` — exact online softmax over k-blocks (a Python loop
where the reference scans); peak temporary O(B·H·S·block_k) instead of
O(B·H·S²), so long prompts stay memory-bounded on the CPU.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _softcap(x, cap: float):
    return cap * torch.tanh(x / max(cap, 1e-6))


def _expand_kv(k, H: int):
    KV = k.shape[2]
    if KV == H:
        return k
    return k.repeat_interleave(H // KV, dim=2)


def naive_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0):
    """q: (B,S,H,hd); k,v: (B,S,KV,hd).  Exact, O(S^2) memory."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(hd)
    if logit_softcap > 0:
        scores = _softcap(scores, logit_softcap)
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= (qi - ki) < window
    scores = torch.where(mask[None, None], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def blocked_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                      block_k=512):
    """Exact online-softmax attention over k/v blocks of ``block_k``."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    KV = k.shape[2]
    G = H // KV
    block_k = min(block_k, Sk)
    dev = q.device
    qg = (q.float() / math.sqrt(hd)).reshape(B, S, KV, G, hd)
    qi = torch.arange(S, device=dev)
    acc = torch.zeros((B, S, KV, G, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, S, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, KV, G), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    for start in range(0, Sk, block_k):
        # The last block is ragged: the reference pads it with zero keys
        # and masks them, which contributes exactly nothing.
        kblk = k[:, start:start + block_k].float()
        vblk = v[:, start:start + block_k].float()
        ki = start + torch.arange(kblk.shape[1], device=dev)
        s = torch.einsum("bqkgh,bckh->bqkgc", qg, kblk)
        if logit_softcap > 0:
            s = _softcap(s, logit_softcap)
        mask = torch.ones((S, kblk.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= qi[:, None] >= ki[None, :]
        if window > 0:
            mask &= (qi[:, None] - ki[None, :]) < window
        s = torch.where(mask[None, :, None, None, :], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqkgc,bckh->bqkgh",
                                                    p, vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, S, H, hd).to(q.dtype)
