"""Plain PyTorch paged-attention math (``repro/kernels/paged_attention/
ref.py``).  This slice ports ``masked_gqa_attention`` only: the contiguous
decode's attention, plain tensor code in the reference too.  The page-pool
gathers and the paged decode kernel come with ROADMAP queue A item 8.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _softcap(x, cap: float):
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def masked_gqa_attention(q, k, v, valid, logit_softcap: float = 0.0):
    """Grouped-query attention with an explicit validity mask.

    q: (B, C, H, hd); k, v: (B, S, KV, hd); valid: (B, C, S) bool.
    Returns (B, C, H, hd): scores in the compute dtype, softmax in float32.
    """
    B, C, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, C, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k) / math.sqrt(hd)
    scores = _softcap(scores, logit_softcap)
    scores = torch.where(valid[:, None, None, :, :], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, C, H, hd)
