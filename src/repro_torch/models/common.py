"""Shared model building blocks: device resolution, initializers, norms,
activations, softcap, rotary position embeddings (RoPE and Qwen2-VL's
M-RoPE), the whisper encoder's sinusoidal positions and the cross-entropy
loss (``repro/models/common.py``).

Models are ``init(generator, cfg, device=...) -> params`` /
``apply(params, ...)`` function pairs over nested dicts of tensors keyed as
the reference's pytrees.  On a mesh the layers ask
``distributed.context`` what to do with their leaves.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device on a machine without
    one raises here, with the way out named, instead of deep inside torch."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run the plain PyTorch path on the CPU")
    return dev


def normal(generator: Optional[torch.Generator], shape, std: float,
           dtype=torch.float32, device="cuda") -> torch.Tensor:
    """N(0, std²) draws of ``shape``, made on the generator's device and
    moved to ``device``: one seed gives the same weights on the card and on
    the CPU.  On the ``meta`` device only the shape is made (the
    counterpart of ``jax.eval_shape`` over an init)."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    gen_dev = generator.device if generator is not None else "cpu"
    x = torch.randn(shape, generator=generator, device=gen_dev,
                    dtype=torch.float32).mul_(std)
    return x.to(device=resolve_device(dev), dtype=dtype)


def uniform(generator: Optional[torch.Generator], shape, dtype=torch.float32,
            device="cuda") -> torch.Tensor:
    """U[0, 1) draws of ``shape`` in float32, made on the generator's device
    and moved to ``device`` (``normal``'s rule)."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    gen_dev = generator.device if generator is not None else "cpu"
    x = torch.rand(shape, generator=generator, device=gen_dev,
                   dtype=torch.float32)
    return x.to(device=resolve_device(dev), dtype=dtype)


def dense_init(generator, in_dim: int, out_dim: int, dtype=torch.float32,
               scale: float = 1.0, device="cuda") -> torch.Tensor:
    """muP/spectral-consistent init: std = scale / sqrt(in_dim)."""
    return normal(generator, (in_dim, out_dim), scale / math.sqrt(in_dim),
                  dtype, device)


def embed_init(generator, vocab: int, dim: int, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    return normal(generator, (vocab, dim), 0.02, dtype, device)


def norm_init(d: int, kind: str, device="cuda"):
    dev = resolve_device(device)
    if kind == "layernorm":
        return {"scale": torch.ones(d, device=dev),
                "bias": torch.zeros(d, device=dev)}
    return {"scale": torch.ones(d, device=dev)}


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm / RMSNorm computed in float32 with the reference's
    ``eps=1e-6`` (not ``nn.LayerNorm``'s 1e-5)."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        return F.gelu(x, approximate="tanh")
    if kind == "silu":
        return F.silu(x)
    raise ValueError(kind)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embeddings (RoPE and 3D M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    """theta^(-2i/hd) for i < hd/2, in float32 on the CPU (the reference's
    f32 arithmetic)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                            / head_dim))


_ROPE_TABLES: dict = {}


def rope_table(head_dim: int, theta: float, length: int, device):
    """(cos, sin), each (length, hd/2) float32 on ``device``: the rotation
    of every position below ``length``, built once per (hd, θ, length,
    device).  The angles are the reference's float32 products pos · freq;
    their sin and cos are taken by numpy in float64 (one function for
    every element, on one thread) and rounded, so a position gets the same
    bits in tables of every length, on every device and wherever it sits
    in a batch (torch's CPU sin/cos split a tensor by thread and by vector
    tail), and a decode step launches no transcendental."""
    dev = torch.device(device)
    key = (head_dim, float(theta), length, dev)
    if key not in _ROPE_TABLES:
        pos = np.arange(length, dtype=np.float32)
        angles = (pos[:, None] * rope_freqs(head_dim, theta).numpy()[None, :]
                  ).astype(np.float64)
        _ROPE_TABLES[key] = tuple(
            torch.from_numpy(f(angles).astype(np.float32)).to(dev)
            for f in (np.cos, np.sin))
    return _ROPE_TABLES[key]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               max_len: int) -> torch.Tensor:
    """x: (..., S, H, hd); positions: integer, broadcastable to (..., S).
    The half-split rotation [x1 cos - x2 sin, x1 sin + x2 cos] in float32,
    returned in x's dtype.  The table covers positions below
    ``max_len``; a position at or past it is clamped to the last entry,
    as the learned position table clamps (a speculative round reads up to
    ``cursor + γ``, whose logits are never in play), with no check that
    would sync the card."""
    cos, sin = rope_table(x.shape[-1], theta, max_len, x.device)
    pos = positions.long().clamp(0, max_len - 1)
    cos, sin = cos[pos][..., None, :], sin[pos][..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int, sections=(16, 24, 24)) -> list:
    """The (temporal, height, width) frequency bands of M-RoPE, by
    half-dim; rescaled as the reference rescales them when they do not add
    up to hd/2 (the remainder to the first band)."""
    half = head_dim // 2
    secs = list(sections)
    if sum(secs) != half:
        tot = sum(secs)
        secs = [n * half // tot for n in secs]
        secs[0] += half - sum(secs)
    return secs


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                max_len: int, sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (..., S, H, hd); positions_3d:
    (3, ..., S) temporal/height/width ids.  The rotary frequency bands are
    split into ``mrope_sections``, each rotated by its own position
    component: band i's angles are gathered from ``rope_table``'s columns
    of that band at ids ``positions_3d[i]``, so text-only ids (t = h = w =
    pos) rotate to ``apply_rope``'s bits.  Ids at or past ``max_len``
    clamp, as in ``apply_rope``."""
    cos_t, sin_t = rope_table(x.shape[-1], theta, max_len, x.device)
    pos = positions_3d.long().clamp(0, max_len - 1)
    cos, sin, start = [], [], 0
    for i, n in enumerate(mrope_sections(x.shape[-1], sections)):
        cos.append(cos_t[:, start:start + n][pos[i]])
        sin.append(sin_t[:, start:start + n][pos[i]])
        start += n
    cos = torch.cat(cos, dim=-1)[..., None, :]
    sin = torch.cat(sin, dim=-1)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(max_len: int, dim: int,
                         device="cuda") -> torch.Tensor:
    """Absolute sinusoidal table (max_len, dim) of the whisper encoder:
    [sin(pos · inv), cos(pos · inv)], inv = exp(-(2i/dim) ln 10000), in
    float32 as the reference computes it."""
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    inv = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32) / dim
                    * math.log(10000.0))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(
        resolve_device(device))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  final_softcap: float = 0.0) -> torch.Tensor:
    """Mean next-token cross entropy. logits (B,S,V), labels (B,S).  The
    logsumexp is taken in float32 after the final softcap, as the
    reference takes it."""
    logits = softcap(logits.float(), final_softcap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 group, vocab_start: int,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """``cross_entropy`` over vocab-parallel logits: the rank holds columns
    ``vocab_start ..`` of (B, S, V/m).  The max is all-reduced (no
    gradient), the sum of exponentials and the gold logit (zero on the
    ranks that do not hold it) are all-reduced over 'model', so every rank
    computes the same loss and each rank's logits get their own
    gradient."""
    logits = logits.float()
    m = coll.all_reduce(logits.detach().amax(dim=-1), group, "max")
    se = coll.reduce_from_model(torch.exp(logits - m[..., None]).sum(-1),
                                group)
    logz = torch.log(se) + m
    n = logits.shape[-1]
    local = labels.long() - vocab_start
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = coll.reduce_from_model(gold * inside, group)
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
