"""Shared model building blocks: device resolution, initializers, norms,
activations, softcap and the cross-entropy loss (``repro/models/
common.py``).

Models are ``init(generator, cfg, device=...) -> params`` /
``apply(params, ...)`` function pairs over nested dicts of tensors keyed as
the reference's pytrees.  The reference's sharding-constraint helpers have no
counterpart: the port serves from one card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


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
