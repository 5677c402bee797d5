"""Symmetric quantization for the paged KV pool (``repro/core/quant.py``):
per-slot-per-head int8 or fp8 page storage with float32 scales,
dequantized inside paged attention.

Conventions (the reference's, bit for bit on the CPU):
  * symmetric, zero-point-free: ``scale = max|x| / qmax + 1e-12`` along
    the reduced axes, ``q = round(x / scale)`` (half to even, as
    ``jnp.round``) clipped to ±127 (int8), or cast (fp8 e4m3fn, round to
    nearest even);
  * ``axis=None`` reduces over the whole tensor (a scalar scale); an
    int or tuple axis keeps dims, so the scale broadcasts back against
    ``q`` and rides any gather or scatter the quantized tensor rides;
  * scales are always float32, whatever the storage dtype.

One edge differs from JAX: a cast of a value past 448 to fp8 saturates
to ±448 in torch and gives NaN in JAX.  The scale keeps ``|x / scale| <=
448``, so ``quantize`` never meets it.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Axis = Union[None, int, Tuple[int, ...]]

# Largest representable magnitude per storage dtype (int8 symmetric range;
# fp8 e4m3fn saturates at 448).
_INT8_MAX = 127.0
_FP8_E4M3_MAX = 448.0
_EPS = 1e-12


def fp8_dtype():
    """``torch.float8_e4m3fn`` when this torch has it, else None."""
    return getattr(torch, "float8_e4m3fn", None)


def is_quantized(dtype) -> bool:
    """True for storage dtypes that need a scale array (int8 / fp8)."""
    return dtype == torch.int8 or (fp8_dtype() is not None
                                   and dtype == fp8_dtype())


def qmax(dtype) -> float:
    if dtype == torch.int8:
        return _INT8_MAX
    if fp8_dtype() is not None and dtype == fp8_dtype():
        return _FP8_E4M3_MAX
    raise ValueError(f"not a quantized storage dtype: {dtype}")


def quantize(x: torch.Tensor, axis: Axis = None,
             dtype=torch.int8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization of ``x`` to ``dtype``.

    Returns ``(q, scale)`` with ``scale`` float32; ``axis=None`` yields a
    scalar scale, otherwise the reduced dims are kept (size 1) so
    ``q.float() * scale`` broadcasts without reshaping."""
    xf = x.float()
    m = qmax(dtype)
    amax = xf.abs().amax() if axis is None \
        else xf.abs().amax(dim=axis, keepdim=True)
    # A tensor divisor, not a Python scalar: CUDA divides by a scalar as a
    # product with its reciprocal (1 ulp off at times); elementwise true
    # division gives the CPU's (and the reference's) scales on every device.
    scale = amax / torch.full_like(amax, m) + _EPS
    y = xf / scale
    if dtype == torch.int8:
        q = torch.clamp(torch.round(y), -m, m).to(torch.int8)
    else:                                   # fp8: round to nearest even
        q = y.to(dtype)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


_KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}


def resolve_kv_dtype(name: Optional[str]):
    """Map a ``--kv-dtype`` CLI name to a storage dtype (None -> None,
    i.e. 'use the engine's cache_dtype').  Raises for 'fp8' when this
    torch has no float8_e4m3fn: quantized serving never widens silently."""
    if name is None:
        return None
    if name in _KV_DTYPES:
        return _KV_DTYPES[name]
    if name == "fp8":
        if fp8_dtype() is None:
            raise ValueError(
                "kv_dtype='fp8' requested but this torch has no "
                "float8_e4m3fn; use 'int8' (same byte width) instead")
        return fp8_dtype()
    raise ValueError(f"unknown kv_dtype {name!r} "
                     f"(choose from f32, bf16, int8, fp8)")
