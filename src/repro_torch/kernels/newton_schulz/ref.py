"""Plain PyTorch Newton–Schulz orthogonalization (``repro/kernels/
newton_schulz/ref.py``): the CUDA chain's reference and its path on the
CPU."""
from __future__ import annotations

import torch

# Quintic iteration coefficients (Jordan et al., 2024).
NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz_ref(m: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Orthogonalize a single matrix: singular values -> ~1.

    Works on (n, m) with any aspect; computed in f32."""
    a, b, c = NS_COEFFS
    x = m.float()
    transpose = x.shape[0] > x.shape[1]
    if transpose:
        x = x.T
    x = x / (torch.linalg.norm(x) + 1e-7)
    for _ in range(steps):
        gram = x @ x.T
        x = a * x + (b * gram + c * (gram @ gram)) @ x
    if transpose:
        x = x.T
    return x.to(m.dtype)
