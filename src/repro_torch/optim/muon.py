"""Muon-NSGD, the paper's main optimizer (``repro/optim/muon.py``).

All matrix-shaped leaves are updated with Muon (Newton–Schulz
orthogonalized momentum, scaled by the muP spectral factor
sqrt(max(n_out, n_in)/n_in)); every other leaf uses normalized SGD, with a
single learning rate for both.

Stacked super-block leaves (leading n_super axis) are orthogonalized per
layer: the reference vmaps over the stack, the port hands the whole stack
to ``kernels.newton_schulz.ops.newton_schulz``, one launch chain per
stacked leaf.  All update arithmetic is float32; params and moments are
written in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim.base import Optimizer, clip_by_global_norm
from repro_torch.tree import leaves_with_path, tree_map

# Leaf names that are *not* semantic matrices even when >=2-D (stacked norm
# scales, per-channel SSM params, token-shift factors, position tables):
# these take NSGD, everything matrix-shaped takes Muon (paper §2).
NSGD_NAMES = frozenset({
    "scale", "bias", "conv_b", "dt_bias", "A_log", "D", "u", "w_base",
    "conv_w", "pos_embed", "enc_pos",
})


def _is_matrix(path, x: torch.Tensor) -> bool:
    """``path``: the tuple of dict keys of the leaf."""
    names = list(path)
    if names and (names[-1] in NSGD_NAMES or
                  (len(names) >= 2 and names[-2] in ("mu", "cm_mu"))):
        return False
    return x.ndim >= 2 and x.shape[-1] > 1 and x.shape[-2] > 1


def _stacked(path) -> bool:
    return bool(path) and path[0] in ("blocks", "enc_blocks")


def orthogonalize(m: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Newton–Schulz quintic iteration (Muon) over the trailing two dims;
    the leading dims (the layer stack) go to the kernel as one batch."""
    from repro_torch.kernels.newton_schulz import ops as ns_ops
    lead = m.shape[:-2]
    x = m.reshape((-1,) + tuple(m.shape[-2:]))
    y = ns_ops.newton_schulz(x, steps=steps)
    return y.reshape(lead + tuple(m.shape[-2:]))


def muon_nsgd(cfg: OptimizerConfig) -> Optimizer:
    beta = cfg.momentum
    wd = cfg.weight_decay

    def init(params):
        dev = next(iter(leaves_with_path(params)))[1].device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        grads = clip_by_global_norm(grads, cfg.grad_clip)
        m_tree = state["m"]
        for (_, m), (_, g) in zip(leaves_with_path(m_tree),
                                  leaves_with_path(grads)):
            m.mul_(beta).add_(g.to(m.dtype))
        lr = torch.as_tensor(lr, dtype=torch.float32)
        for (path, p), (_, m) in zip(leaves_with_path(params),
                                     leaves_with_path(m_tree)):
            lr_d = lr.to(p.device)
            if _is_matrix(path, p):
                upd = orthogonalize(m.float(), cfg.ns_steps)
                if cfg.mup:
                    n_in, n_out = p.shape[-2], p.shape[-1]
                    upd = upd * torch.sqrt(torch.tensor(
                        max(n_out, n_in) / n_in, dtype=torch.float32,
                        device=p.device))
            else:
                mf = m.float()
                if _stacked(path) and mf.ndim > 1:
                    # per-layer normalization: depth expansion must not
                    # dilute each layer's NSGD step (hyperparameter
                    # transfer).
                    flat = mf.reshape(mf.shape[0], -1)
                    norm = torch.linalg.norm(flat, dim=1) + 1e-9
                    upd = (flat / norm[:, None]).reshape(mf.shape)
                else:
                    upd = mf / (torch.linalg.norm(mf.reshape(-1)) + 1e-9)
            new = (1.0 - lr_d * wd) * p.float() - lr_d * upd
            p.copy_(new.to(p.dtype))
        return params, {"step": state["step"] + 1, "m": m_tree}

    return Optimizer("muon_nsgd", init, update)
