"""Depth expansion operators, the paper's primary contribution
(``repro/core/expansion.py``).

Every model stacks its layers as super-blocks with a leading ``n_super``
axis on each leaf of ``params["blocks"]``, so depth expansion is one
operation on that axis.  Initializations (paper §3.1/§3.3/§A.2):

  random         new blocks freshly initialized (muP scale)   [feature learning]
  zero           new blocks all-zero            [function-preserving, untrainable]
  copying_stack  [1,2,3] -> [1,2,3,1,2,3]
  copying_inter  [1,2,3] -> [1,1,2,2,3,3]
  copying_last   [1,2,3] -> [1,2,3,3,3,3]
  copying_zeroL  copying + zero last linear sub-layer  [function-preserving, trainable]
  copying_zeroN  copying + zero norm scales            [function-preserving, weak]

``insert_at='bottom'`` appends new blocks after the old ones ([1..k,R..R]),
which the paper finds best (§A.3); 'top' prepends.

The reference runs the expansion jitted under its mesh and donates the old
buffers; here it is eager tensor code on the params' device.  Every block
leaf it returns is a new tensor (concatenation, gather or fresh init), so
the optimizer's moments, expanded alongside, never alias the params.
``random`` draws from a ``torch.Generator``; its bits are not the
reference's threefry bits, only the same distribution.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_leaves, tree_map

COPY_METHODS = ("copying_stack", "copying_inter", "copying_last",
                "copying_zeroL", "copying_zeroN")
ALL_METHODS = ("random", "zero") + COPY_METHODS

# Names of "last linear" leaves inside a layer, zeroed by copying_zeroL.
_LAST_LINEAR_KEYS = ("wo", "w_down", "out_proj", "w_o", "cm_v", "w_b")


def _source_index_map(n_src: int, n_tgt: int, method: str) -> List[int]:
    """Which source block seeds each target block (copying variants)."""
    if n_src < 1:
        raise ValueError(f"copying needs a source block, got {n_src}")
    if method == "copying_last":
        return list(range(n_src)) + [n_src - 1] * (n_tgt - n_src)
    if method in ("copying_stack",):
        return [i % n_src for i in range(n_tgt)]
    # copying_inter: repeat each source block ~n_tgt/n_src times, remainder
    # spread over the deepest blocks.
    base, rem = divmod(n_tgt, n_src)
    out = []
    for i in range(n_src):
        out.extend([i] * (base + (1 if i >= n_src - rem else 0)))
    return out


def _inter_new_flags(n_src, n_tgt):
    seen = set()
    flags = []
    for s in _source_index_map(n_src, n_tgt, "copying_inter"):
        flags.append(s in seen)
        seen.add(s)
    return flags


def _zero_sublayers(block, keys: Tuple[str, ...], norm_mode: bool = False):
    """Zero selected leaves of one (stacked) block tree."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if norm_mode:
            # zero norm scale/bias of the residual branches
            hit = any(p in ("ln1", "ln2", "ln_x") for p in path) and \
                path[-1] in ("scale", "bias")
        else:
            hit = path[-1] in keys
        return torch.zeros_like(tree) if hit else tree
    return walk(block, ())


def _n_stack(stack) -> int:
    return tree_leaves(stack)[0].shape[0]


def expand_stack(old_stack, n_tgt: int, method: str,
                 fresh_stack=None, insert_at: str = "bottom"):
    """Expand a stacked super-block tree (leading axis n_src -> n_tgt).

    ``old_stack`` may be None (zero-layer source: only 'random'/'zero'
    valid).  ``fresh_stack`` supplies freshly initialized blocks (leading
    axis n_tgt) for 'random' (only its new-block slices are used) and the
    shapes for 'zero' from a zero-layer source."""
    n_src = 0 if old_stack is None else _n_stack(old_stack)
    if n_tgt < n_src:
        raise ValueError(f"cannot shrink stack {n_src} -> {n_tgt}")
    if method in COPY_METHODS and n_src == 0:
        raise ValueError("copying from a zero-layer source is undefined "
                         "(paper Table 2); use 'random'")
    if method not in ALL_METHODS:
        raise ValueError(f"unknown expansion method {method!r}")

    if method == "random":
        if fresh_stack is None:
            raise ValueError("'random' expansion needs fresh_stack")
        if n_src == 0:
            return fresh_stack

        def mix(old, fresh):
            new_part = (fresh[n_src:] if insert_at == "bottom"
                        else fresh[:n_tgt - n_src])
            parts = [old, new_part] if insert_at == "bottom" \
                else [new_part, old]
            return torch.cat(parts, dim=0)
        return tree_map(mix, old_stack, fresh_stack)

    if method == "zero":
        if n_src == 0:
            if fresh_stack is None:
                raise ValueError("'zero' from a zero-layer source needs "
                                 "fresh_stack for the shapes")
            return tree_map(torch.zeros_like, fresh_stack)

        def mix0(old):
            z = torch.zeros((n_tgt - n_src,) + tuple(old.shape[1:]),
                            dtype=old.dtype, device=old.device)
            parts = [old, z] if insert_at == "bottom" else [z, old]
            return torch.cat(parts, dim=0)
        return tree_map(mix0, old_stack)

    # copying family -------------------------------------------------------
    base = {"copying_zeroL": "copying_stack",
            "copying_zeroN": "copying_stack"}.get(method, method)
    src = _source_index_map(n_src, n_tgt, base)
    copied = tree_map(
        lambda x: x[torch.as_tensor(src, device=x.device)], old_stack)
    if method in ("copying_zeroL", "copying_zeroN"):
        # zero the chosen sub-layers of the *new* blocks only
        flags = ([i >= n_src for i in range(n_tgt)]
                 if base != "copying_inter" else _inter_new_flags(n_src, n_tgt))
        zeroed = _zero_sublayers(copied, _LAST_LINEAR_KEYS,
                                 norm_mode=(method == "copying_zeroN"))

        def sel(z, c):
            m = torch.as_tensor(flags, device=c.device).reshape(
                (-1,) + (1,) * (c.ndim - 1))
            return torch.where(m, z, c)
        copied = tree_map(sel, zeroed, copied)
    return copied


def _fresh_blocks(cfg: ModelConfig, target_layers: int, method: str,
                  generator: Optional[torch.Generator], dtype, device):
    """The target-depth block stack the reference takes from a fresh
    model init: random draws for 'random', zeros of that shape for
    'zero'."""
    from repro_torch.models import transformer
    tcfg = cfg.with_depth(target_layers)
    n_tgt = target_layers // cfg.pattern_period
    if method == "zero":
        one = transformer.superblock_init(None, tcfg, dtype, device="meta")
        return tree_map(lambda x: torch.zeros((n_tgt,) + tuple(x.shape),
                                              dtype=x.dtype, device=device),
                        one)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    blocks = [transformer.superblock_init(generator, tcfg, dtype, device)
              for _ in range(n_tgt)]
    return tree_map(lambda *xs: torch.stack(xs), *blocks)


def expand_params(params, cfg: ModelConfig, target_layers: int, method: str,
                  generator: Optional[torch.Generator] = None,
                  insert_at: str = "bottom", dtype=torch.float32):
    """Expand a model's depth.  Non-block params (embed, head, norms) are
    inherited unchanged (the same tensors): the paper keeps them across
    expansion."""
    period = cfg.pattern_period
    if target_layers % period:
        raise ValueError((target_layers, period))
    n_tgt = target_layers // period
    device = params["embed"].device
    fresh = None
    if method in ("random", "zero"):
        fresh = _fresh_blocks(cfg, target_layers, method, generator, dtype,
                              device)
    new_params = dict(params)
    if "blocks" in params or fresh is not None:
        new_params["blocks"] = expand_stack(
            params.get("blocks"), n_tgt, method, fresh_stack=fresh,
            insert_at=insert_at)
    return new_params


def truncate_params(params, cfg: ModelConfig, num_layers: int):
    """Depth-truncated model: the first ``num_layers`` layers plus the
    shared embedding / final norm / (tied) head, the expansion's inverse.
    Non-block leaves are the same tensors; block leaves are ``x[:n_keep]``
    views of the stacked axis."""
    period = cfg.pattern_period
    if num_layers % period:
        raise ValueError(f"draft depth {num_layers} not a multiple of the "
                         f"layer pattern period {period}")
    if num_layers < 0:
        raise ValueError(f"draft depth {num_layers} < 0")
    out = {k: v for k, v in params.items() if k != "blocks"}
    n_keep = num_layers // period
    if n_keep:
        if "blocks" not in params:
            raise ValueError(f"draft depth {num_layers} exceeds model "
                             "depth 0 (zero-layer source)")
        n_src = _n_stack(params["blocks"])
        if n_keep > n_src:
            raise ValueError(f"draft depth {num_layers} exceeds model depth "
                             f"{n_src * period}")
        out["blocks"] = tree_map(lambda x: x[:n_keep], params["blocks"])
    return out


def expand_opt_state(opt_state: dict, params_new, policy: str, method: str,
                     insert_at: str = "bottom") -> dict:
    """Expand optimizer state alongside params (paper §C.2).

    Optimizer states are dicts whose params-like trees live under 'm' /
    'v'; 'step' and other scalars pass through.

    policy: 'inherit'  old layers keep OS, new layers zero
            'copy'     new layers copy their source layer's OS (copying methods)
            'reset'    all OS zeroed
    """
    def expand_moments(tree):
        if policy == "reset":
            return tree_map(torch.zeros_like, params_new)
        out = dict(tree)
        if "blocks" in params_new:
            n_tgt = _n_stack(params_new["blocks"])
            old = tree.get("blocks")
            if old is None:      # zero-layer source: no prior block OS
                out["blocks"] = tree_map(torch.zeros_like,
                                         params_new["blocks"])
            elif policy == "copy" and method in COPY_METHODS:
                out["blocks"] = expand_stack(old, n_tgt, method,
                                             insert_at=insert_at)
            else:                # inherit: old OS kept, new blocks zero
                out["blocks"] = expand_stack(old, n_tgt, "zero",
                                             insert_at=insert_at)
        return out

    new_state = {}
    for k, v in opt_state.items():
        if k in ("m", "v"):
            new_state[k] = expand_moments(v)
        elif k == "step":
            new_state[k] = torch.zeros_like(v) if policy == "reset" else v
        else:
            new_state[k] = v
    return new_state


def make_expand_fn(cfg: ModelConfig, target_layers: int, method: str,
                   insert_at: str = "bottom",
                   opt_state_policy: str = "inherit", dtype=torch.float32):
    """``(params, opt_state, generator) -> (params, opt_state)``: whole-model
    depth expansion (the reference jits it under its mesh; here it is a
    plain function run without autograd)."""
    @torch.no_grad()
    def expand_fn(params, opt_state, generator=None):
        new_p = expand_params(params, cfg, target_layers, method,
                              generator=generator, insert_at=insert_at,
                              dtype=dtype)
        new_os = expand_opt_state(opt_state, new_p, opt_state_policy, method,
                                  insert_at=insert_at)
        return new_p, new_os
    return expand_fn
