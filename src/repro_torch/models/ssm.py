"""State-space / linear-recurrence blocks: Mamba (S6) and RWKV6 (Finch)
(``repro/models/ssm.py``).

The sequence recurrences route through ``kernels.mamba_scan.ops`` and
``kernels.rwkv6.ops``: the hand-written kernels on the card, the plain
PyTorch forms on the CPU.  Decode keeps O(1) recurrent state per row (no KV
cache) and steps it in plain PyTorch, as the reference does outside any
kernel.  The functions return new tensors and new state dicts, as the
reference's do; the model layer writes them into its cache.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.models.common import (apply_norm, dense_init, normal,
                                       norm_init, resolve_device, uniform)


# ===========================================================================
# Mamba (selective SSM)
# ===========================================================================

def mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, s.d_state, s.d_conv


def _host(generator, dev: torch.device) -> torch.device:
    """Where an init computes from its draws: the generator's device (the
    CPU for none), so one seed gives the same weights on every device;
    ``meta`` stays ``meta``."""
    if dev.type == "meta":
        return dev
    return torch.device(generator.device if generator is not None
                        else "cpu")


def mamba_init(generator, cfg: ModelConfig, dtype=torch.float32,
               device="cuda"):
    """Draws in the reference's key order: in_proj, conv_w, x_proj,
    dt_proj, dt_bias, out_proj."""
    D = cfg.d_model
    d_inner, dt_rank, d_state, d_conv = mamba_dims(cfg)
    dev = resolve_device(device)

    def dense(n_in, n_out, scale=1.0):
        return dense_init(generator, n_in, n_out, dtype, scale, dev)
    in_proj = dense(D, 2 * d_inner)
    conv_w = normal(generator, (d_conv, d_inner), 1.0 / math.sqrt(d_conv),
                    dtype, dev)
    x_proj = dense(d_inner, dt_rank + 2 * d_state)
    dt_proj = dense(dt_rank, d_inner, scale=dt_rank ** 0.5)
    # dt = exp(U * (log 0.1 - log 1e-3) + log 1e-3), floored at 1e-4, then
    # the softplus inverse log(expm1(dt)), computed where the draws are made
    # and then moved (``normal``'s rule).
    host = _host(generator, dev)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(uniform(generator, (d_inner,), torch.float32, host)
                   * (hi - lo) + lo)
    dt_bias = torch.log(torch.expm1(torch.clamp(dt, min=1e-4))).to(
        dev, dtype)
    A = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=host).repeat(d_inner, 1)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": dt_bias,
        "A_log": torch.log(A).to(dev, dtype),
        "D": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense(d_inner, D),
    }


def _mamba_project(p, x):
    """Shared pre-scan projection. x: (B, S, D) -> xs, z (B, S, d_inner)."""
    xs, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    return xs, z


def _mamba_ssm_params(p, cfg: ModelConfig, u):
    """u: (B, S, d_inner) post-conv activations -> (dt, B_mat, C_mat)."""
    _, dt_rank, d_state, _ = mamba_dims(cfg)
    xdbc = u @ p["x_proj"]
    dt, Bm, Cm = torch.split(xdbc, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])     # (B, S, d_inner)
    return dt, Bm, Cm


def mamba_apply(p, cfg: ModelConfig, x: torch.Tensor, state=None):
    """Full-sequence Mamba block. x: (B, S, D) -> (B, S, D).

    With ``state`` (serve prefill) the incoming conv/ssm state replaces the
    zero left context, the state-returning scan runs, and the return
    becomes ``(y, new_state)``: the state a token-by-token decode of the
    same sequence would leave."""
    S = x.shape[1]
    d_conv = mamba_dims(cfg)[3]
    xs, z = _mamba_project(p, x)
    # Depthwise causal conv over time as the reference's sum of shifted
    # slices, in its order (left context: zeros, or the state's).
    if state is None:
        ctx = F.pad(xs, (0, 0, d_conv - 1, 0))
    else:
        ctx = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
    u = ctx[:, 0:S] * p["conv_w"][0]
    for i in range(1, d_conv):
        u = u + ctx[:, i:i + S] * p["conv_w"][i]
    u = F.silu(u + p["conv_b"])
    dt, Bm, Cm = _mamba_ssm_params(p, cfg, u)
    A = -torch.exp(p["A_log"].float())                    # (d_inner, d_state)
    if state is None:
        y = scan_ops.selective_scan(u, dt, A, Bm, Cm, p["D"])
        return (y * F.silu(z)) @ p["out_proj"]
    y, h = scan_ops.selective_scan_with_state(u, dt, A, Bm, Cm, p["D"],
                                              h0=state["ssm"])
    new_state = {"conv": ctx[:, S:].to(state["conv"].dtype), "ssm": h}
    return (y * F.silu(z)) @ p["out_proj"], new_state


def mamba_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                  state) -> Tuple[torch.Tensor, dict]:
    """Prefill = ``mamba_apply`` advancing the decode state; see there."""
    return mamba_apply(p, cfg, x, state=state)


def mamba_init_state(cfg: ModelConfig, batch: int, device="cuda"):
    """Per-row decode state, float32 whatever the cache dtype (as the
    reference keeps it): the last d_conv - 1 conv inputs and the SSM
    state."""
    d_inner, _, d_state, d_conv = mamba_dims(cfg)
    dev = torch.device(device)
    return {"conv": torch.zeros((batch, d_conv - 1, d_inner), device=dev),
            "ssm": torch.zeros((batch, d_inner, d_state), device=dev)}


def mamba_decode(p, cfg: ModelConfig, x: torch.Tensor,
                 state) -> Tuple[torch.Tensor, dict]:
    """Single-token step. x: (B, 1, D) -> (B, 1, D), carrying O(1) state.
    Rows never mix: each row's conv/ssm advance reads only that row."""
    xs, z = _mamba_project(p, x)                           # (B, 1, d_inner)
    conv_buf = torch.cat([state["conv"], xs], dim=1)       # (B, d_conv, d_inner)
    u = torch.einsum("bcd,cd->bd", conv_buf, p["conv_w"]) + p["conv_b"]
    u = F.silu(u)[:, None, :]                              # (B, 1, d_inner)
    dt, Bm, Cm = _mamba_ssm_params(p, cfg, u)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt[:, 0, :, None].float() * A)          # (B, d_inner, N)
    dBx = (dt[:, 0, :, None] * Bm[:, 0, None, :]).float() \
        * u[:, 0, :, None].float()
    h = state["ssm"] * dA + dBx
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0].float())
    y = (y + p["D"] * u[:, 0]).to(x.dtype)[:, None, :]
    y = y * F.silu(z)
    return y @ p["out_proj"], {"conv": conv_buf[:, 1:], "ssm": h}


# ===========================================================================
# RWKV6 (Finch): data-dependent decay linear attention
# ===========================================================================

def rwkv_dims(cfg: ModelConfig):
    hd = cfg.ssm.head_dim if cfg.ssm else 64
    return cfg.d_model // hd, hd


def rwkv_init(generator, cfg: ModelConfig, dtype=torch.float32,
              device="cuda"):
    D = cfg.d_model
    H, hd = rwkv_dims(cfg)
    lora = max(32, D // 64)
    dev = resolve_device(device)

    def half():
        return torch.full((D,), 0.5, dtype=dtype, device=dev)

    def dense(n_in, n_out, scale=1.0):
        return dense_init(generator, n_in, n_out, dtype, scale, dev)
    ramp = torch.arange(D, dtype=torch.float32,
                        device=_host(generator, dev)) / max(D - 1, 1)
    return {
        # token-shift interpolation factors per stream
        "mu": {n: half() for n in ("r", "k", "v", "g", "w")},
        "w_r": dense(D, D), "w_k": dense(D, D), "w_v": dense(D, D),
        "w_g": dense(D, D),
        # data-dependent decay: w = base + tanh(x Wa) Wb  (low-rank, Finch)
        "w_base": (-6.0 + 5.0 * ramp ** 0.7).to(dev, dtype),
        "w_a": dense(D, lora),
        "w_b": dense(lora, D, scale=0.1),
        "u": normal(generator, (H, hd), 0.1, dtype, dev),
        "w_o": dense(D, D),
        "ln_x": norm_init(D, "layernorm", dev),
        # channel mixing
        "cm_mu": {n: half() for n in ("r", "k")},
        "cm_r": dense(D, D),
        "cm_k": dense(D, cfg.d_ff),
        "cm_v": dense(cfg.d_ff, D),
    }


def _token_shift(x, x_prev_last=None):
    """Shift the sequence right by one.  x: (B, S, D); the first row is
    ``x_prev_last`` (B, D), or zeros."""
    if x_prev_last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev_last[:, None, :], x[:, :-1]], dim=1)


def _rwkv_streams(p, x, prev):
    def lerp(mu):
        return x + (prev - x) * mu
    r = lerp(p["mu"]["r"]) @ p["w_r"]
    k = lerp(p["mu"]["k"]) @ p["w_k"]
    v = lerp(p["mu"]["v"]) @ p["w_v"]
    g = lerp(p["mu"]["g"]) @ p["w_g"]
    w = p["w_base"] + torch.tanh(lerp(p["mu"]["w"]) @ p["w_a"]) @ p["w_b"]
    w = torch.exp(-torch.exp(w.float()))                 # decay in (0, 1)
    return r, k, v, g, w


def rwkv_time_mix(p, cfg: ModelConfig, x: torch.Tensor, state=None,
                  x_prev=None, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D).  ``state``: WKV matrix (B, H, hd, hd) or
    None (zeros); ``x_prev``: (B, D) last pre-mix input for the token shift
    (serve prefill continuation).  ``return_state=True`` also returns the
    final WKV state."""
    B, S, D = x.shape
    H, hd = rwkv_dims(cfg)
    prev = _token_shift(x, None if x_prev is None else x_prev.to(x.dtype))
    r, k, v, g, w = _rwkv_streams(p, x, prev)
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=x.device)
    y, state_f = rwkv_ops.wkv(r.reshape(B, S, H, hd), k.reshape(B, S, H, hd),
                              v.reshape(B, S, H, hd), w.reshape(B, S, H, hd),
                              p["u"], state)
    y = apply_norm(p["ln_x"], y.reshape(B, S, D), "layernorm")
    out = (y * F.silu(g)) @ p["w_o"]
    return (out, state_f) if return_state else out


def rwkv_channel_mix(p, cfg: ModelConfig, x: torch.Tensor,
                     x_prev=None) -> torch.Tensor:
    del cfg
    prev = _token_shift(x, None if x_prev is None else x_prev.to(x.dtype))
    xr = x + (prev - x) * p["cm_mu"]["r"]
    xk = x + (prev - x) * p["cm_mu"]["k"]
    r = torch.sigmoid(xr @ p["cm_r"])
    k = torch.square(torch.relu(xk @ p["cm_k"]))
    return r * (k @ p["cm_v"])


def rwkv_time_mix_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                          state) -> Tuple[torch.Tensor, dict]:
    """Prefill = ``rwkv_time_mix`` seeded from and advancing the decode
    state dict (token shift from tm_x, WKV recurrence from wkv)."""
    y, state_f = rwkv_time_mix(p, cfg, x, state=state["wkv"],
                               x_prev=state["tm_x"], return_state=True)
    return y, {**state, "tm_x": x[:, -1].to(state["tm_x"].dtype),
               "wkv": state_f}


def rwkv_channel_mix_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                             state) -> Tuple[torch.Tensor, dict]:
    """Prefill = ``rwkv_channel_mix`` advancing the token-shift state."""
    out = rwkv_channel_mix(p, cfg, x, x_prev=state["cm_x"])
    return out, {**state, "cm_x": x[:, -1].to(state["cm_x"].dtype)}


def rwkv_init_state(cfg: ModelConfig, batch: int, device="cuda"):
    """Per-row decode state, float32 whatever the cache dtype (as the
    reference keeps it)."""
    H, hd = rwkv_dims(cfg)
    dev = torch.device(device)
    return {"tm_x": torch.zeros((batch, cfg.d_model), device=dev),
            "cm_x": torch.zeros((batch, cfg.d_model), device=dev),
            "wkv": torch.zeros((batch, H, hd, hd), device=dev)}


def rwkv_decode(p, cfg: ModelConfig, x: torch.Tensor,
                state) -> Tuple[torch.Tensor, dict]:
    """Single-token time mix.  x: (B, 1, D).  Rows never mix: each row's
    tm_x/wkv advance reads only that row."""
    B, _, D = x.shape
    H, hd = rwkv_dims(cfg)
    prev = state["tm_x"][:, None, :].to(x.dtype)
    r, k, v, g, w = _rwkv_streams(p, x, prev)
    rh, kh, vh = (t.reshape(B, H, hd).float() for t in (r, k, v))
    wh = w.reshape(B, H, hd)
    S = state["wkv"]                                       # (B,H,hd,hd) k x v
    kv = kh[..., :, None] * vh[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rh,
                     S + p["u"].float()[None, :, :, None] * kv)
    S_new = S * wh[..., :, None] + kv
    y = apply_norm(p["ln_x"], y.reshape(B, 1, D).to(x.dtype), "layernorm")
    out = ((y * F.silu(g)) @ p["w_o"]).to(x.dtype)
    return out, {**state, "tm_x": x[:, 0].to(state["tm_x"].dtype),
                 "wkv": S_new}


def rwkv_channel_mix_decode(p, cfg: ModelConfig, x: torch.Tensor, state):
    del cfg
    prev = state["cm_x"][:, None, :].to(x.dtype)
    xr = x + (prev - x) * p["cm_mu"]["r"]
    xk = x + (prev - x) * p["cm_mu"]["k"]
    r = torch.sigmoid(xr @ p["cm_r"])
    k = torch.square(torch.relu(xk @ p["cm_k"]))
    return (r * (k @ p["cm_v"])).to(x.dtype), \
        {**state, "cm_x": x[:, 0].to(state["cm_x"].dtype)}
