"""State-space / linear-recurrence blocks: Mamba (S6) and RWKV6 (Finch)
(``repro/models/ssm.py``).

The sequence recurrences route through ``kernels.mamba_scan.ops`` and
``kernels.rwkv6.ops``: the hand-written kernels on the card, the plain
PyTorch forms on the CPU.  Decode keeps O(1) recurrent state per row (no KV
cache) and steps it in plain PyTorch, as the reference does outside any
kernel.  The functions return new tensors and new state dicts, as the
reference's do; the model layer writes them into its cache.

On a mesh a Mamba layer runs on the rank's d_inner/model channels
(``distributed.context.mamba_tp``) and an RWKV6 time mix on its H/model
heads (``rwkv_tp``), the channel mix on its d_ff columns (``mlp_tp``):
the scan and the WKV kernels, forward and backward, see the rank's
channels and heads, and the recurrent states hold them.  ``_mamba_local``
and ``_rwkv_local`` give the leaves as a rank uses them.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import (mamba_tp, mlp_tp, model_group,
                                            rwkv_tp, tp_size)
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


def _mamba_local(p, cfg: ModelConfig):
    """(leaves as the rank's channels use them, 'model' group or None).
    Under ``mamba_tp`` ``in_proj`` (packed: the rank's xs | z columns),
    ``dt_proj`` and ``out_proj`` arrive as the rank's shards; the
    per-channel leaves and ``x_proj``'s rows, whole on every rank, are
    cut to the rank's channels here."""
    if not mamba_tp(cfg):
        return p, None
    group = model_group(cfg)
    q = dict(p)
    for name, dim in (("conv_w", 1), ("conv_b", 0), ("dt_bias", 0),
                      ("A_log", 0), ("D", 0), ("x_proj", 0)):
        q[name] = coll.split_to_model(p[name], group, dim)
    return q, group


def _mamba_project(p, x, group=None):
    """Shared pre-scan projection. x: (B, S, D) -> xs, z (B, S, d_inner),
    or the rank's channels of each under ``group``."""
    xs, z = torch.chunk(coll.copy_to_model(x, group) @ p["in_proj"], 2,
                        dim=-1)
    return xs, z


def _mamba_ssm_params(p, cfg: ModelConfig, u, group=None):
    """u: (B, S, d_inner) post-conv activations -> (dt, B_mat, C_mat).
    Under ``group`` u holds the rank's channels: its x_proj rows give a
    partial dt|B|C, summed over 'model' both ways."""
    _, dt_rank, d_state, _ = mamba_dims(cfg)
    # A float32 u (the decode's, after the float32 conv state) takes
    # bf16 weights at float32, as the reference's promotion does.
    xdbc = coll.sum_over_model(u @ p["x_proj"].to(u.dtype), group)
    dt, Bm, Cm = torch.split(xdbc, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].to(dt.dtype)
                    + p["dt_bias"])                       # (B, S, d_inner)
    return dt, Bm, Cm


def mamba_apply(p, cfg: ModelConfig, x: torch.Tensor, state=None):
    """Full-sequence Mamba block. x: (B, S, D) -> (B, S, D).

    With ``state`` (serve prefill) the incoming conv/ssm state replaces the
    zero left context, the state-returning scan runs, and the return
    becomes ``(y, new_state)``: the state a token-by-token decode of the
    same sequence would leave."""
    p, group = _mamba_local(p, cfg)
    S = x.shape[1]
    d_conv = mamba_dims(cfg)[3]
    xs, z = _mamba_project(p, x, group)
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
    dt, Bm, Cm = _mamba_ssm_params(p, cfg, u, group)
    A = -torch.exp(p["A_log"].float())                    # (d_inner, d_state)
    if state is None:
        y = scan_ops.selective_scan(u, dt, A, Bm, Cm, p["D"])
        return coll.reduce_from_model((y * F.silu(z)) @ p["out_proj"], group)
    y, h = scan_ops.selective_scan_with_state(u, dt, A, Bm, Cm, p["D"],
                                              h0=state["ssm"])
    new_state = {"conv": ctx[:, S:].to(state["conv"].dtype), "ssm": h}
    return coll.reduce_from_model((y * F.silu(z)) @ p["out_proj"],
                                  group), new_state


def mamba_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                  state) -> Tuple[torch.Tensor, dict]:
    """Prefill = ``mamba_apply`` advancing the decode state; see there."""
    return mamba_apply(p, cfg, x, state=state)


def mamba_init_state(cfg: ModelConfig, batch: int, device="cuda"):
    """Per-row decode state, float32 whatever the cache dtype (as the
    reference keeps it): the last d_conv - 1 conv inputs and the SSM
    state, over the rank's channels under ``mamba_tp``."""
    d_inner, _, d_state, d_conv = mamba_dims(cfg)
    if mamba_tp(cfg):
        d_inner //= tp_size(cfg)
    dev = torch.device(device)
    return {"conv": torch.zeros((batch, d_conv - 1, d_inner), device=dev),
            "ssm": torch.zeros((batch, d_inner, d_state), device=dev)}


def mamba_decode(p, cfg: ModelConfig, x: torch.Tensor,
                 state) -> Tuple[torch.Tensor, dict]:
    """Single-token step. x: (B, 1, D) -> (B, 1, D), carrying O(1) state.
    Rows never mix: each row's conv/ssm advance reads only that row."""
    p, group = _mamba_local(p, cfg)
    xs, z = _mamba_project(p, x, group)                    # (B, 1, d_inner)
    conv_buf = torch.cat([state["conv"], xs], dim=1)       # (B, d_conv, d_inner)
    u = torch.einsum("bcd,cd->bd", conv_buf,
                     p["conv_w"].to(conv_buf.dtype)) + p["conv_b"]
    u = F.silu(u)[:, None, :]                              # (B, 1, d_inner)
    dt, Bm, Cm = _mamba_ssm_params(p, cfg, u, group)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt[:, 0, :, None].float() * A)          # (B, d_inner, N)
    dBx = (dt[:, 0, :, None] * Bm[:, 0, None, :]).float() \
        * u[:, 0, :, None].float()
    h = state["ssm"] * dA + dBx
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0].float())
    y = (y + p["D"] * u[:, 0]).to(x.dtype)[:, None, :]
    y = y * F.silu(z)
    return coll.reduce_from_model(y @ p["out_proj"], group), \
        {"conv": conv_buf[:, 1:], "ssm": h}


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


def _rwkv_local(p, cfg: ModelConfig):
    """(time-mix leaves as the rank's heads use them, 'model' group or
    None).  Under ``rwkv_tp`` ``w_r/w_k/w_v/w_g/w_b`` arrive as the
    rank's column shards and ``w_o`` as its row shard; ``u``,
    ``w_base`` and ``ln_x``, whole on every rank, are cut to its heads
    here.  ``w_a`` and the ``mu`` lerps stay whole."""
    if not rwkv_tp(cfg):
        return p, None
    group = model_group(cfg)
    q = dict(p)
    q["u"] = coll.split_to_model(p["u"], group, 0)
    q["w_base"] = coll.split_to_model(p["w_base"], group, 0)
    q["ln_x"] = {k: coll.split_to_model(v, group, 0)
                 for k, v in p["ln_x"].items()}
    return q, group


def _rwkv_streams(p, x, prev, group=None):
    """r, k, v, g and the decay w (the rank's heads under ``group``).
    The lerps are whole; each stream's lerp enters the rank-local
    projection through ``copy_to_model``, so its gradient sums the
    ranks' heads."""
    def lerp(mu):
        return x + (prev - x) * mu

    def local(t):
        return coll.copy_to_model(t, group)
    r = local(lerp(p["mu"]["r"])) @ p["w_r"]
    k = local(lerp(p["mu"]["k"])) @ p["w_k"]
    v = local(lerp(p["mu"]["v"])) @ p["w_v"]
    g = local(lerp(p["mu"]["g"])) @ p["w_g"]
    w = p["w_base"] + local(torch.tanh(lerp(p["mu"]["w"]) @ p["w_a"])) \
        @ p["w_b"]
    w = torch.exp(-torch.exp(w.float()))                 # decay in (0, 1)
    return r, k, v, g, w


def _ln_x(p, y, group, n: int, eps: float = 1e-6):
    """``ln_x``: a LayerNorm over the whole D = ``n`` of the WKV output.
    Under ``group`` y holds the rank's heads: the mean and the variance
    sum the ranks' partial sums both ways (``sum_over_model``)."""
    if group is None:
        return apply_norm(p, y, "layernorm")
    yf = y.float()
    mu = coll.sum_over_model(yf.sum(-1, keepdim=True), group) / n
    var = coll.sum_over_model((yf - mu).square().sum(-1, keepdim=True),
                              group) / n
    out = (yf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(y.dtype)


def rwkv_time_mix(p, cfg: ModelConfig, x: torch.Tensor, state=None,
                  x_prev=None, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D).  ``state``: WKV matrix (B, H, hd, hd) or
    None (zeros); ``x_prev``: (B, D) last pre-mix input for the token shift
    (serve prefill continuation).  ``return_state=True`` also returns the
    final WKV state."""
    p, group = _rwkv_local(p, cfg)
    B, S, _ = x.shape
    _, hd = rwkv_dims(cfg)
    H = p["u"].shape[0]
    prev = _token_shift(x, None if x_prev is None else x_prev.to(x.dtype))
    r, k, v, g, w = _rwkv_streams(p, x, prev, group)
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=x.device)
    y, state_f = rwkv_ops.wkv(r.reshape(B, S, H, hd), k.reshape(B, S, H, hd),
                              v.reshape(B, S, H, hd), w.reshape(B, S, H, hd),
                              p["u"], state)
    y = _ln_x(p["ln_x"], y.reshape(B, S, H * hd), group, cfg.d_model)
    out = coll.reduce_from_model((y * F.silu(g)) @ p["w_o"], group)
    return (out, state_f) if return_state else out


def _channel_mix(p, cfg: ModelConfig, x, prev):
    """The channel mix over the token-shifted ``prev``; under ``mlp_tp``
    on the rank's d_ff columns (``cm_k`` columns, ``cm_v`` rows, the
    partial reduced over 'model'); ``cm_r`` is whole."""
    group = model_group(cfg) if mlp_tp(cfg) else None
    xr = x + (prev - x) * p["cm_mu"]["r"]
    xk = x + (prev - x) * p["cm_mu"]["k"]
    r = torch.sigmoid(xr @ p["cm_r"])
    k = torch.square(torch.relu(coll.copy_to_model(xk, group) @ p["cm_k"]))
    return r * coll.reduce_from_model(k @ p["cm_v"], group)


def rwkv_channel_mix(p, cfg: ModelConfig, x: torch.Tensor,
                     x_prev=None) -> torch.Tensor:
    prev = _token_shift(x, None if x_prev is None else x_prev.to(x.dtype))
    return _channel_mix(p, cfg, x, prev)


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
    reference keeps it); the WKV state over the rank's heads under
    ``rwkv_tp`` (the token-shift rows are whole)."""
    H, hd = rwkv_dims(cfg)
    if rwkv_tp(cfg):
        H //= tp_size(cfg)
    dev = torch.device(device)
    return {"tm_x": torch.zeros((batch, cfg.d_model), device=dev),
            "cm_x": torch.zeros((batch, cfg.d_model), device=dev),
            "wkv": torch.zeros((batch, H, hd, hd), device=dev)}


def rwkv_decode(p, cfg: ModelConfig, x: torch.Tensor,
                state) -> Tuple[torch.Tensor, dict]:
    """Single-token time mix.  x: (B, 1, D).  Rows never mix: each row's
    tm_x/wkv advance reads only that row."""
    p, group = _rwkv_local(p, cfg)
    B = x.shape[0]
    _, hd = rwkv_dims(cfg)
    H = p["u"].shape[0]
    prev = state["tm_x"][:, None, :].to(x.dtype)
    r, k, v, g, w = _rwkv_streams(p, x, prev, group)
    rh, kh, vh = (t.reshape(B, H, hd).float() for t in (r, k, v))
    wh = w.reshape(B, H, hd)
    S = state["wkv"]                                       # (B,H,hd,hd) k x v
    kv = kh[..., :, None] * vh[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rh,
                     S + p["u"].float()[None, :, :, None] * kv)
    S_new = S * wh[..., :, None] + kv
    y = _ln_x(p["ln_x"], y.reshape(B, 1, H * hd).to(x.dtype), group,
             cfg.d_model)
    out = coll.reduce_from_model((y * F.silu(g)) @ p["w_o"], group)
    return out.to(x.dtype), {**state, "tm_x": x[:, 0].to(state["tm_x"].dtype),
                             "wkv": S_new}


def rwkv_channel_mix_decode(p, cfg: ModelConfig, x: torch.Tensor, state):
    prev = state["cm_x"][:, None, :].to(x.dtype)
    return _channel_mix(p, cfg, x, prev).to(x.dtype), \
        {**state, "cm_x": x[:, 0].to(state["cm_x"].dtype)}
