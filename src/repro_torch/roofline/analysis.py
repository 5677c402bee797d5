"""Roofline terms of a counted dry-run cell (``repro/roofline/
analysis.py``, on the H100's constants):

    compute term    = sum over units of FLOPs / (chips x the unit's peak)
    memory term     = bytes / (chips x HBM bandwidth)
    collective term = collective bytes / (chips x link bandwidth)

The reference takes FLOPs and bytes from its compiled HLO; the port counts
them (``roofline.torch_cost``), so ``hlo_flops`` and ``hlo_bytes`` keep the
reference's names (and JSON keys: either package's report reads either's
JSONs) but hold counted figures.  ``flops_by_unit`` splits the FLOPs by
the unit the card runs them on: f32 products outside a kernel at the f32
FMA peak (TF32 is off in the port's engines), bf16 products at the bf16
peak, a kernel region at its route's rate (3xTF32: three TF32 products an
f32 one).  A JSON without it (the reference's) is one bf16 unit.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

from repro_torch.configs.base import HW_HBM_BW, HW_LINK_BW, ModelConfig, \
    ShapeConfig
from repro_torch.roofline.torch_cost import unit_seconds

# Approximate traffic multiplier per collective (ring algorithms, large N):
# all-reduce moves ~2x the tensor, gather/scatter ~1x.
_OP_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
              "all-to-all": 1.0, "collective-permute": 1.0}


def weighted_collective_bytes(by_op: Dict[str, float]) -> float:
    return sum(v * _OP_FACTOR.get(k, 1.0) for k, v in by_op.items())


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                 # counted, not taken from HLO
    hlo_bytes: float                 # counted, outside kernel regions
    coll_bytes_weighted: float
    coll_by_op: Dict[str, float]
    model_flops: float               # 6·N(_active)·D useful-compute estimate
    per_device_memory: Optional[dict] = None
    flops_by_unit: Optional[Dict[str, float]] = None

    def _units(self) -> Dict[str, float]:
        return (self.flops_by_unit if self.flops_by_unit is not None
                else {"bf16": self.hlo_flops})

    @property
    def t_compute(self) -> float:
        return unit_seconds(self._units()) / self.chips

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HW_HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_weighted / (self.chips * HW_LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def peak_flops(self) -> float:
        """FLOP/s of one chip over this mix of units (the unit's peak when
        there is one)."""
        return self.hlo_flops / max(self.chips * self.t_compute, 1e-30)

    @property
    def roofline_fraction(self) -> float:
        """useful FLOPs / (chips × peak × achievable step time) — the score.
        Achievable time is max(terms) assuming perfect overlap."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.model_flops / (self.chips * self.peak_flops
                                   * max(t, 1e-30))

    def to_json(self) -> dict:
        return {**dataclasses.asdict(self),
                "t_compute": self.t_compute, "t_memory": self.t_memory,
                "t_collective": self.t_collective, "dominant": self.dominant,
                "useful_ratio": self.useful_ratio,
                "roofline_fraction": self.roofline_fraction}


def model_flops_estimate(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful-compute floor: 6·N·tokens (dense) / 6·N_active·tokens (MoE),
    plus causal attention window FLOPs; decode counts one token/seq."""
    n_active = cfg.param_count(active_only=True)
    if shape.mode == "train":
        tokens = shape.seq_len * shape.global_batch
        mult = 3.0               # fwd + bwd
    elif shape.mode == "prefill":
        tokens = shape.seq_len * shape.global_batch
        mult = 1.0
    else:                        # decode: one new token per sequence
        tokens = shape.global_batch
        mult = 1.0
    flops = 2.0 * n_active * tokens * mult
    # attention scores/values term
    attn_layers = sum(1 for i in range(cfg.num_layers)
                      if cfg.layer_kind(i) == "attn")
    if attn_layers:
        hd, H = cfg.head_dim, cfg.num_heads
        if shape.mode == "decode":
            ctx = shape.seq_len
            flops += mult * 4.0 * attn_layers * H * hd * ctx * shape.global_batch
        else:
            per_layer = 0.0
            for i in range(cfg.num_layers):
                if cfg.layer_kind(i) != "attn":
                    continue
                w = cfg.layer_window(i)
                eff = min(w, shape.seq_len) if w > 0 else shape.seq_len
                per_layer += 4.0 * H * hd * shape.seq_len * eff * 0.5
            flops += mult * per_layer * shape.global_batch
    return flops


def load_terms(path: str) -> RooflineTerms:
    with open(path) as f:
        d = json.load(f)
    keys = {f.name for f in dataclasses.fields(RooflineTerms)}
    return RooflineTerms(**{k: v for k, v in d.items() if k in keys})


# ---------------------------------------------------------------------------
# Paged-decode HBM-bytes-per-token model (quantized KV storage)
# ---------------------------------------------------------------------------

KV_DTYPE_BYTES = {"f32": 4, "bf16": 2, "int8": 1, "fp8": 1}
_SCALE_BYTES = 4                     # scales are always float32


def decode_kv_bytes_per_token(cfg: ModelConfig, context_len: int,
                              kv_dtype: str = "f32") -> float:
    """KV-cache HBM bytes ONE decode step streams per sequence: every
    attention layer reads its whole visible context through the block table
    (full layers: ``context_len`` slots; window layers: ``min(window,
    context_len)``; MLA: compressed ``kv_lora_rank`` rows instead of 2·KV·hd)
    plus — under quantized storage — one f32 scale per slot per KV head
    (per slot for MLA).  Writes (one token) are negligible against the
    context read and are omitted; recurrent layers stream O(1) state, also
    omitted.  This is the term quantization attacks: params and activations
    are untouched."""
    if kv_dtype not in KV_DTYPE_BYTES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    vb = KV_DTYPE_BYTES[kv_dtype]
    quantized = kv_dtype in ("int8", "fp8")
    total = 0.0
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i % cfg.pattern_period) != "attn":
            continue
        w = cfg.layer_window(i % cfg.pattern_period)
        ctx = min(w, context_len) if w > 0 else context_len
        if cfg.attention == "mla" and cfg.mla_kv_lora_rank:
            per_slot = cfg.mla_kv_lora_rank * vb
            if quantized and w <= 0:       # only pool layers carry scales
                per_slot += _SCALE_BYTES
        else:
            per_slot = 2 * cfg.num_kv_heads * cfg.head_dim * vb
            if quantized and w <= 0:
                per_slot += 2 * cfg.num_kv_heads * _SCALE_BYTES
        if w > 0 and quantized:
            # Window rings stay in the float cache dtype (f32 here) — they
            # are per-row state outside the pool.
            per_slot = 2 * cfg.num_kv_heads * cfg.head_dim \
                * KV_DTYPE_BYTES["f32"]
        total += ctx * per_slot
    return total


def decode_hbm_bytes_per_token(cfg: ModelConfig, context_len: int,
                               kv_dtype: str = "f32", batch: int = 1,
                               param_bytes_per_el: int = 4) -> float:
    """Total HBM bytes per GENERATED token per sequence for paged decode:
    the per-sequence KV stream plus the parameter read amortized over the
    decode batch (every row shares one weight stream per step).  The
    predicted speedup of a quantized pool at fixed batch is the ratio of
    these totals — exact when decode is purely bandwidth-bound."""
    kv = decode_kv_bytes_per_token(cfg, context_len, kv_dtype)
    params = cfg.param_count(active_only=True) * param_bytes_per_el
    return kv + params / max(batch, 1)


def predicted_quant_speedup(cfg: ModelConfig, context_len: int,
                            kv_dtype: str, batch: int = 1,
                            baseline: str = "f32") -> float:
    """Roofline-predicted decode speedup of ``kv_dtype`` over ``baseline``
    at the same batch (the ratio of ``decode_hbm_bytes_per_token``)."""
    return (decode_hbm_bytes_per_token(cfg, context_len, baseline, batch)
            / decode_hbm_bytes_per_token(cfg, context_len, kv_dtype, batch))
