#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # on a machine with one NVIDIA H100

Phases, each fatal on failure (the script exits nonzero and prints no
result):

1. the card: ``nvidia-smi`` name and power limit, torch and device names;
2. the build: every CUDA kernel of the serving path, compiled from the
   sources in this checkout, with ``-Xptxas -v`` register/shared-memory use;
3. kernel parity: the flash-attention kernel against its plain PyTorch
   version on the card over dtype x causal x window x softcap x MHA/GQA x
   head dim x ragged lengths, plus the serving prefill's exact shape;
4. the main path: ``repro_torch.launch.serve.main`` serves ``gpt2-12l`` at
   full width (batch 8, prompt 512, 64 tokens, random weights from seed 0)
   with the launch counters set to 0 just before and read just after;
5. card against CPU: the same weights, a greedy B=1 P=128 8-token
   generation on the card against the port's plain CPU path fed the same
   tokens;
6. times, with CUDA events: the kernel, its plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only;
   the port never calls it) at the serving prefill shape, beside the bound.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances of the kernel against its plain version on the same inputs.
# f32: both sum in f32 in another order (~1e-6 seen in practice);
# bf16: the output is rounded to bf16 (a relative step of 2^-8) on both
# sides, after sums in another order.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Card against CPU, each generated step's logits: cuBLAS, MKL and the
# kernel sum in other orders through 12 layers of float32 (TF32 off).
LOGIT_TOL = 1e-3

# H100 SXM data-sheet peaks (dense): float32 outside the tensor cores, HBM.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

MAIN_ARGV = ["--arch", "gpt2-12l", "--batch", "8", "--prompt-len", "512",
             "--gen", "64", "--seed", "0"]
MAIN_SHAPE = (8, 512, 12, 64)       # (B, S, H, hd) of the main path's prefill


def _fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _inputs(B, S, H, KV, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, S, n, hd), generator=g, device="cuda",
                             dtype=torch.float32).to(dtype)
                 for n in (H, KV, KV))


def parity(fa_ops) -> float:
    """Kernel against plain version over the grid; returns the max abs
    error at the main path's shape."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for H, KV in ((12, 12), (8, 2)):
                for S in (77, 512, 1000):
                    for causal in (True, False):
                        for window in (0, 64):
                            for cap in (0.0, 30.0):
                                cases.append((2, S, H, KV, hd, dtype, causal,
                                              window, cap))
    cases.append(MAIN_SHAPE[:3] + (MAIN_SHAPE[2], MAIN_SHAPE[3],
                                   torch.float32, True, 0, 0.0))
    bad = 0
    err = 0.0
    for n, (B, S, H, KV, hd, dtype, causal, window, cap) in enumerate(cases):
        q, k, v = _inputs(B, S, H, KV, hd, dtype, n)
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        got = fa_ops.flash_attention(q, k, v, force="kernel", **kw)
        want = fa_ops.flash_attention(q, k, v, force="ref", **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= TOL[dtype] and bool(torch.isfinite(got).all())
        bad += not ok
        print(f"  fa {str(dtype)[6:]:8s} B{B} S{S:<4d} H{H}/{KV} hd{hd} "
              f"c{int(causal)} w{window:<2d} cap{cap:<4g} err={err:.2e} "
              f"tol={TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
    if bad:
        _fail(f"{bad} of {len(cases)} flash-attention parity cases")
    print(f"parity: {len(cases)} cases within tolerance")
    return err                                   # the last case: MAIN_SHAPE


def card_vs_cpu(cfglib, registry, ServeEngine, fa_ops):
    """Greedy B=1 P=128 8-token generation on the card, held against the
    port's plain path on the CPU fed the same tokens (teacher forcing: one
    CPU forward over prompt + generated tokens gives each step's logits,
    so a near-tie cannot send the two runs down different paths)."""
    cfg = cfglib.get_config("gpt2-12l")
    api = registry.get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    P, G = 128, 8
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, P)).astype(np.int32)
    fa_ops.KERNEL_LAUNCHES = 0
    card = ServeEngine(cfg, params, device="cuda", max_len=P + G).generate(
        prompts, G, return_logits=True)
    launches = fa_ops.KERNEL_LAUNCHES
    if launches != cfg.num_layers:
        _fail(f"B=1 generation launched the kernel {launches} times, "
              f"expected {cfg.num_layers} (one prefill, none in decode)")
    with torch.inference_mode():
        cpu_logits, _ = api.apply(params, cfg,
                                  torch.from_numpy(card.tokens[:, :-1]).long())
    want = cpu_logits[0, P - 1:].numpy()                   # (G, V)
    worst = 0.0
    for t in range(G):
        top2 = np.sort(want[t])[-2:]
        margin = float(top2[1] - top2[0])
        diff = float(np.abs(card.logits[0, t] - want[t]).max())
        worst = max(worst, diff)
        tok, cpu_tok = int(card.tokens[0, P + t]), int(np.argmax(want[t]))
        print(f"  step {t}: max|logit diff|={diff:.2e} top-2 margin="
              f"{margin:.4f} token card={tok} cpu={cpu_tok}")
        if diff > LOGIT_TOL:
            _fail(f"step {t} logits differ by {diff:.2e} > {LOGIT_TOL:.0e}")
        if tok != cpu_tok and margin > LOGIT_TOL:
            _fail(f"step {t} tokens differ with top-2 margin {margin:.4f}")
    print(f"card vs cpu: logits within {LOGIT_TOL:.0e} over {G} steps "
          f"(worst {worst:.2e}), tokens equal where the margin allows")


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def times(fa_ops):
    B, S, H, hd = MAIN_SHAPE
    q, k, v = _inputs(B, S, H, H, hd, torch.float32, 12345)
    kernel_ms = _time_ms(lambda: fa_ops.flash_attention(q, k, v,
                                                        force="kernel"), 50)
    plain_ms = _time_ms(lambda: fa_ops.flash_attention(q, k, v, force="ref"),
                        10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 50)
    flops = 4 * B * H * hd * S * (S + 1) // 2          # causal pairs only
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    op_ms = flops / PEAK_F32_FLOPS * 1e3
    byte_ms = nbytes / PEAK_HBM_BYTES * 1e3
    print(f"times at B={B} S={S} H={H} hd={hd} causal f32: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms; bound {max(op_ms, byte_ms):.4f} ms "
          f"({flops / 1e9:.3f} GFLOP -> {op_ms:.4f} ms, "
          f"{nbytes / 1e6:.1f} MB -> {byte_ms:.4f} ms)")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs as cfglib
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.train.serve_engine import ServeEngine

    # 1. the card
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. the build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {list(_build.KERNELS)}")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernel parity on the card
    main_err = parity(fa_ops)

    # 4. the main path, counters from 0
    cfg = cfglib.get_config("gpt2-12l")
    fa_ops.KERNEL_LAUNCHES = 0
    res = serve.main(MAIN_ARGV)
    launches = fa_ops.KERNEL_LAUNCHES
    # serve.main runs two generations (warm-up and timed): two prefills of
    # one launch per layer, and decode attention is plain torch.
    if launches != 2 * cfg.num_layers:
        _fail(f"main path launched flash attention {launches} times, "
              f"expected {2 * cfg.num_layers}")
    if res.tokens.shape != (8, 512 + 64):
        _fail(f"main path returned tokens {res.tokens.shape}")
    if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
        _fail("main path produced tokens outside the vocabulary")
    print(f"main path: {launches} flash-attention launches "
          f"(2 prefills x {cfg.num_layers} layers, 0 in decode)")

    # 5. card against CPU
    card_vs_cpu(cfglib, registry, ServeEngine, fa_ops)

    # 6. times
    t = times(fa_ops)
    record = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
        "launches": launches, "max_abs_err": main_err, **t}]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
