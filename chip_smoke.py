#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # on a machine with one NVIDIA H100

Phases, each fatal on failure (the script exits nonzero and prints no
result):

1. the card: ``nvidia-smi`` name and power limit, torch and device names;
2. the build: every CUDA kernel of the serving and training paths (flash
   attention forward and backward, paged-attention decode, the
   Newton–Schulz chain and matmul, the RWKV6 WKV recurrence, the Mamba
   selective scan), compiled from
   the sources in this checkout at once, one ``nvcc`` per kernel package,
   with ``-Xptxas -v`` register/shared-memory use;
3. kernel parity: the flash-attention kernel against its plain PyTorch
   version on the card over dtype x causal x window x softcap x MHA/GQA x
   head dim x ragged lengths, plus jamba's attention shape and the serving
   prefill's exact shape;
4. paged parity: the paged-attention decode kernel against its plain
   version over (q, pages) dtypes x head dim x MHA/GQA x block size x
   softcap x cursors (zero, ragged, bs-1, bs, last slot), with permuted
   pages, garbage past every cursor and an all-trash row, plus the timing
   shape;
5. the contiguous main path: ``repro_torch.launch.serve.main`` serves
   ``gpt2-12l`` at full width (batch 8, prompt 512, 64 tokens, random
   weights from seed 0) with the launch counters set to 0 just before and
   read just after;
6. the continuous paged main path: ``serve.main`` with ``--continuous
   --paged``, 32 requests (prompts 128-512, budgets 16-64) into 8 slots,
   counters from 0: every request ends at its budget, the pool gets every
   page back, the paged kernel ran 12 times per masked decode step and
   flash attention never;
7. card against CPU: the same weights, a greedy B=1 P=128 8-token
   contiguous generation, and three requests through the paged scheduler,
   on the card against the port's plain CPU path fed the same tokens;
8. times, with CUDA events: each kernel, its plain version and a PyTorch
   yardstick the port never calls (``scaled_dot_product_attention``), at
   the main paths' shapes, beside the bound;
9. training parity: the Newton–Schulz chain (``ns_fused``) and ``matmul``
   against their plain versions over stack sizes, aspects, ragged dims,
   dtypes and the exact ``gpt2-12l`` shapes (the tied embedding's too),
   plus the orthogonality check; the flash-attention backward's dq, dk,
   dv against autograd of the plain version over the forward's grid and
   at the training shape;
10. the training main path: ``repro_torch.launch.train.main`` trains
   ``gpt2-12l`` at full width from a one-layer source (batch 16, 256
   tokens), expands to 12 layers mid-run and checkpoints, with every
   counter at 0 just before: the expansion step, finite losses, the
   boundary and final checkpoints, and each kernel's launches against
   the count the run implies;
11. serving that checkpoint: ``serve.main --checkpoint`` at 12 layers;
12. card against CPU: one train step at full width (depth 1, batch 2, 128
   tokens) from the same params and batch, loss and updated params;
13. training times: the Newton–Schulz chain, matmul and the flash
   backward against their plain versions and a PyTorch yardstick, beside
   the bound, and the Newton–Schulz share of a training step at 1 and 12
   layers;
14. WKV parity: the RWKV6 WKV kernel against both plain forms (per-step and
   chunked) over head dim x sequence length x batch·heads x zero/random
   initial state x dtype x decays near 0.69 and near 0.9975, y and the
   final state;
15. the RWKV6 main path: ``serve.main`` serves ``rwkv6-7b`` at full width
   and depth (batch 4, prompt 1024, 32 tokens, random weights from seed 0),
   every counter at 0 just before: one WKV launch per layer per prefill and
   no other kernel;
16. card against CPU: ``rwkv6-7b`` at full width and depth 2, a greedy
   B=2 P=80 8-token generation on the card against the CPU's prefill
   (chunked WKV form) and decode fed the same tokens;
17. WKV times at the main path's prefill shape: the kernel and both plain
   forms beside the bound, and the kernel's share of the prefill;
18. scan parity: the Mamba selective-scan kernel against both plain forms
   (per-step and chunked) over channels (16, 256, 1000, 8192) x state
   dim (4, 16) x sequence length (1, 63, 64, 1000, 1024) x batch (1, 4) x
   zero/random initial state x f32/bf16 x decays near 1 and large
   dt * A, each with and without the final state, y and the final state,
   plus the main path's exact shape;
19. the jamba main path: ``jamba-v0.1-52b`` at full width and depth 8 (one
   period; random weights drawn on the card from seed 0),
   ``ServeEngine.generate`` at batch 4, prompt 1024, 32 greedy tokens (a
   warm-up and a timed run, as ``serve.main`` runs them), then one
   ``ModelApi.loss`` forward at batch 4 x 1024, every counter at 0 just
   before: 21 scan and 3 flash launches, no other kernel;
20. card against CPU: the same weights copied to the host, a greedy B=1
   P=128 8-token generation and one B=1 x 128 loss forward;
21. scan times at the main path's prefill shape: the kernel and both
   plain forms beside the bound, and the kernel's share of the prefill;
   the flash-attention forward at jamba's attention shape.

Every main path (5, 6, 10, 11, 15, 19) starts with every kernel's launch
counter at 0 and checks every counter after it, the kernels it must not
launch included.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
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
PAGED_ARGV = ["--arch", "gpt2-12l", "--continuous", "--paged", "--max-batch",
              "8", "--requests", "32", "--prompt-len", "512", "--gen", "64",
              "--block-size", "16", "--rate", "1000", "--seed", "0"]
MAIN_SHAPE = (8, 512, 12, 64)       # (B, S, H, hd) of the main path's prefill

# The training main path: the launcher's defaults (batch 16 of 256 tokens,
# a one-layer source, Muon-NSGD under WSD) with τ at half of 12 steps.
TRAIN_STEPS, TRAIN_TAU = 12, 0.5
TRAIN_ARGV = ["--arch", "gpt2-12l", "--source-layers", "1", "--tau",
              str(TRAIN_TAU), "--steps", str(TRAIN_STEPS), "--batch", "16",
              "--seq-len", "256", "--init", "random", "--seed", "0"]
TRAIN_SHAPE = (16, 256, 12, 64)     # (B, S, H, hd) of its attention
# Newton–Schulz against its plain version, relative to the largest output
# entry: f32 sums in another order (cuBLAS or CPU against the kernel's
# k-order), which five quintic steps amplify along small singular
# directions (~1e-5 seen at the gpt2 shapes); with bf16 input and output
# the result is rounded to bf16 (a relative step of 2^-8) on both sides.
NS_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The backward against autograd of the plain version, relative to
# max(1, the largest gradient entry): f32 sums in another order; bf16
# gradients are rounded to bf16 once on each side (2^-8 relative).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# One train step, card against CPU: the loss (about 11 at random init) to
# 1e-4, every updated param to 1e-5 absolute (the update is lr = 0.01
# times an orthogonalized or normalized direction of O(0.1) entries, so a
# 1e-3 relative difference of that direction moves a weight by ~1e-6).
TRAIN_LOSS_TOL, TRAIN_PARAM_TOL = 1e-4, 1e-5

# RWKV6 serving at full width and depth: 4 prompts of 1024 tokens, 32
# greedy tokens each.  serve.main runs a warm-up and a timed generation,
# so the prefill runs twice.
RWKV_ARGV = ["--arch", "rwkv6-7b", "--batch", "4", "--prompt-len", "1024",
             "--gen", "32", "--seed", "0"]
RWKV_SHAPE = (4, 1024, 64, 64)      # (B, S, H, hd) of its WKV launches
# The WKV kernel against its plain forms, relative to max(1, max|y|) and
# max(1, max|state|): f32 sums in other orders, to the reference's own bar
# for its chunked kernel against its per-step form; with bf16 r/k/v both
# sides round y to bf16 once (2^-8 relative), the state stays f32.
WKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

# jamba at full width and depth 8 (one period of the layer pattern; full
# depth does not fit one card): 4 prompts of 1024 tokens, 32 greedy tokens
# each, then one loss forward at 4 x 1024.
JAMBA_DEPTH, JAMBA_B, JAMBA_P, JAMBA_G = 8, 4, 1024, 32
JAMBA_SCAN_SHAPE = (4, 1024, 8192, 16)   # (B, S, d_inner, N) of its scans
# The scan kernel against its plain forms, relative to max(1, max|y|) and
# max(1, max|h|): f32 sums and decay products in other orders, the
# kernel's exp on the SFU (2 ulp), to the reference's own 1e-4 bar for its
# kernel; with bf16 inputs both sides round y to bf16 once (2^-8
# relative), the state stays f32.
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# jamba card against CPU: logits relative to max(1, max|logit|), the loss
# relative to itself (f32 through 8 layers; the CPU takes the chunked
# scan, the card its kernel).
JAMBA_LOGIT_TOL, JAMBA_LOSS_TOL = 1e-4, 1e-5

# Each kernel wrapper's launch counter: (ops module key, attribute).
COUNTERS = {"flash_attention": ("fa", "KERNEL_LAUNCHES"),
            "flash_attention_bwd": ("fa", "BWD_LAUNCHES"),
            "paged_attention": ("pa", "KERNEL_LAUNCHES"),
            "ns_fused": ("ns", "NS_FUSED_LAUNCHES"),
            "matmul": ("ns", "MATMUL_LAUNCHES"),
            "wkv": ("wkv", "KERNEL_LAUNCHES"),
            "selective_scan": ("scan", "KERNEL_LAUNCHES")}
OPS = {}                            # ops module key -> module, set in main


def zero_counts():
    for mod, attr in COUNTERS.values():
        setattr(OPS[mod], attr, 0)


def read_counts() -> dict:
    return {name: getattr(OPS[mod], attr)
            for name, (mod, attr) in COUNTERS.items()}


def expect_counts(phase: str, **want):
    """Every counter equals ``want``, 0 where not named."""
    got = read_counts()
    full = {name: want.get(name, 0) for name in COUNTERS}
    if got != full:
        _fail(f"{phase}: launches {got}, expected {full}")
    return got


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
    # jamba's attention layer: GQA 32/8 at head dim 128, its prefill batch.
    cases.append((JAMBA_B, JAMBA_P, 32, 8, 128, torch.float32, True, 0, 0.0))
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


# The paged decode's timing shape: the continuous main path's batch and
# widths at its longest context (prompt 512 + 64 generated = 576 tokens).
PAGED_SHAPE = dict(B=8, H=12, KV=12, hd=64, bs=16, NB=37, cursor=575)
GARBAGE = 1e3            # scale of the finite garbage past every cursor


def paged_case(B, H, KV, hd, bs, NB, q_dtype, kv_dtype, cursors, seed,
               trash_row=True):
    """A pool with permuted physical pages, spare pages and every slot past
    a row's cursor filled with large finite garbage; with ``trash_row`` the
    last row's table is all trash (the pool's last page, garbage too).
    Returns (q, k_pages, v_pages, table int32, index int32)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    NP = B * NB + 3 + 1                         # rows' pages, spares, trash
    trash = NP - 1

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    q = randn(B, 1, H, hd).to(q_dtype)
    kp, vp = (GARBAGE * randn(NP, bs, KV, hd) for _ in range(2))
    perm = torch.randperm(NP - 1, generator=g, device="cuda")[:B * NB]
    table = perm.reshape(B, NB).to(torch.int32)
    if trash_row:
        table[-1] = trash
    index = torch.as_tensor(cursors, dtype=torch.int32, device="cuda")
    slot = torch.arange(NB * bs, device="cuda")
    for b in range(B - 1 if trash_row else B):  # live slots get N(0, 1)
        live = slot[slot <= int(index[b])]
        pages, offs = table[b, live // bs].long(), live % bs
        kp[pages, offs] = randn(len(live), KV, hd)
        vp[pages, offs] = randn(len(live), KV, hd)
    return q, kp.to(kv_dtype), vp.to(kv_dtype), table, index


def paged_parity(pa_ops) -> float:
    """Paged kernel against its plain version over the grid; returns the
    max abs error at the timing shape.  The all-trash row must be finite;
    every other row must agree within the tolerance."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for q_dt, kv_dt in ((f32, f32), (bf16, bf16), (f32, bf16)):
        for hd in (64, 128):
            for H, KV in ((12, 12), (8, 2)):
                for bs in (16, 64):
                    for cap in (0.0, 30.0):
                        for mode in ("zero", "ragged", "bs-1", "bs", "last"):
                            cases.append((4, H, KV, hd, bs, 256 // bs, q_dt,
                                          kv_dt, cap, mode))
    s = PAGED_SHAPE
    cases.append((s["B"], s["H"], s["KV"], s["hd"], s["bs"], s["NB"], f32,
                  f32, 0.0, "timing"))
    bad, err = 0, 0.0
    for n, (B, H, KV, hd, bs, NB, q_dt, kv_dt, cap, mode) in enumerate(cases):
        top = NB * bs - 1
        cursors = {"zero": [0] * B, "bs-1": [bs - 1] * B, "bs": [bs] * B,
                   "last": [top] * B, "timing": [s["cursor"]] * B,
                   "ragged": np.random.default_rng(n).integers(
                       0, top + 1, B).tolist()}[mode]
        q, kp, vp, tbl, idx = paged_case(B, H, KV, hd, bs, NB, q_dt, kv_dt,
                                         cursors, seed=1000 + n,
                                         trash_row=mode != "timing")
        got = pa_ops.paged_attention(q, kp, vp, tbl, idx, logit_softcap=cap,
                                     force="kernel")
        want = pa_ops.paged_attention(q, kp, vp, tbl, idx,
                                      logit_softcap=cap, force="ref")
        torch.cuda.synchronize()
        tol = TOL[bf16] if bf16 in (q_dt, kv_dt) else TOL[f32]
        live = slice(None) if mode == "timing" else slice(0, B - 1)
        err = (got[live].float() - want[live].float()).abs().max().item()
        ok = err <= tol and bool(torch.isfinite(got).all())
        bad += not ok
        print(f"  pa q {str(q_dt)[6:]:8s} kv {str(kv_dt)[6:]:8s} B{B} "
              f"H{H}/{KV} hd{hd} bs{bs} NB{NB} cap{cap:<4g} {mode:6s} "
              f"err={err:.2e} tol={tol:.0e} {'ok' if ok else 'FAIL'}")
    if bad:
        _fail(f"{bad} of {len(cases)} paged-attention parity cases")
    print(f"paged parity: {len(cases)} cases within tolerance")
    return err                                   # the last case: timing


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


def paged_main_path(cfg, serve, fa_ops, pa_ops):
    """``serve.main(PAGED_ARGV)`` with every launch counter at 0 just
    before.  Returns the paged kernel's launches."""
    from repro_torch.train import serve_scheduler
    from repro_torch.train.serve_engine import ServeEngine
    calls = [0]
    scheds = []
    decode, run = ServeEngine.decode_masked, serve_scheduler.ContinuousScheduler.run

    def counted_decode(self, *a, **kw):
        calls[0] += 1
        return decode(self, *a, **kw)

    def kept_run(self, *a, **kw):
        scheds.append(self)
        return run(self, *a, **kw)
    ServeEngine.decode_masked = counted_decode
    serve_scheduler.ContinuousScheduler.run = kept_run
    zero_counts()
    try:
        results = serve.main(PAGED_ARGV)
    finally:
        ServeEngine.decode_masked = decode
        serve_scheduler.ContinuousScheduler.run = run
    launches, flash = pa_ops.KERNEL_LAUNCHES, fa_ops.KERNEL_LAUNCHES
    expect_counts("paged main path", paged_attention=launches,
                  flash_attention=flash)
    # The requests serve.main drew: the reference's rng order (an empty
    # shared prefix, then lengths, then budgets).
    arg = {k: int(v) for k, v in zip(PAGED_ARGV, PAGED_ARGV[1:])
           if k in ("--prompt-len", "--gen", "--requests", "--seed")}
    P, G, n = arg["--prompt-len"], arg["--gen"], arg["--requests"]
    rng = np.random.default_rng(arg["--seed"])
    rng.integers(0, cfg.vocab_size, (0,))
    lens = rng.integers(max(2, P // 4), P + 1, n)
    gens = rng.integers(max(2, G // 4), max(G, 2) + 1, n)
    if len(results) != n:
        _fail(f"paged main path returned {len(results)} results")
    for r, p, g in zip(results, lens, gens):
        if r.finish_reason != "limit" or len(r.new_tokens) != g \
                or len(r.prompt) != p:
            _fail(f"request {r.uid}: {r.finish_reason} with "
                  f"{len(r.new_tokens)} of {g} tokens (prompt {len(r.prompt)} "
                  f"of {p})")
        if r.new_tokens.min() < 0 or r.new_tokens.max() >= cfg.vocab_size:
            _fail(f"request {r.uid} produced tokens outside the vocabulary")
    pool = scheds[-1].last_state.pool
    pool.check_invariants()
    if pool.free_blocks != pool.num_blocks or pool.committed_blocks:
        _fail(f"pool not returned: {pool.free_blocks} of {pool.num_blocks} "
              f"pages free, {pool.committed_blocks} committed")
    if launches != calls[0] * cfg.num_layers or launches == 0:
        _fail(f"paged kernel launched {launches} times for {calls[0]} masked "
              f"decode steps x {cfg.num_layers} layers")
    if flash != 0:
        _fail(f"the paged path launched flash attention {flash} times")
    print(f"paged main path: {n} requests at their budgets, pool "
          f"{pool.free_blocks}/{pool.num_blocks} pages free, {launches} "
          f"paged-kernel launches = {calls[0]} decode steps x "
          f"{cfg.num_layers} layers, 0 flash-attention launches")
    return launches


def paged_card_vs_cpu(cfglib, registry):
    """Three requests (prompts 100, 37, 128; 8 tokens each; 2 slots; pages
    of 16) through the paged scheduler on the card, each stream held
    against the port's plain CPU forward fed the same tokens (teacher
    forcing): tokens equal wherever the CPU top-2 margin exceeds
    ``LOGIT_TOL``."""
    from repro_torch.train.serve_engine import ServeEngine
    from repro_torch.train.serve_scheduler import ContinuousScheduler, Request
    cfg = cfglib.get_config("gpt2-12l")
    api = registry.get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(2)
    G = 8
    prompts = [rng.integers(0, cfg.vocab_size, (P,)).astype(np.int32)
               for P in (100, 37, 128)]
    eng = ServeEngine(cfg, params, device="cuda", max_len=128 + G + 1,
                      paged=True, block_size=16)
    results = ContinuousScheduler(eng, max_batch=2).run(
        [Request(prompt=p, max_new_tokens=G) for p in prompts])
    worst = np.inf
    for res, prompt in zip(results, prompts):
        P = len(prompt)
        with torch.inference_mode():
            logits, _ = api.apply(params, cfg, torch.from_numpy(
                res.tokens[None, :-1]).long())
        want = logits[0, P - 1:].numpy()                       # (G, V)
        for t in range(G):
            top2 = np.sort(want[t])[-2:]
            margin = float(top2[1] - top2[0])
            tok, cpu_tok = int(res.new_tokens[t]), int(np.argmax(want[t]))
            if tok != cpu_tok and margin > LOGIT_TOL:
                _fail(f"paged request {res.uid} step {t}: card {tok} cpu "
                      f"{cpu_tok}, top-2 margin {margin:.4f}")
            worst = min(worst, margin)
        print(f"  paged request {res.uid}: P={P} tokens "
              f"{res.new_tokens.tolist()} equal the CPU argmax")
    print(f"paged card vs cpu: 3 requests x {G} tokens equal where the "
          f"margin allows (smallest top-2 margin {worst:.4f})")


def _time_device_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each bracketed by
    its own CUDA events.  Before each launch the stream spins ~0.5 ms in a
    kernel that touches no memory (``torch.cuda._sleep``), so the host has
    queued ``fn``'s launches before the start event fires and the Python
    wrapper's host time stays out of the reading.  ``flush``, when given,
    first evicts the 50 MB L2 (the decode finds its pages cold: the other
    layers' pages pass through L2 in between); without it each launch finds
    the L2 as the previous launch left it."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def paged_times(pa_ops):
    """The paged kernel, its plain version and the SDPA yardstick at the
    timing shape, device time with the L2 flushed before each launch.  The yardstick is
    ``scaled_dot_product_attention`` over the already gathered contiguous
    (B, H, 576, hd) context: at uniform cursors the same function, but it
    reads no block table."""
    s = PAGED_SHAPE
    B, H, KV, hd, bs, NB = (s[k] for k in ("B", "H", "KV", "hd", "bs", "NB"))
    q, kp, vp, tbl, idx = paged_case(B, H, KV, hd, bs, NB, torch.float32,
                                     torch.float32, [s["cursor"]] * B,
                                     seed=4242, trash_row=False)
    junk = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def flush():
        junk.zero_()
    kernel_ms = _time_device_ms(lambda: pa_ops.paged_attention(
        q, kp, vp, tbl, idx, force="kernel"), 50, flush)
    plain_ms = _time_device_ms(lambda: pa_ops.paged_attention(
        q, kp, vp, tbl, idx, force="ref"), 20, flush)
    from repro_torch.kernels.paged_attention import ref
    S = s["cursor"] + 1
    kt, vt = (ref.gather_pages(t, tbl)[:, :S].transpose(1, 2).contiguous()
              for t in (kp, vp))
    qt = q.transpose(1, 2).contiguous()
    library_ms = _time_device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
        50, flush)
    live = int((idx.long() + 1).sum())
    pages = int(((idx.long() + 1 + bs - 1) // bs).sum())
    nbytes = (2 * live * KV * hd * kp.element_size()        # K and V
              + 2 * q.numel() * q.element_size()            # q in, out
              + 4 * pages + 4 * B)                          # table, cursor
    flops = 4 * live * H * hd
    op_ms = flops / PEAK_F32_FLOPS * 1e3
    byte_ms = nbytes / PEAK_HBM_BYTES * 1e3
    print(f"paged times at B={B} H={H} KV={KV} hd={hd} bs={bs} cursors "
          f"{s['cursor']} f32, L2 flushed: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa on the gathered context "
          f"{library_ms:.4f} ms; bound {max(op_ms, byte_ms):.4f} ms "
          f"({flops / 1e6:.1f} MFLOP -> {op_ms:.4f} ms, {nbytes / 1e6:.1f} MB "
          f"-> {byte_ms:.4f} ms)")
    warm_ms = _time_device_ms(lambda: pa_ops.paged_attention(
        q, kp, vp, tbl, idx, force="kernel"), 50)
    back_ms = _time_ms(lambda: pa_ops.paged_attention(
        q, kp, vp, tbl, idx, force="kernel"), 50)
    print(f"paged kernel with a warm L2: {warm_ms:.4f} ms; back to back, "
          f"host wrapper included: {back_ms:.4f} ms per call")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes")


# ---------------------------------------------------------------------------
# Training: Newton–Schulz, matmul and the flash-attention backward
# ---------------------------------------------------------------------------


def _rel_err(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def ns_parity(ns_ops) -> float:
    """The Newton–Schulz route (``ns_fused`` for the per-layer stacks,
    ``matmul`` for the embedding) against ``newton_schulz_ref`` per matrix,
    plus the orthogonality check.  Returns the max abs error at the main
    path's largest stack (12 x 768 x 3072, f32)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dtype in (f32, bf16):
        for L in (1, 3, 12):
            for n, m in ((64, 192), (128, 128), (192, 64), (100, 300),
                         (300, 100)):
                cases.append((L, n, m, dtype))
    cases += [(12, 768, 768, f32), (12, 3072, 768, f32), (1, 50304, 768, f32),
              (12, 768, 3072, f32)]
    g = torch.Generator(device="cuda").manual_seed(7)
    bad, err = 0, 0.0
    for L, n, m, dtype in cases:
        x = (torch.randn((L, n, m), generator=g, device="cuda") * 0.02).to(
            dtype)
        got = ns_ops.newton_schulz(x, force="kernel")
        want = ns_ops.newton_schulz(x, force="ref")
        torch.cuda.synchronize()
        rel = _rel_err(got, want)
        err = (got.float() - want.float()).abs().max().item()
        ok = rel <= NS_TOL[dtype] and bool(torch.isfinite(got).all()) \
            and got.shape == x.shape and got.dtype == x.dtype
        bad += not ok
        print(f"  ns {str(dtype)[6:]:8s} L{L:<2d} {n}x{m} route "
              f"{ns_ops.route(n, m)} rel={rel:.2e} abs={err:.2e} "
              f"tol={NS_TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
    y = ns_ops.newton_schulz(torch.randn((64, 128), generator=g,
                                         device="cuda"), force="kernel")
    s = torch.linalg.svdvals(y)
    orth = float(s.max()) < 1.35 and float(s.min()) > 0.3
    print(f"  ns orthogonality: singular values in [{float(s.min()):.3f}, "
          f"{float(s.max()):.3f}] {'ok' if orth else 'FAIL'}")
    if bad or not orth:
        _fail(f"{bad} of {len(cases)} Newton-Schulz parity cases, "
              f"orthogonality {'ok' if orth else 'FAILED'}")
    print(f"ns parity: {len(cases)} cases within tolerance")
    return err                                   # the last case


# The embedding's three products per iteration, and ragged and bf16 cases.
MATMUL_CASES = [(100, 300, 77, False, torch.float32),
                (100, 300, 77, True, torch.float32),
                (37, 200, 45, False, torch.bfloat16),
                (768, 768, 768, False, torch.float32),
                (768, 768, 50304, False, torch.float32),
                (768, 50304, 768, True, torch.float32)]


def matmul_parity(ns_ops) -> float:
    """``matmul`` against the plain product; returns the max abs error at
    the embedding's Gram (768 x 50304 @ its transpose)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    bad, err = 0, 0.0
    for M, K, N, trans_b, dtype in MATMUL_CASES:
        x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
        y = torch.randn((N, K) if trans_b else (K, N), generator=g,
                        device="cuda").to(dtype)
        got = ns_ops.matmul(x, y, trans_b=trans_b, force="kernel")
        want = ns_ops.matmul(x, y, trans_b=trans_b, force="ref")
        torch.cuda.synchronize()
        rel = _rel_err(got, want)
        err = (got.float() - want.float()).abs().max().item()
        ok = rel <= NS_TOL[dtype] and got.dtype == dtype
        bad += not ok
        print(f"  matmul {str(dtype)[6:]:8s} ({M},{K})@"
              f"{'T' if trans_b else ''}({K},{N}) rel={rel:.2e} "
              f"abs={err:.2e} tol={NS_TOL[dtype]:.0e} "
              f"{'ok' if ok else 'FAIL'}")
    if bad:
        _fail(f"{bad} of {len(MATMUL_CASES)} matmul parity cases")
    print(f"matmul parity: {len(MATMUL_CASES)} cases within tolerance")
    return err


def _bwd_pair(fa_ops, q, k, v, do, kw, force):
    """(dq, dk, dv) of attention on ``force``'s path for upstream ``do``."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, force=force, **kw)
    return torch.autograd.grad(out, leaves, do)


def bwd_parity(fa_ops) -> float:
    """The CUDA backward (through ``FlashAttentionFn``) against autograd of
    the plain version over the forward's grid and the training shape;
    returns the max abs error over dq, dk, dv at the training shape."""
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
    B, S, H, hd = TRAIN_SHAPE
    cases.append((B, S, H, H, hd, torch.float32, True, 0, 0.0))
    bad, err = 0, 0.0
    for n, (B, S, H, KV, hd, dtype, causal, window, cap) in enumerate(cases):
        q, k, v = _inputs(B, S, H, KV, hd, dtype, 5000 + n)
        do = _inputs(B, S, H, H, hd, dtype, 9000 + n)[0]
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        before = fa_ops.BWD_LAUNCHES
        got = _bwd_pair(fa_ops, q, k, v, do, kw, "kernel")
        want = _bwd_pair(fa_ops, q, k, v, do, kw, "ref")
        torch.cuda.synchronize()
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(got, want)]
        scale = max(1.0, max(b.float().abs().max().item() for b in want))
        err = max(errs)
        ok = (err <= BWD_TOL[dtype] * scale
              and fa_ops.BWD_LAUNCHES == before + 1
              and all(bool(torch.isfinite(a).all()) for a in got))
        bad += not ok
        print(f"  fa-bwd {str(dtype)[6:]:8s} B{B} S{S:<4d} H{H}/{KV} hd{hd} "
              f"c{int(causal)} w{window:<2d} cap{cap:<4g} dq/dk/dv err="
              f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} scale={scale:.2f} "
              f"{'ok' if ok else 'FAIL'}")
    if bad:
        _fail(f"{bad} of {len(cases)} flash-attention backward parity cases")
    print(f"backward parity: {len(cases)} cases within tolerance")
    return err                                   # the last case: training


def _stacked_matrix_leaves(cfg, layers) -> int:
    """Muon leaves with the layer-stack axis: one ns_fused call each."""
    from repro_torch.models import registry
    from repro_torch.optim import muon
    from repro_torch.tree import leaves_with_path
    params = registry.get_model(cfg.with_depth(layers)).init(
        None, cfg.with_depth(layers), device="meta")
    return sum(muon._is_matrix(p, x) and muon._stacked(p)
               for p, x in leaves_with_path(params))


def train_main_path(cfg, train, ckpt_dir):
    """``train.main(TRAIN_ARGV)`` with every launch counter at 0 just
    before; checks the expansion, the losses, the checkpoints and each
    kernel's launches.  Returns (result, {kernel: launches})."""
    from repro_torch.checkpoint import checkpointer as ckpt
    zero_counts()
    res = train.main(TRAIN_ARGV + ["--ckpt-dir", ckpt_dir])
    counts = read_counts()
    tau = int(TRAIN_TAU * TRAIN_STEPS)
    layers = [1] * tau + [cfg.num_layers] * (TRAIN_STEPS - tau)
    h = res.history
    if h["expansion_steps"] != [tau] or res.final_layers != cfg.num_layers:
        _fail(f"expansion at {h['expansion_steps']} to {res.final_layers} "
              f"layers, expected [{tau}] to {cfg.num_layers}")
    if h["layers"][-1] != cfg.num_layers or \
            not all(np.isfinite(h["loss"])) or not h["loss"]:
        _fail(f"training losses {h['loss']} at layers {h['layers']}")
    from repro_torch.configs.base import TrainConfig
    tc = TrainConfig()                 # the launcher's eval cadence
    evals = [s for s in range(1, TRAIN_STEPS) if s % tc.eval_every == 0]
    want = {name: 0 for name in COUNTERS}      # the kernels it never runs
    want.update(flash_attention=sum(layers)
                + tc.eval_batches * sum(layers[s] for s in evals),
                flash_attention_bwd=sum(layers),
                ns_fused=sum(_stacked_matrix_leaves(cfg, L) for L in layers),
                matmul=3 * 5 * TRAIN_STEPS)
    if counts != want:
        _fail(f"training launches {counts}, expected {want}")
    saved = ckpt.all_steps(ckpt_dir)
    if saved != [tau, TRAIN_STEPS]:
        _fail(f"checkpoints {saved}, expected [{tau}, {TRAIN_STEPS}]")
    if ckpt.load_metadata(ckpt_dir, tau)["num_layers"] != 1 or \
            ckpt.load_metadata(ckpt_dir, TRAIN_STEPS)["num_layers"] != \
            cfg.num_layers:
        _fail("checkpoint depths do not follow the expansion")
    print(f"training main path: {TRAIN_STEPS} steps, expansion at step "
          f"{tau} to {cfg.num_layers} layers, losses {h['loss'][0]:.4f} -> "
          f"{h['loss'][-1]:.4f}, checkpoints {saved}; launches {counts}")
    return res, counts


def serve_trained(serve, ckpt_dir, layers):
    """``serve.main --checkpoint`` on the grown checkpoint: one prefill per
    generation through flash attention, at the checkpoint's depth."""
    zero_counts()
    res = serve.main(["--arch", "gpt2-12l", "--checkpoint", ckpt_dir,
                      "--batch", "4", "--prompt-len", "128", "--gen", "16"])
    expect_counts("serving the checkpoint", flash_attention=2 * layers)
    if res.tokens.shape != (4, 128 + 16) or res.tokens.min() < 0 \
            or res.tokens.max() >= 50304:
        _fail(f"serving the checkpoint returned tokens {res.tokens.shape}")
    print(f"served the trained checkpoint at {layers} layers: "
          f"{2 * layers} flash-attention launches")


def train_card_vs_cpu(cfglib, registry):
    """One train step at full width (depth 1, batch 2, 128 tokens) from the
    same params and batch on the card and on the CPU."""
    from repro_torch import bridge
    from repro_torch.configs.base import OptimizerConfig, ScheduleConfig
    from repro_torch.core.schedules import make_schedule
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.optim.base import make_optimizer
    from repro_torch.train import steps
    cfg = cfglib.get_config("gpt2-12l").with_depth(1)
    opt = make_optimizer(OptimizerConfig())
    step = steps.make_train_step(cfg, opt, make_schedule(
        ScheduleConfig(), 0.01, 100))
    host = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=2, seed=0)).batch(0)
    out = {}
    for dev in ("cuda", "cpu"):
        params = registry.get_model(cfg).init(
            torch.Generator().manual_seed(0), cfg, device=dev)
        batch = {k: torch.from_numpy(v).long().to(dev)
                 for k, v in host.items()}
        t0 = time.perf_counter()
        params, _, m = step(params, opt.init(params), batch, 0)
        out[dev] = (float(m["loss"]), bridge.flatten(
            bridge.params_to_numpy(params)), time.perf_counter() - t0)
    loss_diff = abs(out["cuda"][0] - out["cpu"][0])
    worst, worst_key = 0.0, ""
    for key, want in out["cpu"][1].items():
        d = float(np.abs(out["cuda"][1][key] - want).max())
        if d > worst:
            worst, worst_key = d, key
    print(f"train card vs cpu: loss {out['cuda'][0]:.6f} vs "
          f"{out['cpu'][0]:.6f} (diff {loss_diff:.2e}, tol "
          f"{TRAIN_LOSS_TOL:.0e}); worst param diff {worst:.2e} at "
          f"{worst_key} (tol {TRAIN_PARAM_TOL:.0e}); CPU step "
          f"{out['cpu'][2]:.1f} s")
    if loss_diff > TRAIN_LOSS_TOL or worst > TRAIN_PARAM_TOL:
        _fail("one train step differs between the card and the CPU")


def _library_ns(x, steps=5, eps=1e-7):
    """The same Newton–Schulz chain as batched PyTorch calls (bmm and
    baddbmm over the stack): the yardstick, never called by the port."""
    from repro_torch.kernels.newton_schulz.ref import NS_COEFFS
    a, b, c = NS_COEFFS
    x = x / (torch.linalg.norm(x.flatten(1), dim=1)[:, None, None] + eps)
    for _ in range(steps):
        g = torch.bmm(x, x.transpose(1, 2))
        p = torch.baddbmm(g, g, g, beta=b, alpha=c)
        x = torch.baddbmm(x, p, x, beta=a, alpha=1.0)
    return x


def _bound(flops, nbytes):
    op_ms = flops / PEAK_F32_FLOPS * 1e3
    byte_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return dict(bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes")


def train_times(ns_ops, fa_ops, res, cfg):
    """ns_fused at the main path's largest stack, matmul at the
    embedding's Gram, the flash backward at the training shape, each
    against its plain version and a PyTorch yardstick, beside its bound;
    then the Newton–Schulz share of a training step per depth."""
    L, n, m = 12, 768, 3072
    x = torch.randn((L, n, m), device="cuda") * 0.02
    ns = dict(ms=_time_ms(lambda: ns_ops.ns_fused(x, force="kernel"), 10),
              plain_ms=_time_ms(lambda: ns_ops.ns_fused(x, force="ref"), 5),
              library_ms=_time_ms(lambda: _library_ns(x), 10),
              **_bound(L * 5 * (4 * n * n * m + 2 * n ** 3), 2 * 4 * L * n * m))
    print(f"ns_fused at L={L} {n}x{m} f32, 5 steps: kernel {ns['ms']:.4f} ms, "
          f"plain {ns['plain_ms']:.4f} ms, batched torch "
          f"{ns['library_ms']:.4f} ms; bound {ns['bound_ms']:.4f} ms "
          f"({ns['bound_by']})")
    for shape in ((12, 768, 768), (12, 3072, 768)):
        y = torch.randn(shape, device="cuda") * 0.02
        print(f"  newton_schulz at {shape}: kernel route "
              f"{_time_ms(lambda: ns_ops.newton_schulz(y), 10):.4f} ms")

    M, K = 768, 50304
    a = torch.randn((M, K), device="cuda")
    mm = dict(ms=_time_ms(lambda: ns_ops.matmul(a, a, trans_b=True,
                                                force="kernel"), 10),
              plain_ms=_time_ms(lambda: ns_ops.matmul(a, a, trans_b=True,
                                                      force="ref"), 10),
              library_ms=_time_ms(lambda: torch.matmul(a, a.T), 10),
              **_bound(2 * M * M * K, 4 * (2 * M * K + M * M)))
    p = torch.randn((M, M), device="cuda")
    mm_x = _time_ms(lambda: ns_ops.matmul(p, a, force="kernel"), 10)
    print(f"matmul at ({M},{K})@T: kernel {mm['ms']:.4f} ms, plain "
          f"{mm['plain_ms']:.4f} ms, torch.matmul {mm['library_ms']:.4f} ms; "
          f"bound {mm['bound_ms']:.4f} ms ({mm['bound_by']}); ({M},{M})@"
          f"({M},{K}): kernel {mm_x:.4f} ms")

    B, S, H, hd = TRAIN_SHAPE
    q, k, v = _inputs(B, S, H, H, hd, torch.float32, 777)
    do = _inputs(B, S, H, H, hd, torch.float32, 778)[0]
    out, lse = fa_ops.flash_attention_cuda(q, k, v, with_lse=True)
    bwd_ms = _time_device_ms(lambda: fa_ops.flash_attention_bwd_cuda(
        q, k, v, out, lse, do), 50)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_out = fa_ops.flash_attention(*leaves, force="ref")
    plain_ms = _time_device_ms(lambda: torch.autograd.grad(
        ref_out, leaves, do, retain_graph=True), 10)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_ms = _time_device_ms(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), dot, retain_graph=True), 50)
    fwd_ms = _time_device_ms(lambda: fa_ops.flash_attention_cuda(
        q, k, v, with_lse=True), 50)
    pairs = B * H * S * (S + 1) // 2
    bwd = dict(ms=bwd_ms, plain_ms=plain_ms, library_ms=lib_ms,
               **_bound(10 * hd * pairs,
                        4 * (8 * B * S * H * hd + B * H * S)))
    print(f"flash backward at B={B} S={S} H={H} hd={hd} causal f32: kernel "
          f"{bwd_ms:.4f} ms, plain (autograd) {plain_ms:.4f} ms, sdpa "
          f"backward {lib_ms:.4f} ms; bound {bwd['bound_ms']:.4f} ms "
          f"({bwd['bound_by']}); forward with lse {fwd_ms:.4f} ms")

    # Newton–Schulz per training step at each depth: every Muon leaf,
    # through the port's route, against the measured step time.
    from repro_torch.models import registry
    from repro_torch.optim import muon
    from repro_torch.tree import leaves_with_path
    for layers in (1, cfg.num_layers):
        dcfg = cfg.with_depth(layers)
        mats = [torch.randn(x.shape, device="cuda") * 0.02
                for p, x in leaves_with_path(registry.get_model(dcfg).init(
                    None, dcfg, device="meta")) if muon._is_matrix(p, x)]

        def all_ns():
            for mat in mats:
                muon.orthogonalize(mat)
        ns_step = _time_ms(all_ns, 3)
        dts = [dt for Ld, dt in res.step_times if Ld == layers][1:]
        step_ms = 1e3 * sum(dts) / len(dts)
        tok_s = TRAIN_SHAPE[0] * TRAIN_SHAPE[1] / (step_ms / 1e3)
        print(f"training at {layers} layers: {tok_s:.1f} tokens/s "
              f"({step_ms:.2f} ms per step over {len(dts)} steps); "
              f"Newton-Schulz {ns_step:.2f} ms per step = "
              f"{100 * ns_step / step_ms:.1f}% of the step")
    return ns, mm, bwd


# ---------------------------------------------------------------------------
# RWKV6 serving: the WKV recurrence
# ---------------------------------------------------------------------------


def wkv_case(B, S, H, hd, dtype, state, decay, seed):
    """r, k, v ~ N(0, 1) in ``dtype``; w float32 uniform in ``decay``;
    u ~ 0.1 N(0, 1); a zero or N(0, 1) initial state."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = (randn(B, S, H, hd).to(dtype) for _ in range(3))
    lo, hi = decay
    w = lo + (hi - lo) * torch.rand((B, S, H, hd), generator=g,
                                    device="cuda")
    u = 0.1 * randn(H, hd)
    s0 = randn(B, H, hd, hd) if state else torch.zeros(
        (B, H, hd, hd), device="cuda")
    return r, k, v, w, u, s0


def _rel_floor(got, want) -> float:
    want = want.float()
    scale = max(1.0, want.abs().max().item())
    return (got.float() - want).abs().max().item() / scale


# Decays at rwkv_init: w = exp(-exp(w_base)) with w_base in [-6, -1] spans
# about [0.69, 0.9975]; the grid takes each end.
WKV_DECAYS = {"near 0.69": (0.69, 0.72), "near 0.9975": (0.995, 0.9975)}


def wkv_parity(wkv_ops) -> float:
    """The WKV kernel against its per-step and chunked plain forms over
    the grid; y and the final state.  Returns the max abs error of y at the
    main path's prefill shape (f32, zero state) against the chunked form,
    the one the CPU takes there."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dtype in (f32, bf16):
        for hd in (16, 32, 64, 128):
            for S in (1, 7, 63, 64, 100, 1024):
                for B, H in ((1, 2), (4, 64)):
                    for state in (False, True):
                        for decay in WKV_DECAYS:
                            cases.append((B, S, H, hd, dtype, state, decay))
    B, S, H, hd = RWKV_SHAPE
    cases.append((B, S, H, hd, f32, False, "near 0.69"))
    bad, err = 0, 0.0
    worst = {}
    for n, (B, S, H, hd, dtype, state, decay) in enumerate(cases):
        args = wkv_case(B, S, H, hd, dtype, state, WKV_DECAYS[decay],
                        seed=3000 + n)
        y, s = wkv_ops.wkv(*args, force="kernel")
        errs = []
        for form in ("ref", "chunked"):
            want_y, want_s = wkv_ops.wkv(*args, force=form)
            errs.append((_rel_floor(y, want_y), _rel_floor(s, want_s)))
        torch.cuda.synchronize()
        err = (y.float() - want_y.float()).abs().max().item()
        ey = max(e[0] for e in errs)
        es = max(e[1] for e in errs)
        ok = (ey <= WKV_TOL[dtype] and es <= WKV_TOL[f32]
              and y.dtype == dtype and s.dtype == f32
              and bool(torch.isfinite(y).all() and torch.isfinite(s).all()))
        bad += not ok
        label = (f"{str(dtype)[6:]:8s} B{B} S{S:<4d} H{H:<2d} hd{hd:<3d} "
                 f"state {'rand' if state else 'zero'} decay {decay}")
        if dtype not in worst or ey > worst[dtype][0]:
            worst[dtype] = (ey, es, label)
        if not ok:
            print(f"  wkv {label} y rel={ey:.2e} state rel={es:.2e} FAIL")
    for dtype, (ey, es, label) in worst.items():
        print(f"  wkv worst {str(dtype)[6:]}: y rel={ey:.2e} (tol "
              f"{WKV_TOL[dtype]:.0e}), state rel={es:.2e} at {label}")
    if bad:
        _fail(f"{bad} of {len(cases)} WKV parity cases")
    print(f"wkv parity: {len(cases)} cases within tolerance against both "
          "plain forms")
    return err                                   # the last case: main shape


def rwkv_main_path(cfglib, serve):
    """``serve.main(RWKV_ARGV)`` with every counter at 0 just before:
    exactly one WKV launch per layer per prefill (warm-up and timed), no
    other kernel.  Returns (result, WKV launches, peak device bytes)."""
    cfg = cfglib.get_config("rwkv6-7b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    zero_counts()
    res = serve.main(RWKV_ARGV)
    launches = expect_counts("rwkv6 main path", wkv=2 * cfg.num_layers)["wkv"]
    peak = torch.cuda.max_memory_allocated()
    arg = {k: int(v) for k, v in zip(RWKV_ARGV, RWKV_ARGV[1:])
           if k in ("--batch", "--prompt-len", "--gen")}
    shape = (arg["--batch"], arg["--prompt-len"] + arg["--gen"])
    if res.tokens.shape != shape:
        _fail(f"rwkv6 main path returned tokens {res.tokens.shape}, "
              f"expected {shape}")
    if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
        _fail("rwkv6 main path produced tokens outside the vocabulary")
    print(f"rwkv6 main path: {launches} WKV launches (2 prefills x "
          f"{cfg.num_layers} layers, 0 in decode), no other kernel; peak "
          f"device memory {peak / 2 ** 30:.2f} GiB; prefill "
          f"{res.prefill_s * 1e3:.1f} ms, decode {res.decode_s * 1e3:.1f} ms;"
          f" phase {time.perf_counter() - t0:.1f} s")
    return res, launches, peak


def rwkv_card_vs_cpu(cfglib, registry):
    """``rwkv6-7b`` at full width and depth 2: greedy B=2, P=80, 8 tokens
    on the card, against the CPU's prefill (P=80: the chunked WKV form,
    chunks of 16) and plain decode fed the card's tokens.  Logits agree per
    step to ``LOGIT_TOL``; tokens are equal wherever the CPU's top-2 margin
    exceeds it."""
    from repro_torch.models import transformer as tr
    from repro_torch.train.serve_engine import ServeEngine
    cfg = cfglib.get_config("rwkv6-7b").with_depth(2)
    api = registry.get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    B, P, G = 2, 80, 8
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    card = ServeEngine(cfg, params, device="cuda", max_len=P + G).generate(
        prompts, G, return_logits=True)
    toks = torch.from_numpy(card.tokens).long()
    want = []
    with torch.inference_mode():
        cache = tr.lm_init_cache(params, cfg, B, P + G, torch.float32,
                                 device="cpu")
        logits, cache = tr.lm_prefill(params, cfg, toks[:, :P], cache,
                                      last_only=True)
        want.append(logits[:, 0])
        for t in range(1, G):
            logits, cache = tr.lm_decode_step(
                params, cfg, toks[:, P + t - 1:P + t], cache, P + t - 1)
            want.append(logits[:, 0])
    want = torch.stack(want, dim=1).numpy()               # (B, G, V)
    worst = 0.0
    for t in range(G):
        diff = float(np.abs(card.logits[:, t] - want[:, t]).max())
        worst = max(worst, diff)
        top2 = np.sort(want[:, t], axis=-1)[:, -2:]
        margins = top2[:, 1] - top2[:, 0]
        tok, cpu_tok = card.tokens[:, P + t], want[:, t].argmax(-1)
        print(f"  rwkv step {t}: max|logit diff|={diff:.2e} top-2 margins="
              f"{np.round(margins, 4).tolist()} tokens card={tok.tolist()} "
              f"cpu={cpu_tok.tolist()}")
        if diff > LOGIT_TOL:
            _fail(f"rwkv step {t} logits differ by {diff:.2e}")
        if np.any((tok != cpu_tok) & (margins > LOGIT_TOL)):
            _fail(f"rwkv step {t} tokens differ beyond the margin")
    print(f"rwkv card vs cpu: logits within {LOGIT_TOL:.0e} over {G} steps "
          f"(worst {worst:.2e}), tokens equal where the margin allows")


def wkv_times(wkv_ops, res, layers):
    """The kernel and both plain forms at the main path's prefill shape
    (CUDA events), beside the bound; then the WKV launches' share of the
    timed prefill."""
    B, S, H, hd = RWKV_SHAPE
    args = wkv_case(B, S, H, hd, torch.float32, False, (0.69, 0.9975), 99)
    kernel_ms = _time_device_ms(lambda: wkv_ops.wkv(*args, force="kernel"),
                                20)
    chunked_ms = _time_ms(lambda: wkv_ops.wkv(*args, force="chunked"), 3)
    step_ms = _time_ms(lambda: wkv_ops.wkv(*args, force="ref"), 3)
    r, k, v, w, u, s0 = args
    nbytes = (sum(t.numel() * t.element_size() for t in (r, k, v, w, u))
              + r.numel() * r.element_size()              # y out
              + 2 * s0.numel() * s0.element_size())       # state in, out
    bound = _bound(4 * hd * hd * B * S * H, nbytes)
    share = layers * kernel_ms / (res.prefill_s * 1e3)
    print(f"wkv times at B={B} S={S} H={H} hd={hd} f32: kernel "
          f"{kernel_ms:.4f} ms, plain chunked {chunked_ms:.4f} ms, plain "
          f"per-step {step_ms:.4f} ms, library none; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{nbytes / 1e6:.1f} MB, {4 * hd * hd * B * S * H / 1e9:.2f} GFLOP)")
    print(f"rwkv6 prefill {res.prefill_s * 1e3:.1f} ms of which {layers} "
          f"WKV launches ~{layers * kernel_ms:.1f} ms ({100 * share:.1f}%)")
    return dict(ms=kernel_ms, plain_ms=chunked_ms, library_ms=None, **bound)


# ---------------------------------------------------------------------------
# jamba: the Mamba selective scan, the MoE feed-forward, the hybrid stack
# ---------------------------------------------------------------------------

# dt and -A ranges of the scan grid: decays near 1 (dt * A in [-1e-3,
# -1e-5], the state grows over long S) and large dt * A (down to -80: it
# forgets within a step, and exp underflows to 0).
SCAN_REGIMES = {"near 1": ((0.01, 0.1), (1e-3, 1e-2)),
                "large": ((1.0, 5.0), (1.0, 16.0))}


def scan_case(B, S, d, N, dtype, h0, regime, seed):
    """u, Bm, Cm ~ N(0, 1) and dt in ``dtype``, A float32 by ``regime``
    (``"model"``: dt = softplus(N(0, 1)) and A = -(1..N), as mamba_init
    makes them); D ~ 1 + 0.1 N(0, 1); h0 zero or N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def rand(lo_hi, *shape):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(shape, generator=g, device="cuda")
    u, Bm, Cm = randn(B, S, d), randn(B, S, N), randn(B, S, N)
    if regime == "model":
        dt = torch.nn.functional.softplus(randn(B, S, d))
        A = -torch.arange(1, N + 1, device="cuda",
                          dtype=torch.float32).repeat(d, 1)
    else:
        dts, As = SCAN_REGIMES[regime]
        dt, A = rand(dts, B, S, d), -rand(As, d, N)
    Dp = 1.0 + 0.1 * randn(d)
    state = randn(B, d, N) if h0 else torch.zeros((B, d, N), device="cuda")
    return ([t.to(dtype) for t in (u, dt)] + [A]
            + [t.to(dtype) for t in (Bm, Cm)] + [Dp, state])


def scan_parity(scan_ops) -> float:
    """The scan kernel against its per-step and chunked plain forms over
    the grid, with and without the final state (y and h_final).  Returns
    the max abs error of y at the main path's prefill shape (f32, zero
    state) against the chunked form, the one the CPU takes there."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(B, S, d, N, dtype, h0, regime)
             for dtype in (f32, bf16) for d in (16, 256, 1000, 8192)
             for N in (4, 16) for S in (1, 63, 64, 1000, 1024)
             for B in (1, 4) for h0 in (False, True)
             for regime in SCAN_REGIMES]
    B, S, d, N = JAMBA_SCAN_SHAPE
    cases.append((B, S, d, N, f32, False, "model"))
    bad, err, worst = 0, 0.0, {}
    for n, (B, S, d, N, dtype, h0, regime) in enumerate(cases):
        *args, state = scan_case(B, S, d, N, dtype, h0, regime, 5000 + n)
        y, h = scan_ops.selective_scan_with_state(*args, h0=state,
                                                  force="kernel")
        y_only = scan_ops.selective_scan(*args, force="kernel") \
            if not h0 else None
        errs = []
        for form in ("ref", "chunked"):
            want_y, want_h = scan_ops.selective_scan_with_state(
                *args, h0=state, force=form)
            e = [_rel_floor(y, want_y), _rel_floor(h, want_h)]
            if y_only is not None:
                e[0] = max(e[0], _rel_floor(y_only, want_y))
            errs.append(e)
        torch.cuda.synchronize()
        err = (y.float() - want_y.float()).abs().max().item()
        ey = max(e[0] for e in errs)
        eh = max(e[1] for e in errs)
        ok = (ey <= SCAN_TOL[dtype] and eh <= SCAN_TOL[f32]
              and y.dtype == dtype and h.dtype == f32
              and bool(torch.isfinite(y).all() and torch.isfinite(h).all()))
        bad += not ok
        label = (f"{str(dtype)[6:]:8s} B{B} S{S:<4d} d{d:<4d} N{N:<2d} "
                 f"h0 {'rand' if h0 else 'zero'} dtA {regime}")
        if dtype not in worst or ey > worst[dtype][0]:
            worst[dtype] = (ey, eh, label)
        if not ok:
            print(f"  scan {label} y rel={ey:.2e} h rel={eh:.2e} FAIL")
    for dtype, (ey, eh, label) in worst.items():
        print(f"  scan worst {str(dtype)[6:]}: y rel={ey:.2e} (tol "
              f"{SCAN_TOL[dtype]:.0e}), h rel={eh:.2e} at {label}")
    if bad:
        _fail(f"{bad} of {len(cases)} selective-scan parity cases")
    n_zero = sum(not c[5] for c in cases)
    print(f"scan parity: {len(cases)} input sets ({len(cases) + n_zero} "
          "kernel calls, with and without the final state) within "
          "tolerance against both plain forms")
    return err                                   # the last case: main shape


def jamba_main_path(cfglib, registry, ServeEngine):
    """jamba at full width and depth 8: weights drawn on the card from
    seed 0, ``generate`` (warm-up and timed, as ``serve.main``) and one
    ``ModelApi.loss`` forward, with every counter at 0 just before.
    Returns (cfg, engine, timed result, launch counts, peak device
    bytes)."""
    from repro_torch.tree import tree_leaves
    cfg = cfglib.get_config("jamba-v0.1-52b").with_depth(JAMBA_DEPTH)
    api = registry.get_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"jamba init on the card: {time.perf_counter() - t0:.1f} s for "
          f"{n_params} params ({n_params * 4 / 1e9:.2f} GB f32)")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (JAMBA_B, JAMBA_P)).astype(np.int32)
    engine = ServeEngine(cfg, params, device="cuda",
                         max_len=JAMBA_P + JAMBA_G + 1)
    del params
    zero_counts()
    engine.generate(prompts, min(2, JAMBA_G))                  # warm-up
    res = engine.generate(prompts, JAMBA_G, seed=0)
    seq = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (JAMBA_B, JAMBA_P + 1))).long().cuda()
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        loss, parts = api.loss(engine.params, cfg, batch)
    torch.cuda.synchronize()
    loss_ms = (time.perf_counter() - t1) * 1e3
    n_mamba = sum(cfg.layer_kind(i) == "mamba" for i in range(JAMBA_DEPTH))
    n_attn = JAMBA_DEPTH - n_mamba
    counts = expect_counts("jamba main path",
                           selective_scan=3 * n_mamba,
                           flash_attention=3 * n_attn)
    peak = torch.cuda.max_memory_allocated()
    if res.tokens.shape != (JAMBA_B, JAMBA_P + JAMBA_G):
        _fail(f"jamba main path returned tokens {res.tokens.shape}")
    if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
        _fail("jamba main path produced tokens outside the vocabulary")
    if not (torch.isfinite(loss) and torch.isfinite(parts["aux"])):
        _fail(f"jamba loss {loss.item()} aux {parts['aux'].item()}")
    pf = JAMBA_B * JAMBA_P / res.prefill_s
    dec = JAMBA_B * (res.steps - 1) / res.decode_s
    print(f"jamba main path: {counts['selective_scan']} scan launches (2 "
          f"prefills + 1 loss forward x {n_mamba} Mamba layers) and "
          f"{counts['flash_attention']} flash launches, no other kernel")
    print(f"jamba prefill {res.prefill_s * 1e3:.1f} ms ({pf:.1f} tokens/s), "
          f"decode {res.decode_s * 1e3:.1f} ms for {res.steps - 1} steps "
          f"({res.decode_s * 1e3 / (res.steps - 1):.2f} ms per step, "
          f"{dec:.1f} tokens/s); loss forward {loss_ms:.1f} ms (loss "
          f"{loss.item():.4f}, ce {parts['ce'].item():.4f}, aux "
          f"{parts['aux'].item():.4f}); peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; phase {time.perf_counter() - t0:.1f} s")
    print("jamba sample:", res.tokens[0, JAMBA_P:JAMBA_P + 16].tolist())
    return cfg, engine, res, counts, peak


def jamba_card_vs_cpu(cfg, engine, registry):
    """The main path's weights copied to the host: a greedy B=1, P=128,
    8-token generation on the card against the CPU's prefill (P=128: the
    chunked scan) and plain decode fed the card's tokens, and one B=1 x
    128 loss forward on each.  Logits agree per step within
    ``JAMBA_LOGIT_TOL`` of max(1, max|logit|), tokens wherever the CPU's
    top-2 margin exceeds that, the loss within ``JAMBA_LOSS_TOL``."""
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    host = tree_map(lambda t: t.detach().cpu(), engine.params)
    print(f"jamba weights to the host: {time.perf_counter() - t0:.1f} s")
    api = registry.get_model(cfg)
    rng = np.random.default_rng(3)
    B, P, G = 1, 128, 8
    prompts = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    card = engine.generate(prompts, G, return_logits=True)
    toks = torch.from_numpy(card.tokens).long()
    want = []
    with torch.inference_mode():
        cache = tr.lm_init_cache(host, cfg, B, P + G, torch.float32,
                                 device="cpu")
        logits, cache = tr.lm_prefill(host, cfg, toks[:, :P], cache,
                                      last_only=True)
        want.append(logits[:, 0])
        for t in range(1, G):
            logits, cache = tr.lm_decode_step(
                host, cfg, toks[:, P + t - 1:P + t], cache, P + t - 1)
            want.append(logits[:, 0])
    want = torch.stack(want, dim=1).numpy()               # (B, G, V)
    scale = max(1.0, float(np.abs(want).max()))
    worst = 0.0
    for t in range(G):
        rel = float(np.abs(card.logits[:, t] - want[:, t]).max()) / scale
        worst = max(worst, rel)
        top2 = np.sort(want[:, t], axis=-1)[:, -2:]
        margins = top2[:, 1] - top2[:, 0]
        tok, cpu_tok = card.tokens[:, P + t], want[:, t].argmax(-1)
        print(f"  jamba step {t}: logits rel diff={rel:.2e} top-2 margin="
              f"{np.round(margins, 4).tolist()} tokens card={tok.tolist()} "
              f"cpu={cpu_tok.tolist()}")
        if rel > JAMBA_LOGIT_TOL:
            _fail(f"jamba step {t} logits differ by {rel:.2e} relative")
        if np.any((tok != cpu_tok) & (margins > JAMBA_LOGIT_TOL * scale)):
            _fail(f"jamba step {t} tokens differ beyond the margin")
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (B, P + 1))).long()
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    with torch.no_grad():
        card_loss = api.loss(engine.params, cfg,
                             {k: v.cuda() for k, v in batch.items()})[0]
        cpu_loss = api.loss(host, cfg, batch)[0]
    rel_loss = abs(card_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    print(f"jamba loss card {card_loss.item():.6f} cpu {cpu_loss.item():.6f}"
          f" rel diff {rel_loss:.2e}")
    if rel_loss > JAMBA_LOSS_TOL:
        _fail(f"jamba loss differs by {rel_loss:.2e} relative")
    print(f"jamba card vs cpu: logits within {JAMBA_LOGIT_TOL:.0e} relative "
          f"over {G} steps (worst {worst:.2e}), tokens equal where the "
          f"margin allows, loss within {JAMBA_LOSS_TOL:.0e}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    del host
    gc.collect()


def jamba_times(scan_ops, fa_ops, res, n_mamba):
    """The scan kernel and both plain forms at the main path's prefill
    shape (CUDA events), beside the bound; the scan launches' share of the
    timed prefill; and the flash-attention forward at jamba's attention
    shape beside its plain version and SDPA."""
    B, S, d, N = JAMBA_SCAN_SHAPE
    *args, state = scan_case(B, S, d, N, torch.float32, False, "model", 77)
    kernel_ms = _time_device_ms(
        lambda: scan_ops.selective_scan_with_state(*args, h0=state,
                                                   force="kernel"), 20)
    chunked_ms = _time_ms(lambda: scan_ops.selective_scan_with_state(
        *args, h0=state, force="chunked"), 3)
    step_ms = _time_ms(lambda: scan_ops.selective_scan_with_state(
        *args, h0=state, force="ref"), 2)
    u, dt, A, Bm, Cm, Dp = args
    nbytes = (sum(t.numel() * t.element_size()
                  for t in (u, dt, A, Bm, Cm, Dp))
              + u.numel() * u.element_size()              # y out
              + 2 * state.numel() * state.element_size())  # h0 in, h out
    # Per state update: dt * A, (dt u) * B_n, the update FMA and the y FMA.
    flops = 6 * B * S * d * N
    bound = _bound(flops, nbytes)
    share = n_mamba * kernel_ms / (res.prefill_s * 1e3)
    print(f"scan times at B={B} S={S} d={d} N={N} f32: kernel "
          f"{kernel_ms:.4f} ms, plain chunked {chunked_ms:.4f} ms, plain "
          f"per-step {step_ms:.4f} ms, library none; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
          f"{B * S * d * N / 1e6:.0f} M exps)")
    print(f"jamba prefill {res.prefill_s * 1e3:.1f} ms of which {n_mamba} "
          f"scan launches ~{n_mamba * kernel_ms:.2f} ms "
          f"({100 * share:.2f}%)")
    H, KV, hd = 32, 8, 128
    q, k, v = _inputs(JAMBA_B, JAMBA_P, H, KV, hd, torch.float32, 4321)
    fa_ms = _time_ms(lambda: fa_ops.flash_attention(q, k, v, force="kernel"),
                     50)
    fa_plain = _time_ms(lambda: fa_ops.flash_attention(q, k, v, force="ref"),
                        10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fa_lib = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 50)
    fa_bound = _bound(4 * JAMBA_B * H * hd * JAMBA_P * (JAMBA_P + 1) // 2,
                      sum(t.numel() * t.element_size() for t in (q, k, v, q)))
    print(f"flash at jamba's B={JAMBA_B} S={JAMBA_P} H={H}/{KV} hd={hd} "
          f"causal f32: kernel {fa_ms:.4f} ms, plain {fa_plain:.4f} ms, sdpa "
          f"{fa_lib:.4f} ms; bound {fa_bound['bound_ms']:.4f} ms "
          f"({fa_bound['bound_by']})")
    return dict(ms=kernel_ms, plain_ms=chunked_ms, library_ms=None, **bound)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs as cfglib
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.newton_schulz import ops as ns_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.launch import serve, train
    from repro_torch.models import registry
    from repro_torch.train.serve_engine import ServeEngine
    OPS.update(fa=fa_ops, pa=pa_ops, ns=ns_ops, wkv=wkv_ops, scan=scan_ops)

    # 1. the card
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. the build: one nvcc per kernel, all started together
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {list(_build.KERNELS)}")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")

    # 3-4. kernel parity on the card
    main_err = parity(fa_ops)
    paged_err = paged_parity(pa_ops)

    # 5. the contiguous main path, counters from 0
    cfg = cfglib.get_config("gpt2-12l")
    zero_counts()
    res = serve.main(MAIN_ARGV)
    # serve.main runs two generations (warm-up and timed): two prefills of
    # one launch per layer, and contiguous decode attention is plain torch.
    launches = expect_counts("main path", flash_attention=2 * cfg.num_layers)[
        "flash_attention"]
    if res.tokens.shape != (8, 512 + 64):
        _fail(f"main path returned tokens {res.tokens.shape}")
    if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
        _fail("main path produced tokens outside the vocabulary")
    print(f"main path: {launches} flash-attention launches "
          f"(2 prefills x {cfg.num_layers} layers, 0 in decode)")

    # 6. the continuous paged main path, counters from 0
    paged_launches = paged_main_path(cfg, serve, fa_ops, pa_ops)

    # 7. card against CPU
    card_vs_cpu(cfglib, registry, ServeEngine, fa_ops)
    paged_card_vs_cpu(cfglib, registry)

    # 8. times
    t = times(fa_ops)
    tp = paged_times(pa_ops)

    # 9. training parity on the card
    ns_err = ns_parity(ns_ops)
    mm_err = matmul_parity(ns_ops)
    bwd_err = bwd_parity(fa_ops)

    # 10-11. the training main path, counters from 0, then serve its
    # checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "run")
        res, train_counts = train_main_path(cfg, train, ckpt_dir)
        serve_trained(serve, ckpt_dir, cfg.num_layers)

    # 12. card against CPU, one train step
    train_card_vs_cpu(cfglib, registry)

    # 13. training times
    t_ns, t_mm, t_bwd = train_times(ns_ops, fa_ops, res, cfg)

    # 14. WKV parity on the card
    t0 = time.perf_counter()
    wkv_err = wkv_parity(wkv_ops)
    print(f"wkv parity phase {time.perf_counter() - t0:.1f} s")

    # 15. the RWKV6 main path, counters from 0
    rwkv_cfg = cfglib.get_config("rwkv6-7b")
    rwkv_res, wkv_launches, _ = rwkv_main_path(cfglib, serve)

    # 16. card against CPU
    t0 = time.perf_counter()
    rwkv_card_vs_cpu(cfglib, registry)
    print(f"rwkv card vs cpu phase {time.perf_counter() - t0:.1f} s")

    # 17. WKV times
    t_wkv = wkv_times(wkv_ops, rwkv_res, rwkv_cfg.num_layers)
    del rwkv_res

    # 18. scan parity on the card
    t0 = time.perf_counter()
    scan_err = scan_parity(scan_ops)
    print(f"scan parity phase {time.perf_counter() - t0:.1f} s")

    # 19. the jamba main path, counters from 0
    jamba_cfg, engine, jamba_res, jamba_counts, _ = jamba_main_path(
        cfglib, registry, ServeEngine)

    # 20. card against CPU
    jamba_card_vs_cpu(jamba_cfg, engine, registry)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # 21. scan times
    n_mamba = sum(jamba_cfg.layer_kind(i) == "mamba"
                  for i in range(jamba_cfg.num_layers))
    t_scan = jamba_times(scan_ops, fa_ops, jamba_res, n_mamba)

    record = {"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
         "launches": launches, "max_abs_err": main_err, **t},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/paged_attention/csrc/"
                   "paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:97",
         "launches": paged_launches, "max_abs_err": paged_err, **tp},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_bwd.cu",
         "replaces": "none (no TPU kernel: JAX differentiates its attention "
                     "itself)",
         "launches": train_counts["flash_attention_bwd"],
         "max_abs_err": bwd_err, **t_bwd},
        {"name": "ns_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/newton_schulz/csrc/"
                   "newton_schulz.cu",
         "replaces": "src/repro/kernels/newton_schulz/kernel.py:48",
         "launches": train_counts["ns_fused"], "max_abs_err": ns_err,
         **t_ns},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/newton_schulz/csrc/"
                   "newton_schulz.cu",
         "replaces": "src/repro/kernels/newton_schulz/kernel.py:79",
         "launches": train_counts["matmul"], "max_abs_err": mm_err, **t_mm},
        {"name": "wkv", "route": "cuda",
         "source": "src/repro_torch/kernels/rwkv6/csrc/wkv.cu",
         "replaces": "src/repro/kernels/rwkv6/kernel.py:71",
         "launches": wkv_launches, "max_abs_err": wkv_err, **t_wkv},
        {"name": "selective_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/mamba_scan/csrc/"
                   "selective_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan/kernel.py:49",
         "launches": jamba_counts["selective_scan"], "max_abs_err": scan_err,
         **t_scan}]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
