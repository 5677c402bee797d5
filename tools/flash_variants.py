#!/usr/bin/env python3
"""Variants of the flash-attention kernels (``src/repro_torch/kernels/
flash_attention/csrc/``), made from the sources in this checkout by text
edits, built and measured beside them on one card.

    python3 tools/flash_variants.py        # on a machine with an H100

Variants:

* ``kernel``: the sources as they are;
* ``two_warpgroups_hd64``: the forward at hd 64 as at hd 128, two
  warpgroups of 64 query rows sharing each split tile (64 keys, 128 KB,
  one CTA of eight warps an SM instead of two CTAs of four);
* ``transposed_split_during_products``: the transposed splits (V^T in the
  forward, K^T in dq, Q^T and dO^T in dkdv) done while the score products
  run on the tensor cores, before their wait, instead of beside the K-major
  splits (the wait comes before the proxy fence; the other order crashes
  ptxas 12.9).

For each: registers and spills of every flash entry function from
``-Xptxas -v``; CUDA-event times of the forward at the serving prefill
(B=8, S=512, H=12, hd=64), with lse at the training shape (B=16, S=256)
and at jamba's (B=4, S=1024, H=32/8, hd=128), and of the backward at the
training shape, all causal f32, two rounds over the variants; the forward
and the backward against their plain versions.  Prints the card's name and
power limit first and one JSON object last.  Builds go to
``build/flash_variants/``.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

from chip_smoke import card_line, flash_registers  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

FWD, BWD = "flash_attention.cu", "flash_attention_bwd.cu"

_FWD_SPLITS = '''    split_kmajor<T, HD, BK, NT, EXACT>(kb, ks, raw_k);
    split_trans<T, HD, BK, NT, EXACT>(vb, vs, raw_v);
    fence_to_tensor_cores();
    __syncthreads();                   // the raw tile is free
    if (kt < kt_end) {
      load_raw<T, HD, BK, NT>(raw_k, kbase, k0 + BK, S, kv_stride);
      load_raw<T, HD, BK, NT>(raw_v, vbase, k0 + BK, S, kv_stride);
      cp_async_commit();
    }

    // A warpgroup skips a tile that its masks cover entirely (the online
    // softmax would add exactly nothing for it).
    if ((causal && k0 > qw + 63) ||
        (window > 0 && k0 + BK - 1 < qw - window + 1))
      continue;
    float s[BK / 2];
    mma_slots<BK, HD / 8, BK, EXACT>(s, slots, kb, ks);
    wgmma_wait<0>();
'''
_FWD_OVERLAP = '''    split_kmajor<T, HD, BK, NT, EXACT>(kb, ks, raw_k);
    fence_to_tensor_cores();
    __syncthreads();
    const bool skip = (causal && k0 > qw + 63) ||
                      (window > 0 && k0 + BK - 1 < qw - window + 1);
    float s[BK / 2];
    if (!skip) mma_slots<BK, HD / 8, BK, EXACT>(s, slots, kb, ks);
    split_trans<T, HD, BK, NT, EXACT>(vb, vs, raw_v);
    wgmma_wait<0>();
    fence_to_tensor_cores();
    __syncthreads();
    if (kt < kt_end) {
      load_raw<T, HD, BK, NT>(raw_k, kbase, k0 + BK, S, kv_stride);
      load_raw<T, HD, BK, NT>(raw_v, vbase, k0 + BK, S, kv_stride);
      cp_async_commit();
    }
    if (skip) continue;
'''
_DQ_SPLITS = '''    split_kmajor<T, HD, BKQ, NT, EXACT>(kb, ks, raw_k);
    split_kmajor<T, HD, BKQ, NT, EXACT>(vb, vs, raw_v);
    split_trans<T, HD, BKQ, NT, EXACT>(ktb, kts, raw_k);
    fence_to_tensor_cores();
    __syncthreads();                   // the raw tile is free
    if (kt < kt_end) {
      load_raw<T, HD, BKQ, NT>(raw_k, k + kv_off, k0 + BKQ, S, kv_stride);
      load_raw<T, HD, BKQ, NT>(raw_v, v + kv_off, k0 + BKQ, S, kv_stride);
      cp_async_commit();
    }

    float s[16], dp[16];
    mma_slots<32, HD / 8, BKQ, EXACT>(s, q_slots, kb, ks);
    mma_slots<32, HD / 8, BKQ, EXACT>(dp, do_slots, vb, vs);
    wgmma_wait<0>();
'''
_DQ_OVERLAP = '''    split_kmajor<T, HD, BKQ, NT, EXACT>(kb, ks, raw_k);
    split_kmajor<T, HD, BKQ, NT, EXACT>(vb, vs, raw_v);
    fence_to_tensor_cores();
    __syncthreads();
    float s[16], dp[16];
    mma_slots<32, HD / 8, BKQ, EXACT>(s, q_slots, kb, ks);
    mma_slots<32, HD / 8, BKQ, EXACT>(dp, do_slots, vb, vs);
    split_trans<T, HD, BKQ, NT, EXACT>(ktb, kts, raw_k);
    wgmma_wait<0>();
    fence_to_tensor_cores();
    __syncthreads();
    if (kt < kt_end) {
      load_raw<T, HD, BKQ, NT>(raw_k, k + kv_off, k0 + BKQ, S, kv_stride);
      load_raw<T, HD, BKQ, NT>(raw_v, v + kv_off, k0 + BKQ, S, kv_stride);
      cp_async_commit();
    }
'''
_DKDV_SPLITS = '''    split_kmajor<T, HD, BQS, NT, EXACT>(qb_, qs_, raw_q);
    split_kmajor<T, HD, BQS, NT, EXACT>(dob, dos, raw_do);
    split_trans<T, HD, BQS, NT, EXACT>(qtb, qts, raw_q);
    split_trans<T, HD, BQS, NT, EXACT>(dotb, dots, raw_do);
    fence_to_tensor_cores();
    __syncthreads();                   // the raw tile is free
    if (it + 1 < total) load_step(it + 1);

    float st[16], dpt[16];
    mma_slots<32, HD / 8, BQS, EXACT>(st, k_slots, qb_, qs_);
    mma_slots<32, HD / 8, BQS, EXACT>(dpt, v_slots, dob, dos);
    wgmma_wait<0>();
'''
_DKDV_OVERLAP = '''    split_kmajor<T, HD, BQS, NT, EXACT>(qb_, qs_, raw_q);
    split_kmajor<T, HD, BQS, NT, EXACT>(dob, dos, raw_do);
    fence_to_tensor_cores();
    __syncthreads();
    float st[16], dpt[16];
    mma_slots<32, HD / 8, BQS, EXACT>(st, k_slots, qb_, qs_);
    mma_slots<32, HD / 8, BQS, EXACT>(dpt, v_slots, dob, dos);
    split_trans<T, HD, BQS, NT, EXACT>(qtb, qts, raw_q);
    split_trans<T, HD, BQS, NT, EXACT>(dotb, dots, raw_do);
    wgmma_wait<0>();
    fence_to_tensor_cores();
    __syncthreads();
    if (it + 1 < total) load_step(it + 1);
'''

# name -> edits as (file, old, new, occurrences)
VARIANTS = {
    "kernel": [],
    "two_warpgroups_hd64": [
        (FWD, "constexpr int fwd_wgs() { return HD == 64 ? 1 : 2; }",
         "constexpr int fwd_wgs() { return 2; }", 1),
        (FWD, "__launch_bounds__(128 * fwd_wgs<HD>(), HD == 64 ? 2 : 1)",
         "__launch_bounds__(128 * fwd_wgs<HD>(), 1)", 1)],
    "transposed_split_during_products": [
        (FWD, _FWD_SPLITS, _FWD_OVERLAP, 1),
        (BWD, _DQ_SPLITS, _DQ_OVERLAP, 1),
        (BWD, _DKDV_SPLITS, _DKDV_OVERLAP, 1)],
}
OUT = os.path.join(ROOT, "build", "flash_variants")


def build() -> dict:
    """Write and compile every variant at once; {name: (library, log)}."""
    csrc = os.path.dirname(_build._sources("flash_attention")[0])
    texts = {}
    for name in os.listdir(csrc):
        with open(os.path.join(csrc, name)) as f:
            texts[name] = f.read()
    procs = {}
    for name, edits in VARIANTS.items():
        body = dict(texts)
        for fname, old, new, n in edits:
            if body[fname].count(old) != n:
                raise SystemExit(f"{name}: an edit's text occurs "
                                 f"{body[fname].count(old)} times in "
                                 f"{fname}, expected {n}")
            body[fname] = body[fname].replace(old, new)
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for fname, text in body.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        so = os.path.join(d, "flash_attention.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(d, FWD), os.path.join(d, BWD)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        built[name] = (so, log)
    return built


def ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn``, each launch after a ~0.5 ms spin so the
    host's enqueue stays out of the reading (as chip_smoke.py times)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def inputs(B, S, H, KV, hd, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, S, n, hd), generator=g, device="cuda")
                 for n in (H, KV, KV, H))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: no CUDA device")
    print(card_line())
    built = build()
    prefill = inputs(8, 512, 12, 12, 64, 1)
    train = inputs(16, 256, 12, 12, 64, 2)
    jamba = inputs(4, 1024, 32, 8, 128, 3)
    want_fwd = ops.flash_attention(*prefill[:3], force="ref")
    leaves = [t.clone().requires_grad_() for t in train[:3]]
    want_bwd = torch.autograd.grad(ops.flash_attention(*leaves, force="ref"),
                                   leaves, train[3])
    result = {"card": card_line(), "variants": {}}
    libs = {name: ctypes.CDLL(so) for name, (so, _) in built.items()}
    for rnd in range(2):
        for name in VARIANTS:
            _build._loaded["flash_attention"] = libs[name]
            row = result["variants"].setdefault(name, {
                "registers_spills": flash_registers(built[name][1]),
                "prefill_fwd_ms": [], "train_fwd_lse_ms": [],
                "jamba_fwd_ms": [], "train_bwd_ms": []})
            q, k, v, do = train
            out, lse = ops.flash_attention_cuda(q, k, v, with_lse=True)
            row["prefill_fwd_ms"].append(
                ms(lambda: ops.flash_attention_cuda(*prefill[:3])))
            row["train_fwd_lse_ms"].append(ms(
                lambda: ops.flash_attention_cuda(q, k, v, with_lse=True)))
            row["jamba_fwd_ms"].append(
                ms(lambda: ops.flash_attention_cuda(*jamba[:3]), 20))
            row["train_bwd_ms"].append(ms(
                lambda: ops.flash_attention_bwd_cuda(q, k, v, out, lse, do)))
            if rnd == 0:
                got = ops.flash_attention_cuda(*prefill[:3])
                row["prefill_fwd_err"] = (got - want_fwd).abs().max().item()
                grads = ops.flash_attention_bwd_cuda(q, k, v, out, lse, do)
                row["train_bwd_rel"] = max(
                    (a - b).abs().max().item() / max(1.0, b.abs().max().item())
                    for a, b in zip(grads, want_bwd))
    for name, row in result["variants"].items():
        print(f"{name:34s} forward prefill {row['prefill_fwd_ms']} ms, "
              f"training with lse {row['train_fwd_lse_ms']} ms, jamba "
              f"{row['jamba_fwd_ms']} ms; backward {row['train_bwd_ms']} ms; "
              f"forward vs plain {row['prefill_fwd_err']:.2e}, backward "
              f"{row['train_bwd_rel']:.2e}; registers and spills "
              f"{row['registers_spills']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
