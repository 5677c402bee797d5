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
  ptxas 12.9);
* ``hd256_f32_32key_one_raw``: the forward's hd-256 tiles at 32 keys
  (m64n32 score products) instead of 16, which fit the 227 KB a CTA may
  take in f32 only with K and V staged in turn through one raw tile (224
  KB): V's copy is issued once K is split and lands while the score
  product runs, the next K's while P V runs (every head dim stages this
  way here);
* ``hd256_bf16_32key``: the forward's hd-256 bf16 tiles at 32 keys
  instead of 16 (160 KB, one CTA an SM);
* ``hd256_bf16_bwd_8wide``: the backward's hd-256 bf16 steps at 8 keys or
  queries instead of 16 (f32's width; 16-wide f32 steps do not fit).

Splitting hd between two warpgroups (each owning 128 columns of O and
sharing P through shared memory) is not among them.

For each: registers and spills of every flash entry function from
``-Xptxas -v``; CUDA-event times of the forward at the serving prefill
(B=8, S=512, H=12, hd=64), with lse at the training shape (B=16, S=256)
and at jamba's (B=4, S=1024, H=32/8, hd=128), and of the backward at the
training shape, all causal f32; then forward and backward at gemma2-9b's
prefill shape (B=1, S=5120, H=16/8, hd=256, window 4096, softcap 50),
f32 and bf16; two rounds over the variants; each against its plain
version (bf16 against the plain version on f32 copies of the inputs).
Prints the card's name and power limit first and one JSON object last.
Builds go to ``build/flash_variants/``.
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
      load_raw<T, HD, BK, NT>(raw_k, kbase, k0 + BK, Sk, kv_stride);
      load_raw<T, HD, BK, NT>(raw_v, vbase, k0 + BK, Sk, kv_stride);
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
      load_raw<T, HD, BK, NT>(raw_k, kbase, k0 + BK, Sk, kv_stride);
      load_raw<T, HD, BK, NT>(raw_v, vbase, k0 + BK, Sk, kv_stride);
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
      load_raw<T, HD, BKQ, NT>(raw_k, k + kv_off, k0 + BKQ, Sk, kv_stride);
      load_raw<T, HD, BKQ, NT>(raw_v, v + kv_off, k0 + BKQ, Sk, kv_stride);
      cp_async_commit();
    }

    float s[BKQ / 2], dp[BKQ / 2];
    mma_slots<BKQ, HD / 8, BKQ, EXACT>(s, q_slots, kb, ks);
    mma_slots<BKQ, HD / 8, BKQ, EXACT>(dp, do_slots, vb, vs);
    wgmma_wait<0>();
'''
_DQ_OVERLAP = '''    split_kmajor<T, HD, BKQ, NT, EXACT>(kb, ks, raw_k);
    split_kmajor<T, HD, BKQ, NT, EXACT>(vb, vs, raw_v);
    fence_to_tensor_cores();
    __syncthreads();
    float s[BKQ / 2], dp[BKQ / 2];
    mma_slots<BKQ, HD / 8, BKQ, EXACT>(s, q_slots, kb, ks);
    mma_slots<BKQ, HD / 8, BKQ, EXACT>(dp, do_slots, vb, vs);
    split_trans<T, HD, BKQ, NT, EXACT>(ktb, kts, raw_k);
    wgmma_wait<0>();
    fence_to_tensor_cores();
    __syncthreads();
    if (kt < kt_end) {
      load_raw<T, HD, BKQ, NT>(raw_k, k + kv_off, k0 + BKQ, Sk, kv_stride);
      load_raw<T, HD, BKQ, NT>(raw_v, v + kv_off, k0 + BKQ, Sk, kv_stride);
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

    float st[BQS / 2], dpt[BQS / 2];
    mma_slots<BQS, HD / 8, BQS, EXACT>(st, k_slots, qb_, qs_);
    mma_slots<BQS, HD / 8, BQS, EXACT>(dpt, v_slots, dob, dos);
    wgmma_wait<0>();
'''
_DKDV_OVERLAP = '''    split_kmajor<T, HD, BQS, NT, EXACT>(qb_, qs_, raw_q);
    split_kmajor<T, HD, BQS, NT, EXACT>(dob, dos, raw_do);
    fence_to_tensor_cores();
    __syncthreads();
    float st[BQS / 2], dpt[BQS / 2];
    mma_slots<BQS, HD / 8, BQS, EXACT>(st, k_slots, qb_, qs_);
    mma_slots<BQS, HD / 8, BQS, EXACT>(dpt, v_slots, dob, dos);
    split_trans<T, HD, BQS, NT, EXACT>(qtb, qts, raw_q);
    split_trans<T, HD, BQS, NT, EXACT>(dotb, dots, raw_do);
    wgmma_wait<0>();
    fence_to_tensor_cores();
    __syncthreads();
    if (it + 1 < total) load_step(it + 1);
'''

_FWD_TWO_RAW = (
    "    cp_async_wait_all();\n"
    "    __syncthreads();                   // the tile is in; last tile's "
    "wgmma done\n" + _FWD_SPLITS)
_FWD_ONE_RAW = '''    cp_async_wait_all();
    __syncthreads();                   // K is in; last tile's wgmma done
    split_kmajor<T, HD, BK, NT, EXACT>(kb, ks, raw_k);
    fence_to_tensor_cores();
    __syncthreads();                   // the raw tile is free for V
    load_raw<T, HD, BK, NT>(raw_v, vbase, k0, Sk, kv_stride);
    cp_async_commit();
    const bool skip = (causal && k0 > qw + 63) ||
                      (window > 0 && k0 + BK - 1 < qw - window + 1);
    float s[BK / 2];
    if (!skip) mma_slots<BK, HD / 8, BK, EXACT>(s, slots, kb, ks);
    wgmma_wait<0>();
    cp_async_wait_all();
    __syncthreads();                   // V is in
    split_trans<T, HD, BK, NT, EXACT>(vb, vs, raw_v);
    fence_to_tensor_cores();
    __syncthreads();                   // the raw tile is free for next K
    if (kt < kt_end) {
      load_raw<T, HD, BK, NT>(raw_k, kbase, k0 + BK, Sk, kv_stride);
      cp_async_commit();
    }
    if (skip) continue;
'''

# name -> edits as (file, old, new, occurrences)
VARIANTS = {
    "kernel": [],
    "two_warpgroups_hd64": [
        (FWD, "constexpr int fwd_wgs() { return HD == 128 ? 2 : 1; }",
         "constexpr int fwd_wgs() { return HD == 256 ? 1 : 2; }", 1),
        (FWD, "__launch_bounds__(128 * fwd_wgs<HD>(), HD == 64 ? 2 : 1)",
         "__launch_bounds__(128 * fwd_wgs<HD>(), 1)", 1)],
    "transposed_split_during_products": [
        (FWD, _FWD_SPLITS, _FWD_OVERLAP, 1),
        (BWD, _DQ_SPLITS, _DQ_OVERLAP, 1),
        (BWD, _DKDV_SPLITS, _DKDV_OVERLAP, 1)],
    "hd256_f32_32key_one_raw": [
        (FWD, "HD == 128 ? 32 : 16;", "32;", 1),
        (FWD, "  return 64 * fwd_wgs<HD>() * HD * 4 + 2 * BK * HD * "
              "(int)sizeof(T) +",
         "  return 64 * fwd_wgs<HD>() * HD * 4 + BK * HD * (int)sizeof(T) +",
         1),
        (FWD, "  T* raw_v = raw_k + TILE;", "  T* raw_v = raw_k;", 1),
        (FWD, "  load_raw<T, HD, BK, NT>(raw_v, vbase, kt_begin * BK, Sk, "
              "kv_stride);\n", "", 1),
        (FWD, _FWD_TWO_RAW, _FWD_ONE_RAW, 1)],
    "hd256_bf16_32key": [
        (FWD, "HD == 128 ? 32 : 16;", "HD == 128 ? 32 : kExact<T> ? 32 : 16;",
         1)],
    "hd256_bf16_bwd_8wide": [
        (BWD, "return HD <= 128 ? 32 : kExact<T> ? 16 : 8;",
         "return HD <= 128 ? 32 : 8;", 1)],
}
# gemma2-9b's prefill at hd 256
GEMMA2 = dict(B=1, S=5120, H=16, KV=8, window=4096, softcap=50.0)
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
            [_build._nvcc(), *_build.flags("flash_attention"), "-o", so,
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


def inputs(B, S, H, KV, hd, seed, dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, S, n, hd), generator=g,
                             device="cuda").to(dtype)
                 for n in (H, KV, KV, H))


def hd256_cases():
    """{dtype name: (q, k, v, do, kw, plain output, plain grads)} at
    gemma2's shape; the plain version runs on f32 copies."""
    s = GEMMA2
    kw = dict(causal=True, window=s["window"], logit_softcap=s["softcap"])
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = inputs(s["B"], s["S"], s["H"], s["KV"], 256, 4, dtype)
        f32 = [x.float() for x in t]
        want = ops.flash_attention(*f32[:3], force="ref", **kw)
        leaves = [x.clone().requires_grad_() for x in f32[:3]]
        grads = torch.autograd.grad(
            ops.flash_attention(*leaves, force="ref", **kw), leaves, f32[3])
        cases[str(dtype)[6:]] = (*t, kw, want, grads)
    return cases


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
    gemma = hd256_cases()
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
            for dname, (q, k, v, do, kw, want, wgrads) in gemma.items():
                o, lse = ops.flash_attention_cuda(q, k, v, with_lse=True, **kw)
                row.setdefault(f"hd256_fwd_{dname}_ms", []).append(ms(
                    lambda: ops.flash_attention_cuda(q, k, v, **kw), 10))
                row.setdefault(f"hd256_bwd_{dname}_ms", []).append(ms(
                    lambda: ops.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                         **kw), 10))
                if rnd == 0:
                    row[f"hd256_fwd_{dname}_err"] = (
                        o.float() - want).abs().max().item()
                    grads = ops.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                         **kw)
                    row[f"hd256_bwd_{dname}_rel"] = max(
                        (a.float() - b).abs().max().item()
                        / max(1.0, b.abs().max().item())
                        for a, b in zip(grads, wgrads))
    for name, row in result["variants"].items():
        print(f"{name:34s} forward prefill {row['prefill_fwd_ms']} ms, "
              f"training with lse {row['train_fwd_lse_ms']} ms, jamba "
              f"{row['jamba_fwd_ms']} ms; backward {row['train_bwd_ms']} ms; "
              f"forward vs plain {row['prefill_fwd_err']:.2e}, backward "
              f"{row['train_bwd_rel']:.2e}; hd 256 at gemma2's shape: "
              + ", ".join(f"{key} {val}" for key, val in row.items()
                          if key.startswith("hd256_"))
              + f"; registers and spills {row['registers_spills']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
