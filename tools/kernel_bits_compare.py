#!/usr/bin/env python3
"""Hold the attention and recurrent kernels of this checkout to another
checkout's, bit for bit, on the cases both take.

    python3 tools/kernel_bits_compare.py --against DIR   # on the card

``DIR`` is another checkout's root (e.g. a ``git archive`` of the parent
commit unpacked into ``build/parent``).  The flash-attention, paged-decode,
WKV and selective-scan libraries of both checkouts are built with each
checkout's own ``kernels/_build.py`` (sources and flags) into
``build/kernel_bits_compare/<side>/``, then this checkout's wrappers
(``kernels/*/ops.py``) call each library in turn on the same inputs:

* flash: the forward with its logsumexp and the backward's dq, dk, dv
  over f32/bf16 x hd 64/128 x MHA/GQA x S 77/512/1000 x causal x window
  0/64 x softcap 0/30, and the serving, training and jamba shapes of
  ``chip_smoke.py``;
* paged: ``chip_smoke.py``'s paged parity grid at hd 64/128 (f32/bf16 q
  over f32, bf16, int8 and fp8 pages; MHA, G = 4, 9, 12, 16; pages of 16
  and 64; softcap 0/30; zero, ragged, bs-1, bs and last-slot cursors),
  and its timing shapes with an int64 cursor;
* wkv and scan: the inference forwards (``wkv_fwd``,
  ``selective_scan_fwd``: no chunk states saved) over ``chip_smoke.py``'s
  parity grids (phases 14 and 18; the scan with and without its final
  state), y and the final state.

A checkout whose flash entry points take one sequence length (before
S_k != S_q) is called through ``_OneLengthFlash``, on cases where the two
lengths are equal.  Every output must be bitwise equal (``torch.equal``).  Prints the card's
name and power limit first, each mismatch, and one JSON object last
(cases run and equal per kernel); exits 1 if any case differs.
"""
import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402

from repro_torch.kernels.mamba_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402

PACKAGES = ("flash_attention", "paged_attention", "rwkv6", "mamba_scan")


class _OneLengthFlash:
    """A flash library whose entry points take one S where this checkout's
    take S_q and S_k: the wrapper's calls with S_k dropped."""

    def __init__(self, lib):
        fwd, bwd = lib.flash_attention_fwd, lib.flash_attention_bwd
        fwd.restype = bwd.restype = ctypes.c_int
        fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                        + [ctypes.c_float, ctypes.c_void_p])
        bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                        + [ctypes.c_float, ctypes.c_void_p])
        # S_k follows B and S_q: argument 7 of the forward, 12 of the
        # backward.
        self.flash_attention_fwd = self._drop(fwd, 7)
        self.flash_attention_bwd = self._drop(bwd, 12)

    @staticmethod
    def _drop(fn, i: int):
        def call(*args):
            if args[i] != args[i - 1]:
                raise ValueError("a one-length flash library needs S_k == S_q")
            return fn(*args[:i], *args[i + 1:])
        call.argtypes = fn.argtypes       # the wrapper sets none on it
        return call


def _one_length(root: str) -> bool:
    path = os.path.join(root, "src", "repro_torch", "kernels",
                        "flash_attention", "csrc", "flash_attention.cu")
    with open(path) as f:
        return "int Sq, int Sk" not in f.read()


def build(root: str, side: str) -> dict:
    """{package: loaded library} of the checkout at ``root``."""
    path = os.path.join(root, "src", "repro_torch", "kernels", "_build.py")
    spec = importlib.util.spec_from_file_location(f"_build_{side}", path)
    b = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(b)
    out_dir = os.path.join(ROOT, "build", "kernel_bits_compare", side)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    procs = {}
    for name in PACKAGES:
        # A checkout that predates per-package flags has NVCC_FLAGS alone.
        flags = b.flags(name) if hasattr(b, "flags") else b.NVCC_FLAGS
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (subprocess.Popen(
            [b._nvcc(), *flags, "-o", lib, *b._sources(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {side} {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    if _one_length(root):
        libs["flash_attention"] = _OneLengthFlash(libs["flash_attention"])
    # The recurrent forwards' inference entry points, the same in every
    # checkout since they were written; set here, so that the wrappers
    # take a library whatever else it exports.
    for name, fn, n_ptr in (("rwkv6", "wkv_fwd", 8),
                            ("mamba_scan", "selective_scan_fwd", 9)):
        f = getattr(libs[name], fn)
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
    return libs


def both(libs: dict, name: str, fn):
    """``fn()`` with package ``name``'s wrapper calling each side's
    library: {side: output}."""
    out = {}
    for side, lib in libs.items():
        _build._loaded[name] = lib[name]
        out[side] = fn()
    torch.cuda.synchronize()
    return out


def _equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def flash_cases():
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        for hd in (64, 128):
            for H, KV in ((12, 12), (8, 2)):
                for S in (77, 512, 1000):
                    for causal in (True, False):
                        for window in (0, 64):
                            for cap in (0.0, 30.0):
                                yield (2, S, H, KV, hd, dtype, causal, window,
                                       cap)
    B, S, H, hd = cs.MAIN_SHAPE
    yield (B, S, H, H, hd, f32, True, 0, 0.0)
    B, S, H, hd = cs.TRAIN_SHAPE
    yield (B, S, H, H, hd, f32, True, 0, 0.0)
    yield (4, 1024, 32, 8, 128, f32, True, 0, 0.0)


def flash_compare(libs) -> dict:
    run = same = 0
    for n, (B, S, H, KV, hd, dtype, causal, window, cap) in enumerate(
            flash_cases()):
        q, k, v = cs._inputs(B, S, H, KV, hd, dtype, 7000 + n)
        do = cs._inputs(B, S, H, H, hd, dtype, 8000 + n)[0]
        kw = dict(causal=causal, window=window, logit_softcap=cap)

        def step():
            out, lse = fa_ops.flash_attention_cuda(q, k, v, with_lse=True,
                                                   **kw)
            served = fa_ops.flash_attention_cuda(q, k, v, **kw)
            return (out, lse, served) + fa_ops.flash_attention_bwd_cuda(
                q, k, v, out, lse, do, **kw)
        got = both(libs, "flash_attention", step)
        run += 1
        ok = _equal(got["this"], got["other"])
        same += ok
        if not ok:
            print(f"  flash differs: B{B} S{S} H{H}/{KV} hd{hd} {dtype} "
                  f"c{int(causal)} w{window} cap{cap}")
    print(f"flash: {same} of {run} cases bit-identical (forward, lse, "
          "serving forward, dq, dk, dv)")
    return dict(cases=run, equal=same)


def paged_compare(libs) -> dict:
    f32, bf16 = torch.float32, torch.bfloat16
    i8, f8 = torch.int8, torch.float8_e4m3fn
    cases = []
    for q_dt, kv_dt in ((f32, f32), (bf16, bf16), (f32, bf16), (f32, i8),
                        (bf16, i8), (f32, f8), (bf16, f8)):
        for hd in (64, 128):
            for H, KV in ((12, 12), (8, 2), (18, 2), (24, 2), (32, 2)):
                for bs in (16, 64) if H // KV <= 8 else (16,):
                    for cap in (0.0, 30.0):
                        for mode in ("zero", "ragged", "bs-1", "bs", "last"):
                            cases.append((4, H, KV, hd, bs, 256 // bs, q_dt,
                                          kv_dt, cap, mode))
    for s in (cs.PAGED_SHAPE, cs.G12_SHAPE):
        for kv_dt in (f32, i8, f8):
            cases.append((s["B"], s["H"], s["KV"], s["hd"], s["bs"],
                          s["NB"], f32, kv_dt, 0.0, "timing"))
    run = same = 0
    for n, (B, H, KV, hd, bs, NB, q_dt, kv_dt, cap, mode) in enumerate(
            cases):
        top = NB * bs - 1
        cursors = {"zero": [0] * B, "bs-1": [bs - 1] * B, "bs": [bs] * B,
                   "last": [top] * B, "timing": [575] * B,
                   "ragged": np.random.default_rng(n).integers(
                       0, top + 1, B).tolist()}[mode]
        q, kp, vp, tbl, idx, ks, vs = cs.paged_case(
            B, H, KV, hd, bs, NB, q_dt, kv_dt, cursors, seed=2000 + n,
            trash_row=mode != "timing")
        if mode == "timing":
            idx = idx.long()                    # the engine's int64 cursor
        got = both(libs, "paged_attention", lambda: pa_ops.paged_attention(
            q, kp, vp, tbl, idx, k_scales=ks, v_scales=vs,
            logit_softcap=cap, force="kernel"))
        run += 1
        ok = _equal(got["this"], got["other"])
        same += ok
        if not ok:
            print(f"  paged differs: q {q_dt} pages {kv_dt} B{B} H{H}/{KV} "
                  f"hd{hd} bs{bs} cap{cap} {mode}")
    print(f"paged: {same} of {run} cases bit-identical")
    return dict(cases=run, equal=same)


def wkv_compare(libs) -> dict:
    run = same = 0
    for n, (B, S, H, hd, dtype, state, decay) in enumerate(
            cs.wkv_parity_cases()):
        args = cs.wkv_case(B, S, H, hd, dtype, state, cs.WKV_DECAYS[decay],
                           seed=3000 + n, zeros=decay == "near 0")
        got = both(libs, "rwkv6", lambda: wkv_ops.wkv_cuda(*args))
        run += 1
        ok = _equal(got["this"], got["other"])
        same += ok
        if not ok:
            print(f"  wkv differs: B{B} S{S} H{H} hd{hd} {dtype} "
                  f"state {state} decay {decay}")
    print(f"wkv: {same} of {run} cases bit-identical (y, final state)")
    return dict(cases=run, equal=same)


def scan_compare(libs) -> dict:
    run = same = 0
    for n, (B, S, d, N, dtype, h0, regime) in enumerate(
            cs.scan_parity_cases()):
        *args, state = cs.scan_case(B, S, d, N, dtype, h0, regime, 5000 + n)

        def step():
            y, h = scan_ops.selective_scan_cuda(*args, h0=state)
            y_only, _ = scan_ops.selective_scan_cuda(*args,
                                                     final_state=False)
            return y, h, y_only
        got = both(libs, "mamba_scan", step)
        run += 1
        ok = _equal(got["this"], got["other"])
        same += ok
        if not ok:
            print(f"  scan differs: B{B} S{S} d{d} N{N} {dtype} h0 {h0} "
                  f"{regime}")
    print(f"scan: {same} of {run} input sets bit-identical (y with and "
          "without the final state, the final state)")
    return dict(cases=run, equal=same)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", required=True,
                    help="root of the other checkout")
    args = ap.parse_args()
    print(cs.card_line())
    libs = {"this": build(ROOT, "this"),
            "other": build(os.path.abspath(args.against), "other")}
    record = {"flash_attention": flash_compare(libs),
              "paged_attention": paged_compare(libs),
              "wkv": wkv_compare(libs), "selective_scan": scan_compare(libs)}
    print(json.dumps(record))
    return 0 if all(r["cases"] == r["equal"] for r in record.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
