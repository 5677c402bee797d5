#!/usr/bin/env python3
"""Variants and ablations of the RWKV6 WKV kernel (``src/repro_torch/kernels/
rwkv6/csrc/wkv.cu``), made from the source in this checkout by text edits,
built at once and measured beside it on one card.

    python3 tools/wkv_variants.py [--against DIR]   # on a machine with an H100

Variants of the source (the kernel keeps chunks of 32 steps, one CTA per (b,
h) and a 2-stage cp.async ring at hd 64):

* ``kernel``: the source as it is;
* ``chunk_16``, ``chunk_64``: chunks of 16 or 64 steps at hd 64 (one or
  four sub-chunks; three CTAs an SM or one);
* ``stages_3``: a 3-stage ring (one CTA an SM);
* ``pairwise_diag``: the diagonal score blocks always pairwise on the
  CUDA cores, as chunks with decays near 0 take them;
* ablations, whose output is not checked: ``launch_only`` (every CTA
  returns at once), ``compute_only`` (no copies of the chunks: the
  arithmetic on whatever shared memory holds), ``loads_only`` (the
  chunks' copies and the stores of y and the state, no arithmetic),
  ``no_intra`` (every intra-chunk term skipped: only the inter-chunk
  product and the state update), ``no_inter`` (the inter-chunk product
  skipped), ``no_state`` (the state update's product skipped) and
  ``no_products`` (the running products of w skipped).

For each: registers and spills of every WKV entry function (``-Xptxas -v``)
and the CTAs an SM holds at hd 64 (an export that ``_OCCUPANCY`` appends to
each variant); CUDA-event times at chip_smoke.py's
timing shape (B=4, S=1024, H=64, hd=64), f32 and bf16 r/k/v, the L2 flushed
before each launch, two rounds over the variants; the largest error of y and
the state against the plain chunked form, relative to max(1, max|.|). With
``--against DIR`` (a checkout of another commit, e.g. the parent's unpacked
by ``git archive`` into build/parent) it then times that tree's WKV kernel
and this one's in turns (other, this, this, other), each in a process of its
own. Prints the card's name and power limit first and one JSON object last.
Builds go to ``build/wkv_variants/``."""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# --src DIR: take the package from another checkout (the --against turns).
SRC_DIR = (sys.argv[sys.argv.index("--src") + 1] if "--src" in sys.argv
           else os.path.join(ROOT, "src"))
sys.path[:0] = [SRC_DIR, ROOT, os.path.join(ROOT, "tools")]

import torch  # noqa: E402

import kernel_variants as kv  # noqa: E402
from chip_smoke import (RWKV_SHAPE, _flusher, _rel_floor,  # noqa: E402
                        _time_device_ms, card_line, wkv_case,
                        wkv_registers)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rwkv6 import ops  # noqa: E402

_CHUNK = "HD >= 128 ? 16 : 32;   // steps of a chunk"
_START = "  const int nchunks = (S + C - 1) / C;\n"
_STEPS = "    const int steps = min(C, S - n * C);\n"
_LOADS_ONLY = """    if (S >= 0) {
      T* yp = y + base + (size_t)(n * C + ym0 + g) * row_step + yn0 + 2 * tq;
      for (int i = 0; i < P::TPW_Y; ++i) {
        if (ym0 + g < steps) store2(yp + 8 * i, 0.f, 0.f);
        if (ym0 + g + 8 < steps) store2(yp + 8 * row_step + 8 * i, 0.f, 0.f);
      }
      continue;
    }
"""
_VOTE = "    fast = __syncthreads_and(fast);\n"
_DIAG = "    for (int it = tid; !fast && it < NSUB * L * NG; it += NT) {"
_JOBS = "job < NSUB * (NSUB - 1 + 2 * diag);"
_AV = "    for (int kc = 0; kc < ym0 + 16; kc += 8) {"
_INTER = ("      for (int kc = 0; kc < HD; kc += 8) {\n"
          "        const int c0 = kc + tq, c1 = c0 + 4, h2 = kc / 8 % 2;\n"
          "        float f0 = 1.f, f1 = 1.f;\n#pragma unroll\n"
          "        for (int i = 0; i < NSUB - 1; ++i) {")
_STATE = ("      for (int q = 0; q < C / 8; ++q) {\n#pragma unroll\n"
          "        for (int i = 0; i < P::TPW_S; ++i) {")
_SCAN = "    for (int it = tid; it < 2 * NSUB * HD; it += NT) {"

_COPY = "        cp_async16(dst, in ? src :"

# The CTAs of a launch at head dim 64 that one SM holds, appended to every
# variant.
_OCCUPANCY = """
extern "C" int wkv_ctas_per_sm(int dtype) {
  int n = 0;
  cudaError_t err = dtype ? set_attributes<__nv_bfloat16, 64>()
                          : set_attributes<float, 64>();
  if (err == cudaSuccess)
    err = dtype ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &n, wkv_kernel<__nv_bfloat16, 64>,
                      Cfg<__nv_bfloat16, 64>::NT, Cfg<__nv_bfloat16, 64>::SMEM)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &n, wkv_kernel<float, 64>, Cfg<float, 64>::NT,
                      Cfg<float, 64>::SMEM);
  return err == cudaSuccess ? n : -1;
}
"""

# name -> edits as (old, new, occurrences)
VARIANTS = {
    "kernel": [],
    "chunk_16": [(_CHUNK, _CHUNK.replace("32;", "HD == 64 ? 16 : 32;"), 1)],
    "chunk_64": [(_CHUNK, _CHUNK.replace("32;", "HD == 64 ? 64 : 32;"), 1)],
    "stages_3": [("STAGES = 2;", "STAGES = 3;", 1)],
    "pairwise_diag": [(_VOTE, _VOTE.replace(");", ") && S < 0;"), 1)],
    "launch_only": [(_START, _START + "  if (S >= 0) return;\n", 1)],
    "compute_only": [(_COPY, _COPY.replace("cp_", "if (S < 0) cp_"), 1)],
    "loads_only": [(_STEPS, _STEPS + _LOADS_ONLY, 1)],
    "no_intra": [(_DIAG, _DIAG.replace("!fast", "S < 0"), 1),
                 (_JOBS, "job < 0;", 1),
                 (_AV, _AV.replace("kc < ym0", "kc < 0 * ym0"), 1)],
    "no_inter": [(_INTER, _INTER.replace("kc < HD", "kc < 0 * HD"), 1)],
    "no_state": [(_STATE, _STATE.replace("q < C / 8", "q < 0"), 1)],
    "no_products": [(_SCAN, _SCAN.replace("it < 2", "it < 0 * 2"), 1)],
}
ABLATIONS = ("launch_only", "compute_only", "loads_only", "no_intra",
             "no_inter", "no_state", "no_products")
OUT = os.path.join(ROOT, "build", "wkv_variants")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cases():
    B, S, H, hd = RWKV_SHAPE
    return {k: wkv_case(B, S, H, hd, dt, False, (0.69, 0.9975), 99)
            for k, dt in DTYPES.items()}


def time_only() -> dict:
    """This process's package (``--src``): the WKV kernel at the timing
    shape, f32 and bf16, L2 flushed."""
    flush = _flusher()
    out = {"src": SRC_DIR}
    for k, args in _cases().items():
        out[k] = _time_device_ms(lambda a=args: ops.wkv(*a, force="kernel"),
                                 20, flush)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wkv_variants: no CUDA device")
    if "--time-only" in sys.argv:
        print(json.dumps(time_only()))
        return 0
    print(card_line(), flush=True)
    built = kv.build(_build, "rwkv6", VARIANTS, OUT, _OCCUPANCY)
    cases = _cases()
    want = {k: ops.wkv(*a, force="chunked") for k, a in cases.items()}
    flush = _flusher()
    result = {"card": card_line(), "runs": {}}
    try:
        for rnd in range(2):
            for name, (lib, log) in built.items():
                _build._loaded["rwkv6"] = lib
                row = result["runs"].setdefault(name, {
                    "registers_spills": wkv_registers(log), "ms": {},
                    "rel_err": {}, "ctas_per_sm": {
                        k: lib.wkv_ctas_per_sm(ops._DTYPE_CODES[dt])
                        for k, dt in DTYPES.items()}})
                for k, args in cases.items():
                    def call(a=args):
                        return ops.wkv(*a, force="kernel")
                    row["ms"].setdefault(k, []).append(
                        _time_device_ms(call, 20, flush))
                    if rnd == 0 and name not in ABLATIONS:
                        y, s = call()
                        row["rel_err"][k] = (_rel_floor(y, want[k][0]),
                                             _rel_floor(s, want[k][1]))
    finally:
        _build._loaded.pop("rwkv6", None)
    for name, row in result["runs"].items():
        print(f"{name:12s} ms {row['ms']}; rel err {row['rel_err']}; "
              f"CTAs an SM {row['ctas_per_sm']}; registers, spills "
              f"{row['registers_spills']}", flush=True)
    if "--against" in sys.argv:
        result["turns"] = kv.turns(
            os.path.abspath(__file__),
            sys.argv[sys.argv.index("--against") + 1])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
