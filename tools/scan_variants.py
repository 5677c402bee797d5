#!/usr/bin/env python3
"""Variants and ablations of the Mamba selective-scan kernel
(``src/repro_torch/kernels/mamba_scan/csrc/selective_scan.cu``), made from
the source in this checkout by text edits, built at once and measured beside
it on one card.

    python3 tools/scan_variants.py [--against DIR]   # on an H100

Variants of the source (the kernel keeps 64 channels a CTA, one thread a
channel, every exp on the SFU a step ahead of its update, a 2-chunk ring
of 16 steps):

* ``kernel``: the source as it is;
* ``poly_1``, ``poly_2``, ``poly_4``: 1, 2 or 4 of every 16 exps on the
  FMA pipe, by the polynomial exp2 that ``_EXP2_POLY`` inserts (the rest on
  the SFU);
* ``in_update``: each step's decays and (dt u) B_n taken in its updates,
  not with its loads a step ahead;
* ``ch_8``: chunks of 8 steps (32 would pass the 48 KB of static shared
  memory);
* ``stages_3``, ``stages_4``: a ring of 3 or 4 chunks;
* ``cpb_32``: 32 channels a CTA; ``cpb_128``: 128 channels a CTA in
  chunks of 8 steps (at 16 steps it would pass the 48 KB of static shared
  memory in f32);
* ``guarded``: every chunk step by step as the ragged last one (no loads
  a step ahead, y stored each step);
* ablations, whose output is not checked: ``launch_only`` (every CTA
  returns at once), ``compute_only`` (no copies of u and dt: the updates
  on whatever shared memory holds), ``loads_only`` (the copies of u, dt,
  B, C and the stores of y, no state updates), ``no_exp`` (each decay
  1 + dt A, no exp) and ``compute_no_exp`` (both of those).

For each: registers and spills of every scan entry function (``-Xptxas -v``)
and the CTAs an SM holds (an export that ``_OCCUPANCY`` appends to each
variant); CUDA-event times at chip_smoke.py's timing shape
(B=4, S=1024, d=8192, N=16, the model's dt and A), f32 and bf16, the L2
flushed before each launch, two rounds over the variants; the largest error
of y and the final state against the plain chunked form, relative to max(1,
max|.|). With ``--against DIR`` (a checkout of another commit, e.g. the
parent's unpacked by ``git archive`` into build/parent) it then times that
tree's scan kernel and this one's in turns (other, this, this, other), each
in a process of its own. Prints the card's name and power limit first and
one JSON object last. Builds go to ``build/scan_variants/``."""
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
from chip_smoke import (JAMBA_SCAN_SHAPE, _flusher,  # noqa: E402
                        _rel_floor, _time_device_ms, card_line, scan_case,
                        scan_registers)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mamba_scan import ops  # noqa: E402

# 2^x on the FMA pipe, inserted by the poly_* variants.  x is clamped to
# [-127, 127]; n = rint(x) by the 1.5 * 2^23 shift, f = x - n in [-0.5,
# 0.5]; p(f) = 1 + f q(f) with q of degree 4, fitted for least maximum
# relative error with p(0) = 1 exactly; then n is added to p's exponent as
# an integer.  Within 2^-22 relative of 2^x over [-126, 0]; below -126 it
# gives 0, as ex2.approx.ftz does.
_EXP2_POLY = """__device__ __forceinline__ float exp2_poly(float x) {
  x = fminf(fmaxf(x, -127.f), 127.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  float q = 1.3264723820611835e-3f;
  q = fmaf(q, f, 9.6715129911899567e-3f);
  q = fmaf(q, f, 5.5507335811853409e-2f);
  q = fmaf(q, f, 2.4022242426872253e-1f);
  q = fmaf(q, f, 6.9314700365066528e-1f);
  const float p = fmaf(q, f, 1.f);
  const int bits = static_cast<int>(__float_as_uint(p) +
                                    (__float_as_uint(t) << 23));
  return bits < 0x00800000 ? 0.f : __int_as_float(bits);
}

"""
# The CTAs of a launch that one SM holds, appended to every variant.
_OCCUPANCY = """
extern "C" int selective_scan_ctas_per_sm(int N, int dtype) {
  int n = 0;
  cudaError_t err = cudaSuccess;
  switch (N * 2 + (dtype != 0)) {
#define CASE(K, T, NN)                                                    \\
    case K:                                                               \\
      err = set_attributes<T, NN>();                                      \\
      if (err == cudaSuccess)                                             \\
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \\
            &n, scan_kernel<T, NN>, CPB, 0);                              \\
      break;
    CASE(8, float, 4) CASE(9, __nv_bfloat16, 4)
    CASE(32, float, 16) CASE(33, __nv_bfloat16, 16)
#undef CASE
    default: return -1;
  }
  return err == cudaSuccess ? n : -1;
}
"""
_SMEM_FN = "__device__ __forceinline__ unsigned smem_addr"
_START = "  const int nchunks = (S + CH - 1) / CH;\n"
_DA = "in.da[e] = ex2_approx(dt * a2[e]);"
_NO_EXP = (_DA, "in.da[e] = 1.f + dt * a2[e];", 1)
_UPDATE = "    auto update = [&](const In& in) {\n"
_IN = "    struct In { float u, bu[N], c[N], da[N]; };"
_IN_UPDATE = [
    (_IN, "    struct In { float u, dt, b[N], c[N]; };", 1),
    ("      const float dt = to_f32(ud[stage][1][k][tid]);\n"
     "      const float dtu = dt * in.u;\n",
     "      in.dt = to_f32(ud[stage][1][k][tid]);\n", 1),
    ("        in.bu[e] = dtu * p.x; in.bu[e + 1] = dtu * p.y;\n"
     "        in.bu[e + 2] = dtu * p.z; in.bu[e + 3] = dtu * p.w;\n",
     "        in.b[e] = p.x; in.b[e + 1] = p.y; in.b[e + 2] = p.z; "
     "in.b[e + 3] = p.w;\n", 1),
    ("#pragma unroll\n      for (int e = 0; e < N; ++e) " + _DA + "\n", "", 1),
    ("      float yp[4] = {0.f, 0.f, 0.f, 0.f};\n",
     "      const float dtu = in.dt * in.u;\n"
     "      float yp[4] = {0.f, 0.f, 0.f, 0.f};\n", 1),
    ("        h[e] = fmaf(h[e], in.da[e], in.bu[e]);\n",
     "        h[e] = fmaf(h[e], ex2_approx(in.dt * a2[e]), dtu * in.b[e]);\n",
     1)]
_COPY = "          cp_async16(dst, in ? src"
_COMPUTE_ONLY = (_COPY, _COPY.replace("cp_", "if (S < 0) cp_"), 1)

# name -> edits as (old, new, occurrences)
VARIANTS = {
    "kernel": [],
    **{f"poly_{n}": [(_SMEM_FN, _EXP2_POLY + _SMEM_FN, 1), (_DA, (
        f"in.da[e] = e >= N - N * {n} / 16 ? exp2_poly(dt * a2[e]) : "
        "ex2_approx(dt * a2[e]);"), 1)] for n in (1, 2, 4)},
    "in_update": _IN_UPDATE,
    "ch_8": [("CH = 16;", "CH = 8;", 1)],
    "stages_3": [("NSTAGE = 2;", "NSTAGE = 3;", 1)],
    "stages_4": [("NSTAGE = 2;", "NSTAGE = 4;", 1)],
    "cpb_32": [("CPB = 64;", "CPB = 32;", 1)],
    "cpb_128": [("CPB = 64;", "CPB = 128;", 1), ("CH = 16;", "CH = 8;", 1)],
    "guarded": [("if (steps == CH) {", "if (steps == CH && S < 0) {", 1)],
    "launch_only": [(_START, _START + "  if (S >= 0) return;\n", 1)],
    "compute_only": [_COMPUTE_ONLY],
    "loads_only": [(_UPDATE, _UPDATE + "      if (S >= 0) return 0.f;\n", 1)],
    "no_exp": [_NO_EXP],
    "compute_no_exp": [_COMPUTE_ONLY, _NO_EXP],
}
ABLATIONS = ("launch_only", "compute_only", "loads_only", "no_exp",
             "compute_no_exp")
OUT = os.path.join(ROOT, "build", "scan_variants")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cases():
    B, S, d, N = JAMBA_SCAN_SHAPE
    return {k: scan_case(B, S, d, N, dt, False, "model", 77)
            for k, dt in DTYPES.items()}


def _call(case):
    *args, state = case
    return ops.selective_scan_with_state(*args, h0=state, force="kernel")


def time_only() -> dict:
    """This process's package (``--src``): the scan kernel at the timing
    shape, f32 and bf16, L2 flushed."""
    flush = _flusher()
    out = {"src": SRC_DIR}
    for k, case in _cases().items():
        out[k] = _time_device_ms(lambda c=case: _call(c), 20, flush)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("scan_variants: no CUDA device")
    if "--time-only" in sys.argv:
        print(json.dumps(time_only()))
        return 0
    print(card_line(), flush=True)
    built = kv.build(_build, "mamba_scan", VARIANTS, OUT, _OCCUPANCY)
    cases = _cases()
    want = {k: ops.selective_scan_with_state(*c[:-1], h0=c[-1],
                                             force="chunked")
            for k, c in cases.items()}
    flush = _flusher()
    result = {"card": card_line(), "runs": {}}
    try:
        for rnd in range(2):
            for name, (lib, log) in built.items():
                _build._loaded["mamba_scan"] = lib
                row = result["runs"].setdefault(name, {
                    "registers_spills": scan_registers(log), "ms": {},
                    "rel_err": {}, "ctas_per_sm": {
                        k: lib.selective_scan_ctas_per_sm(
                            16, ops._DTYPE_CODES[dt])
                        for k, dt in DTYPES.items()}})
                for k, case in cases.items():
                    row["ms"].setdefault(k, []).append(_time_device_ms(
                        lambda c=case: _call(c), 20, flush))
                    if rnd == 0 and name not in ABLATIONS:
                        y, h = _call(case)
                        row["rel_err"][k] = (_rel_floor(y, want[k][0]),
                                             _rel_floor(h, want[k][1]))
    finally:
        _build._loaded.pop("mamba_scan", None)
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
