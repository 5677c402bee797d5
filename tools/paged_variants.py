#!/usr/bin/env python3
"""Variants of the paged-attention decode kernel (``src/repro_torch/kernels/
paged_attention/csrc/paged_attention.cu``), made from the source in this
checkout by text edits, built and measured beside it on one card.

    python3 tools/paged_variants.py        # on a machine with an H100

Variants of the source:

* ``kernel``: the source as it is;
* ``stages_2``, ``stages_4``: each warp's ring 2 or 4 stages deep (3 in
  the kernel);
* ``wide_pv_g1``: at G = 1, P·V lanes of one 16-byte chunk (4 f32, 8
  bf16, 16 one-byte values) instead of 4 values;
* ``q_from_smem_g1``: at G = 1, q read from shared memory in the score
  loop instead of held in registers;
* ``accurate_exp2``: ``exp2f`` instead of the SFU's ``ex2.approx``;
* ablations, whose output is not checked: ``launch_only`` (every CTA
  returns at once), ``setup_only`` (after reading the cursor, the table
  and q), ``loads_only`` (the warps copy every tile and compute nothing),
  ``no_pv`` (scores and softmax, no P·V), ``no_merge`` (every CTA
  returns after its warps' loops, before the merges) and
  ``no_scale_copies`` (1-byte pages without their scales' copies);

and of the plan: the kernel and ``launch_only`` with the cluster size
forced to 1, 2 and 4 CTAs (``ops.split_plan`` gives 3 at the timing
shape).  Also the floor of the timing (events around a one-thread kernel)
and the kernel after an L2 flush by a read, which leaves the lines clean,
where chip_smoke.py's flush writes them (dirty lines are written back
while the kernel reads).

With ``--against DIR`` (a checkout of another commit, e.g. the parent's
unpacked by ``git archive``) it then times that tree's paged kernel and
this one's in turns (other, this, this, other), each in a process of its
own that imports the tree's package and builds the tree's kernel.

For each: registers and spills of every paged entry function from
``-Xptxas -v``; how many clusters the card holds at once
(``cudaOccupancyMaxActiveClusters``); CUDA-event times at chip_smoke.py's
timing shape (B=8, H=KV=12, hd=64, bs=16, cursors 575, q f32) over f32,
int8 and fp8 pages, L2 flushed before each launch (two rounds over the
variants) and warm; the largest error against the plain version.  Prints
the card's name and power limit first and one JSON object last.  Builds
go to ``build/paged_variants/``.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# --src DIR: take the package from another checkout (the --against turns).
SRC_DIR = (sys.argv[sys.argv.index("--src") + 1] if "--src" in sys.argv
           else os.path.join(ROOT, "src"))
sys.path[:0] = [SRC_DIR, ROOT]

import torch  # noqa: E402

from chip_smoke import (PAGED_SHAPE, _time_device_ms, card_line,  # noqa: E402
                        paged_case, paged_registers)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_attention import ops  # noqa: E402

SRC = "paged_attention.cu"
_AFTER_SETUP = ("  if (n_split > 1) cluster_arrive_relaxed();\n"
                "  __syncthreads();\n")
_BEFORE_MERGE = "  __syncthreads();\n\n  // The CTA's state"
_DPV = "  static constexpr int DPV = 4;"
_Q_REG = ("      if constexpr (GM == 1) {\n#pragma unroll\n"
          "        for (int e = 0; e < CW; ++e) dot = fmaf(q_reg[e]")
_EX2 = ('  float y;\n  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n'
        '  return y;\n')
_SCALES = "    if constexpr (S::QUANT) {\n      if (lane < TW) {\n"
_START = "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
_COMPUTE = "    const unsigned char* st = ring + (j % STAGES) * STAGE;\n"
_PV = "      tile_pv<KVC, HD, GM>(acc, st, p_s[warp], vt, vc);\n"
_SKIP = "    if (n_split > 0) {\n      __syncwarp();\n      continue;\n    }\n"

# name -> edits as (old, new, occurrences)
VARIANTS = {
    "kernel": [],
    "stages_2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;", 1)],
    "stages_4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;", 1)],
    "wide_pv_g1": [(_DPV, _DPV.replace("4;", "GM == 1 ? CW : 4;"), 1)],
    "q_from_smem_g1": [(_Q_REG, _Q_REG.replace("GM == 1", "false"), 1)],
    "accurate_exp2": [(_EX2, "  return exp2f(x);\n", 1)],
    "launch_only": [(_START, _START + "  if (n_split > 0) return;\n", 1)],
    "setup_only": [(_AFTER_SETUP, _AFTER_SETUP + "  if (n_split > 0) return;\n",
                    1)],
    "no_merge": [(_BEFORE_MERGE, "  if (n_split > 0) return;\n" + _BEFORE_MERGE,
                  1)],
    "loads_only": [(_COMPUTE, _SKIP + _COMPUTE, 1)],
    "no_pv": [(_PV, _SKIP + _PV, 1)],
    "no_scale_copies": [(_SCALES, _SCALES.replace("S::QUANT", "false"), 1)],
}
ABLATIONS = ("launch_only", "setup_only", "no_merge", "loads_only", "no_pv",
             "no_scale_copies")
PLANS = (1, 2, 4)
OUT = os.path.join(ROOT, "build", "paged_variants")


def build() -> dict:
    """Write and compile every variant at once; {name: (library, log)}."""
    with open(_build._sources("paged_attention")[0]) as f:
        text = f.read()
    bodies = {}
    for name, edits in VARIANTS.items():
        body = text
        for old, new, n in edits:
            if body.count(old) != n:
                raise SystemExit(f"{name}: an edit's text occurs "
                                 f"{body.count(old)} times, expected {n}")
            body = body.replace(old, new)
        bodies[name] = body
    procs = {}
    for name, body in bodies.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, SRC), "w") as f:
            f.write(body)
        so = os.path.join(d, "paged_attention.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.flags("paged_attention"), "-o", so,
             os.path.join(d, SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        built[name] = (so, log)
    return built


def occupancy(lib, case, n_split) -> int:
    """Clusters of the launch at ``case`` the card holds at once."""
    q, kp, vp, tbl, idx, ks, vs = case
    B, _, H, hd = q.shape
    _, bs, KV, _ = kp.shape
    n = ctypes.c_int(-1)
    err = lib.paged_attention_fwd(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), tbl.data_ptr(),
        idx.data_ptr(), None, B, H, KV, hd, bs, tbl.shape[1], n_split,
        ops._Q_CODES[q.dtype], ops._KV_CODES[kp.dtype], 0, 0.0, None,
        ctypes.addressof(n))
    return n.value if err == 0 else -err


def _cases():
    s = PAGED_SHAPE
    B, H, KV, hd, bs, NB = (s[k] for k in ("B", "H", "KV", "hd", "bs", "NB"))
    dtypes = {"float32": torch.float32, "int8": torch.int8,
              "fp8": torch.float8_e4m3fn}
    return {k: paged_case(B, H, KV, hd, bs, NB, torch.float32, dt,
                          [s["cursor"]] * B, seed=4242, trash_row=False)
            for k, dt in dtypes.items()}


def time_only() -> dict:
    """This process's package (``--src``): the paged kernel at the timing
    shape, L2 flushed (written) and warm, and back to back with its host
    wrapper (int64 cursor, as the engine passes it)."""
    from chip_smoke import _time_ms
    junk = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    out = {"src": SRC_DIR}
    for k, c in _cases().items():
        cur = c[4].long()

        def call(c=c, cur=cur):
            return ops.paged_attention(*c[:4], cur, k_scales=c[5],
                                       v_scales=c[6], force="kernel")
        out[k] = {"ms": _time_device_ms(call, 50, junk.zero_),
                  "warm_ms": _time_device_ms(call, 50),
                  "back_to_back_ms": _time_ms(call, 50)}
    return out


def against(other: str) -> list:
    """Turns other, this, this, other, each in a process of its own."""
    runs = []
    for src in (other, ROOT, ROOT, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-only",
             "--src", os.path.join(src, "src")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            raise SystemExit(f"the turn over {src} failed:\n{proc.stdout}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"turn {src}: {runs[-1]}")
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("paged_variants: no CUDA device")
    if "--time-only" in sys.argv:
        print(json.dumps(time_only()))
        return 0
    print(card_line())
    built = build()
    s = PAGED_SHAPE
    B, KV, NB = s["B"], s["KV"], s["NB"]
    cases = _cases()
    want = {k: ops.paged_attention(*c[:5], k_scales=c[5], v_scales=c[6],
                                   force="ref") for k, c in cases.items()}
    junk = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    libs = {name: ctypes.CDLL(so) for name, (so, _) in built.items()}
    plan = ops.split_plan(B, KV, NB)
    runs = [(name, plan) for name in VARIANTS] + [
        (name, n) for name in ("kernel", "launch_only") for n in PLANS
        if n != plan]
    result = {"card": card_line(), "plan": plan, "runs": {}}
    split_plan = ops.split_plan
    try:
        for rnd in range(2):
            for name, n in runs:
                _build._loaded["paged_attention"] = libs[name]
                ops._library()                    # sets the argtypes
                ops.split_plan = lambda *a, n=n: n
                key = f"{name} n_split={n}"
                row = result["runs"].setdefault(key, {
                    "registers_spills": paged_registers(built[name][1]),
                    "max_active_clusters": {}, "ms": {}, "warm_ms": {},
                    "max_abs_err": {}})
                for k, c in cases.items():
                    kw = dict(k_scales=c[5], v_scales=c[6], force="kernel")

                    def call(c=c, kw=kw):
                        return ops.paged_attention(*c[:5], **kw)
                    row["ms"].setdefault(k, []).append(_time_device_ms(
                        call, 50, junk.zero_))
                    if rnd == 0:
                        row["warm_ms"][k] = _time_device_ms(call, 50)
                        row["max_abs_err"][k] = (
                            None if name in ABLATIONS else
                            (call() - want[k]).abs().max().item())
                        row["max_active_clusters"][k] = occupancy(
                            libs[name], c, n)
    finally:
        ops.split_plan = split_plan
        _build._loaded.pop("paged_attention", None)
    # The floor of this timing: events around a one-thread kernel.
    result["empty_kernel_ms"] = _time_device_ms(lambda: torch.cuda._sleep(1),
                                                50)
    # The kernel with the L2 flushed by a read (its lines left clean)
    # instead of chip_smoke.py's write (dirty lines, written back while
    # the kernel reads).
    _build._loaded["paged_attention"] = libs["kernel"]
    result["clean_flush_ms"] = {k: _time_device_ms(
        lambda c=c: ops.paged_attention(*c[:5], k_scales=c[5], v_scales=c[6],
                                        force="kernel"), 50,
        lambda: junk.sum()) for k, c in cases.items()}
    _build._loaded.pop("paged_attention", None)
    print(f"empty kernel {result['empty_kernel_ms']} ms; the kernel after a "
          f"clean flush {result['clean_flush_ms']} ms")
    for key, row in result["runs"].items():
        print(f"{key:30s} ms {row['ms']}; warm {row['warm_ms']}; clusters "
              f"{row['max_active_clusters']}; err {row['max_abs_err']}")
    if "--against" in sys.argv:
        result["turns"] = against(sys.argv[sys.argv.index("--against") + 1])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
