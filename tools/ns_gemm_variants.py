#!/usr/bin/env python3
"""Variants of the Newton–Schulz GEMM (``src/repro_torch/kernels/
newton_schulz/csrc/newton_schulz.cu``), made from the source in this
checkout by text edits, built and measured beside it on one card.

    python3 tools/ns_gemm_variants.py      # on a machine with an H100

Variants:

* ``kernel``: the source as it is;
* ``one_running_sum``: the tensor cores accumulate every k-slice into one
  running sum, with no per-slice sum added in IEEE f32;
* ``two_blocks_per_sm``: a 2-deep ring and ``__launch_bounds__`` for two
  resident blocks per SM (at most 128 registers a thread), the split-K plan
  counting waves of two blocks per SM.

For each: registers and spills from ``-Xptxas -v``; CUDA-event times of the
embedding's 768 x 50304 Gram (symmetric, split-K), P X (768 x 768 @ 768 x
50304) and ``ns_fused`` on a 12 x 768 x 3072 stack, two rounds over the
variants; the Gram against an f64 product, beside cuBLAS's f32 Gram, and
whether ``chip_smoke.py``'s ``GRAM_F64_TOL`` holds; ``ns_fused`` against
its plain version.  Prints the card's name and power limit first and one
JSON object last.  Builds go to ``build/ns_variants/``.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

from chip_smoke import GRAM_F64_TOL, card_line  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.newton_schulz import ops  # noqa: E402

# name -> (edits as (old, new, occurrences), resident blocks per SM)
VARIANTS = {
    "kernel": ([], 1),
    "one_running_sum": ([("wgmma_tf32(part,", "wgmma_tf32(acc,", 4),
                         ("db, s);", "db, 1);", 2),
                         ("for (int i = 0; i < 64; ++i) acc[i] += part[i];",
                          "", 1)], 1),
    "two_blocks_per_sm": ([("constexpr int STAGES = 4;",
                            "constexpr int STAGES = 2;", 1),
                           ("__launch_bounds__(GEMM_THREADS, 1)",
                            "__launch_bounds__(GEMM_THREADS, 2)", 1)], 2),
}
OUT = os.path.join(ROOT, "build", "ns_variants")


def build() -> dict:
    """Write and compile every variant at once; {name: (library, log)}."""
    src, = _build._sources("newton_schulz")
    with open(src) as f:
        text = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        body = text
        for old, new, n in edits:
            if body.count(old) != n:
                raise SystemExit(f"{name}: {old!r} occurs {body.count(old)} "
                                 f"times in the source, expected {n}")
            body = body.replace(old, new)
        cu, so = (os.path.join(OUT, name + ext) for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(body)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.flags("newton_schulz"), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        built[name] = (so, log)
    return built


def gemm_registers(log: str) -> list:
    """[(instantiation, registers, spill store bytes, spill load bytes)]
    of every gemm_kernel in an ``-Xptxas -v`` log."""
    rows, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and "gemm_kernel" in fn:
            inst = re.search(r"gemm_kernelI(.*?)EEvNS", fn)
            rows.append((inst.group(1) if inst else fn, int(m.group(1)),
                         *spill))
    return rows


def ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def rel64(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ns_gemm_variants: no CUDA device")
    print(card_line())
    built = build()
    g = torch.Generator(device="cuda").manual_seed(0)
    xn = torch.randn((768, 50304), generator=g, device="cuda")
    xn = xn / torch.linalg.norm(xn)
    f64 = xn.double() @ xn.double().T
    p = torch.randn((768, 768), generator=g, device="cuda") / 768
    stack = 0.02 * torch.randn((12, 768, 3072), generator=g, device="cuda")
    stack_ref = ops.ns_fused_ref(stack)
    result = {"card": card_line(), "gram_f64_tol": GRAM_F64_TOL,
              "cublas_f32_gram_f64_rel": rel64(xn @ xn.T, f64),
              "torch_matmul_gram_ms": ms(lambda: xn @ xn.T),
              "variants": {}}
    libs = {name: ctypes.CDLL(so) for name, (so, _) in built.items()}
    for rnd in range(2):
        for name, (_, bps) in VARIANTS.items():
            _build._loaded["newton_schulz"] = libs[name]
            ops._BLOCKS_PER_SM = bps
            row = result["variants"].setdefault(name, {
                "registers_spills": gemm_registers(built[name][1]),
                "gram_ms": [], "px_ms": [], "ns_fused_ms": []})
            row["gram_ms"].append(
                ms(lambda: ops.matmul(xn, xn, trans_b=True)))
            row["px_ms"].append(ms(lambda: ops.matmul(p, xn)))
            row["ns_fused_ms"].append(ms(lambda: ops.ns_fused(stack)))
            if rnd == 0:
                row["gram_f64_rel"] = rel64(
                    ops.matmul(xn, xn, trans_b=True), f64)
                row["gram_f64_tol_holds"] = (row["gram_f64_rel"]
                                             <= GRAM_F64_TOL)
                got = ops.ns_fused(stack)
                row["ns_fused_rel"] = ((got - stack_ref).abs().max()
                                       / stack_ref.abs().max()).item()
    for name, row in result["variants"].items():
        print(f"{name:18s} gram {row['gram_ms']} ms, P X {row['px_ms']} ms, "
              f"ns_fused {row['ns_fused_ms']} ms; Gram vs f64 "
              f"{row['gram_f64_rel']:.2e} (limit {GRAM_F64_TOL:.0e} "
              f"{'holds' if row['gram_f64_tol_holds'] else 'fails'}); "
              f"ns_fused vs plain {row['ns_fused_rel']:.2e}; registers and "
              f"spills {row['registers_spills']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
