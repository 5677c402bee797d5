"""Render the roofline table from the port's dry-run JSONs (a copy of
``repro/roofline/report.py``).

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir experiments/dryrun_torch]
        [--mesh single] [--tag baseline] [--format md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_all(directory: str, mesh: str = "single", tag: str = "baseline"):
    rows = []
    for fn in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(fn) as f:
            d = json.load(f)
        if d.get("mesh") != mesh or d.get("tag") != tag:
            continue
        rows.append(d)
    return rows


def _fmt_s(x):
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


SUGGESTIONS = {
    "compute": "reduce recompute (remat policy) / shrink useful-vs-HLO gap",
    "memory": "fuse elementwise chains; keep residual seq-sharded; bf16 temps",
    "collective": "reshard to cut all-gathers (seq-parallel boundaries); "
                  "int8 cross-pod grads; overlap via latency-hiding scheduler",
}


def render(rows, fmt: str = "md") -> str:
    hdr = ["arch", "shape", "chips", "t_compute", "t_memory", "t_collective",
           "dominant", "MODEL/HLO", "roofline_frac", "fits_hbm"]
    lines = []
    if fmt == "md":
        lines.append("| " + " | ".join(hdr) + " |")
        lines.append("|" + "---|" * len(hdr))
    for d in rows:
        row = [d["arch"], d["shape"], str(d["chips"]),
               _fmt_s(d["t_compute"]), _fmt_s(d["t_memory"]),
               _fmt_s(d["t_collective"]), d["dominant"],
               f"{d['useful_ratio']:.2f}",
               f"{d['roofline_fraction']:.1%}",
               "y" if d.get("fits_hbm") else "n"]
        lines.append("| " + " | ".join(row) + " |" if fmt == "md"
                     else ",".join(row))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--format", default="md")
    args = ap.parse_args(argv)
    rows = load_all(args.dir, args.mesh, args.tag)
    print(render(rows, args.format))
    if rows:
        worst = min(rows, key=lambda d: d["roofline_fraction"])
        coll = max(rows, key=lambda d: d["t_collective"] /
                   max(d["t_compute"], 1e-30))
        print(f"\nworst roofline fraction: {worst['arch']} x {worst['shape']} "
              f"({worst['roofline_fraction']:.1%})")
        print(f"most collective-bound: {coll['arch']} x {coll['shape']}")
        for dom in ("compute", "memory", "collective"):
            n = sum(1 for d in rows if d["dominant"] == dom)
            print(f"  dominated by {dom}: {n}  -> {SUGGESTIONS[dom]}")


if __name__ == "__main__":
    main()
