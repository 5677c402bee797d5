"""Generate the data-driven sections of EXPERIMENTS.md from the port's
dry-run JSONs (a copy of ``repro/roofline/experiments_md.py``; the
``compile`` column reads the reference's ``compile_s``, or the port's
``count_s`` where a row has no compile).

    PYTHONPATH=src python -m repro_torch.roofline.experiments_md > EXPERIMENTS.tables.md
"""
from __future__ import annotations

import glob
import json
import os
from collections import defaultdict

DIR = "experiments/dryrun_torch"


def load():
    cells = defaultdict(dict)
    for fn in glob.glob(os.path.join(DIR, "*.json")):
        d = json.load(open(fn))
        cells[(d["arch"], d["shape"], d["mesh"])][d["tag"]] = d
    return cells


def fmt_s(x):
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def dryrun_table(cells):
    print("| arch | shape | mesh | chips | compile | HLO FLOPs | HBM bytes "
          "(adj) | coll bytes (wt) | per-dev args | per-dev temps | fits HBM |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for (arch, shape, mesh), tags in sorted(cells.items()):
        d = tags.get("baseline")
        if d is None:
            continue
        m = d["per_device_memory"]
        print(f"| {arch} | {shape} | {mesh} | {d['chips']} "
              f"| {d.get('compile_s', d.get('count_s')):.0f}s "
              f"| {d['hlo_flops']:.2e} "
              f"| {d['hlo_bytes']:.2e} | {d['coll_bytes_weighted']:.2e} "
              f"| {m['argument_size_in_bytes']/d['chips']/2**30:.2f}GiB "
              f"| {m['temp_size_in_bytes']/2**30:.2f}GiB "
              f"| {'y' if d['fits_hbm'] else 'n'} |")


def roofline_table(cells, mesh="single"):
    print("| arch | shape | t_compute | t_memory | t_coll | dominant | "
          "MODEL/HLO | roofline frac | one-line lever |")
    print("|---|---|---|---|---|---|---|---|---|")
    lever = {
        "compute": "cut remat recompute / raise useful-FLOP ratio",
        "memory": "kernelize remaining HBM-resident temps; fuse chains",
        "collective": "reshard (EP/SP boundaries); compress cross-pod grads",
    }
    for (arch, shape, m), tags in sorted(cells.items()):
        if m != mesh or "baseline" not in tags:
            continue
        d = tags["baseline"]
        print(f"| {arch} | {shape} | {fmt_s(d['t_compute'])} "
              f"| {fmt_s(d['t_memory'])} | {fmt_s(d['t_collective'])} "
              f"| {d['dominant']} | {d['useful_ratio']:.2f} "
              f"| {d['roofline_fraction']:.2%} | {lever[d['dominant']]} |")


def perf_table(cells):
    print("| cell | tag | t_compute | t_memory | t_coll | dominant | "
          "roofline frac |")
    print("|---|---|---|---|---|---|---|")
    for (arch, shape, m), tags in sorted(cells.items()):
        if len(tags) < 2:
            continue
        for tag in sorted(tags, key=lambda t: (t != "baseline", t)):
            d = tags[tag]
            print(f"| {arch} x {shape} ({m}) | {tag} "
                  f"| {fmt_s(d['t_compute'])} | {fmt_s(d['t_memory'])} "
                  f"| {fmt_s(d['t_collective'])} | {d['dominant']} "
                  f"| {d['roofline_fraction']:.2%} |")


def main():
    cells = load()
    print("## §Dry-run (auto-generated)\n")
    dryrun_table(cells)
    print("\n## §Roofline — single-pod baselines (auto-generated)\n")
    roofline_table(cells, "single")
    print("\n## §Roofline — multi-pod (auto-generated)\n")
    roofline_table(cells, "multi")
    print("\n## §Perf — iteration cells (auto-generated)\n")
    perf_table(cells)


if __name__ == "__main__":
    main()
