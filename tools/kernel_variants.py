"""What ``tools/wkv_variants.py`` and ``tools/scan_variants.py`` share:
variants of one kernel package's CUDA source made by text edits and built
at once with the package's own ``nvcc`` flags, and turns against another
checkout's kernel, each turn in a process of its own.  Runs on a machine
with a CUDA card; imports no JAX.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_sources(text: str, variants: dict, suffix: str = "") -> dict:
    """{name: source} from ``text`` and {name: [(old, new, occurrences)]},
    ``suffix`` appended to each (the tools' own exports); an edit whose
    text does not occur as often as it says stops the run."""
    bodies = {}
    for name, edits in variants.items():
        body = text
        for old, new, n in edits:
            if body.count(old) != n:
                raise SystemExit(f"{name}: an edit's text occurs "
                                 f"{body.count(old)} times, expected {n}")
            body = body.replace(old, new)
        bodies[name] = body + suffix
    return bodies


def build(build_mod, package: str, variants: dict, out: str,
          suffix: str = "") -> dict:
    """Write and compile every variant of ``package``'s one CUDA source at
    once, ``suffix`` appended to each; returns {name: (ctypes library,
    nvcc log)}."""
    src = build_mod._sources(package)[0]
    with open(src) as f:
        bodies = make_sources(f.read(), variants, suffix)
    # A checkout that predates per-package flags has NVCC_FLAGS alone.
    flags = (build_mod.flags(package) if hasattr(build_mod, "flags")
             else build_mod.NVCC_FLAGS)
    procs = {}
    for name, body in bodies.items():
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, os.path.basename(src))
        with open(path, "w") as f:
            f.write(body)
        so = os.path.join(d, package + ".so")
        procs[name] = (subprocess.Popen(
            [build_mod._nvcc(), *flags, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        built[name] = (ctypes.CDLL(so), log)
    return built


def turns(script: str, other: str) -> list:
    """``script --time-only`` over ``other``'s package and this one's in
    turns (other, this, this, other); each prints one JSON object last."""
    runs = []
    for src in (other, ROOT, ROOT, other):
        proc = subprocess.run(
            [sys.executable, script, "--time-only", "--src",
             os.path.join(src, "src")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            raise SystemExit(f"the turn over {src} failed:\n{proc.stdout}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"turn {src}: {runs[-1]}", flush=True)
    return runs
