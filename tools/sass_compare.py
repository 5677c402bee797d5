#!/usr/bin/env python3
"""Compare the machine code (SASS) of the CUDA kernels of this checkout
with another checkout's, entry function by entry function, and time each
kernel package's build.

    python3 tools/sass_compare.py --against DIR   # on a machine with nvcc

``DIR`` is another checkout's root (e.g. a ``git archive`` of the parent
commit unpacked into ``build/parent``).  Each checkout's kernel packages
are compiled with its own ``kernels/_build.py`` flags, one ``nvcc`` per
package, each timed alone (the packages one after another, so a build's
seconds are its own), into ``build/sass_compare/<side>/``; then
``cuobjdump -sass`` of every library is split into entry functions and
the two sides' SASS compared function by function (text equal after
dropping the addresses' comment columns).  An entry function that exists
on both sides with other code is listed; so are functions on one side
only.  Needs no card.  Prints one JSON object last: per package, the
build seconds of both sides, the functions equal, differing, and only on
one side.
"""
import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build_module(root: str):
    """The ``kernels/_build.py`` of the checkout at ``root``, loaded alone."""
    path = os.path.join(root, "src", "repro_torch", "kernels", "_build.py")
    spec = importlib.util.spec_from_file_location(
        f"_build_{abs(hash(root))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(root: str, side: str) -> dict:
    """{package: (library path, nvcc seconds)} for the checkout at
    ``root``, built into ``build/sass_compare/<side>/``."""
    b = _build_module(root)
    out_dir = os.path.join(ROOT, "build", "sass_compare", side)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    out = {}
    for name in b.KERNELS:
        lib = os.path.join(out_dir, f"{name}.so")
        t0 = time.perf_counter()
        # A checkout that predates per-package flags has NVCC_FLAGS alone.
        flags = b.flags(name) if hasattr(b, "flags") else b.NVCC_FLAGS
        subprocess.run([b._nvcc(), *flags, "-o", lib, *b._sources(name)],
                       check=True, capture_output=True, text=True)
        out[name] = (lib, time.perf_counter() - t0)
        print(f"{side} {name}: nvcc {out[name][1]:.1f} s", flush=True)
    return out


def _unhash(text: str) -> str:
    """``text`` with the anonymous namespace's per-file hashes in mangled
    names (``_GLOBAL__N__<hash>_...cu_<hash>``) replaced, so that the same
    function compiled from two checkouts has one name."""
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__X_", text)
    return re.sub(r"_cu_[0-9a-f]{8}", "_cu_X", text)


def sass_functions(lib: str) -> dict:
    """{entry function (mangled, hashes replaced): SASS text without
    address comments}."""
    cuobjdump = os.path.join(os.path.dirname(_build_module(ROOT)._nvcc()),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    funcs, name, body = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name is not None:
                funcs[name] = "\n".join(body)
            name, body = _unhash(m.group(1)), []
            continue
        if name is not None:
            # "/*0040*/   INSTR ;  /* 0x... */": keep the instruction only
            body.append(_unhash(re.sub(r"/\*[^*]*\*/", "", line).strip()))
    if name is not None:
        funcs[name] = "\n".join(body)
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", required=True,
                    help="root of the other checkout")
    args = ap.parse_args()
    here = build(ROOT, "this")
    there = build(os.path.abspath(args.against), "other")
    record = {}
    for name in here:
        a = sass_functions(here[name][0])
        b = sass_functions(there[name][0]) if name in there else {}
        equal = sorted(f for f in a if f in b and a[f] == b[f])
        differ = sorted(f for f in a if f in b and a[f] != b[f])
        record[name] = dict(build_s=round(here[name][1], 1),
                            other_build_s=round(there[name][1], 1)
                            if name in there else None,
                            equal=len(equal), differ=len(differ),
                            only_here=len(set(a) - set(b)),
                            only_other=len(set(b) - set(a)))
        print(f"{name}: {len(equal)} entry functions with equal SASS, "
              f"{len(differ)} differing, {len(set(a) - set(b))} only here, "
              f"{len(set(b) - set(a))} only in the other checkout")
        for f in differ:
            print(f"  differs: {f}")
        for f in sorted(set(b) - set(a)):
            print(f"  only in the other checkout: {f}")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
