"""Build the port's CUDA kernels from the sources in the checkout.

Each kernel package keeps its sources (``*.cu``, and headers ``*.cuh``
that they include) under ``csrc/``.  ``load(name)``
compiles them at first use with ``nvcc`` into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), caches it under
``build/repro_torch/`` at the repository root keyed by a hash of the sources
and flags, and loads it with ``ctypes``.  ``build_all()`` starts one ``nvcc``
per kernel at once and waits for all of them.  A failed build raises with the
compiler's output; nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_KERNELS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_KERNELS_DIR)))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "repro_torch")

# Kernel packages with CUDA sources, in the order the main path meets them.
KERNELS = ("flash_attention", "paged_attention", "newton_schulz", "rwkv6",
           "mamba_scan")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _sources(name: str) -> List[str]:
    srcs = sorted(glob.glob(os.path.join(_KERNELS_DIR, name, "csrc", "*.cu")))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under kernels/{name}/csrc")
    return srcs


def _headers(name: str) -> List[str]:
    return sorted(glob.glob(os.path.join(_KERNELS_DIR, name, "csrc", "*.cuh")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, default "
                       "/usr/local/cuda/bin, and on PATH): the CUDA kernels "
                       "are built from source at first use")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name) + _headers(name):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``'s library, or '' if none is kept."""
    path = library_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is built; returns
    (process or None, output path, temporary path)."""
    out = library_path(name)
    if os.path.exists(out):
        return None, out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name: str, proc, out: str, tmp: str) -> str:
    """Wait for one build; returns '' or the error to raise."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return (f"nvcc failed to build kernels/{name} "
                f"(exit {proc.returncode}):\n{log}")
    with open(out + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)      # atomic: a concurrent build sees all or none
    return ""


def build_all(names=KERNELS) -> Dict[str, str]:
    """Compile every kernel library not yet built, all ``nvcc`` processes
    at once; returns {name: library path}.  Every process is waited for
    before the first failure is raised."""
    with _lock:
        started = [(n, *_start(n)) for n in names]
        errors = [_finish(n, proc, out, tmp) for n, proc, out, tmp in started]
    failed = [e for e in errors if e]
    if failed:
        raise RuntimeError("\n\n".join(failed))
    return {n: out for n, _, out, _ in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel package ``name``, built if needed."""
    if name not in _loaded:
        path = build_all((name,))[name]
        with _lock:
            _loaded.setdefault(name, ctypes.CDLL(path))
    return _loaded[name]
