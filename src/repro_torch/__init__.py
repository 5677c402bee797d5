"""PyTorch/CUDA port of the progressive-training system in ``repro``.

The JAX package under ``src/repro`` is the reference; this package mirrors
its layout and names module by module and imports nothing of it.  Plain
tensor code is PyTorch; each TPU kernel on a ported path is a kernel written
by hand for Hopper (``kernels/*/csrc``), built from the sources at first use
(``kernels/_build.py``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
