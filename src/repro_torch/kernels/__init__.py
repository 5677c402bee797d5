"""The port's hand-written CUDA kernels, one package each.

Every wrapper adds one to a module-level counter of its ``ops`` module
where it launches its kernel, and nowhere else.  ``LAUNCH_COUNTERS`` names
each kernel's counter; ``launch_counts`` reads them all and
``zero_launch_counts`` sets them to 0.
"""
from __future__ import annotations

import importlib

# kernel -> (ops module under repro_torch.kernels, counter attribute)
LAUNCH_COUNTERS = {
    "flash_attention": ("flash_attention", "KERNEL_LAUNCHES"),
    "flash_attention_bwd": ("flash_attention", "BWD_LAUNCHES"),
    "paged_attention": ("paged_attention", "KERNEL_LAUNCHES"),
    "ns_fused": ("newton_schulz", "NS_FUSED_LAUNCHES"),
    "matmul": ("newton_schulz", "MATMUL_LAUNCHES"),
    "wkv": ("rwkv6", "KERNEL_LAUNCHES"),
    "wkv_bwd": ("rwkv6", "BWD_LAUNCHES"),
    "selective_scan": ("mamba_scan", "KERNEL_LAUNCHES"),
    "selective_scan_bwd": ("mamba_scan", "BWD_LAUNCHES")}


def _ops(package: str):
    return importlib.import_module(f"repro_torch.kernels.{package}.ops")


def launch_counts() -> dict:
    """{kernel: launches} from every wrapper's counter in this process."""
    return {name: getattr(_ops(pkg), attr)
            for name, (pkg, attr) in LAUNCH_COUNTERS.items()}


def zero_launch_counts() -> None:
    for pkg, attr in LAUNCH_COUNTERS.values():
        setattr(_ops(pkg), attr, 0)
