import os
import sys

# Tests run on CPU with 8 fake XLA devices (olmax-style), so the sharded
# engine and the multi-device tests exercise real GSPMD partitioning
# hermetically.  Both must be set before jax is first imported; test.sh sets
# the same flags for command-line runs.  (The dry-run sets its own
# 512-device flag in its own process; never here.)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Layout-invariant random bits (also set by the engine; set here so the whole
# suite sees one RNG algorithm regardless of import order).
os.environ.setdefault("JAX_THREEFRY_PARTITIONABLE", "true")
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", "")).strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    # Registered here (no pytest.ini/pyproject): multi-device serving /
    # distributed parity tests are marked slow; deselect with
    # `bash test.sh -m "not slow"` for a quick inner loop.
    config.addinivalue_line(
        "markers", "slow: multi-device parity tests (several train/serve "
        "runs each); deselect with -m 'not slow'")
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one (python -m pytest -m gpu tests/test_torch_gpu.py)")
