"""The CUDA kernels (flash attention, paged-attention decode) against their
plain PyTorch versions, on the card.

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.  Without a card every test skips (decided in a
fixture when the test runs, so that test workers all collect the same
tests).  Tolerances: 1e-4 in f32 (both sides sum in f32, in other orders);
2e-2 in bf16, where both sides round the output to bf16 once.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.paged_attention import ops as pa_ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python -m pytest -m gpu "
                    "tests/test_torch_gpu.py on the card)")
    return torch.device("cuda")


def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, S, KV, hd), dtype=np.float32),
            rng.standard_normal((B, S, KV, hd), dtype=np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S,H,KV,causal,window,softcap", [
    (77, 12, 12, True, 0, 0.0), (512, 8, 2, True, 64, 30.0),
    (1000, 8, 2, False, 0, 30.0)])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, hd, S, H, KV,
                                           causal, window, softcap):
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda_device, td)
               for x in _qkv(6, 2, S, H, KV, hd))
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    before = ops.KERNEL_LAUNCHES
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, force="ref", **kw)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES == before + 1
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol)


@pytest.mark.gpu
def test_cuda_tensors_never_take_the_plain_version(cuda_device):
    """A head dim the kernel is not built for raises on the card; nothing
    falls back to the plain version."""
    q, k, v = (torch.from_numpy(x).to(cuda_device) for x in _qkv(7, 1, 32, 4,
                                                                 4, 16))
    before = ops.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="head dim 16"):
        ops.flash_attention(q, k, v)
    assert ops.KERNEL_LAUNCHES == before


def _paged(seed, B, H, KV, hd, bs, NB, dtypes, device):
    """Permuted physical pages; slots past each cursor hold large finite
    garbage, which must not reach the output."""
    rng = np.random.default_rng(seed)
    NP = B * NB + 2
    q = rng.standard_normal((B, 1, H, hd), dtype=np.float32)
    kp = 1e3 * rng.standard_normal((NP, bs, KV, hd), dtype=np.float32)
    vp = 1e3 * rng.standard_normal((NP, bs, KV, hd), dtype=np.float32)
    tbl = rng.permutation(NP)[:B * NB].reshape(B, NB).astype(np.int32)
    idx = rng.integers(0, NB * bs, (B,)).astype(np.int32)
    for b in range(B):
        live = np.arange(idx[b] + 1)
        for pages in (kp, vp):
            pages[tbl[b, live // bs], live % bs] = rng.standard_normal(
                (len(live), KV, hd), dtype=np.float32)
    q_dt, kv_dt = (getattr(torch, d) for d in dtypes)
    return (torch.from_numpy(q).to(device, q_dt),
            torch.from_numpy(kp).to(device, kv_dt),
            torch.from_numpy(vp).to(device, kv_dt),
            torch.from_numpy(tbl).to(device), torch.from_numpy(idx).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("float32", "bfloat16")])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,KV,bs,NB,softcap", [(12, 12, 16, 37, 0.0),
                                                (8, 2, 64, 4, 30.0)])
def test_paged_kernel_matches_plain_version(cuda_device, dtypes, hd, H, KV,
                                            bs, NB, softcap):
    q, kp, vp, tbl, idx = _paged(8, 3, H, KV, hd, bs, NB, dtypes,
                                 cuda_device)
    before = pa_ops.KERNEL_LAUNCHES
    got = pa_ops.paged_attention(q, kp, vp, tbl, idx, logit_softcap=softcap)
    want = pa_ops.paged_attention(q, kp, vp, tbl, idx, logit_softcap=softcap,
                                  force="ref")
    torch.cuda.synchronize()
    assert pa_ops.KERNEL_LAUNCHES == before + 1
    tol = 2e-2 if "bfloat16" in dtypes else 1e-4
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol)


@pytest.mark.gpu
def test_paged_kernel_refuses_an_unsupported_head_dim(cuda_device):
    """Head dim 16 raises on the card with no launch counted; nothing falls
    back to the plain version."""
    q, kp, vp, tbl, idx = _paged(9, 2, 4, 2, 16, 8, 2,
                                 ("float32", "float32"), cuda_device)
    before = pa_ops.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="head dim 16"):
        pa_ops.paged_attention(q, kp, vp, tbl, idx)
    assert pa_ops.KERNEL_LAUNCHES == before
