"""The CUDA kernels (flash attention forward and backward, paged-attention
decode, the Newton–Schulz chain and matmul, the RWKV6 WKV recurrence, the
Mamba selective scan) against their plain PyTorch versions, on the card.

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.  Without a card every test skips (decided in a
fixture when the test runs, so that test workers all collect the same
tests).  Tolerances of the attention kernels: 1e-4 in f32 (both sides sum
in f32, in other orders); 2e-2 in bf16, where both sides round the output
to bf16 once.  The training kernels' tolerances are stated above their
tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.newton_schulz import ops as ns_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops


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


# ---------------------------------------------------------------------------
# Training kernels: the flash-attention backward, ns_fused and matmul.
# Tolerances (relative to the largest entry of the plain result): 1e-4 in
# f32, where both sides sum in f32 in other orders and Newton–Schulz's five
# quintic steps amplify that along small singular directions; 1e-2 (NS,
# matmul) or 2e-2 (gradients, relative to max(1, largest)) in bf16, where
# both sides round the result to bf16 once.
# ---------------------------------------------------------------------------


def _rel(got, want, floor=0.0):
    want = want.float()
    scale = max(floor, want.abs().max().item())
    return (got.float() - want).abs().max().item() / scale


def _grads(q, k, v, do, kw, force):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, force=force, **kw)
    return torch.autograd.grad(out, leaves, do)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("B,S,H,KV,causal,window,softcap", [
    (2, 77, 12, 12, True, 0, 0.0), (2, 300, 8, 2, True, 64, 30.0),
    (2, 200, 8, 2, False, 0, 30.0), (16, 256, 12, 12, True, 0, 0.0)])
def test_flash_backward_matches_autograd_of_plain_version(
        cuda_device, dtype, hd, B, S, H, KV, causal, window, softcap):
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda_device, td)
               for x in _qkv(10, B, S, H, KV, hd))
    do = torch.from_numpy(_qkv(11, B, S, H, KV, hd)[0]).to(cuda_device, td)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    before = ops.BWD_LAUNCHES
    got = _grads(q, k, v, do, kw, "auto")
    want = _grads(q, k, v, do, kw, "ref")
    torch.cuda.synchronize()
    assert ops.BWD_LAUNCHES == before + 1
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for g, w in zip(got, want):
        assert g.dtype == td and g.shape == w.shape
        assert _rel(g, w, floor=1.0) <= tol


@pytest.mark.gpu
def test_serving_forward_is_unchanged_by_the_lse_output(cuda_device):
    """The training forward (with the logsumexp) writes the same output
    bits as the serving forward, and serving never runs the backward."""
    q, k, v = (torch.from_numpy(x).to(cuda_device)
               for x in _qkv(12, 2, 100, 8, 2, 64))
    with torch.no_grad():
        served = ops.flash_attention(q, k, v)
    out, lse = ops.flash_attention_cuda(q, k, v, with_lse=True)
    assert torch.equal(out, served)
    want = torch.logsumexp(torch.einsum(
        "bqhd,bkhd->bhqk", q, k.repeat_interleave(4, dim=2)) / 8.0
        + torch.triu(torch.full((100, 100), -1e30, device=cuda_device), 1),
        dim=-1)
    assert (lse - want).abs().max().item() < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,n,m", [(1, 100, 300), (3, 64, 64), (3, 192, 64),
                                   (12, 768, 3072)])
def test_ns_fused_matches_plain_version(cuda_device, dtype, L, n, m):
    td = getattr(torch, dtype)
    x = (0.02 * torch.from_numpy(np.random.default_rng(L * n).standard_normal(
        (L, n, m)).astype(np.float32))).to(cuda_device, td)
    before = ns_ops.NS_FUSED_LAUNCHES
    got = ns_ops.newton_schulz(x)
    want = ns_ops.newton_schulz(x, force="ref")
    torch.cuda.synchronize()
    assert ns_ops.NS_FUSED_LAUNCHES == before + 1
    assert got.dtype == td and got.shape == x.shape
    assert _rel(got, want) <= (1e-2 if dtype == "bfloat16" else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,trans_b,dtype", [
    (100, 300, 77, False, "float32"), (100, 300, 77, True, "float32"),
    (37, 200, 45, False, "bfloat16"), (768, 50304, 768, True, "float32")])
def test_matmul_matches_plain_product(cuda_device, M, K, N, trans_b, dtype):
    td = getattr(torch, dtype)
    rng = np.random.default_rng(M + N)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(
        np.float32)).to(cuda_device, td)
    y = torch.from_numpy(rng.standard_normal(
        (N, K) if trans_b else (K, N)).astype(np.float32)).to(cuda_device, td)
    before = ns_ops.MATMUL_LAUNCHES
    got = ns_ops.matmul(x, y, trans_b=trans_b)
    want = ns_ops.matmul(x, y, trans_b=trans_b, force="ref")
    torch.cuda.synchronize()
    assert ns_ops.MATMUL_LAUNCHES == before + 1 and got.dtype == td
    assert _rel(got, want) <= (1e-2 if dtype == "bfloat16" else 1e-4)


@pytest.mark.gpu
def test_newton_schulz_kernels_refuse_what_they_do_not_take(cuda_device):
    """Non-contiguous, float16 or n > m inputs raise on the card with no
    launch counted; nothing falls back to the plain versions."""
    x = torch.randn(2, 64, 32, device=cuda_device)
    before = (ns_ops.NS_FUSED_LAUNCHES, ns_ops.MATMUL_LAUNCHES)
    with pytest.raises(ValueError, match="n <= m"):
        ns_ops.ns_fused(x)
    with pytest.raises(ValueError, match="dtype"):
        ns_ops.ns_fused(x.transpose(1, 2).contiguous().half())
    with pytest.raises(ValueError, match="contiguous"):
        ns_ops.matmul(x[0].T, x[0])
    assert (ns_ops.NS_FUSED_LAUNCHES, ns_ops.MATMUL_LAUNCHES) == before


def _wkv_inputs(seed, B, S, H, hd, dtype, device, decay):
    """r, k, v ~ N(0, 1) in ``dtype``; w float32 uniform in ``decay``;
    u ~ 0.1 N(0, 1); a N(0, 1) initial state."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal(
        (B, S, H, hd), dtype=np.float32)).to(device, dtype) for _ in range(3))
    w = torch.from_numpy(rng.uniform(*decay, (B, S, H, hd)).astype(
        np.float32)).to(device)
    u = torch.from_numpy((0.1 * rng.standard_normal((H, hd))).astype(
        np.float32)).to(device)
    s0 = torch.from_numpy(rng.standard_normal(
        (B, H, hd, hd), dtype=np.float32)).to(device)
    return r, k, v, w, u, s0


# The WKV kernel against both plain forms, relative to max(1, max|y|) (and
# max(1, max|state|)): f32 sums in other orders, to the reference's own
# 1e-4 bar for its chunked form; with bf16 r/k/v both sides round y to
# bf16 once (2^-8 relative), the state stays f32.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("S,decay", [(1, (0.69, 0.75)), (63, (0.69, 0.75)),
                                     (100, (0.995, 0.9975))])
def test_wkv_kernel_matches_plain_forms(cuda_device, dtype, hd, S, decay):
    td = getattr(torch, dtype)
    args = _wkv_inputs(hd + S, 2, S, 3, hd, td, cuda_device, decay)
    before = wkv_ops.KERNEL_LAUNCHES
    y, s = wkv_ops.wkv(*args)
    torch.cuda.synchronize()
    assert wkv_ops.KERNEL_LAUNCHES == before + 1
    assert y.dtype == td and s.dtype == torch.float32
    tol = 1e-2 if dtype == "bfloat16" else 1e-4
    for force in ("ref", "chunked"):
        want_y, want_s = wkv_ops.wkv(*args, force=force)
        assert _rel(y, want_y, floor=1.0) <= tol
        assert _rel(s, want_s, floor=1.0) <= 1e-4


@pytest.mark.gpu
def test_wkv_kernel_refuses_grads_and_what_it_does_not_take(cuda_device):
    """An input that requires grad raises naming the ROADMAP item of the
    backward; a float16 stream or an odd head dim raises; no launch is
    counted and nothing falls back to the plain versions."""
    args = _wkv_inputs(1, 1, 8, 2, 64, torch.float32, cuda_device,
                       (0.7, 0.9))
    before = wkv_ops.KERNEL_LAUNCHES
    with pytest.raises(NotImplementedError, match="item 16"):
        wkv_ops.wkv(args[0].clone().requires_grad_(), *args[1:])
    with pytest.raises(ValueError, match="dtypes"):
        wkv_ops.wkv(*(a.half() for a in args[:3]), *args[3:])
    odd = _wkv_inputs(2, 1, 8, 2, 48, torch.float32, cuda_device, (0.7, 0.9))
    with pytest.raises(ValueError, match="head dim 48"):
        wkv_ops.wkv(*odd)
    assert wkv_ops.KERNEL_LAUNCHES == before
    with torch.no_grad():
        wkv_ops.wkv(args[0].clone().requires_grad_(), *args[1:])
    assert wkv_ops.KERNEL_LAUNCHES == before + 1


def _scan_inputs(seed, B, S, d, N, dtype, device, regime):
    """u, Bm, Cm ~ N(0, 1) in ``dtype``; dt in ``dtype`` and A float32 by
    regime (decays near 1, or large dt * A down to -80); D ~ 1 + 0.1 N(0,
    1); a N(0, 1) initial state."""
    rng = np.random.default_rng(seed)
    (dlo, dhi), (alo, ahi) = {"near 1": ((0.01, 0.1), (1e-3, 1e-2)),
                              "large": ((1.0, 5.0), (1.0, 16.0))}[regime]

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)
    u = t(rng.standard_normal((B, S, d)))
    dt = t(rng.uniform(dlo, dhi, (B, S, d)))
    A = t(-rng.uniform(alo, ahi, (d, N)), torch.float32)
    Bm = t(rng.standard_normal((B, S, N)))
    Cm = t(rng.standard_normal((B, S, N)))
    Dp = t(1.0 + 0.1 * rng.standard_normal(d), torch.float32)
    h0 = t(rng.standard_normal((B, d, N)), torch.float32)
    return u, dt, A, Bm, Cm, Dp, h0


# The scan kernel against both plain forms, y and the final state relative
# to max(1, max|·|): f32 sums and decay products in other orders, with the
# kernel's exp on the SFU (2 ulp), to the reference's own 1e-4 bar for its
# kernel; with bf16 inputs both sides round y to bf16 once (2^-8
# relative), the state stays f32.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("S,d,regime", [(1, 16, "large"), (63, 200, "near 1"),
                                        (200, 256, "large"),
                                        (1000, 130, "near 1")])
def test_scan_kernel_matches_plain_forms(cuda_device, dtype, N, S, d,
                                         regime):
    td = getattr(torch, dtype)
    *args, h0 = _scan_inputs(N + S + d, 2, S, d, N, td, cuda_device, regime)
    before = scan_ops.KERNEL_LAUNCHES
    y, h = scan_ops.selective_scan_with_state(*args, h0=h0)
    y_only = scan_ops.selective_scan(*args)
    torch.cuda.synchronize()
    assert scan_ops.KERNEL_LAUNCHES == before + 2
    assert y.dtype == td and h.dtype == torch.float32
    tol = 1e-2 if dtype == "bfloat16" else 1e-4
    for force in ("ref", "chunked"):
        want_y, want_h = scan_ops.selective_scan_with_state(*args, h0=h0,
                                                            force=force)
        assert _rel(y, want_y, floor=1.0) <= tol
        assert _rel(h, want_h, floor=1.0) <= 1e-4
        want_0 = scan_ops.selective_scan(*args, force=force)
        assert _rel(y_only, want_0, floor=1.0) <= tol


@pytest.mark.gpu
def test_scan_kernel_refuses_grads_and_what_it_does_not_take(cuda_device):
    """An input that requires grad raises naming the ROADMAP item of the
    backward; float16 inputs, a state dim of 3 or mixed dtypes raise; no
    launch is counted and nothing falls back to the plain versions."""
    *args, h0 = _scan_inputs(1, 1, 8, 32, 4, torch.float32, cuda_device,
                             "large")
    before = scan_ops.KERNEL_LAUNCHES
    with pytest.raises(NotImplementedError, match="item 18"):
        scan_ops.selective_scan(args[0].clone().requires_grad_(), *args[1:])
    with pytest.raises(ValueError, match="dtypes"):
        scan_ops.selective_scan(*(a.half() for a in args[:2]), args[2],
                                *(a.half() for a in args[3:5]), args[5])
    with pytest.raises(ValueError, match="dtypes"):
        scan_ops.selective_scan(args[0].bfloat16(), *args[1:])
    odd = _scan_inputs(2, 1, 8, 32, 3, torch.float32, cuda_device, "large")
    with pytest.raises(ValueError, match="state dim 3"):
        scan_ops.selective_scan(*odd[:6])
    assert scan_ops.KERNEL_LAUNCHES == before
    with torch.no_grad():
        scan_ops.selective_scan(args[0].clone().requires_grad_(), *args[1:])
    assert scan_ops.KERNEL_LAUNCHES == before + 1
