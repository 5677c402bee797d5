"""The CUDA kernels (flash attention forward and backward, paged-attention
decode over float and int8/fp8 pages, the Newton–Schulz chain and matmul,
the RWKV6 WKV recurrence, the Mamba selective scan) against their plain
PyTorch versions, on the card.

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.  Without a card every test skips (decided in a
fixture when the test runs, so that test workers all collect the same
tests).  Tolerances of the attention kernels: 1e-4 in f32 (both sides sum
in f32, in other orders); 2e-2 in bf16, where both sides round the output
to bf16 once; in f32 also 1e-5 against an f64 version, which tells the
kernels' 3xTF32 products from plain TF32.  The training kernels'
tolerances are stated above their tests.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import quant
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
@pytest.mark.parametrize("hd", [64, 128, 256])
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


def _paged(seed, B, H, KV, hd, bs, NB, dtypes, device, cursors=None):
    """Permuted physical pages; slots past each cursor hold large finite
    garbage, which must not reach the output.  Cursors are drawn unless
    given."""
    rng = np.random.default_rng(seed)
    NP = B * NB + 2
    q = rng.standard_normal((B, 1, H, hd), dtype=np.float32)
    kp = 1e3 * rng.standard_normal((NP, bs, KV, hd), dtype=np.float32)
    vp = 1e3 * rng.standard_normal((NP, bs, KV, hd), dtype=np.float32)
    tbl = rng.permutation(NP)[:B * NB].reshape(B, NB).astype(np.int32)
    idx = rng.integers(0, NB * bs, (B,)).astype(np.int32)
    if cursors is not None:
        idx = np.asarray(cursors, np.int32)
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
@pytest.mark.parametrize("hd", [64, 128, 256])
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


def _quant_pages(pages, kv, device):
    """Quantize float pages per slot and head -> (pages, scales) on the
    card."""
    q, s = quant.quantize(pages, axis=-1, dtype=quant.resolve_kv_dtype(kv))
    return q.to(device), s.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("H,KV,bs,NB,softcap", [(12, 12, 16, 37, 0.0),
                                                (8, 2, 64, 4, 30.0)])
def test_quantized_paged_kernel_matches_plain_version(cuda_device, kv,
                                                      q_dtype, hd, H, KV, bs,
                                                      NB, softcap):
    """int8/fp8 pages with their f32 scale pages (garbage past every
    cursor quantized too).  Tolerance relative to max(1, max|plain|): 1e-4
    for f32 q (the same dequantizing product, sums in other orders); 2e-2
    for bf16 q, where the plain version rounds the dequantized context,
    scores and probabilities to bf16 and the kernel keeps them in f32."""
    q, kp, vp, tbl, idx = _paged(10, 3, H, KV, hd, bs, NB,
                                 (q_dtype, "float32"), "cpu")
    (kq, ks), (vq, vs) = (_quant_pages(t, kv, cuda_device) for t in (kp, vp))
    q, tbl, idx = (t.to(cuda_device) for t in (q, tbl, idx))
    before = pa_ops.KERNEL_LAUNCHES
    kw = dict(k_scales=ks, v_scales=vs, logit_softcap=softcap)
    got = pa_ops.paged_attention(q, kq, vq, tbl, idx, **kw)
    want = pa_ops.paged_attention(q, kq, vq, tbl, idx, force="ref", **kw)
    torch.cuda.synchronize()
    assert pa_ops.KERNEL_LAUNCHES == before + 1
    want = want.float().cpu().numpy()
    tol = (2e-2 if q_dtype == "bfloat16" else 1e-4) * max(
        1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().cpu().numpy(), want, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantize_on_the_card_is_bit_exact_with_the_cpu(cuda_device, kv):
    """Per-head quantization of the decode's new K/V: values and scales on
    the card equal the CPU's byte for byte (IEEE division, round half to
    even, the same fp8 rounding)."""
    x = torch.from_numpy(3 * np.random.default_rng(12).standard_normal(
        (8, 12, 64), dtype=np.float32))
    dt = quant.resolve_kv_dtype(kv)
    qc, sc = quant.quantize(x, axis=-1, dtype=dt)
    qg, sg = quant.quantize(x.to(cuda_device), axis=-1, dtype=dt)
    assert torch.equal(qg.cpu(), qc)
    assert torch.equal(sg.cpu(), sc)


@pytest.mark.gpu
def test_quantized_decode_on_the_card_matches_the_cpu(cuda_device):
    """``paged_attention_decode`` over an int8 pool: the quantized write
    lands byte for byte as on the CPU, and the attention output agrees
    with the CPU's plain version within 1e-4."""
    B, H, KV, hd, bs, NB = 3, 8, 2, 64, 16, 4
    q, kp, vp, tbl, idx = _paged(13, B, H, KV, hd, bs, NB,
                                 ("float32", "float32"), "cpu")
    (kq, ks), (vq, vs) = (_quant_pages(t, "int8", "cpu") for t in (kp, vp))
    rng = np.random.default_rng(14)
    k_new, v_new = (torch.from_numpy(rng.standard_normal(
        (B, KV, hd), dtype=np.float32)) for _ in range(2))
    page = tbl[torch.arange(B), idx.long() // bs].clone()
    off = idx % bs
    cpu = [t.clone() for t in (kq, vq, ks, vs)]
    want, _ = pa_ops.paged_attention_decode(
        q, *cpu[:2], k_new, v_new, page, off, tbl, idx, k_scales=cpu[2],
        v_scales=cpu[3])
    card = [t.to(cuda_device) for t in (kq, vq, ks, vs)]
    args = [t.to(cuda_device) for t in (q, k_new, v_new, page, off, tbl,
                                        idx)]
    got, _ = pa_ops.paged_attention_decode(
        args[0], *card[:2], *args[1:], k_scales=card[2], v_scales=card[3])
    torch.cuda.synchronize()
    for c, g in zip(cpu, card):
        assert torch.equal(g.cpu(), c)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)


@pytest.mark.gpu
def test_quantized_pages_without_scales_raise_on_the_card(cuda_device):
    q, kp, vp, tbl, idx = _paged(15, 2, 4, 2, 64, 8, 2,
                                 ("float32", "float32"), cuda_device)
    before = pa_ops.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="both scale pages"):
        pa_ops.paged_attention(q, kp.to(torch.int8), vp.to(torch.int8), tbl,
                               idx)
    assert pa_ops.KERNEL_LAUNCHES == before


def _paged_kw(seed, B, H, KV, hd, bs, NB, kv, device, cursors=None):
    """``_paged`` with f32 q over ``kv`` pages ("float32", "int8", "fp8"):
    (q, k_pages, v_pages, table, index) on the card and the scale pages'
    keywords (empty for float pages)."""
    q, kp, vp, tbl, idx = _paged(seed, B, H, KV, hd, bs, NB,
                                 ("float32", "float32"), "cpu", cursors)
    kw = {}
    if kv != "float32":
        (kp, ks), (vp, vs) = (_quant_pages(t, kv, "cpu") for t in (kp, vp))
        kw = dict(k_scales=ks.to(device), v_scales=vs.to(device))
    return tuple(t.to(device) for t in (q, kp, vp, tbl, idx)), kw


def _close_to_plain(got, want):
    """Within 1e-4 of the plain version, relative to max(1, max|plain|)
    (f32 q: the same dequantizing product, f32 sums in other orders)."""
    want = want.float().cpu().numpy()
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().cpu().numpy(), want, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_paged_kernel_repeats_are_bit_identical(cuda_device, kv):
    """The cluster merge reads every rank's partials in rank order, and
    each reduction has a fixed order: the same inputs give the same bits,
    at the serving timing shape (B=8, H=KV=12, hd=64, bs=16)."""
    (q, kp, vp, tbl, idx), kw = _paged_kw(16, 8, 12, 12, 64, 16, 37, kv,
                                          cuda_device)
    first = pa_ops.paged_attention(q, kp, vp, tbl, idx, **kw)
    for _ in range(3):
        assert torch.equal(pa_ops.paged_attention(q, kp, vp, tbl, idx, **kw),
                           first)
    _close_to_plain(first, pa_ops.paged_attention(q, kp, vp, tbl, idx,
                                                  force="ref", **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("H,KV,hd", [(6, 6, 64), (8, 4, 64), (12, 1, 128)])
def test_paged_kernel_at_tensor_parallel_local_shapes(cuda_device, kv, H,
                                                      KV, hd):
    """The paged decode on a rank's heads when 'model' splits them in two
    (continuous serving on a mesh): ``gpt2-12l``'s 6 of 12 heads (G = 1),
    ``llama3-0.3b``'s 8 of 16 over 4 of 8 KV heads (G = 2) and
    ``starcoder2-3b``'s 12 of 24 over 1 of 2 (G = 12, hd 128), over f32
    and int8 pages: one launch a call, within 1e-4 of the plain
    version."""
    (q, kp, vp, tbl, idx), kw = _paged_kw(24, 4, H, KV, hd, 16, 9, kv,
                                          cuda_device)
    before = pa_ops.KERNEL_LAUNCHES
    got = pa_ops.paged_attention(q, kp, vp, tbl, idx, **kw)
    assert pa_ops.KERNEL_LAUNCHES == before + 1
    _close_to_plain(got, pa_ops.paged_attention(q, kp, vp, tbl, idx,
                                                force="ref", **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("B,KV,NB,n_split", [(1, 1, 256, 8), (64, 12, 8, 1)])
def test_paged_cluster_plan_at_its_extremes(cuda_device, B, KV, NB, n_split):
    """B = KV = 1 over a 4096-slot table takes the largest cluster, 8 CTAs
    (the other SMs idle); B = 64, KV = 12 fills the card without splits.
    Cursors at the last slot, a page boundary, and 0 (seven empty ranks)."""
    assert pa_ops.split_plan(B, KV, NB) == n_split
    top = NB * 16 - 1
    cursors = [top, 16 * (NB // 2), 0][:B] + [top - 5] * (B - 3)
    (q, kp, vp, tbl, idx), kw = _paged_kw(17, B, KV, KV, 64, 16, NB,
                                          "float32", cuda_device, cursors)
    ranges = pa_ops.rank_tokens(top, NB, 16, n_split)
    assert all(t1 > t0 for t0, t1 in ranges)
    before = pa_ops.KERNEL_LAUNCHES
    got = pa_ops.paged_attention(q, kp, vp, tbl, idx)
    want = pa_ops.paged_attention(q, kp, vp, tbl, idx, force="ref")
    assert pa_ops.KERNEL_LAUNCHES == before + 1
    _close_to_plain(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_paged_kernel_hd128_gqa8(cuda_device, kv):
    """hd 128 with G = 8 query heads per kv head over 1-byte pages: the
    widest accumulator (acc[8][4] a lane) and the 16-lane score rows."""
    (q, kp, vp, tbl, idx), kw = _paged_kw(18, 3, 16, 2, 128, 16, 12, kv,
                                          cuda_device)
    _close_to_plain(pa_ops.paged_attention(q, kp, vp, tbl, idx,
                                           logit_softcap=30.0, **kw),
                    pa_ops.paged_attention(q, kp, vp, tbl, idx, force="ref",
                                           logit_softcap=30.0, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [9, 12, 16])
def test_paged_kernel_past_eight_heads_per_kv_head(cuda_device, kv, hd, G):
    """G > 8 query heads per kv head (starcoder2-3b: 24 over 2, G = 12) in
    one launch: head blocks of 8 over each tile in shared memory.  Two kv
    heads, a cluster of 8 ranks over a 640-slot table (the merge runs), a
    ragged cursor, cursor 0 and the last slot; f32 q over f32, bf16, int8
    and fp8 pages, each within ``_close_to_plain`` (both sides read bf16
    pages exactly into f32); repeats bit-identical."""
    B, KV, bs, NB = 3, 2, 16, 40
    cursors = [377, 0, NB * bs - 1]
    if kv == "bfloat16":
        q, kp, vp, tbl, idx = _paged(21, B, G * KV, KV, hd, bs, NB,
                                     ("float32", "bfloat16"), cuda_device,
                                     cursors)
        kw = {}
    else:
        (q, kp, vp, tbl, idx), kw = _paged_kw(21, B, G * KV, KV, hd, bs, NB,
                                              kv, cuda_device, cursors)
    assert pa_ops.split_plan(B, KV, NB) == 8
    before = pa_ops.KERNEL_LAUNCHES
    got = pa_ops.paged_attention(q, kp, vp, tbl, idx, logit_softcap=30.0,
                                 **kw)
    assert pa_ops.KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, pa_ops.paged_attention(
        q, kp, vp, tbl, idx, logit_softcap=30.0, **kw))
    _close_to_plain(got, pa_ops.paged_attention(
        q, kp, vp, tbl, idx, logit_softcap=30.0, force="ref", **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("softcap", [50.0, 0.0])
def test_paged_kernel_hd256_at_gemma_shape(cuda_device, kv, softcap):
    """gemma's global layers: hd 256, G = 2 (16 query heads over 8 kv
    heads), softcap 50 (gemma2) and none (gemma3), contexts past 4096
    tokens over pages of 16; f32 q, each page dtype within
    ``_close_to_plain``; repeats bit-identical."""
    B, H, KV, bs, NB = 2, 16, 8, 16, 400
    cursors = [4200, 6175]
    if kv == "bfloat16":
        q, kp, vp, tbl, idx = _paged(23, B, H, KV, 256, bs, NB,
                                     ("float32", "bfloat16"), cuda_device,
                                     cursors)
        kw = {}
    else:
        (q, kp, vp, tbl, idx), kw = _paged_kw(23, B, H, KV, 256, bs, NB, kv,
                                              cuda_device, cursors)
    before = pa_ops.KERNEL_LAUNCHES
    got = pa_ops.paged_attention(q, kp, vp, tbl, idx, logit_softcap=softcap,
                                 **kw)
    assert pa_ops.KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, pa_ops.paged_attention(
        q, kp, vp, tbl, idx, logit_softcap=softcap, **kw))
    _close_to_plain(got, pa_ops.paged_attention(
        q, kp, vp, tbl, idx, logit_softcap=softcap, force="ref", **kw))


@pytest.mark.gpu
def test_paged_kernel_takes_either_cursor_dtype(cuda_device):
    """The engine's int64 cursor is read as it is (no cast kernel); an
    int32 one gives the same bits."""
    (q, kp, vp, tbl, idx), kw = _paged_kw(19, 4, 8, 2, 64, 16, 9, "int8",
                                          cuda_device)
    got32 = pa_ops.paged_attention(q, kp, vp, tbl, idx, **kw)
    got64 = pa_ops.paged_attention(q, kp, vp, tbl, idx.long(), **kw)
    assert torch.equal(got32, got64)
    _close_to_plain(got64, pa_ops.paged_attention(q, kp, vp, tbl, idx.long(),
                                                  force="ref", **kw))


@pytest.mark.gpu
def test_paged_refused_launch_raises(cuda_device, monkeypatch):
    """120 query heads per kv head at hd 64 pass the shared memory a block
    can use, and a cluster of 9 CTAs passes the portable 8: each comes back
    from the C function as a CUDA error and raises RuntimeError; neither
    counts a launch, and the next launch runs."""
    (q, kp, vp, tbl, idx), _ = _paged_kw(20, 2, 240, 2, 64, 16, 4, "float32",
                                         cuda_device)
    before = pa_ops.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        pa_ops.paged_attention(q, kp, vp, tbl, idx)
    q = q[:, :, :16].contiguous()
    monkeypatch.setattr(pa_ops, "split_plan", lambda *a: 9)
    with pytest.raises(RuntimeError, match="launch failed"):
        pa_ops.paged_attention(q, kp, vp, tbl, idx)
    assert pa_ops.KERNEL_LAUNCHES == before
    monkeypatch.undo()
    got = pa_ops.paged_attention(q, kp, vp, tbl, idx)
    _close_to_plain(got, pa_ops.paged_attention(q, kp, vp, tbl, idx,
                                                force="ref"))


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
@pytest.mark.parametrize("hd", [64, 128, 256])
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


def _attention_f64(q, k, v, causal, window, softcap):
    """Attention in f64 with the kernels' masks and softcap; GQA by
    repeated K/V."""
    q, k, v = (t.double() for t in (q, k, v))
    G = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(G, dim=2) for t in (k, v))
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    i = torch.arange(S, device=q.device)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        keep &= i[:, None] >= i[None, :]
    if window > 0:
        keep &= (i[:, None] - i[None, :]) < window
    s = s.masked_fill(~keep, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


# The f32 kernels against f64 (the forward's max abs error, the gradients
# relative to max(1, largest)): their 3xTF32 products keep them about as
# close as the plain f32 version (~1e-6); one TF32 pass is ~7e-4 off.
FA_F64_TOL = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("S,H,KV,causal,window,softcap", [
    (200, 4, 4, True, 0, 0.0), (150, 8, 2, True, 32, 30.0),
    (130, 4, 2, False, 0, 0.0)])
def test_flash_f32_is_within_1e5_of_f64(cuda_device, hd, S, H, KV, causal,
                                         window, softcap):
    q, k, v = (torch.from_numpy(x).to(cuda_device)
               for x in _qkv(13, 2, S, H, KV, hd))
    do = torch.from_numpy(_qkv(14, 2, S, H, KV, hd)[0]).to(cuda_device)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    want = _attention_f64(*leaves, causal, window, softcap)
    want_grads = torch.autograd.grad(want, leaves, do.double())
    got = ops.flash_attention(q, k, v, **kw)
    assert (got.double() - want).abs().max().item() <= FA_F64_TOL
    for g, w in zip(_grads(q, k, v, do, kw, "auto"), want_grads):
        assert _rel(g.double(), w, floor=1.0) <= FA_F64_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_repeats_are_bit_identical(cuda_device, dtype, hd):
    """No atomics and fixed sum orders: the same inputs give the same bits,
    forward and backward."""
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda_device, td)
               for x in _qkv(15, 2, 300, 8, 2, hd))
    do = torch.from_numpy(_qkv(16, 2, 300, 8, 2, hd)[0]).to(cuda_device, td)
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(q, k, v),
                           ops.flash_attention(q, k, v))
    first = _grads(q, k, v, do, {}, "auto")
    for a, b in zip(first, _grads(q, k, v, do, {}, "auto")):
        assert torch.equal(a, b)


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


# The GEMM's symmetric route and split-K (``ns_ops.gemm_plan``): x @ x.T at
# a ragged one-tile M = N = 100 with K = 20000, at the tied embedding's
# 768 x 50304 Gram, and G G^T at 768^3 (G a Gram, exactly symmetric); a
# bf16 Gram.  Each is exactly symmetric, the same bits on a second call,
# and within the tolerances of the tests above (1e-4 f32, 1e-2 bf16).
@pytest.mark.gpu
@pytest.mark.parametrize("M,K,gram_of,dtype", [
    (100, 20000, 0, "float32"), (768, 50304, 0, "float32"),
    (768, 768, 50304, "float32"), (130, 4096, 0, "bfloat16")])
def test_symmetric_split_k_matmul(cuda_device, M, K, gram_of, dtype):
    td = getattr(torch, dtype)
    rng = np.random.default_rng(M + K)
    x = torch.from_numpy(rng.standard_normal(
        (M, gram_of or K)).astype(np.float32)).to(cuda_device)
    if gram_of:
        x = ns_ops.matmul(x, x, trans_b=True) / gram_of
        assert torch.equal(x, x.T)
    x = x.to(td)
    plan = ns_ops.gemm_plan(1, M, M, K, symmetric=True)
    assert plan.splits >= 2 and plan.tiles == (-(-M // 128)) * (
        -(-M // 128) + 1) // 2
    before = ns_ops.MATMUL_LAUNCHES
    got = ns_ops.matmul(x, x, trans_b=True)
    again = ns_ops.matmul(x, x, trans_b=True)
    want = ns_ops.matmul(x, x, trans_b=True, force="ref")
    torch.cuda.synchronize()
    assert ns_ops.MATMUL_LAUNCHES == before + 2 and got.dtype == td
    assert torch.equal(got, got.T)
    assert torch.equal(got, again)
    assert _rel(got, want) <= (1e-2 if dtype == "bfloat16" else 1e-4)


@pytest.mark.gpu
def test_large_route_updates_fused_into_the_gemm(cuda_device):
    """``_ns_large``'s c G G^T + b G and P X + a X through the GEMM's
    epilogue against the same arithmetic in plain f32 products."""
    from repro_torch.kernels.newton_schulz.ref import NS_COEFFS
    a, b, c = NS_COEFFS
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((768, 4096)).astype(
        np.float32)).to(cuda_device)
    x = x / torch.linalg.norm(x)
    gram = ns_ops.matmul(x, x, trans_b=True)
    poly = ns_ops._gemm(gram, gram, trans_b=True, d=gram, alpha=c, beta=b)
    upd = ns_ops._gemm(poly, x, d=x, beta=a)
    torch.cuda.synchronize()
    assert torch.equal(poly, poly.T)
    assert _rel(poly, c * (gram @ gram) + b * gram) <= 1e-4
    assert _rel(upd, poly @ x + a * x) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("L,n,m", [(12, 768, 3072), (1, 768, 3072),
                                   (3, 100, 300)])
def test_ns_fused_is_bit_identical_on_repeat(cuda_device, L, n, m):
    """No atomics: a one-layer stack cuts K (its Grams have 21 tiles), and
    its split-K sums come out the same on every call."""
    x = 0.02 * torch.from_numpy(np.random.default_rng(L + n).standard_normal(
        (L, n, m)).astype(np.float32)).to(cuda_device)
    first = ns_ops.ns_fused(x)
    assert torch.equal(first, ns_ops.ns_fused(x))


@pytest.mark.gpu
def test_gram_accumulates_in_f32_against_f64(cuda_device):
    """The embedding's Gram against an f64 product.  The tensor cores
    truncate as they accumulate, which over 50304 same-signed terms (a
    Gram's diagonal) biases the sum by ~1e-4 relative unless each k-slice
    is summed afresh and added in IEEE f32, as the kernel does; 1e-5 lies
    between the two (PERF.md gives both readings)."""
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (768, 50304)).astype(np.float32)).to(cuda_device)
    x = x / torch.linalg.norm(x)
    got = ns_ops.matmul(x, x, trans_b=True).double()
    want = x.double() @ x.double().T
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


@pytest.mark.gpu
def test_gemm_refused_launch_raises(cuda_device, monkeypatch):
    """A plan the GEMM refuses (K cut into no splits) comes back from the
    launch as an error: both wrappers raise RuntimeError with nothing
    counted, and the next launch runs."""
    x = torch.randn(256, 512, device=cuda_device)
    plan = ns_ops.gemm_plan
    monkeypatch.setattr(ns_ops, "gemm_plan", lambda *a, **k: (
        dataclasses.replace(plan(*a, **k), splits=0)))
    before = (ns_ops.MATMUL_LAUNCHES, ns_ops.NS_FUSED_LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        ns_ops.matmul(x, x, trans_b=True)
    with pytest.raises(RuntimeError, match="launch failed"):
        ns_ops.ns_fused(x[None])
    assert (ns_ops.MATMUL_LAUNCHES, ns_ops.NS_FUSED_LAUNCHES) == before
    monkeypatch.undo()
    got = ns_ops.matmul(x, x, trans_b=True)
    torch.cuda.synchronize()
    assert _rel(got, x @ x.T) <= 1e-4


def _near_zero_decays(rng, shape):
    """w uniform in [1e-4, 0.05], a tenth of the entries exactly 0 and a
    twentieth in [1e-37, 1e-31], below the reference's 1e-30 floor: a
    factorization across a chunk would overflow f32 here."""
    w = rng.uniform(1e-4, 0.05, shape)
    pick = rng.random(shape)
    w[pick < 0.1] = 0.0
    tiny = (pick >= 0.1) & (pick < 0.15)
    w[tiny] = 10.0 ** rng.uniform(-37, -31, int(tiny.sum()))
    return w


def _wkv_inputs(seed, B, S, H, hd, dtype, device, decay):
    """r, k, v ~ N(0, 1) in ``dtype``; w float32 uniform in ``decay`` (or
    the "near 0" regime); u ~ 0.1 N(0, 1); a N(0, 1) initial state."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal(
        (B, S, H, hd), dtype=np.float32)).to(device, dtype) for _ in range(3))
    shape = (B, S, H, hd)
    w = (_near_zero_decays(rng, shape) if decay == "near 0"
         else rng.uniform(*decay, shape))
    w = torch.from_numpy(w.astype(np.float32)).to(device)
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
                                     (100, (0.995, 0.9975)), (17, "near 0"),
                                     (100, "near 0")])
def test_wkv_kernel_matches_plain_forms(cuda_device, dtype, hd, S, decay):
    td = getattr(torch, dtype)
    args = _wkv_inputs(hd + S, 2, S, 3, hd, td, cuda_device, decay)
    before = wkv_ops.KERNEL_LAUNCHES
    y, s = wkv_ops.wkv(*args)
    torch.cuda.synchronize()
    assert wkv_ops.KERNEL_LAUNCHES == before + 1
    assert y.dtype == td and s.dtype == torch.float32
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    tol = 1e-2 if dtype == "bfloat16" else 1e-4
    for force in ("ref", "chunked"):
        want_y, want_s = wkv_ops.wkv(*args, force=force)
        assert _rel(y, want_y, floor=1.0) <= tol
        assert _rel(s, want_s, floor=1.0) <= 1e-4


@pytest.mark.gpu
def test_wkv_kernel_refuses_grads_and_what_it_does_not_take(cuda_device):
    """An input that requires grad now launches the forward (saving its
    chunk states) and, on backward, the backward kernel; a float16 stream
    or an odd head dim still raises, counting no launch, and nothing falls
    back to the plain versions."""
    args = _wkv_inputs(1, 1, 8, 2, 64, torch.float32, cuda_device,
                       (0.7, 0.9))
    before = wkv_ops.KERNEL_LAUNCHES, wkv_ops.BWD_LAUNCHES
    r = args[0].clone().requires_grad_()
    y, _ = wkv_ops.wkv(r, *args[1:])
    assert wkv_ops.KERNEL_LAUNCHES == before[0] + 1
    y.sum().backward()
    torch.cuda.synchronize()
    assert wkv_ops.BWD_LAUNCHES == before[1] + 1
    assert r.grad is not None and bool(torch.isfinite(r.grad).all())
    with pytest.raises(ValueError, match="dtypes"):
        wkv_ops.wkv(*(a.half() for a in args[:3]), *args[3:])
    with pytest.raises(ValueError, match="dtypes"):
        wkv_ops.wkv(*(a.half().requires_grad_() for a in args[:3]),
                    *args[3:])
    odd = _wkv_inputs(2, 1, 8, 2, 48, torch.float32, cuda_device, (0.7, 0.9))
    with pytest.raises(ValueError, match="head dim 48"):
        wkv_ops.wkv(*odd)
    with pytest.raises(ValueError, match="head dim 48"):
        wkv_ops.wkv(odd[0].requires_grad_(), *odd[1:])
    assert (wkv_ops.KERNEL_LAUNCHES, wkv_ops.BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        wkv_ops.wkv(args[0].clone().requires_grad_(), *args[1:])
    assert wkv_ops.KERNEL_LAUNCHES == before[0] + 2


def _bwd_room(want, dtype):
    """Each gradient entry's limit against the plain backward: 1e-4 of
    max(1, max|plain|) (f32 sums in other orders; the kernels re-run their
    states from the forward's chunk starts), plus 2^-7 |plain| where the
    gradient is bfloat16: both sides round it once, and two f32 values a
    hair apart can round to neighbouring bf16 values, one unit in the last
    place (at most 2^-7 relative) apart."""
    room = torch.full_like(want.float(), 1e-4 * max(
        1.0, want.float().abs().max().item()))
    if dtype == torch.bfloat16:
        room = room + 2.0 ** -7 * want.float().abs()
    return room


def _within(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    ratio = ((got.float() - want.float()).abs()
             / _bwd_room(want, want.dtype)).max().item()
    assert ratio <= 1.0, f"{ratio:.3f} of the limit"


# The WKV backward kernel against the plain reverse recurrence
# (ref.wkv_bwd_ref) on the same inputs and output gradients, entry by entry
# (_bwd_room), over head dims, ragged and chunk-edge lengths, decays near
# 0.69, 0.9975 and 0 (zeros and values below 1e-30 included), zero and
# random initial states.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("S,decay,state", [
    (1, (0.69, 0.75), True), (17, "near 0", True), (64, (0.69, 0.75), False),
    (100, (0.995, 0.9975), True), (100, "near 0", False)])
def test_wkv_backward_matches_plain(cuda_device, dtype, hd, S, decay, state):
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    td = getattr(torch, dtype)
    args = list(_wkv_inputs(hd + S + 7, 2, S, 3, hd, td, cuda_device, decay))
    if not state:
        args[5] = torch.zeros_like(args[5])
    g = torch.Generator(device=cuda_device).manual_seed(S)
    dy = torch.randn(args[0].shape, generator=g, device=cuda_device).to(td)
    ds = torch.randn(args[5].shape, generator=g, device=cuda_device)
    leaves = [a.clone().requires_grad_() for a in args]
    before = wkv_ops.BWD_LAUNCHES
    y, s = wkv_ops.wkv(*leaves)
    got = torch.autograd.grad((y.float() * dy.float()).sum()
                              + (s * ds).sum(), leaves)
    torch.cuda.synchronize()
    assert wkv_ops.BWD_LAUNCHES == before + 1
    want = wkv_ref.wkv_bwd_ref(*args, dy, ds)
    for a, b in zip(got, want):
        _within(a, b)


def _scan_inputs(seed, B, S, d, N, dtype, device, regime):
    """u, Bm, Cm ~ N(0, 1) in ``dtype``; dt in ``dtype`` and A float32 by
    regime (decays near 1, large dt * A down to -80, or the model's: dt =
    softplus(N(0, 1)), A = -(1..N) as mamba_init makes it); D ~ 1 + 0.1
    N(0, 1); a N(0, 1) initial state."""
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)
    u = t(rng.standard_normal((B, S, d)))
    if regime == "model":
        dt = t(np.log1p(np.exp(rng.standard_normal((B, S, d)))))
        A = t(-np.tile(np.arange(1, N + 1), (d, 1)), torch.float32)
    else:
        (dlo, dhi), (alo, ahi) = {"near 1": ((0.01, 0.1), (1e-3, 1e-2)),
                                  "large": ((1.0, 5.0), (1.0, 16.0))}[regime]
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
                                        (1000, 130, "near 1"),
                                        (300, 192, "model")])
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
    assert bool(torch.isfinite(y).all() and torch.isfinite(h).all())
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
    """An input that requires grad now launches the forward (saving h every
    64 steps) and, on backward, the backward kernel; float16 inputs, a
    state dim of 3 or mixed dtypes still raise, counting no launch, and
    nothing falls back to the plain versions."""
    *args, h0 = _scan_inputs(1, 1, 8, 32, 4, torch.float32, cuda_device,
                             "large")
    before = scan_ops.KERNEL_LAUNCHES, scan_ops.BWD_LAUNCHES
    u = args[0].clone().requires_grad_()
    scan_ops.selective_scan(u, *args[1:]).sum().backward()
    torch.cuda.synchronize()
    assert (scan_ops.KERNEL_LAUNCHES, scan_ops.BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert u.grad is not None and bool(torch.isfinite(u.grad).all())
    with pytest.raises(ValueError, match="dtypes"):
        scan_ops.selective_scan(*(a.half() for a in args[:2]), args[2],
                                *(a.half() for a in args[3:5]), args[5])
    with pytest.raises(ValueError, match="dtypes"):
        scan_ops.selective_scan(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError, match="dtypes"):
        scan_ops.selective_scan(args[0].bfloat16().requires_grad_(),
                                *args[1:])
    odd = _scan_inputs(2, 1, 8, 32, 3, torch.float32, cuda_device, "large")
    with pytest.raises(ValueError, match="state dim 3"):
        scan_ops.selective_scan(*odd[:6])
    with pytest.raises(ValueError, match="state dim 3"):
        scan_ops.selective_scan(odd[0].requires_grad_(), *odd[1:6])
    assert (scan_ops.KERNEL_LAUNCHES, scan_ops.BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        scan_ops.selective_scan(args[0].clone().requires_grad_(), *args[1:])
    assert scan_ops.KERNEL_LAUNCHES == before[0] + 2


# The scan backward kernel against the plain reverse recurrence
# (ref.selective_scan_bwd_ref), entry by entry (_bwd_room): both entry
# points (h0 and the final state's gradient on selective_scan_with_state),
# N 4 and 16, ragged and chunk-edge lengths and channel counts, decays near
# 1 and large dt * A (exp underflowing).
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("S,d,regime", [(1, 16, "large"), (15, 100, "model"),
                                        (64, 64, "near 1"),
                                        (100, 200, "large"),
                                        (300, 130, "near 1")])
def test_scan_backward_matches_plain(cuda_device, dtype, N, S, d, regime):
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    td = getattr(torch, dtype)
    *args, h0 = _scan_inputs(N + S + d + 11, 2, S, d, N, td, cuda_device,
                             regime)
    g = torch.Generator(device=cuda_device).manual_seed(S + d)
    dy = torch.randn(args[0].shape, generator=g, device=cuda_device).to(td)
    dh = torch.randn(h0.shape, generator=g, device=cuda_device)
    for with_state in (True, False):
        leaves = [a.clone().requires_grad_() for a in args]
        hl = h0.clone().requires_grad_()
        before = scan_ops.BWD_LAUNCHES
        if with_state:
            y, h = scan_ops.selective_scan_with_state(*leaves, h0=hl)
            loss = (y.float() * dy.float()).sum() + (h * dh).sum()
            got = torch.autograd.grad(loss, leaves + [hl])
            want = scan_ref.selective_scan_bwd_ref(*args, h0, dy, dh)
        else:
            y = scan_ops.selective_scan(*leaves)
            got = torch.autograd.grad((y.float() * dy.float()).sum(), leaves)
            want = scan_ref.selective_scan_bwd_ref(*args, None, dy)[:6]
        torch.cuda.synchronize()
        assert scan_ops.BWD_LAUNCHES == before + 1
        for a, b in zip(got, want):
            _within(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_and_scan_repeats_are_bit_identical(cuda_device, dtype):
    """No atomics and a fixed order of sums: the same call gives the same
    bits, y and the final state, for both recurrent kernels."""
    td = getattr(torch, dtype)
    args = _wkv_inputs(5, 2, 70, 4, 64, td, cuda_device, (0.69, 0.9975))
    first = wkv_ops.wkv(*args)
    *sargs, h0 = _scan_inputs(6, 2, 70, 256, 16, td, cuda_device, "model")
    sfirst = scan_ops.selective_scan_with_state(*sargs, h0=h0)
    for _ in range(3):
        again = wkv_ops.wkv(*args)
        sagain = scan_ops.selective_scan_with_state(*sargs, h0=h0)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        assert all(torch.equal(a, b) for a, b in zip(sfirst, sagain))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_and_scan_backward_repeats_are_bit_identical(cuda_device, dtype):
    """No atomics and fixed orders of sums in the backward kernels and the
    wrappers' sums of their partials: the same backward gives the same
    bits, every gradient, for both recurrent kernels."""
    td = getattr(torch, dtype)
    args = _wkv_inputs(15, 2, 200, 4, 64, td, cuda_device, (0.69, 0.9975))
    *sargs, h0 = _scan_inputs(16, 2, 200, 256, 16, td, cuda_device, "model")
    g = torch.Generator(device=cuda_device).manual_seed(3)
    dy = torch.randn(args[0].shape, generator=g, device=cuda_device).to(td)
    sdy = torch.randn(sargs[0].shape, generator=g,
                      device=cuda_device).to(td)

    def grads():
        leaves = [a.clone().requires_grad_() for a in args]
        y, _ = wkv_ops.wkv(*leaves)
        out = torch.autograd.grad((y.float() * dy.float()).sum(), leaves)
        sleaves = [a.clone().requires_grad_() for a in sargs + [h0]]
        y, _ = scan_ops.selective_scan_with_state(*sleaves[:6],
                                                  h0=sleaves[6])
        return out + torch.autograd.grad((y.float() * sdy.float()).sum(),
                                         sleaves)
    first = grads()
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, grads()))


@pytest.mark.gpu
def test_wkv_and_scan_take_an_empty_sequence(cuda_device):
    """S = 0 launches once and hands the initial state back."""
    args = _wkv_inputs(7, 2, 0, 3, 64, torch.float32, cuda_device,
                       (0.69, 0.9975))
    y, s = wkv_ops.wkv(*args)
    assert y.shape == (2, 0, 3, 64) and torch.equal(s, args[-1])
    *sargs, h0 = _scan_inputs(8, 2, 0, 64, 16, torch.float32, cuda_device,
                              "model")
    y, h = scan_ops.selective_scan_with_state(*sargs, h0=h0)
    assert y.shape == (2, 0, 64) and torch.equal(h, h0)


@pytest.mark.gpu
def test_wkv_and_scan_backward_take_an_empty_sequence(cuda_device):
    """S = 0 through the autograd Functions: the initial state's gradient
    is the final state's, the rest are empty or zero, and no backward
    kernel launches (there is no step to walk back)."""
    args = _wkv_inputs(9, 2, 0, 3, 64, torch.float32, cuda_device,
                       (0.69, 0.9975))
    leaves = [a.clone().requires_grad_() for a in args]
    before = wkv_ops.BWD_LAUNCHES, scan_ops.BWD_LAUNCHES
    _, s = wkv_ops.wkv(*leaves)
    ds = torch.randn_like(s)
    grads = torch.autograd.grad((s * ds).sum(), leaves)
    assert torch.equal(grads[5], ds) and grads[0].shape == (2, 0, 3, 64)
    assert not bool(grads[4].any())
    *sargs, h0 = _scan_inputs(10, 2, 0, 64, 16, torch.float32, cuda_device,
                              "model")
    sleaves = [a.clone().requires_grad_() for a in sargs + [h0]]
    _, h = scan_ops.selective_scan_with_state(*sleaves[:6], h0=sleaves[6])
    dh = torch.randn_like(h)
    sgrads = torch.autograd.grad((h * dh).sum(), sleaves)
    assert torch.equal(sgrads[6], dh) and sgrads[0].shape == (2, 0, 64)
    assert not bool(sgrads[2].any())
    assert (wkv_ops.BWD_LAUNCHES, scan_ops.BWD_LAUNCHES) == before


# Self-speculative decoding on the card: a 4-layer gpt2 of head dim 64 (the
# flash kernel runs the draft's prefill; the smoke configs' head dim 16 is
# not one it takes), 2 heads, vocab 512, max_seq_len 64.
def _spec_cfg():
    from repro_torch import configs
    return dataclasses.replace(configs.get_config("gpt2-12l"), num_layers=4,
                               d_model=128, num_heads=2, num_kv_heads=2,
                               d_ff=256, vocab_size=512, max_seq_len=64)


def _spec_run(cfg, params, device, shapes, max_len, seed=0):
    from repro_torch.train.serve_engine import ServeEngine
    from repro_torch.train.serve_scheduler import ContinuousScheduler, Request
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        (p,)).astype(np.int32),
                    max_new_tokens=g) for p, g in shapes]
    eng = ServeEngine(cfg, params, device=device, max_len=max_len,
                      paged=True, block_size=16, spec_decode=True, gamma=3,
                      draft_depth=2)
    sched = ContinuousScheduler(eng, max_batch=2, invariant_every=1)
    results = sched.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return sched, results


@pytest.mark.gpu
def test_spec_serving_on_the_card_agrees_with_the_cpu(cuda_device):
    """Four requests through the spec scheduler on the card and on the
    CPU from the same weights: token agreement at least 0.9 (chip_smoke
    phase 7's lane; the card's verify and draft sum in other orders, so a
    near-tie may flip a token), every request at its budget, and the
    draft's prefill on the flash kernel, two launches per admission."""
    from repro_torch.models import registry
    cfg = _spec_cfg()
    params = registry.get_model(cfg).init(torch.Generator().manual_seed(0),
                                          cfg, device="cpu")
    shapes = ((40, 12), (17, 9), (33, 20), (8, 14))
    before = ops.KERNEL_LAUNCHES
    _, card = _spec_run(cfg, params, cuda_device, shapes, 64)
    assert ops.KERNEL_LAUNCHES - before == 2 * len(shapes)
    _, cpu = _spec_run(cfg, params, torch.device("cpu"), shapes, 64)
    hit = tot = 0
    for a, b, (_, g) in zip(card, cpu, shapes):
        assert len(a.new_tokens) == len(b.new_tokens) == g
        hit += int((a.new_tokens == b.new_tokens).sum())
        tot += g
    assert hit / tot >= 0.9


@pytest.mark.gpu
def test_spec_draft_past_the_position_table_on_the_card(cuda_device):
    """P + G - 1 == max_seq_len (max_len one more, as P + G <= max_len
    needs), γ = 3: the last rounds' draft runs positions past the position
    table and its cache, the verify's block index past the table's width.
    The run ends without a device-side assert, at the budget."""
    from repro_torch.models import registry
    cfg = _spec_cfg()
    params = registry.get_model(cfg).init(torch.Generator().manual_seed(1),
                                          cfg, device="cpu")
    L = cfg.max_seq_len
    sched, (res,) = _spec_run(cfg, params, cuda_device, ((L - 9, 10),),
                              L + 1)
    assert len(res.new_tokens) == 10 and res.finish_reason == "limit"
    assert sched.spec_rounds > 0


@pytest.mark.gpu
def test_spec_draft_past_the_rope_table_on_the_card(cuda_device):
    """The same run on a RoPE config (``_spec_cfg`` with rotary positions
    and GQA 4/2): the draft's and the verify's positions past ``max_len``
    gather the cos/sin table's last row, without a device-side assert."""
    from repro_torch.models import registry
    cfg = dataclasses.replace(_spec_cfg(), position="rope", num_heads=4,
                              num_kv_heads=2, d_model=256, d_ff=512)
    params = registry.get_model(cfg).init(torch.Generator().manual_seed(1),
                                          cfg, device="cpu")
    L = cfg.max_seq_len
    sched, (res,) = _spec_run(cfg, params, cuda_device, ((L - 9, 10),),
                              L + 1)
    assert len(res.new_tokens) == 10 and res.finish_reason == "limit"
    assert sched.spec_rounds > 0


@pytest.mark.gpu
@pytest.mark.parametrize("theta,hd,max_len", [(1e4, 64, 1024),
                                              (5e6, 128, 32768)])
def test_rope_rotation_bits_agree_across_paths_and_with_the_cpu(
        cuda_device, theta, hd, max_len):
    """The same q/k rows at the same positions, laid out as the prefill
    (B, S), a decode step (B, 1), a chunk (ctx + arange(C)) and a verify
    (per-row cursor + arange(C)) lay them out, rotate to the same bits on
    the card, and to the CPU's bits: the cos/sin table is built once on
    the host, and the rotation is elementwise products and sums, each
    rounded once.  Positions run up to max_seq_len - 1."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import attention
    cfg = ModelConfig(name="rope", family="dense", num_layers=1,
                      d_model=4 * hd, num_heads=4, num_kv_heads=2,
                      head_dim=hd, d_ff=64, vocab_size=64,
                      max_seq_len=max_len, rope_theta=theta)
    rng = np.random.default_rng(3)
    S = 48
    base = max_len - S                      # the table's last S positions
    xq = rng.standard_normal((2, S, 4, hd), dtype=np.float32)
    xk = rng.standard_normal((2, S, 2, hd), dtype=np.float32)

    def rotate(device, starts, n):
        """Rows starts[b] .. starts[b] + n - 1 of batch row b, at their
        positions."""
        q = np.stack([xq[b, t:t + n] for b, t in enumerate(starts)])
        k = np.stack([xk[b, t:t + n] for b, t in enumerate(starts)])
        pos = np.stack([base + t + np.arange(n) for t in starts])
        q, k = attention._position_encode(
            cfg, torch.from_numpy(q).to(device), torch.from_numpy(k).to(device),
            torch.from_numpy(pos).to(device))
        return q.cpu(), k.cpu()

    ref_q, ref_k = rotate(torch.device("cpu"), (0, 0), S)
    layouts = [((0, 0), S),                               # prefill
               ((0, 17), 1), ((S - 1, 5), 1),             # decode steps
               ((16, 16), 16),                            # a chunk
               ((40, 30), 5)]                             # a verify round
    for dev in (cuda_device, torch.device("cpu")):
        for starts, n in layouts:
            q, k = rotate(dev, starts, n)
            for b, t in enumerate(starts):
                assert torch.equal(q[b], ref_q[b, t:t + n])
                assert torch.equal(k[b], ref_k[b, t:t + n])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(24, 512, 8), (3, 8, 1024, 512)],
                         ids=["routers", "expert_stacks"])
def test_ns_fused_on_moe_leaves(cuda_device, shape):
    """Muon's orthogonalization of mixtral-0.3b's MoE leaves through the
    kernel: the routers (n_super, 512, 8) reach ``ns_fused`` as 8 x 512
    (n = 8, a shape the GEMM's tiles meet nowhere else), the expert stacks
    (n_super, E, 1024, 512) as one batch of E·n_super matrices; against
    the plain version within 1e-4 of the largest entry."""
    from repro_torch.optim import muon
    x = (0.02 * torch.from_numpy(np.random.default_rng(len(shape))
                                 .standard_normal(shape).astype(np.float32))
         ).to(cuda_device)
    before = ns_ops.NS_FUSED_LAUNCHES
    got = muon.orthogonalize(x)
    torch.cuda.synchronize()
    assert ns_ops.NS_FUSED_LAUNCHES == before + 1
    want = ns_ops.newton_schulz(x.reshape((-1,) + shape[-2:]),
                                force="ref").reshape(shape)
    assert got.shape == shape and _rel(got, want) <= 1e-4


# Recurrent carries in continuous serving on the card: RWKV6 (heads of 16)
# and Mamba (state dim 4) smoke stacks; the WKV and scan kernels take those
# sizes, and neither model has an attention layer.
def _recurrent_cfg(kind):
    from repro_torch import configs
    from repro_torch.configs.base import ModelConfig, SSMConfig
    if kind == "rwkv":
        return configs.get_smoke_config("rwkv6-7b")
    return ModelConfig(name="t-mamba", family="ssm", num_layers=4,
                       d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
                       vocab_size=64, max_seq_len=160, attention="none",
                       position="none", block_pattern=("mamba",),
                       ssm=SSMConfig(d_state=4))


def _recurrent_params(cfg, device, seed=0):
    from repro_torch.models import registry
    from repro_torch.tree import tree_map
    params = registry.get_model(cfg).init(
        torch.Generator().manual_seed(seed), cfg, device="cpu")
    return params, tree_map(lambda t: t.to(device), params)


def _recurrent_ops(kind):
    return wkv_ops if kind == "rwkv" else scan_ops


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_chunked_prefill_carry_on_the_card_matches_the_plain_path(
        cuda_device, kind):
    """A 90-token prompt as chunks of 80, 8 and 2 through
    ``lm_prefill_chunk``: on the card each recurrent layer launches its
    kernel once a chunk from the carried state (no plain form runs), and
    each chunk's logits and the carry after it agree with the CPU's plain
    forms within 1e-4 (relative to max(1, max|x|) for the carry)."""
    from repro_torch.models import transformer as tr
    cfg = _recurrent_cfg(kind)
    host, dev = _recurrent_params(cfg, cuda_device)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 90))).long()
    table = torch.zeros((1, 1), dtype=torch.int32)
    carries = [tr.lm_init_prefill_carry(p, cfg, 90, torch.float32, device=d)
               for p, d in ((host, "cpu"), (dev, cuda_device))]
    kernel = _recurrent_ops(kind)
    ctx = 0
    for C in (80, 8, 2):
        before = kernel.KERNEL_LAUNCHES
        with torch.inference_mode():
            want, _, _ = tr.lm_prefill_chunk(host, cfg, prompt[:, ctx:ctx + C],
                                             {}, carries[0], table, ctx)
            got, _, _ = tr.lm_prefill_chunk(
                dev, cfg, prompt[:, ctx:ctx + C].to(cuda_device), {},
                carries[1], table.to(cuda_device), ctx)
        torch.cuda.synchronize()
        assert kernel.KERNEL_LAUNCHES - before == cfg.num_layers
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4, rtol=0)
        for ln, lc in carries[0].items():
            for key, w in lc.items():
                g = carries[1][ln][key].cpu()
                scale = max(1.0, float(w.abs().max()))
                assert float((g - w).abs().max()) / scale <= 1e-4, (C, key)
        ctx += C


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_masked_decode_freezes_recurrent_rows_on_the_card(cuda_device, kind):
    """On the card an inactive row's recurrent state comes out of a masked
    paged decode step, a verify committed at ``acc == 0`` and a draft
    rolled back to ``acc == 0`` bit for bit as it went in; the active
    rows' state moves."""
    from repro_torch.models import transformer as tr
    from repro_torch.train import steps
    cfg = _recurrent_cfg(kind)
    _, params = _recurrent_params(cfg, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B = 3
    cache = tr.lm_init_paged_cache(params, cfg, B, 4, 4, 32, torch.float32,
                                   device=cuda_device)
    for lc in cache.values():
        for t in lc.values():
            t.normal_(generator=g)
    before = {ln: {k: t.clone() for k, t in lc.items()}
              for ln, lc in cache.items()}
    toks = torch.randint(0, cfg.vocab_size, (B, 4), device=cuda_device,
                         generator=g)
    index = torch.tensor([3, 5, 7], device=cuda_device)
    active = torch.tensor([True, False, True], device=cuda_device)
    table = torch.zeros((B, 4), dtype=torch.int32, device=cuda_device)

    def frozen(cache, moved=True):
        for ln, lc in cache.items():
            for key, t in lc.items():
                assert torch.equal(t[:, 1], before[ln][key][:, 1]), key
                assert not moved or not torch.equal(t[:, 0],
                                                    before[ln][key][:, 0])
    step = steps.make_serve_decode_step(cfg, masked=True, paged=True)
    _, _, cache, _, _ = step(params, toks[:, :1], cache, index, active,
                             index + 10, -1, None, None, table)
    frozen(cache)
    with torch.inference_mode():
        _, out = tr.lm_verify(params, cfg, toks, cache, index, table,
                              active[:, None].expand(B, 4))
        cache = tr.lm_spec_commit(out, index, torch.tensor(
            [4, 0, 2], device=cuda_device))
    frozen(cache)
    rec = tuple(cache)
    draft = steps.make_draft_loop_step(cfg, 3, rec_layers=rec)
    _, cache, ring = draft(params, toks[:, :1], cache, index, active, None)
    cache = steps.make_draft_rollback_step(cfg, 3, rec_layers=rec)(
        cache, ring, index, torch.tensor([1, 0, 3], device=cuda_device))
    torch.cuda.synchronize()
    frozen(cache)


@pytest.mark.gpu
def test_recurrent_prefix_hit_equals_cold_on_the_card(cuda_device):
    """The RWKV6 smoke stack through the prefix-cached paged scheduler on
    the card, one slot: a repeat of the first prompt hits at the
    publisher's snapshot and runs the publisher's own tail chunks, so its
    stream equals the cold run's bit for bit; the WKV kernel runs every
    chunk (the snapshot edge forced into the cold run's chunks)."""
    from repro_torch.train.serve_engine import ServeEngine
    from repro_torch.train.serve_scheduler import ContinuousScheduler, Request
    cfg = _recurrent_cfg("rwkv")
    host, _ = _recurrent_params(cfg, cuda_device)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (70,)).astype(np.int32)
    other = rng.integers(0, cfg.vocab_size, (30,)).astype(np.int32)
    reqs = [Request(prompt=p, max_new_tokens=8)
            for p in (prompt, other, prompt)]
    eng = ServeEngine(cfg, host, device=cuda_device, max_len=96, paged=True,
                      block_size=16, prefix_cache=True)
    before = wkv_ops.KERNEL_LAUNCHES
    sched = ContinuousScheduler(eng, max_batch=1, num_blocks=16,
                                invariant_every=1)
    res = sched.run(reqs)
    torch.cuda.synchronize()
    assert [r.prefix_tokens for r in res] == [0, 0, 64]
    np.testing.assert_array_equal(res[2].tokens, res[0].tokens)
    # cold 70: 64 + 4 + 2 (edge at 64); 30: 16 + 8 + 4 + 2 (edge at 16);
    # the hit's tail: 4 + 2
    assert wkv_ops.KERNEL_LAUNCHES - before == 9 * cfg.num_layers


@pytest.mark.gpu
def test_async_checkpoint_snapshot_survives_the_next_in_place_step(
        cuda_device, tmp_path):
    """``AsyncCheckpointer.save`` clones every leaf on the compute stream
    before it returns; the worker copies the clones to the host on a side
    stream.  In-place updates queued right after the save (as the next
    train step makes them) never reach the file, and the write overlaps
    them."""
    from repro_torch.checkpoint import checkpointer as ckpt
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"params": {"w": torch.randn(4096, 4096, generator=g,
                                        device=cuda_device)},
            "opt_state": {"m": torch.randn(8192, 1024, generator=g,
                                           device=cuda_device)}}
    want = {k: {n: t.cpu().numpy().copy() for n, t in v.items()}
            for k, v in tree.items()}
    ac = ckpt.AsyncCheckpointer()
    ac.save(str(tmp_path), 1, tree)
    for _ in range(20):               # the "next step": in place, queued
        tree["params"]["w"].mul_(-1.5).add_(1.0)
        tree["opt_state"]["m"].sqrt_()
    ac.wait()
    back = ckpt.restore(str(tmp_path), 1, tree)
    for k, v in want.items():
        for n, arr in v.items():
            np.testing.assert_array_equal(back[k][n], arr)


def _train_cfg():
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name="gpu-sentinel", family="dense", num_layers=2,
                       d_model=128, num_heads=2, num_kv_heads=2, d_ff=256,
                       vocab_size=256, max_seq_len=64)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["nan", "spike"])
def test_skipped_step_leaves_params_and_momenta_bit_identical(cuda_device,
                                                             kind):
    """A sentinel step under 'skip' on the card (flash forward and
    backward, the Newton–Schulz kernels): a clean step moves the state, an
    injected ``nan`` or ``spike`` step is bad and leaves params and Muon
    momenta bit for bit (the optimizer runs on clones only), and the step
    after it moves on as from the pre-step state."""
    from repro_torch.configs.base import OptimizerConfig, ScheduleConfig
    from repro_torch.core.schedules import make_schedule
    from repro_torch.models import registry
    from repro_torch.optim.base import make_optimizer
    from repro_torch.train import steps
    from repro_torch.tree import tree_leaves
    cfg = _train_cfg()
    params = registry.get_model(cfg).init(torch.Generator().manual_seed(0),
                                          cfg, device=cuda_device)
    opt = make_optimizer(OptimizerConfig(name="muon_nsgd"))
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt, make_schedule(
        ScheduleConfig(), 0.01, 10), sentinels=True, nan_policy="skip",
        inject={1: kind})
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64)))
             .to(cuda_device) for k in ("tokens", "labels")}
    before_ns = ns_ops.NS_FUSED_LAUNCHES
    params, state, m0 = step(params, state, batch, 0, 0.0)
    assert float(m0["bad"]) == 0.0 and float(m0["update_norm"]) > 0.0
    assert ns_ops.NS_FUSED_LAUNCHES > before_ns
    before = [t.clone() for t in tree_leaves({"p": params, "s": state})]
    params, state, m1 = step(params, state, batch, 1,
                             float(m0["gnorm_ema"]))
    torch.cuda.synchronize()
    assert float(m1["bad"]) == 1.0
    assert float(m1["gnorm_ema"]) == float(m0["gnorm_ema"])
    after = tree_leaves({"p": params, "s": state})
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert int(state["step"]) == 1
    params, state, m2 = step(params, state, batch, 2,
                             float(m1["gnorm_ema"]))
    assert float(m2["bad"]) == 0.0 and int(state["step"]) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("B,Sq,Sk,H,KV", [(2, 77, 300, 8, 8),
                                          (2, 200, 1500, 4, 2),
                                          (1, 333, 190, 4, 4)])
def test_flash_takes_more_or_fewer_keys_than_queries(cuda_device, dtype, hd,
                                                     B, Sq, Sk, H, KV):
    """Non-causal attention of Sq queries over Sk keys (the encoder-decoder's
    cross-attention; ragged last tiles on both sides): the forward and the
    backward's dq (B, Sq, ...), dk and dv (B, Sk, ...) against the plain
    version and autograd of it, by the tolerances above; f32 within 1e-5
    of f64; repeats bit-identical."""
    td = getattr(torch, dtype)
    rng = np.random.default_rng(Sq + Sk + hd)
    q, do = (torch.from_numpy(rng.standard_normal(
        (B, Sq, H, hd), dtype=np.float32)).to(cuda_device, td)
        for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(
        (B, Sk, KV, hd), dtype=np.float32)).to(cuda_device, td)
        for _ in range(2))
    kw = dict(causal=False)
    before = ops.KERNEL_LAUNCHES, ops.BWD_LAUNCHES
    with torch.no_grad():
        got = ops.flash_attention(q, k, v, **kw)
        again = ops.flash_attention(q, k, v, **kw)
        want = ops.flash_attention(q, k, v, force="ref", **kw)
    grads = _grads(q, k, v, do, kw, "auto")
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES == before[0] + 3
    assert ops.BWD_LAUNCHES == before[1] + 1
    assert torch.equal(got, again)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert got.shape == q.shape
    assert _rel(got, want, floor=1.0) <= tol
    for g, w in zip(grads, _grads(q, k, v, do, kw, "ref")):
        assert g.dtype == td and g.shape == w.shape
        assert _rel(g, w, floor=1.0) <= tol
    assert [tuple(g.shape) for g in grads] == [tuple(q.shape),
                                                tuple(k.shape),
                                                tuple(v.shape)]
    if dtype == "float32":
        leaves = [t.double() for t in (q, k, v)]
        G = H // KV
        s = torch.einsum("bqhd,bkhd->bhqk", leaves[0],
                         leaves[1].repeat_interleave(G, dim=2)) / hd ** 0.5
        f64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                           leaves[2].repeat_interleave(G, dim=2))
        assert (got.double() - f64).abs().max().item() <= FA_F64_TOL


@pytest.mark.gpu
def test_causal_flash_at_unequal_lengths_is_refused(cuda_device):
    """Causal attention at S_k != S_q has no caller: the wrapper refuses it
    before any launch."""
    q = torch.zeros((1, 8, 4, 64), device=cuda_device)
    k = torch.zeros((1, 16, 4, 64), device=cuda_device)
    before = ops.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="non-causal only"):
        ops.flash_attention(q, k, k, causal=True)
    assert ops.KERNEL_LAUNCHES == before
