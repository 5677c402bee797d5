"""The port's flash attention against the JAX package's.

The port's plain versions (``naive_attention``, ``blocked_attention``) are
held against the JAX Pallas kernel in interpret mode and against the JAX
``ref.naive_attention`` on the same numpy inputs, over the shape, mask,
softcap and GQA grid of ``tests/test_kernels.py``.  Tolerances: 1e-5 in
f32 (both sides sum in f32, in other orders); 2e-2 in bf16, where both
sides compute in f32 and round the output to bf16 once (a relative step of
2^-8), so one rounding may land on either side.  The CUDA kernel itself is
held against the plain version on the card by ``test_torch_gpu.py``; its
3xTF32 products are emulated here, with TF32 rounding, against f64.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jax_ref
from repro.kernels.flash_attention.kernel import flash_attention_tpu
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _qkv(seed, B, Sq, H, KV, hd, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd), dtype=np.float32))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("S,H,KV,hd", [(64, 2, 2, 32), (128, 4, 2, 64),
                                       (96, 4, 1, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_pallas_kernel(S, H, KV, hd, dtype):
    q, k, v = _qkv(0, 2, S, H, KV, hd)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    pal = flash_attention_tpu(*(jnp.asarray(x, jd) for x in (q, k, v)),
                              causal=True, block_q=32, block_k=32,
                              interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    for fn in (ref.naive_attention,
               lambda *a, **kw: ref.blocked_attention(*a, block_k=32, **kw)):
        out = fn(tq, tk, tv, causal=True, window=0)
        assert out.dtype == td and out.shape == tq.shape
        np.testing.assert_allclose(_np(out), _np(pal), atol=tol, rtol=tol)


@pytest.mark.parametrize("window,softcap,causal", [(16, 0.0, True),
                                                   (0, 20.0, True),
                                                   (32, 30.0, True),
                                                   (0, 0.0, False)])
def test_plain_versions_match_jax_masks(window, softcap, causal):
    q, k, v = _qkv(1, 1, 128, 2, 2, 32)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    want = flash_attention_tpu(*(jnp.asarray(x) for x in (q, k, v)),
                               block_q=32, block_k=32, interpret=True, **kw)
    want_naive = jax_ref.naive_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                         **kw)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    naive = ref.naive_attention(tq, tk, tv, **kw)
    blocked = ref.blocked_attention(tq, tk, tv, block_k=32, **kw)
    for got in (naive, blocked):
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)
        np.testing.assert_allclose(_np(got), _np(want_naive), atol=F32_TOL)


@pytest.mark.parametrize("S,window", [(77, 0), (77, 16), (300, 64)])
def test_ragged_lengths_match_jax_naive(S, window):
    """Serving prompts have any length: a ragged last k-block must match
    the JAX oracle, GQA included."""
    q, k, v = _qkv(2, 2, S, 4, 2, 16)
    want = jax_ref.naive_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal=True, window=window)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for got in (ref.naive_attention(tq, tk, tv, window=window),
                ref.blocked_attention(tq, tk, tv, window=window, block_k=64)):
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)


def test_blocked_cross_ragged_matches_jax():
    """Sq != Sk, Sk not a multiple of the block (the reference's cross-
    attention case)."""
    q, k, v = _qkv(3, 2, 16, 2, 2, 16, Sk=50)
    want = jax_ref.blocked_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                     causal=False, block_k=16)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ref.blocked_attention(tq, tk, tv, causal=False, block_k=16)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)


@pytest.mark.parametrize("S", [64, 300])
def test_dispatch_on_cpu_takes_the_plain_version(S):
    """CPU tensors take naive (S <= 256) or blocked attention, as the
    reference's ops picks, and never count a kernel launch."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, S, 2, 2, 16))
    before = ops.KERNEL_LAUNCHES
    got = ops.flash_attention(q, k, v, causal=True)
    want = (ref.naive_attention if S <= 256 else ref.blocked_attention)(
        q, k, v, causal=True)
    assert torch.equal(got, want)
    assert ops.KERNEL_LAUNCHES == before


def test_kernel_path_refuses_cpu_tensors_and_bad_input():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, force="kernel")
    with pytest.raises(ValueError, match="force"):
        ops.flash_attention(q, k, v, force="pallas")
    with pytest.raises(ValueError, match="kv heads"):
        ops.flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1),
                            v[:, :, :1].repeat(1, 1, 3, 1))


def test_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A missing or failing nvcc raises with its output; nothing falls
    back to the plain version.  A fake nvcc stands in for the compiler."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_attention")

    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'flash_attention.cu(1): error: boom'\n"
                    "exit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="(?s)exit 2.*error: boom"):
        _build.build_all()
    assert not any((tmp_path / "build").iterdir())
    # the library name follows the sources: an edit means a rebuild
    assert _build.library_path("flash_attention").startswith(
        str(tmp_path / "build" / "flash_attention-"))


# ---------------------------------------------------------------------------
# The CUDA kernels' 3xTF32 products against plain TF32, emulated on the CPU
# ---------------------------------------------------------------------------

# chip_smoke.py's FA_F64_TOL (the kernels' f32 results against f64) and
# TOL[float32] (the kernels against their plain f32 version).
FA_F64_TOL = 1e-5
KERNEL_F32_TOL = 1e-4


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round f32 to 10 mantissa bits, to nearest with
    ties away from zero (the sign-magnitude bits round up on a half)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """The kernels' product: each operand split into big = tf32(x) and
    small = tf32(x - big); small*small dropped.  Products of TF32 values
    are exact in f32, the sums f32."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _attention_and_grads(q, k, v, do, mm, causal, window, softcap):
    """The kernels' arithmetic on (B, H, S, hd) tensors, every product
    through ``mm``: the forward S = Q Kᵀ (scaled after the product), the
    softmax in the tensors' type, O = P V / l and the logsumexp; the
    backward from them, dP = dO Vᵀ, dS = P (dP - D) and the softcap's
    derivative, dQ = dS K, dK = dSᵀ Q, dV = Pᵀ dO."""
    S, hd = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    x = mm(q, k.transpose(-1, -2)) * scale
    deriv = torch.ones_like(x)
    if softcap > 0:
        x = softcap * torch.tanh(x / softcap)
        deriv = 1 - (x / softcap) ** 2
    i = torch.arange(S)
    keep = torch.ones(S, S, dtype=torch.bool)
    if causal:
        keep &= i[:, None] >= i[None, :]
    if window > 0:
        keep &= (i[:, None] - i[None, :]) < window
    x = torch.where(keep, x, torch.full((), ref.NEG_INF, dtype=x.dtype))
    m = x.amax(-1, keepdim=True)
    p = torch.exp(x - m)
    l = p.sum(-1, keepdim=True)
    out = mm(p, v) / l
    lse = m + torch.log(l)
    p = torch.where(keep, torch.exp(x - lse), torch.zeros((), dtype=x.dtype))
    d = (do * out).sum(-1, keepdim=True)
    ds = p * (mm(do, v.transpose(-1, -2)) - d) * deriv
    return (out, mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(p.transpose(-1, -2), do))


@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0),
                                                   (True, 32, 0.0),
                                                   (True, 0, 30.0),
                                                   (False, 0, 0.0)])
def test_3xtf32_attention_holds_f64_and_one_tf32_pass_does_not(
        causal, window, softcap):
    """With 3xTF32 products the forward stays within FA_F64_TOL of f64 (max
    abs) and so do the gradients (relative to max(1, largest)); one TF32
    pass misses the kernels' f32 tolerance.  The f64 arithmetic is held to
    the JAX oracle first."""
    q, k, v = _qkv(7, 1, 128, 2, 2, 64)
    do = _qkv(8, 1, 128, 2, 2, 64)[0]
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    oracle = jax_ref.naive_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                     **kw)
    bhsd = [torch.from_numpy(x).transpose(1, 2).contiguous()
            for x in (q, k, v, do)]
    want = _attention_and_grads(*(t.double() for t in bhsd), torch.matmul,
                                causal, window, softcap)
    np.testing.assert_allclose(want[0].transpose(1, 2).numpy(), _np(oracle),
                               atol=F32_TOL)
    got = _attention_and_grads(*bhsd, _mm_3xtf32, causal, window, softcap)
    one = _attention_and_grads(*bhsd, _mm_tf32, causal, window, softcap)
    assert (got[0].double() - want[0]).abs().max().item() <= FA_F64_TOL
    for g, w in zip(got[1:], want[1:]):
        scale = max(1.0, w.abs().max().item())
        assert (g.double() - w).abs().max().item() / scale <= FA_F64_TOL
    assert (one[0].double() - want[0]).abs().max().item() > KERNEL_F32_TOL
