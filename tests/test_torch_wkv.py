"""The port's WKV recurrence (``repro_torch.kernels.rwkv6``) against the JAX
package's, on the CPU.

Inputs come from a numpy seed and go through both.  The JAX side is its
per-step ``wkv_ref``, its chunked ``wkv_chunked`` and the Pallas
``wkv_tpu`` in interpret mode.  Tolerance 1e-4 absolute and relative in
float32, the reference's own bar for its chunked kernel against its
per-step form (``tests/test_kernels.py``): the two forms sum in other
orders.  With bfloat16 inputs both sides round y to bfloat16 once, after
float32 sums in other orders, so y is held to 1e-2 of max(1, max|y|); the
state stays float32 on both sides.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6 import ref as jref
from repro.kernels.rwkv6.kernel import wkv_tpu
from repro_torch.kernels.rwkv6 import ops, ref

TOL = 1e-4


def _inputs(B, S, H, hd, seed, state=False, decay=(0.45, 0.95)):
    """r, k, v ~ N(0, 1); w uniform in ``decay``; u ~ 0.1 N(0, 1); the
    state zero or N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd), dtype=np.float32)
               for _ in range(3))
    w = rng.uniform(*decay, (B, S, H, hd)).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, hd))).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) if state
          else np.zeros((B, H, hd, hd))).astype(np.float32)
    return r, k, v, w, u, s0


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               atol=tol, rtol=tol)


# The reference's grid (S, H, hd, chunk), as test_kernels.py runs it.
GRID = [(32, 1, 16, 8), (64, 2, 16, 16), (48, 2, 32, 16)]


@pytest.mark.parametrize("S,H,hd,chunk", GRID)
@pytest.mark.parametrize("state", [False, True])
def test_plain_forms_match_jax(S, H, hd, chunk, state):
    arrays = _inputs(2, S, H, hd, seed=S + H, state=state)
    want_y, want_s = jref.wkv_ref(*arrays)
    got_ref = ref.wkv_ref(*_torch(arrays))
    got_chunked = ref.wkv_chunked(*_torch(arrays), chunk=chunk)
    jc_y, jc_s = jref.wkv_chunked(*arrays, chunk=chunk)
    pal_y, pal_s = wkv_tpu(*arrays, chunk=chunk, interpret=True)
    for y, s in (got_ref, got_chunked):
        assert y.dtype == torch.float32 and s.dtype == torch.float32
        _close(y, want_y)
        _close(s, want_s)
    _close(got_chunked[0], jc_y)
    _close(got_chunked[1], jc_s)
    _close(got_ref[0], pal_y)
    _close(got_ref[1], pal_s)


@pytest.mark.parametrize("S", [1, 7, 63, 64, 100])
def test_dispatch_on_the_cpu_takes_the_reference_choice(S):
    """``ops.wkv`` on CPU tensors takes the per-step form below S = 64 and
    the chunked form from there (the reference's non-TPU choice); a ragged
    S halves the chunk until it divides S.  Both agree with JAX."""
    arrays = _inputs(2, S, 2, 16, seed=100 + S, state=True)
    before = ops.KERNEL_LAUNCHES
    y, s = ops.wkv(*_torch(arrays))
    assert ops.KERNEL_LAUNCHES == before
    want = jref.wkv_ref(*arrays)
    _close(y, want[0])
    _close(s, want[1])
    form = ref.wkv_ref if S < 64 else ref.wkv_chunked
    y_form, s_form = form(*_torch(arrays))
    assert torch.equal(y, y_form) and torch.equal(s, s_form)
    jy, js = jref.wkv_chunked(*arrays) if S >= 64 else want
    _close(y, jy)
    _close(s, js)


def test_decays_near_one_over_a_long_sequence():
    """Decays near 0.9975 let the state grow large over S = 256 from a
    nonzero start; held relative to max(1, max|y|)."""
    arrays = _inputs(1, 256, 2, 16, seed=7, state=True,
                     decay=(0.995, 0.9999))
    want_y, want_s = jref.wkv_ref(*arrays)
    for form in (ref.wkv_ref, ref.wkv_chunked):
        y, s = form(*_torch(arrays))
        scale = max(1.0, float(np.abs(want_y).max()))
        assert float(np.abs(y.numpy() - want_y).max()) <= TOL * scale
        s_scale = max(1.0, float(np.abs(want_s).max()))
        assert float(np.abs(s.numpy() - want_s).max()) <= TOL * s_scale


@pytest.mark.parametrize("force", ["ref", "chunked"])
def test_bfloat16_inputs(force):
    """bf16 r/k/v (w stays float32, as the model makes it): y in bf16,
    the state float32, against JAX on the same bf16 values."""
    r, k, v, w, u, s0 = _inputs(2, 80, 2, 16, seed=3, state=True)
    tr, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v))
    jr, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (r, k, v))
    y, s = ops.wkv(tr, tk, tv, torch.from_numpy(w), torch.from_numpy(u),
                   torch.from_numpy(s0), force=force)
    want_y, want_s = jref.wkv_ref(jr, jk, jv, w, u, s0)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    want_y = np.asarray(want_y.astype(jnp.float32))
    scale = max(1.0, float(np.abs(want_y).max()))
    assert float(np.abs(y.float().numpy() - want_y).max()) <= 1e-2 * scale
    _close(s, want_s, tol=TOL * max(1.0, float(np.abs(want_s).max())))


def test_empty_sequence_returns_the_state():
    arrays = _inputs(1, 0, 2, 16, seed=5, state=True)
    for form in (ref.wkv_ref, ref.wkv_chunked):
        y, s = form(*_torch(arrays))
        assert y.shape == (1, 0, 2, 16)
        np.testing.assert_array_equal(s.numpy(), arrays[-1])


def test_gradients_flow_through_the_plain_version():
    """On the CPU autograd differentiates the plain version (the CPU
    training path); against jax.grad of the reference's per-step form."""
    import jax
    arrays = _inputs(1, 12, 2, 16, seed=9, state=True)
    leaves = [t.requires_grad_() for t in _torch(arrays)]
    y, s = ops.wkv(*leaves)
    (y.square().sum() + s.sum()).backward()

    def loss(*xs):
        y, s = jref.wkv_ref(*xs)
        return jnp.square(y).sum() + s.sum()
    want = jax.grad(loss, argnums=tuple(range(6)))(*arrays)
    for got, w in zip(leaves, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        assert float(np.abs(got.grad.numpy() - np.asarray(w)).max()) \
            <= TOL * scale


def test_bad_force_and_shapes_raise():
    arrays = _torch(_inputs(1, 4, 2, 16, seed=1))
    with pytest.raises(ValueError, match="force"):
        ops.wkv(*arrays, force="pallas")
    with pytest.raises(ValueError, match="u"):
        ops.wkv_cuda(*arrays[:4], arrays[4][:1], arrays[5])
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv_cuda(*arrays)


# ---------------------------------------------------------------------------
# The CUDA kernel's chunk and sub-chunk arithmetic, emulated
# ---------------------------------------------------------------------------

_CU = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                   "kernels", "rwkv6", "csrc", "wkv.cu")


def _kernel_plan(hd):
    """(C, L, FAST_MIN) as csrc/wkv.cu sets them at head dim ``hd``: the
    steps of a chunk, of a sub-chunk, and the least sub-chunk decay total
    with which a chunk takes its diagonal score blocks on the tensor
    cores."""
    with open(_CU) as f:
        src = f.read()
    sub_chunk = int(re.search(r"constexpr int L = (\d+);", src).group(1))
    fast_min = float(re.search(r"constexpr float FAST_MIN = ([0-9.e+-]+)f;",
                               src).group(1))
    edge, big, small = (int(x) for x in re.search(
        r"static constexpr int C = HD >= (\d+) \? (\d+) : (\d+);",
        src).groups())
    return (big if hd >= edge else small), sub_chunk, fast_min

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """The kernel's 3xTF32 product: big·small + small·big + big·big."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _kernel_emulation(r, k, v, w, u, s0):
    """csrc/wkv.cu's arithmetic in f32 for one (b, h) at a time, with the
    chunk plan ``_kernel_plan`` reads from the source; running
    products of w from each sub-chunk's start (Qs) and to its end (Ks), the
    sub-chunk totals W; the inter-chunk product (Qs ⊙ Π W_{<j}) S, the
    off-diagonal scores (Qs ⊙ Π W_{i<m<j}) Ksᵀ, the state update's keys Ks
    ⊙ Π W_{>i}, all four in 3xTF32; the diagonal blocks as Qs (Ks ⊙ 1 /
    W_i)ᵀ in 3xTF32 when every W is at least FAST_MIN, else pairwise by
    running products; the state's product summed from zero and added to
    diag(Π W) S in f32.  Rows past S decay by 1."""
    B, S, H, hd = r.shape
    C, L, fast_min = _kernel_plan(hd)
    n_sub = C // L
    y = torch.zeros(B, S, H, hd)
    s_out = torch.zeros(B, H, hd, hd)
    nchunks = -(-S // C)
    for b in range(B):
        for h in range(H):
            st = s0[b, h].clone()
            for n in range(nchunks):
                t0, steps = n * C, min(C, S - n * C)

                def pad(x, fill):
                    out = torch.full((C, x.shape[-1]), fill)
                    out[:steps] = x[b, t0:t0 + steps, h]
                    return out
                rr, kk, ww = pad(r, 0.0), pad(k, 0.0), pad(w, 1.0)
                vv = pad(v, 0.0)
                qs, ks = torch.empty(C, hd), torch.empty(C, hd)
                tot = torch.empty(n_sub, hd)
                for i in range(n_sub):
                    p = torch.ones(hd)
                    for t in range(i * L, i * L + L):
                        qs[t] = rr[t] * p
                        p = p * ww[t]
                    tot[i] = p
                    p = torch.ones(hd)
                    for t in range(i * L + L - 1, i * L - 1, -1):
                        ks[t] = kk[t] * p
                        p = p * ww[t]
                A = torch.zeros(C, C)
                bonus = (rr * u[h] * kk).sum(1)
                fast = bool((tot >= fast_min).all())
                for i in range(n_sub):                 # diagonal blocks
                    blk = slice(i * L, i * L + L)
                    if fast:
                        A[blk, blk] = torch.tril(
                            _mm3(qs[blk], (ks[blk] * (1 / tot[i])).T), -1)
                    else:
                        for s in range(i * L, i * L + L):
                            kp = kk[s].clone()
                            for t in range(s + 1, i * L + L):
                                A[t, s] = (rr[t] * kp).sum()
                                kp = kp * ww[t]
                    A[blk, blk] += torch.diag(bonus[blk])
                yy = torch.empty(C, hd)
                for j in range(n_sub):
                    rows = slice(j * L, j * L + L)
                    pfx = torch.ones(hd)
                    for i in range(j):
                        pfx = pfx * tot[i]
                        d = torch.ones(hd)
                        for m in range(i + 1, j):
                            d = d * tot[m]
                        A[rows, i * L:i * L + L] = _mm3(
                            qs[rows] * d, ks[i * L:i * L + L].T)
                    yy[rows] = _mm3(qs[rows] * pfx, st)
                for j in range(n_sub):
                    rows = slice(j * L, j * L + L)
                    yy[rows] += _mm3(A[rows, :j * L + L], vv[:j * L + L])
                y[b, t0:t0 + steps, h] = yy[:steps]
                sfx = torch.ones(n_sub, hd)
                for i in range(n_sub - 2, -1, -1):
                    sfx[i] = sfx[i + 1] * tot[i + 1]
                dec = sfx[0] * tot[0]
                keys = ks * sfx.repeat_interleave(L, dim=0)
                st = torch.addcmul(_mm3(keys.T, vv), st, dec[:, None])
            s_out[b, h] = st
    return y, s_out


def _decay_inputs(S, hd, state, regime, seed):
    """Two heads of a batch row; w by regime: the init's ends, or near 0
    with a tenth exactly 0 and a twentieth below the 1e-30 floor."""
    decay = {"near 0.69": (0.69, 0.72), "near 0.9975": (0.995, 0.9975),
             "near 0": (1e-4, 0.05)}[regime]
    arrays = _inputs(1, S, 2, hd, seed=seed, state=state, decay=decay)
    if regime == "near 0":
        rng = np.random.default_rng(seed + 1)
        w = arrays[3].astype(np.float64)
        pick = rng.random(w.shape)
        w[pick < 0.1] = 0.0
        tiny = (pick >= 0.1) & (pick < 0.15)
        w[tiny] = 10.0 ** rng.uniform(-37, -31, int(tiny.sum()))
        arrays = arrays[:3] + (w.astype(np.float32),) + arrays[4:]
    return arrays


def _rel_to(got, want):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 64, 100])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("regime", ["near 0.69", "near 0.9975", "near 0"])
def test_kernel_arithmetic_matches_jax(S, state, regime):
    """The emulated kernel at hd 16 (its chunk plan read from the source)
    against JAX's per-step ``wkv_ref`` and its chunked ``wkv_chunked``: y
    and the state within 1e-4 of max(1, max|.|), the reference's bar for
    its chunked kernel, and finite.  Near 0 the reference's chunked form can
    be NaN (its masked exponents overflow once a chunk spans decays of 0,
    ROADMAP queue C): there it is left out, and the port's chunked plain
    form, which clamps them, is held to the per-step form too."""
    arrays = _decay_inputs(S, 16, state, regime, seed=S + 3 * state)
    y, s = _kernel_emulation(*_torch(arrays))
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    wants = [jref.wkv_ref(*arrays)]
    jc = jref.wkv_chunked(*arrays, chunk=16)
    if np.isfinite(np.asarray(jc[0])).all():
        wants.append(jc)
    else:
        assert regime == "near 0"
    if regime == "near 0":
        port_y, port_s = ref.wkv_chunked(*_torch(arrays), chunk=16)
        assert _rel_to(port_y, wants[0][0]) <= TOL
        assert _rel_to(port_s, wants[0][1]) <= TOL
    for want_y, want_s in wants:
        assert _rel_to(y, want_y) <= TOL
        assert _rel_to(s, want_s) <= TOL


@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("regime", ["near 0.9975", "near 0"])
def test_kernel_chunk_plan_at_each_head_dim_matches_jax(hd, regime):
    """The emulated kernel at the head dims whose chunk plans differ from
    hd 16's in width (32) or in length (128: one sub-chunk a chunk), over
    chunks cut by S = 40, held to JAX's per-step form like the grid
    above."""
    arrays = _decay_inputs(40, hd, True, regime, seed=hd + 5)
    y, s = _kernel_emulation(*_torch(arrays))
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    want_y, want_s = jref.wkv_ref(*arrays)
    assert _rel_to(y, want_y) <= TOL and _rel_to(s, want_s) <= TOL
