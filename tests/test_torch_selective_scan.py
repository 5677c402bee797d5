"""The port's Mamba selective scan (``repro_torch.kernels.mamba_scan``)
against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both.  The JAX side is its
per-step ``selective_scan_ref``, its chunked ``selective_scan_chunked`` and
the Pallas ``selective_scan_tpu`` in interpret mode (which emits y only).
Tolerance 1e-5 absolute and 1e-4 relative in float32, the reference's own
bar for its kernel against its per-step form (``tests/test_kernels.py``):
the forms sum and multiply decays in other orders.  With bfloat16 inputs
both sides round y to bfloat16 once, after float32 sums in other orders,
so y is held to 1e-2 of max(1, max|y|); the state stays float32 on both
sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import ref as jref
from repro.kernels.mamba_scan.kernel import selective_scan_tpu
from repro_torch.kernels.mamba_scan import ops, ref

ATOL, RTOL = 1e-5, 1e-4

# dt ranges: the model's (softplus of N(0, 1)), decays near 1 (dt * A near
# 0 through a small |A|) and large dt * A (the state forgets within a step).
REGIMES = {"model": None, "near 1": ((0.01, 0.1), (1e-3, 1e-2)),
           "large": ((1.0, 5.0), (1.0, 16.0))}


def _inputs(B, S, d, N, seed, h0=False, regime="model"):
    """u, Bm, Cm ~ N(0, 1); dt and A by ``regime``; D ~ 1 + 0.1 N(0, 1);
    h0 zero or N(0, 1)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, d), dtype=np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    if REGIMES[regime] is None:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, d))))
        A = -np.exp(rng.standard_normal((d, N)))
    else:
        (dlo, dhi), (alo, ahi) = REGIMES[regime]
        dt = rng.uniform(dlo, dhi, (B, S, d))
        A = -rng.uniform(alo, ahi, (d, N))
    Dp = 1.0 + 0.1 * rng.standard_normal(d)
    state = (rng.standard_normal((B, d, N)) if h0
             else np.zeros((B, d, N))).astype(np.float32)
    return (u, dt.astype(np.float32), A.astype(np.float32), Bm, Cm,
            Dp.astype(np.float32), state)


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("S,d,N", [(9, 16, 4), (70, 32, 8), (128, 8, 16),
                                   (100, 24, 2)])
@pytest.mark.parametrize("h0", [False, True])
def test_plain_forms_match_jax(S, d, N, h0):
    """Both port forms against both JAX forms: y and the final state, from
    a zero or a random initial state.  S = 100 halves the chunk to 4."""
    *args, state = _inputs(2, S, d, N, seed=S + d + N, h0=h0)
    h = state if h0 else None
    want_y, want_h = jref.selective_scan_ref(*args, h0=h)
    jc_y, jc_h = jref.selective_scan_chunked(*args, h0=h)
    th = torch.from_numpy(state) if h0 else None
    for form in (ref.selective_scan_ref, ref.selective_scan_chunked):
        y, hf = form(*_torch(args), h0=th)
        assert y.dtype == torch.float32 and hf.dtype == torch.float32
        for wy, wh in ((want_y, want_h), (jc_y, jc_h)):
            _close(y, wy)
            _close(hf, wh)


# The reference's grid (S, d, N, chunk, block_d), as test_kernels.py runs it.
GRID = [(32, 16, 4, 8, 8), (64, 32, 8, 16, 16), (16, 8, 2, 16, 8)]


@pytest.mark.parametrize("S,d,N,chunk,bd", GRID)
def test_plain_forms_match_the_pallas_kernel(S, d, N, chunk, bd):
    """The Pallas kernel in interpret mode on test_selective_scan_vs_ref's
    grid (D = 1, as there), against both port forms (the chunked one at
    the kernel's chunk)."""
    u, dt, A, Bm, Cm, _, _ = _inputs(2, S, d, N, seed=chunk + bd)
    Dp = np.ones((d,), np.float32)
    args = (u, dt, A, Bm, Cm, Dp)
    want = selective_scan_tpu(*args, chunk=chunk, block_d=bd, interpret=True)
    _close(ref.selective_scan_ref(*_torch(args))[0], want)
    _close(ref.selective_scan_chunked(*_torch(args), chunk=chunk)[0], want)


@pytest.mark.parametrize("S", [1, 63, 64, 100])
def test_dispatch_on_the_cpu_takes_the_reference_choice(S):
    """CPU tensors take the per-step form below S = 64 and the chunked form
    from there (the reference's non-TPU choice), in both entry points; no
    kernel launch is counted."""
    *args, state = _inputs(2, S, 16, 4, seed=200 + S, h0=True)
    targs = _torch(args)
    th = torch.from_numpy(state)
    before = ops.KERNEL_LAUNCHES
    y = ops.selective_scan(*targs)
    y_s, h_s = ops.selective_scan_with_state(*targs, h0=th)
    assert ops.KERNEL_LAUNCHES == before
    form = ref.selective_scan_ref if S < 64 else ref.selective_scan_chunked
    assert torch.equal(y, form(*targs)[0])
    fy, fh = form(*targs, h0=th)
    assert torch.equal(y_s, fy) and torch.equal(h_s, fh)
    want_y, want_h = jref.selective_scan_ref(*args, h0=state)
    _close(y_s, want_y)
    _close(h_s, want_h)


@pytest.mark.parametrize("regime", ["near 1", "large"])
def test_decay_extremes_over_a_long_sequence(regime):
    """Decays near 1 (dt * A in [-1e-3, -1e-5]) let the state grow over
    S = 1024 from a random start; large dt * A (down to -80) makes it forget
    within a step, and exp underflows to 0.  y and h are held relative to
    max(1, max|·|)."""
    *args, state = _inputs(1, 1024, 16, 4, seed=11, h0=True, regime=regime)
    want_y, want_h = jref.selective_scan_ref(*args, h0=state)
    for form in (ref.selective_scan_ref, ref.selective_scan_chunked):
        y, h = form(*_torch(args), h0=torch.from_numpy(state))
        for got, want in ((y, want_y), (h, want_h)):
            want = np.asarray(want)
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got.numpy() - want).max()) <= RTOL * scale


@pytest.mark.parametrize("force", ["ref", "chunked"])
def test_bfloat16_inputs(force):
    """bf16 u, dt, B, C (A and the state float32): y in bf16, the state
    float32, against JAX on the same bf16 values."""
    u, dt, A, Bm, Cm, Dp, state = _inputs(2, 80, 16, 4, seed=3, h0=True)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (u, dt, Bm, Cm)]
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (u, dt, Bm, Cm)]
    y, h = ops.selective_scan_with_state(
        tb[0], tb[1], torch.from_numpy(A), tb[2], tb[3], torch.from_numpy(Dp),
        h0=torch.from_numpy(state), force=force)
    want_y, want_h = jref.selective_scan_ref(jb[0], jb[1], A, jb[2], jb[3],
                                             Dp, h0=state)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    want_y = np.asarray(want_y.astype(jnp.float32))
    scale = max(1.0, float(np.abs(want_y).max()))
    assert float(np.abs(y.float().numpy() - want_y).max()) <= 1e-2 * scale
    want_h = np.asarray(want_h)
    h_scale = max(1.0, float(np.abs(want_h).max()))
    assert float(np.abs(h.numpy() - want_h).max()) <= RTOL * h_scale


def test_empty_sequence_returns_the_state():
    *args, state = _inputs(1, 0, 8, 4, seed=5, h0=True)
    for form in (ref.selective_scan_ref, ref.selective_scan_chunked):
        y, h = form(*_torch(args), h0=torch.from_numpy(state))
        assert y.shape == (1, 0, 8)
        np.testing.assert_array_equal(h.numpy(), state)


@pytest.mark.parametrize("S", [12, 80])
def test_gradients_flow_through_the_plain_forms(S):
    """On the CPU autograd differentiates the plain forms (per-step at
    S = 12, chunked at S = 80); against jax.grad of the reference's
    per-step form."""
    *arrays, state = _inputs(1, S, 8, 4, seed=9 + S, h0=True)
    arrays = arrays + [state]
    leaves = [t.requires_grad_() for t in _torch(arrays)]
    y, h = ops.selective_scan_with_state(*leaves[:6], h0=leaves[6])
    (y.square().sum() + h.sum()).backward()

    def loss(u, dt, A, Bm, Cm, Dp, h0):
        y, h = jref.selective_scan_ref(u, dt, A, Bm, Cm, Dp, h0=h0)
        return jnp.square(y).sum() + h.sum()
    want = jax.grad(loss, argnums=tuple(range(7)))(*arrays)
    for got, w in zip(leaves, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        assert float(np.abs(got.grad.numpy() - np.asarray(w)).max()) \
            <= RTOL * scale


def test_bad_force_shapes_and_cpu_kernel_raise():
    """An unknown force or mismatched shapes raise; ``force="kernel"`` on
    CPU tensors raises (the kernel runs only on the card) and counts no
    launch."""
    *args, state = _inputs(1, 4, 8, 4, seed=1)
    targs = _torch(args)
    with pytest.raises(ValueError, match="force"):
        ops.selective_scan(*targs, force="pallas")
    before = ops.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ops.selective_scan(*targs, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.selective_scan_with_state(*targs, h0=torch.from_numpy(state),
                                      force="kernel")
    with pytest.raises(ValueError, match="h0"):
        ops.selective_scan_with_state(*targs, h0=torch.zeros(1, 8, 5),
                                      force="kernel")
    with pytest.raises(ValueError, match="Bm"):
        ops.selective_scan(targs[0], targs[1], targs[2], targs[3][:, :2],
                           targs[4], targs[5], force="kernel")
    assert ops.KERNEL_LAUNCHES == before
