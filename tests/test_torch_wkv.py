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
