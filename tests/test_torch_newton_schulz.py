"""The port's Newton–Schulz (Muon's orthogonalization) against the JAX
package's, on the CPU.

The same numpy matrices go through the JAX ``newton_schulz_ref``, the JAX
Pallas route in interpret mode (``force="pallas"``, as
``tests/test_kernels.py`` runs it), the port's plain version and the port's
kernel route, which on CPU tensors runs each kernel's plain version.
Tolerance: 5e-5 absolute in f32 (outputs are O(0.1); both sides sum in f32
in other orders, and five quintic steps amplify that noise ~10-100x along
small singular directions), 3e-2 where the input is bf16 (the reference's
own bf16 tolerance).  The CUDA chain itself is held against the plain
version on the card by ``test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels.newton_schulz import kernel as jax_kernel
from repro.kernels.newton_schulz import ops as jax_ops
from repro.kernels.newton_schulz import ref as jax_ref
from repro.models import registry as jax_registry
from repro.optim import muon as jax_muon
from repro_torch.kernels.newton_schulz import ops
from repro_torch.kernels.newton_schulz import ref

TOL = 5e-5
BF16_TOL = 3e-2


def _mat(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(32, 64), (64, 32), (128, 128), (96, 40),
                                   (100, 300)])
def test_plain_version_matches_jax_ref(shape):
    m = _mat(shape)
    want = np.asarray(jax_ref.newton_schulz_ref(jnp.asarray(m)))
    got = ref.newton_schulz_ref(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("shape", [(32, 64), (64, 32), (128, 128), (96, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_route_matches_pallas_interpret(shape, dtype):
    """The port's route (transpose, ``ns_fused``) against the JAX route
    through the Pallas ``ns_fused`` in interpret mode."""
    m = _mat(shape, seed=1)
    want = jax_ops.newton_schulz(jnp.asarray(m, getattr(jnp, dtype)),
                                 force="pallas")
    got = ops.newton_schulz(torch.from_numpy(m).to(getattr(torch, dtype)),
                            force="kernel")
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_TOL if dtype == "bfloat16" else TOL)


@pytest.mark.parametrize("trans_b", [False, True])
def test_plain_matmul_matches_pallas_interpret(trans_b):
    x, y = _mat((256, 384), 2), _mat((384, 128), 3)
    want = jax_kernel.matmul(jnp.asarray(x), jnp.asarray(y), bm=128, bk=128,
                             bn=128, interpret=True)
    yt = torch.from_numpy(np.ascontiguousarray(y.T) if trans_b else y)
    got = ops.matmul(torch.from_numpy(x), yt, trans_b=trans_b)
    # K = 384 products of N(0,1) entries: |out| ~ 20, f32 sums.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-4)


def test_large_route_matches_jax_ref():
    """``_ns_large`` (NS composed from ``matmul``) on a transposed tall
    matrix, the embedding's route, against the JAX reference."""
    m = _mat((200, 72), 4)
    got = ops._ns_large(torch.from_numpy(np.ascontiguousarray(m.T)), 5).T
    want = np.asarray(jax_ref.newton_schulz_ref(jnp.asarray(m)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_batched_form_equals_per_matrix_loop():
    """The batch axis written out where the reference vmaps: one call on a
    stack equals the calls on its matrices, bit for bit."""
    stack = torch.from_numpy(_mat((3, 48, 80), 5))
    for force in ("kernel", "ref"):
        got = ops.newton_schulz(stack, force=force)
        want = torch.stack([ops.newton_schulz(a, force=force)
                            for a in stack])
        assert torch.equal(got, want)
    tall = torch.from_numpy(_mat((3, 80, 48), 6))
    got = ops.ns_fused(tall.transpose(1, 2).contiguous())
    want = torch.stack([ops.ns_fused(a.T.contiguous()[None])[0]
                        for a in tall])
    assert torch.equal(got, want)


def test_orthogonalizes():
    """``tests/test_kernels.py::test_newton_schulz_orthogonalizes`` on the
    port's kernel route."""
    m = torch.from_numpy(_mat((64, 128), 7))
    s = torch.linalg.svdvals(ops.newton_schulz(m, force="kernel"))
    assert float(s.max()) < 1.35 and float(s.min()) > 0.3


def test_routing_matches_reference_on_every_gpt2_leaf():
    """Every matrix leaf of ``gpt2-12l`` (full size, shapes only) takes the
    route the reference's ``_fits_fused`` gives it: the per-layer matrices
    the fused chain, the tied embedding the tiled matmul."""
    cfg = jax_configs.get_config("gpt2-12l")
    shapes = jax.eval_shape(
        lambda k: jax_registry.get_model(cfg).init(k, cfg),
        jax.random.PRNGKey(0))
    routes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        if not jax_muon._is_matrix(path, leaf):
            continue
        key = jax.tree_util.keystr(path)
        n, m = sorted(leaf.shape[-2:])
        pad = lambda d: d + (-d) % 128
        want = "fused" if jax_ops._fits_fused(pad(n), pad(m)) else "large"
        routes[key] = ops.route(*leaf.shape[-2:])
        assert routes[key] == want, key
    assert routes["['embed']"] == "large"
    assert sum(r == "fused" for r in routes.values()) == 6
