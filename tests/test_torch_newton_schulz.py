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

Two things of the CUDA design are checked here without the card: the
launch plan (``ops.gemm_plan``: symmetric tiles, split-K, workspace), and
its precision argument, with a TF32 rounding emulated in this file: the
chain with every product in 3xTF32 (big*big + big*small + small*big, as the
kernel's tensor cores take it) stays within ``TOL`` of the JAX reference,
while plain TF32 products do not.
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


# ---------------------------------------------------------------------------
# The launch plan of the CUDA GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,M,N,K,sym", [
    (1, 768, 768, 50304, True),        # the tied embedding's Gram
    (1, 768, 768, 768, True),          # G G^T in the large route
    (1, 100, 100, 20000, True),        # ragged, one tile
    (1, 768, 50304, 768, False),       # P X in the large route
    (12, 768, 768, 3072, True),        # the MLP stack's Gram
    (12, 768, 3072, 768, False),       # the MLP stack's P X
    (1, 768, 768, 3072, True),         # a one-layer stack's Gram
    (3, 37, 45, 200, False),           # ragged, smaller than a slice
])
def test_plan_splits_cover_k_exactly(batch, M, N, K, sym):
    """Every split gets a non-empty share of K in whole 32-deep k-slices,
    the last one up to K, and the workspace holds one f32 tile per split,
    tile and matrix when K is cut."""
    plan = ops.gemm_plan(batch, M, N, K, symmetric=sym)
    assert plan.k_split % 32 == 0 and plan.k_split > 0
    assert (plan.splits - 1) * plan.k_split < K <= plan.splits * plan.k_split
    assert plan.workspace == (batch * plan.splits * plan.tiles * 128 * 128
                              if plan.splits > 1 else 0)


@pytest.mark.parametrize("batch,M,N,K,sym", [
    (1, 768, 768, 50304, True), (1, 768, 768, 768, True),
    (1, 100, 100, 20000, True)])
def test_plan_splits_k_where_the_grid_is_small(batch, M, N, K, sym):
    """21 upper tiles of a 768-wide Gram fill a sixth of the card's 132 SMs:
    K is cut."""
    plan = ops.gemm_plan(batch, M, N, K, symmetric=sym)
    assert plan.splits >= 2
    assert plan.workspace == batch * plan.splits * plan.tiles * 128 * 128


@pytest.mark.parametrize("batch,M,N,K,sym", [
    (12, 768, 3072, 768, False),       # 6 x 24 tiles x 12 = 1728 blocks
    (1, 768, 50304, 768, False),       # 6 x 393 = 2358 blocks
    (12, 768, 768, 768, False)])       # 432 blocks
def test_plan_keeps_k_whole_where_the_grid_fills_the_card(batch, M, N, K,
                                                          sym):
    plan = ops.gemm_plan(batch, M, N, K, symmetric=sym)
    assert batch * plan.tiles >= 2 * 132
    assert plan.splits == 1 and plan.workspace == 0
    assert plan.k_split >= K


@pytest.mark.parametrize("n,tiles", [(768, 21), (100, 1), (128, 1),
                                     (129, 3), (3072, 300)])
def test_plan_symmetric_tiles_are_the_upper_triangle(n, tiles):
    full = ops.gemm_plan(1, n, n, 4096)
    half = ops.gemm_plan(1, n, n, 4096, symmetric=True)
    t = -(-n // 128)
    assert full.tiles == t * t
    assert half.tiles == tiles == t * (t + 1) // 2


def test_plan_of_the_embedding_gram_and_its_workspace():
    """The tied embedding's 768 x 50304 Gram: 21 of 36 tiles, six splits of
    262 k-slices (126 blocks, one wave), and a workspace of one 128 x 128
    f32 tile per split and tile."""
    plan = ops.gemm_plan(1, 768, 768, 50304, symmetric=True)
    assert (plan.tiles, plan.splits, plan.k_split) == (21, 6, 8384)
    assert plan.workspace == 6 * 21 * 128 * 128
    gg = ops.gemm_plan(1, 768, 768, 768, symmetric=True)
    assert (gg.tiles, gg.splits, gg.k_split) == (21, 3, 256)
    assert gg.workspace == 3 * 21 * 128 * 128


def test_plan_refuses_a_symmetric_rectangle():
    with pytest.raises(ValueError, match="square"):
        ops.gemm_plan(1, 768, 3072, 768, symmetric=True)


@pytest.mark.parametrize("L,n,m", [(12, 768, 3072), (12, 768, 768),
                                   (1, 768, 3072), (3, 100, 300)])
def test_ns_fused_plans_are_the_chains_three_products(L, n, m):
    gram, gg, px = ops.ns_fused_plans(L, n, m)
    assert gram == ops.gemm_plan(L, n, n, m, symmetric=True)
    assert gg == ops.gemm_plan(L, n, n, n, symmetric=True)
    assert px == ops.gemm_plan(L, n, m, n)
    assert px.tiles == -(-n // 128) * -(-m // 128)


def test_fused_epilogue_plain_form():
    """The large route's private product on the CPU: alpha * x @ op(y) +
    beta * d, the form its CUDA epilogue computes."""
    x, y, d = (torch.from_numpy(_mat(s, 10 + i))
               for i, s in enumerate([(40, 24), (40, 24), (40, 40)]))
    got = ops._gemm(x, y, trans_b=True, d=d, alpha=2.0, beta=-0.5)
    torch.testing.assert_close(got, 2.0 * (x @ y.T) - 0.5 * d)
    assert torch.equal(ops._gemm(x, y.T.contiguous()), x @ y.T)


# ---------------------------------------------------------------------------
# 3xTF32 against plain TF32, emulated on the CPU
# ---------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round f32 to 10 mantissa bits, to nearest with
    ties away from zero (the sign-magnitude bits round up on a half)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """The kernel's product: each operand split into big = tf32(x) and
    small = tf32(x - big); small*small dropped.  Products of TF32 values
    are exact in f32, the sums f32."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _ns_emulated(m: np.ndarray, mm, steps: int = 5) -> np.ndarray:
    """The CUDA chain's arithmetic (G = X X^T, P = c G G^T + b G,
    X' = P X + a X) with every product through ``mm``."""
    a, b, c = ref.NS_COEFFS
    x = torch.from_numpy(m)
    tall = x.shape[0] > x.shape[1]
    x = x.T.contiguous() if tall else x
    x = x / (torch.sqrt(torch.sum(x * x)) + ops.EPS)
    for _ in range(steps):
        g = mm(x, x.T)
        p = c * mm(g, g.T) + b * g
        x = mm(p, x) + a * x
    return (x.T if tall else x).numpy()


def test_tf32_rounding_emulation():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 3.0e-3])
    got = _tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2.0 ** -10   # a tie: away
    assert got[2] == 1.0 + 2.0 ** -9 and got[3] == -(1.0 + 2.0 ** -10)
    assert (got[4] - x[4]).abs() <= 2.0 ** -11 * x[4]
    big = _tf32(x)
    assert torch.all((x - big - _tf32(x - big)).abs() <= 2.0 ** -21 * x.abs())


# The gpt2-12l shape that binds the fused chain (768 x 3072), and every
# matrix leaf shape of the gpt2 smoke config (d 64, d_ff 128, vocab 256).
EMULATED_SHAPES = [(768, 3072), (64, 64), (64, 128), (128, 64), (256, 64)]


@pytest.mark.parametrize("shape", EMULATED_SHAPES)
def test_3xtf32_newton_schulz_matches_jax_ref(shape):
    m = 0.02 * _mat(shape, 20)
    want = np.asarray(jax_ref.newton_schulz_ref(jnp.asarray(m)))
    got = _ns_emulated(m, _mm_3xtf32)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("shape", [(768, 3072), (64, 128)])
def test_plain_tf32_newton_schulz_misses_the_f32_tolerance(shape):
    """The control: one TF32 product keeps ~10 bits, and five quintic steps
    put it well outside ``TOL``; this is why the kernel takes three."""
    m = 0.02 * _mat(shape, 20)
    want = np.asarray(jax_ref.newton_schulz_ref(jnp.asarray(m)))
    assert np.abs(_ns_emulated(m, _mm_tf32) - want).max() > 4 * TOL
