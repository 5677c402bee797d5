"""The port's quantizer (``repro_torch/core/quant.py``) and its int8/fp8
KV pools against the JAX package's, on the CPU.

The quantizer is held bit-exact against ``repro.core.quant`` on the same
numpy-seeded inputs (values and scales compared as bytes), and the cases
of ``tests/test_quant.py`` are re-proved on the port.  Quantized serving
follows the reference's tolerance lane (``tests/test_serving_paged.py::
TestQuantizedTolerance``, dense lane) at the port's smoke ``gpt2-12l``:
per-token greedy agreement with the f32 pool of at least 0.9 for int8 and
0.8 for fp8.  Against the JAX engine's int8 pool on the same weights the
port's streams are held to the same 0.9 lane (both quantize bit-exactly;
their float sums differ in order at ~1e-6, which can move a value across
a rounding edge).  Pool structure and the bytes-per-token telemetry are
held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core import quant as jquant
from repro.launch import mesh as mesh_lib
from repro.models import transformer as jtr
from repro.train import serve_engine as jax_engine
from repro.train import serve_scheduler as jax_sched
from repro_torch import bridge
from repro_torch import configs
from repro_torch.core import quant
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_scheduler import ContinuousScheduler, Request

CFG = configs.get_smoke_config("gpt2-12l")
JCFG = jax_configs.get_smoke_config("gpt2-12l")
F8 = torch.float8_e4m3fn
QUANT_AGREEMENT = 0.9          # the reference's int8 lane
FP8_AGREEMENT = 0.8            # fp8 keeps 3 mantissa bits against int8's 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these ops are tiny, and on a shared CPU many
    threads make them several times slower.  Every comparison here is
    between runs under the same setting, or within a stated tolerance."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed=0, lo=-3.0, hi=3.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def _bytes(t):
    return (t.view(torch.uint8) if t.dtype == F8 else t).numpy()


@pytest.mark.parametrize("axis", [None, -1, (0, 2)])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_is_bit_exact_against_jax(dtype, axis):
    """Values and scales byte for byte, on values spanning the range, an
    all-zero row and exact ties at half a step (round half to even)."""
    x = 3 * np.random.default_rng(1).standard_normal((6, 4, 8)).astype(
        np.float32)
    x[0, 0] = 0.0
    x[1, 1, :4] = [127.0, 0.5, 1.5, -2.5]        # scale 1: exact halves
    tdt = quant.resolve_kv_dtype(dtype)
    jdt = jquant.resolve_kv_dtype(dtype)
    q, s = quant.quantize(torch.from_numpy(x), axis=axis, dtype=tdt)
    jq, js = jquant.quantize(jnp.asarray(x), axis=axis, dtype=jdt)
    np.testing.assert_array_equal(_bytes(q).view(np.uint8),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quant.dequantize(q, s).numpy(), np.asarray(jquant.dequantize(jq, js)))


def test_int8_roundtrip_scalar_scale():
    x = _rand((64, 8))
    q, s = quant.quantize(torch.from_numpy(x), axis=None, dtype=torch.int8)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.ndim == 0
    # symmetric round to nearest: error <= scale/2, and the largest
    # magnitude lands on +-127
    err = np.abs(quant.dequantize(q, s).numpy() - x)
    assert err.max() <= float(s) * 0.5 + 1e-7
    assert int(q.abs().max()) == 127


@pytest.mark.parametrize("axis", [-1, (0, 2)])
def test_int8_roundtrip_per_axis_keepdims(axis):
    """Reduced dims are kept (size 1), so ``q * scale`` broadcasts back:
    the property the per-slot-per-head scale pages rely on."""
    x = _rand((6, 4, 8), seed=1)
    q, s = quant.quantize(torch.from_numpy(x), axis=axis, dtype=torch.int8)
    want = list(x.shape)
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        want[a] = 1
    assert list(s.shape) == want and s.dtype == torch.float32
    err = np.abs(quant.dequantize(q, s).numpy() - x)
    assert (err <= s.numpy() * 0.5 + 1e-7).all()


def test_quantize_zero_tensor_is_exact():
    q, s = quant.quantize(torch.zeros((4, 4)), axis=-1)
    assert not q.any()
    assert not quant.dequantize(q, s).any()


def test_int8_clips_instead_of_wrapping():
    """An exactly-at-max value maps to +-127; nothing ever wraps."""
    x = torch.tensor([[-5.0, 5.0, 2.5, 0.0]])
    q, s = quant.quantize(x, axis=None)
    assert int(q.min()) == -127 and int(q.max()) == 127
    assert abs(float(quant.dequantize(q, s)[0, 2]) - 2.5) <= float(s) * 0.5


def test_dequantize_output_dtype():
    q, s = quant.quantize(torch.from_numpy(_rand((8,))), axis=None)
    assert quant.dequantize(q, s).dtype == torch.float32
    assert quant.dequantize(q, s, torch.bfloat16).dtype == torch.bfloat16


def test_fp8_roundtrip_and_saturation():
    """fp8 e4m3fn: 3 mantissa bits -> relative error <= ~2^-4 after the
    max-scaling; the largest value lands on 448, never on inf or NaN."""
    x = _rand((32, 16), seed=2)
    q, s = quant.quantize(torch.from_numpy(x), axis=-1, dtype=F8)
    assert q.dtype == F8 and s.dtype == torch.float32
    deq = quant.dequantize(q, s).numpy()
    rel = np.abs(deq - x) / np.maximum(np.abs(x), 1e-3)
    assert rel.max() <= 0.07
    assert np.isfinite(deq).all()
    assert float(q.float().abs().max()) == 448.0


def test_qmax_and_is_quantized():
    assert quant.qmax(torch.int8) == 127.0
    assert quant.qmax(F8) == 448.0
    assert quant.is_quantized(torch.int8) and quant.is_quantized(F8)
    assert not quant.is_quantized(torch.float32)
    assert not quant.is_quantized(torch.bfloat16)
    with pytest.raises(ValueError, match="not a quantized"):
        quant.qmax(torch.float32)


def test_resolve_kv_dtype_names():
    assert quant.resolve_kv_dtype(None) is None
    assert quant.resolve_kv_dtype("f32") == torch.float32
    assert quant.resolve_kv_dtype("bf16") == torch.bfloat16
    assert quant.resolve_kv_dtype("int8") == torch.int8
    assert quant.resolve_kv_dtype("fp8") == F8
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        quant.resolve_kv_dtype("int4")


# ---------------------------------------------------------------------------
# Quantized pools through the engine (smoke gpt2-12l: hd 16, 4 kv heads)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(3), JCFG))
    return jp, bridge.params_from_jax(jp)


def _requests(seed=0):
    """Eight ragged requests (prompt 2-10, budgets 3-9)."""
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, CFG.vocab_size,
                                        (int(p),)).astype(np.int32),
                    max_new_tokens=int(g))
            for p, g in zip(rng.integers(2, 11, 8), rng.integers(3, 10, 8))]


def _run(tp, kv_dtype, reqs, cfg=CFG):
    eng = ServeEngine(cfg, tp, device="cpu", max_len=48, paged=True,
                      block_size=4, kv_dtype=kv_dtype)
    return ContinuousScheduler(eng, max_batch=2, chunk_len=4,
                               num_blocks=8).run(reqs)


def _agreement(res_a, res_b):
    tot = hit = 0
    for a, b in zip(res_a, res_b):
        ta, tb = np.asarray(a.new_tokens), np.asarray(b.new_tokens)
        n = min(len(ta), len(tb))
        hit += int((ta[:n] == tb[:n]).sum())
        tot += max(len(ta), len(tb))
    return hit / max(tot, 1)


# The reference's window lane (tests/test_serving_paged.py:36, :639): a
# 4-layer model whose even layers keep a ring of 4 beside the pool.
_WINDOW = dict(name="pg-window", family="dense", num_layers=4, d_model=32,
               num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
               max_seq_len=64, window_pattern=(4, 0))
_WINDOW_SHAPES = ((5, 7), (9, 4), (3, 10), (6, 2), (4, 8), (7, 5), (2, 6),
                  (8, 3))


def _window_case():
    """The window lane's config, its JAX init (PRNGKey(0)) carried over,
    and the reference's eight requests."""
    from repro.configs.base import ModelConfig as JModelConfig
    from repro_torch.configs.base import ModelConfig
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(0),
                                    JModelConfig(**_WINDOW)))
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, 64, (p,)).astype(np.int32),
                    max_new_tokens=g) for p, g in _WINDOW_SHAPES]
    return ModelConfig(**_WINDOW), bridge.params_from_jax(jp), reqs


@pytest.mark.parametrize("kv,lane", [("int8", QUANT_AGREEMENT),
                                     ("fp8", FP8_AGREEMENT),
                                     ("int8-window", QUANT_AGREEMENT)])
def test_greedy_agreement_with_f32_pool(params, kv, lane):
    """The reference's tolerance lane: quantized greedy streams agree with
    the f32 pool's on at least ``lane`` of the tokens; lengths and finish
    reasons are dtype-invariant.  ``int8-window`` is the reference's
    window case (rings of 4 in f32 beside an int8 pool, its config, JAX
    weights and requests)."""
    _, tp = params
    reqs = _requests()
    cfg = CFG
    if kv == "int8-window":
        kv = "int8"
        cfg, tp, reqs = _window_case()
    f32, qz = _run(tp, None, reqs, cfg), _run(tp, kv, reqs, cfg)
    assert _agreement(f32, qz) >= lane
    for a, b in zip(f32, qz):
        assert len(a.new_tokens) == len(b.new_tokens)
        assert a.finish_reason == b.finish_reason


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_streams_match_jax_engine(params, kv):
    """The port's quantized pool against the JAX engine's on the same
    weights and requests: agreement at least the int8 lane (0.9)."""
    jp, tp = params
    reqs = _requests(1)
    jeng = jax_engine.ServeEngine(JCFG, jp, mesh=mesh_lib.single_device_mesh(),
                                  max_len=48, paged=True, block_size=4,
                                  kv_dtype=kv)
    want = jax_sched.ContinuousScheduler(
        jeng, max_batch=2, chunk_len=4, num_blocks=8).run(
        [jax_sched.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
         for r in reqs])
    got = _run(tp, kv, reqs)
    assert _agreement(got, want) >= QUANT_AGREEMENT
    for a, b in zip(got, want):
        assert len(a.new_tokens) == len(b.new_tokens)


def test_quantized_requires_paged(params):
    _, tp = params
    for kv in ("int8", "fp8"):
        with pytest.raises(ValueError, match="paged"):
            ServeEngine(CFG, tp, device="cpu", max_len=48, kv_dtype=kv)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_pool_leaves_are_quantized_with_f32_scales(params, kv):
    """Every pool K/V leaf stores the 1-byte dtype with a matching
    (n_super, NP+1, bs, KV, 1) float32 scale leaf."""
    _, tp = params
    eng = ServeEngine(CFG, tp, device="cpu", max_len=48, paged=True,
                      block_size=4, kv_dtype=kv)
    cache = eng.continuous_state(2, num_blocks=8).cache
    want = quant.resolve_kv_dtype(kv)
    for layer in cache.values():
        assert layer["k_pages"].dtype == want == layer["v_pages"].dtype
        for name in ("k_scales", "v_scales"):
            assert layer[name].dtype == torch.float32
            assert layer[name].shape[-4:] == (9, 4, CFG.num_kv_heads, 1)


def test_kv_stats_telemetry(params):
    """Bytes per cached token, scales included, equal the JAX engine's:
    smoke hd 16 -> int8 (16 + 4) / (4 * 16) = 0.3125 of f32; an f32 pool
    reports 1.0 and a contiguous engine degenerates."""
    jp, tp = params
    for kv in ("int8", "fp8"):
        eng = ServeEngine(CFG, tp, device="cpu", max_len=48, paged=True,
                          block_size=4, kv_dtype=kv)
        stats = ContinuousScheduler(eng, max_batch=2).kv_stats()
        jeng = jax_engine.ServeEngine(
            JCFG, jp, mesh=mesh_lib.single_device_mesh(), max_len=48,
            paged=True, block_size=4, kv_dtype=kv)
        assert stats["kv_dtype"] == {"int8": "int8",
                                     "fp8": "float8_e4m3fn"}[kv]
        assert stats["kv_bytes_ratio"] == 0.3125
        assert stats["kv_bytes_per_token"] == jeng.kv_bytes_per_token()
    f32 = ServeEngine(CFG, tp, device="cpu", max_len=48, paged=True,
                      block_size=4)
    assert ContinuousScheduler(f32).kv_stats()["kv_bytes_ratio"] == 1.0
    cont = ServeEngine(CFG, tp, device="cpu", max_len=48)
    assert ContinuousScheduler(cont).kv_stats()["kv_dtype"] is None
