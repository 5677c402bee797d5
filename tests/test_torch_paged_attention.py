"""The port's paged attention against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages: the port's
plain versions (``kernels/paged_attention/ref.py``, which CPU tensors take)
against the reference's ``ref.py`` and its Pallas kernel in interpret mode.
Tolerance 2e-5 absolute and relative (the reference tests' own): float32
sums in other orders.  Gathers and pool writes move bits unchanged, so they
are held bit-equal.  The CUDA kernel is held against the same plain version
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jops
from repro.kernels.paged_attention import ref as jref
from repro.kernels.paged_attention.kernel import paged_attention_tpu
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import ref

TOL = 2e-5


def _case(seed, B, H, KV, hd, bs, NB, spare=3):
    """Random pool + permuted block tables + ragged cursors (numpy), the
    reference tests' case generator with numpy draws."""
    NP = B * NB + spare
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd), dtype=np.float32)
    kp = rng.standard_normal((NP, bs, KV, hd), dtype=np.float32)
    vp = rng.standard_normal((NP, bs, KV, hd), dtype=np.float32)
    tbl = rng.permutation(NP)[:B * NB].reshape(B, NB).astype(np.int32)
    idx = rng.integers(0, NB * bs, (B,)).astype(np.int32)
    return q, kp, vp, tbl, idx


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("H,KV,hd,bs,NB", [(4, 2, 16, 8, 4), (2, 2, 32, 16, 2),
                                           (8, 2, 8, 4, 6)])
def test_plain_version_matches_jax_ref_and_pallas(H, KV, hd, bs, NB):
    case = _case(0, 3, H, KV, hd, bs, NB)
    got = ops.paged_attention(*_t(*case))
    _close(got, jref.paged_attention_ref(*case))
    _close(got, paged_attention_tpu(*case, interpret=True))


@pytest.mark.parametrize("idx", [[0, 0], [31, 7]])
def test_softcap_and_edge_cursors_match_jax(idx):
    q, kp, vp, tbl, _ = _case(1, 2, 4, 4, 16, 8, 4)
    idx = np.asarray(idx, np.int32)
    got = ops.paged_attention(*_t(q, kp, vp, tbl, idx), logit_softcap=20.0)
    _close(got, jref.paged_attention_ref(q, kp, vp, tbl, idx,
                                         logit_softcap=20.0))
    _close(got, paged_attention_tpu(q, kp, vp, tbl, idx, logit_softcap=20.0,
                                    interpret=True))


def test_decode_writes_then_attends_like_jax_pallas_branch():
    """The port's write-then-attend decode against the reference's
    ``force='pallas'`` branch (interpret mode): outputs to 2e-5 and the
    updated pages bit-equal.  Row 2 is redirected to the trash page."""
    B, H, KV, hd, bs, NB = 3, 4, 2, 16, 8, 4
    q, kp, vp, tbl, idx = _case(2, B, H, KV, hd, bs, NB)
    rng = np.random.default_rng(3)
    k_new = rng.standard_normal((B, KV, hd), dtype=np.float32)
    v_new = rng.standard_normal((B, KV, hd), dtype=np.float32)
    trash = kp.shape[0] - 1
    page = tbl[np.arange(B), idx // bs].copy()
    page[2] = trash
    off = (idx % bs).astype(np.int32)
    want, want_cache = jops.paged_attention_decode(
        q, jnp.asarray(kp), jnp.asarray(vp), k_new, v_new, page, off, tbl,
        idx, force="pallas")
    tq, tkp, tvp, tkn, tvn, tpage, toff, ttbl, tidx = _t(
        q, kp, vp, k_new, v_new, page, off, tbl, idx)
    got, cache = ops.paged_attention_decode(tq, tkp, tvp, tkn, tvn, tpage,
                                            toff, ttbl, tidx)
    assert cache["k_pages"] is tkp and cache["v_pages"] is tvp   # in place
    np.testing.assert_array_equal(tkp.numpy(),
                                  np.asarray(want_cache["k_pages"]))
    np.testing.assert_array_equal(tvp.numpy(),
                                  np.asarray(want_cache["v_pages"]))
    _close(got[:2], np.asarray(want)[:2])
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("vector", [False, True])
def test_prefill_attention_matches_jax(vector):
    """Chunked-prefill attention with a scalar ``ctx_len`` and a per-row
    (B,) vector (the chunk's own K/V already in the pages)."""
    B, C, H, KV, hd, bs, NB = 2, 5, 4, 2, 16, 4, 6
    _, kp, vp, tbl, _ = _case(4, B, H, KV, hd, bs, NB)
    q = np.random.default_rng(5).standard_normal((B, C, H, hd),
                                                 dtype=np.float32)
    ctx = np.asarray([3, 11], np.int32) if vector else 7
    want = jref.paged_prefill_attention_ref(q, kp, vp, tbl, ctx,
                                            logit_softcap=30.0)
    got = ops.paged_prefill_attention(
        *_t(q, kp, vp, tbl), torch.as_tensor(ctx) if vector else ctx,
        logit_softcap=30.0)
    _close(got, want)


def test_paged_ref_matches_contiguous_gather_bitwise():
    """The gather path == masked attention over the logically contiguous
    layout, bit for bit (the contiguous decode's math by construction)."""
    q, kp, vp, tbl, idx = _t(*_case(2, 2, 4, 2, 16, 8, 4))
    S = tbl.shape[1] * kp.shape[1]
    k = ref.gather_pages(kp, tbl)
    v = ref.gather_pages(vp, tbl)
    np.testing.assert_array_equal(
        k.numpy(), np.asarray(jref.gather_pages(kp.numpy(), tbl.numpy())))
    valid = (torch.arange(S)[None, :] <= idx[:, None].long())[:, None, :]
    want = ref.masked_gqa_attention(q, k, v, valid)
    got = ref.paged_attention_ref(q, kp, vp, tbl, idx)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_kernel_path_on_a_cpu_tensor_raises():
    """``force='kernel'`` never falls back to the plain version."""
    q, kp, vp, tbl, idx = _t(*_case(6, 2, 4, 2, 64, 8, 2))
    before = ops.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA device"):
        ops.paged_attention(q, kp, vp, tbl, idx, force="kernel")
    assert ops.KERNEL_LAUNCHES == before


def test_quantized_pages_name_their_roadmap_item():
    q, kp, vp, tbl, idx = _t(*_case(7, 2, 4, 2, 16, 8, 2))
    scales = torch.ones(kp.shape[:3] + (1,))
    with pytest.raises(NotImplementedError, match="item 10"):
        ops.paged_attention(q, kp, vp, tbl, idx, k_scales=scales,
                            v_scales=scales)
    with pytest.raises(NotImplementedError, match="item 10"):
        ref.gather_dequant(kp, scales, tbl, torch.float32)


@pytest.mark.parametrize("B,KV,NB", [(8, 12, 37), (1, 1, 37), (64, 12, 37),
                                     (4, 2, 16)])
def test_split_plan_covers_the_table_on_page_boundaries(B, KV, NB):
    bs = 16
    n_split, tok = ops.split_plan(B, KV, NB, bs)
    assert tok % bs == 0 and tok >= bs                # >= one page each
    assert n_split * tok >= NB * bs > (n_split - 1) * tok
    assert B * KV * n_split >= min(2 * 132, B * KV * NB)
