"""The port's paged attention against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages: the port's
plain versions (``kernels/paged_attention/ref.py``, which CPU tensors take)
against the reference's ``ref.py`` and its Pallas kernel in interpret mode.
Tolerance 2e-5 absolute and relative (the reference tests' own): float32
sums in other orders.  Gathers and pool writes move bits unchanged, so they
are held bit-equal.  Quantized pools (int8/fp8 pages with per-slot-per-head
f32 scales) go through the same checks: the pages and scales are made by
the JAX quantizer and handed to both packages as bytes, dequantization is
one f32 product on both sides (held bit-equal), and the decode's quantized
writes are held bit-equal to the reference's.  The CUDA kernel is held
against the same plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``); here its split-and-merge arithmetic (the cluster plan,
a partial softmax state per warp and rank, the merges in order) is
emulated in f32 and held against both packages, at G = 12 too (the
kernel's head blocks change no head's arithmetic).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
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
                                           (8, 2, 8, 4, 6), (24, 2, 16, 8, 4)])
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


def _qcase(seed, B, H, KV, hd, bs, NB, kv):
    """``_case`` with its pages quantized per slot and head by the JAX
    quantizer: (q, k_pages, v_pages, table, index, k_scales, v_scales) as
    numpy arrays (fp8 pages as ml_dtypes float8_e4m3fn)."""
    q, kp, vp, tbl, idx = _case(seed, B, H, KV, hd, bs, NB)
    jdt = jquant.resolve_kv_dtype(kv)
    (kq, ks), (vq, vs) = (jquant.quantize(jnp.asarray(x), axis=-1, dtype=jdt)
                          for x in (kp, vp))
    return (q, np.asarray(kq), np.asarray(vq), tbl, idx, np.asarray(ks),
            np.asarray(vs))


def _tq(*arrays):
    """numpy (fp8 via its bytes) -> torch."""
    out = []
    for a in arrays:
        a = np.array(a)
        if a.dtype == jnp.float8_e4m3fn:
            out.append(torch.from_numpy(a.view(np.uint8)).view(
                torch.float8_e4m3fn))
        else:
            out.append(torch.from_numpy(a))
    return tuple(out)


def _raw(t):
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
            else t).numpy()


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("H,KV,hd,bs,NB", [(4, 2, 16, 8, 4), (8, 2, 8, 4, 6)])
def test_quantized_plain_version_matches_jax_ref_and_pallas(kv, H, KV, hd,
                                                            bs, NB):
    """Quantized pages with their scale pages: the port's plain version
    against JAX ``ref.paged_attention_ref`` and interpret-mode
    ``paged_attention_tpu`` (its ``quantized=True`` body), both with
    scales, softcap 20 on the second shape."""
    q, kp, vp, tbl, idx, ks, vs = _qcase(8, 3, H, KV, hd, bs, NB, kv)
    cap = 20.0 if H == 8 else 0.0
    got = ops.paged_attention(*_tq(q, kp, vp, tbl, idx), k_scales=_tq(ks)[0],
                              v_scales=_tq(vs)[0], logit_softcap=cap)
    kw = dict(k_scales=ks, v_scales=vs, logit_softcap=cap)
    _close(got, jref.paged_attention_ref(q, kp, vp, tbl, idx, **kw))
    _close(got, paged_attention_tpu(q, kp, vp, tbl, idx, interpret=True,
                                    **kw))


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_gather_dequant_is_bit_equal_to_jax(kv):
    """Pages and scales gathered through one table, dequantized as one f32
    product: bit-equal to the reference's ``gather_dequant``."""
    _, kp, _, tbl, _, ks, _ = _qcase(9, 3, 4, 2, 16, 8, 4, kv)
    got = ref.gather_dequant(*_tq(kp, ks, tbl), torch.float32)
    want = jref.gather_dequant(kp, ks, tbl, jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_decode_matches_jax_pallas_branch(kv):
    """The quantized write-then-attend decode against the reference's
    ``force='pallas'`` branch (interpret mode): the new K/V quantized per
    head and written with its scales bit-equal, outputs to 2e-5; row 2 is
    redirected to the trash page."""
    B, H, KV, hd, bs, NB = 3, 4, 2, 16, 8, 4
    q, kp, vp, tbl, idx, ks, vs = _qcase(10, B, H, KV, hd, bs, NB, kv)
    rng = np.random.default_rng(11)
    k_new = rng.standard_normal((B, KV, hd), dtype=np.float32)
    v_new = rng.standard_normal((B, KV, hd), dtype=np.float32)
    page = tbl[np.arange(B), idx // bs].copy()
    page[2] = kp.shape[0] - 1
    off = (idx % bs).astype(np.int32)
    want, wc = jops.paged_attention_decode(
        q, jnp.asarray(kp), jnp.asarray(vp), k_new, v_new, page, off, tbl,
        idx, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        force="pallas")
    tq, tkp, tvp, tks, tvs = _tq(q, kp, vp, ks, vs)
    got, cache = ops.paged_attention_decode(
        tq, tkp, tvp, *_t(k_new, v_new, page, off, tbl, idx), k_scales=tks,
        v_scales=tvs)
    assert cache["k_pages"] is tkp and cache["k_scales"] is tks  # in place
    for name, t in (("k_pages", tkp), ("v_pages", tvp)):
        np.testing.assert_array_equal(_raw(t).view(np.uint8),
                                      np.asarray(wc[name]).view(np.uint8))
    for name, t in (("k_scales", tks), ("v_scales", tvs)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(wc[name]))
    _close(got[:2], np.asarray(want)[:2])
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_prefill_attention_matches_jax(kv):
    """Chunked-prefill attention over quantized pages with a per-row
    ``ctx_len`` vector."""
    B, C, H, KV, hd, bs, NB = 2, 5, 4, 2, 16, 4, 6
    _, kp, vp, tbl, _, ks, vs = _qcase(12, B, H, KV, hd, bs, NB, kv)
    q = np.random.default_rng(13).standard_normal((B, C, H, hd),
                                                  dtype=np.float32)
    ctx = np.asarray([3, 11], np.int32)
    want = jref.paged_prefill_attention_ref(q, kp, vp, tbl, ctx, k_scales=ks,
                                            v_scales=vs, logit_softcap=30.0)
    tks, tvs = _tq(ks, vs)
    got = ops.paged_prefill_attention(*_tq(q, kp, vp, tbl),
                                      torch.as_tensor(ctx), k_scales=tks,
                                      v_scales=tvs, logit_softcap=30.0)
    _close(got, want)


def test_scale_pages_must_match_the_page_dtype():
    """1-byte pages need both scale pages, of (NP, bs, KV, 1) float32;
    float pages take none.  Raised on the CPU path as on the kernel's."""
    q, kp, vp, tbl, idx = _t(*_case(7, 2, 4, 2, 16, 8, 2))
    scales = torch.ones(kp.shape[:3] + (1,))
    with pytest.raises(ValueError, match="no scale pages"):
        ops.paged_attention(q, kp, vp, tbl, idx, k_scales=scales,
                            v_scales=scales)
    kq, vq = kp.to(torch.int8), vp.to(torch.int8)
    with pytest.raises(ValueError, match="both scale pages"):
        ops.paged_attention(q, kq, vq, tbl, idx)
    with pytest.raises(ValueError, match="expected"):
        ops.paged_attention(q, kq, vq, tbl, idx, k_scales=scales[..., 0],
                            v_scales=scales)


@pytest.mark.parametrize("B,KV,NB", [(8, 12, 37), (1, 1, 37), (64, 12, 37),
                                     (4, 2, 16), (1, 1, 9), (2, 3, 1)])
def test_split_plan_covers_the_table_on_page_boundaries(B, KV, NB):
    """The cluster plan: at most 8 CTAs (the portable cluster size) and NB,
    at least half the ~2x132 CTAs the card wants where the table allows,
    1 once B·KV alone gives them; the kernel's per-rank ranges
    (``rank_tokens``) start on page boundaries, follow each other in rank
    order, cover the live slots exactly for every cursor, and give every
    rank a page when the table is full."""
    bs = 16
    n = ops.split_plan(B, KV, NB)
    assert 1 <= n <= min(ops.MAX_CLUSTER, NB)
    assert 2 * B * KV * n >= min(2 * 132, B * KV * min(NB, ops.MAX_CLUSTER))
    if B * KV >= 2 * 132:
        assert n == 1
    top = NB * bs - 1
    for cursor in sorted({min(c, top) for c in (0, 1, bs - 1, bs, 5 * bs + 3,
                                                top)}):
        ranges = ops.rank_tokens(cursor, NB, bs, n)
        assert len(ranges) == n
        pos = 0
        for t0, t1 in ranges:
            assert t0 % bs == 0
            if t1 > t0:
                assert t0 == pos
                pos = t1
        assert pos == cursor + 1
        if cursor == top:
            assert all(t1 - t0 >= bs for t0, t1 in ranges[:-1])
            assert ranges[-1][1] > ranges[-1][0]


# The CUDA kernel's arithmetic (csrc/paged_attention.cu), emulated in f32 on
# the CPU: the cluster plan and each rank's page range (ops.split_plan,
# ops.rank_tokens); in each rank 4 warps taking every 4th tile of TW tokens
# (TW rows of one kv head's K make 2 KB); per tile the scores of q
# pre-scaled by 1/sqrt(hd), softcap, then an online softmax; a partial
# (m, l, acc) per warp, empty ones (m = -1e30, l = 0) included, merged in
# warp order into the CTA's; and the CTAs' merged in rank order,
# acc e^(m - M) / max(L, 1e-30).  Held to
# TOL (2e-5) against both packages' plain versions and interpret-mode
# Pallas: f32 sums in other orders.
KERNEL_WARPS, KERNEL_TILE_BYTES = 4, 2048


def _emulate_kernel(q, kp, vp, tbl, idx, ks=None, vs=None, softcap=0.0):
    B, _, H, hd = q.shape
    NP, bs, KV, _ = kp.shape
    G, NB = H // KV, tbl.shape[1]
    n_split = ops.split_plan(B, KV, NB)
    TW = KERNEL_TILE_BYTES // (hd * kp.element_size())
    scale = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        float(hd)).sqrt()
    flat = [t.reshape(NP * bs, KV, -1) if t is not None else None
            for t in (kp, vp, ks, vs)]

    def rows(i, sc, slots, kvh):
        x = flat[i][slots, kvh].float()
        return x if sc is None else x * flat[sc][slots, kvh]
    out = torch.empty(B, 1, H, hd)
    for b in range(B):
        for kvh in range(KV):
            qs = q[b, 0, kvh * G:(kvh + 1) * G].float() * scale
            ranks = []
            for t0, t1 in ops.rank_tokens(int(idx[b]), NB, bs, n_split):
                n_tiles = -(-max(t1 - t0, 0) // TW)
                parts = []
                for w in range(KERNEL_WARPS):
                    m = torch.full((G,), ref.NEG_INF)
                    l, acc = torch.zeros(G), torch.zeros(G, hd)
                    for tile in range(w, n_tiles, KERNEL_WARPS):
                        ts = torch.arange(t0 + tile * TW,
                                          min(t0 + (tile + 1) * TW, t1))
                        slots = tbl[b, ts // bs].long() * bs + ts % bs
                        k = rows(0, None if ks is None else 2, slots, kvh)
                        v = rows(1, None if vs is None else 3, slots, kvh)
                        s = qs @ k.T
                        if softcap > 0:
                            s = softcap * torch.tanh(s / softcap)
                        m_new = torch.maximum(m, s.max(dim=1).values)
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        l = l * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + p @ v
                        m = m_new
                    parts.append((m, l, acc))
                ranks.append(_merge(parts))            # warp order
            _, L, o = _merge(ranks)                    # rank order
            out[b, 0, kvh * G:(kvh + 1) * G] = o / L.clamp_min(1e-30)[:, None]
    return out


def _merge(parts):
    """(m, l, acc) of partial softmax states, summed in their order."""
    M = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    L, o = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        wt = torch.exp(m - M)
        L = L + l * wt
        o = o + acc * wt[:, None]
    return M, L, o


@pytest.mark.parametrize("kv", ["float32", "int8", "fp8"])
@pytest.mark.parametrize("G,cap", [(1, 0.0), (4, 20.0), (8, 0.0), (12, 20.0)])
def test_kernel_split_and_merge_matches_jax(kv, G, cap):
    """Three rows over a 320-slot table (a cluster of 8 ranks of 5 pages,
    so warps take several tiles): a ragged cursor, cursor 0 (seven empty
    ranks, three empty warps) and an all-trash row (every entry one spare
    page).  The emulation against the port's plain version, the JAX
    ``paged_attention_ref`` and interpret-mode ``paged_attention_tpu``."""
    B, KV, hd, bs, NB = 3, 2, 64, 8, 40
    if kv == "float32":
        q, kp, vp, tbl, idx = _case(14, B, G * KV, KV, hd, bs, NB)
        ks = vs = None
    else:
        q, kp, vp, tbl, idx, ks, vs = _qcase(14, B, G * KV, KV, hd, bs, NB,
                                             kv)
    idx = np.asarray([287, 0, 201], np.int32)
    tbl = tbl.copy()
    tbl[2] = kp.shape[0] - 1
    assert ops.split_plan(B, KV, NB) == 8
    scales = () if ks is None else (ks, vs)
    tq = _tq(q, kp, vp, tbl, idx, *scales)
    tkw = {} if ks is None else dict(k_scales=tq[5], v_scales=tq[6])
    got = _emulate_kernel(*tq[:5], *tq[5:], softcap=cap)
    _close(got, ops.paged_attention(*tq[:5], logit_softcap=cap, **tkw))
    kw = dict(logit_softcap=cap) if ks is None else dict(
        k_scales=ks, v_scales=vs, logit_softcap=cap)
    _close(got, jref.paged_attention_ref(q, kp, vp, tbl, idx, **kw))
    _close(got, paged_attention_tpu(q, kp, vp, tbl, idx, interpret=True,
                                    **kw))
