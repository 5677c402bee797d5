"""The port's page allocator (``repro_torch/train/kv_pool.py``, a copy of
the reference's that the port keeps) against the JAX package's.

Both pools are driven by the same seeded random sequence of
admit/advance/free; after every operation their block tables, versions and
counters must be equal, and both must raise on the same operations.  The
admission contract and the invariant fuzz of ``tests/test_serving_paged.py``
are re-proved on the port's pool.
"""
import numpy as np
import pytest

from repro.train.kv_pool import KVBlockPool as JaxPool
from repro.train.kv_pool import PoolExhausted as JaxExhausted
from repro_torch.train.kv_pool import KVBlockPool, PoolExhausted


def _snapshot(pool):
    return (pool.table.copy(), pool.version, pool.free_blocks,
            pool.allocated_blocks, pool.committed_blocks,
            pool.remaining_commitment)


def _same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_matches_jax_pool_op_by_op(seed):
    rng = np.random.default_rng(seed)
    kw = dict(num_blocks=10, block_size=4, batch=4, max_blocks=6)
    mine, ref = KVBlockPool(**kw), JaxPool(**kw)
    admitted = {}                         # row -> (prompt, budget, tokens)
    for _ in range(300):
        row = int(rng.integers(0, 4))
        op = rng.choice(["admit", "advance", "free"])
        if op == "admit" and row not in admitted:
            p, g = int(rng.integers(1, 15)), int(rng.integers(1, 10))
            need = mine.blocks_needed(p, g)
            assert need == ref.blocks_needed(p, g)
            assert mine.can_admit(need) == ref.can_admit(need)
            outcome = []
            for pool, exc in ((mine, PoolExhausted), (ref, JaxExhausted)):
                try:
                    pool.admit(row, p, g)
                    outcome.append("ok")
                except exc:
                    outcome.append("exhausted")
                except ValueError:
                    outcome.append("too big")
            assert outcome[0] == outcome[1]
            if outcome[0] == "ok":
                admitted[row] = (p, g, 0)
        elif op == "advance" and row in admitted:
            p, g, t = admitted[row]
            t = min(t + int(rng.integers(1, 6)), p + g - 1)
            assert mine.advance(row, t) == ref.advance(row, t)
            admitted[row] = (p, g, t)
        elif op == "free" and row in admitted:
            mine.free(row)
            ref.free(row)
            del admitted[row]
        _same(_snapshot(mine), _snapshot(ref))
        mine.check_invariants()
        ref.check_invariants()
        for r in admitted:
            assert mine.row_pages(r) == ref.row_pages(r)
            assert all(mine.ref_count(pg) == 1 for pg in mine.row_pages(r))


def test_pool_admission_contract():
    """``tests/test_serving_paged.py::test_pool_admission_contract`` on the
    port's pool."""
    pool = KVBlockPool(num_blocks=8, block_size=4, batch=4, max_blocks=8)
    assert pool.blocks_needed(5, 7) == 3                 # ceil(11/4)
    pool.admit(0, 5, 7)
    assert pool.committed_blocks == 3 and pool.allocated_blocks == 0
    pool.advance(0, 5)                                   # prompt pages
    assert pool.allocated_blocks == 2
    with pytest.raises(PoolExhausted):
        pool.advance(0, 13)                              # beyond commitment
    pool.admit(1, 16, 4)                                 # 5 pages -> 8 total
    with pytest.raises(PoolExhausted):
        pool.admit(2, 4, 4)                              # 2 more: over 8
    pool.free(0)
    assert pool.committed_blocks == 5 and pool.free_blocks == 8
    pool.admit(2, 4, 4)                                  # fits now
    pool.check_invariants()
    with pytest.raises(ValueError, match="already admitted"):
        pool.admit(2, 1, 1)
    with pytest.raises(ValueError, match="not admitted"):
        pool.advance(3, 1)
    assert (pool.table[0] == pool.trash).all()           # freed row -> trash


def _drive_pool(events, num_blocks):
    """Admit / advance token by token / EOS churn (the reference fuzz's
    event loop without its speculative rollback, which
    tests/test_torch_spec.py drives op by op against the JAX pool).  Pages never leak or double-book, commitments bound
    allocation, admitted rows' advances never fail, and a drained pool is
    fully free with zero commitment."""
    pool = KVBlockPool(num_blocks=num_blocks, block_size=4, batch=6,
                       max_blocks=8)
    live = {}
    for row, p, g, e in events:
        if row in live:                  # EOS: free mid-flight
            pool.free(row)
            del live[row]
            pool.check_invariants()
            continue
        need = pool.blocks_needed(p, g)
        if need > min(pool.num_blocks, pool.max_blocks) \
                or not pool.can_admit(need):
            continue
        pool.admit(row, p, g)
        for t in range(1, min(p + max(0, g - 1 - e), p + g - 1) + 1):
            pool.advance(row, t)         # must never raise
        live[row] = True
        pool.check_invariants()
    for row in live:
        pool.free(row)
    pool.check_invariants()
    assert pool.free_blocks == pool.num_blocks
    assert pool.committed_blocks == 0


def test_pool_fuzz_poisson_arrivals_and_eos():
    """The same property over 60 seeded random event tapes."""
    rng = np.random.default_rng(0)
    for _ in range(60):
        events = [(int(rng.integers(0, 6)), int(rng.integers(1, 15)),
                   int(rng.integers(1, 11)), int(rng.integers(0, 10)))
                  for _ in range(int(rng.integers(1, 61)))]
        _drive_pool(events, int(rng.integers(2, 13)))
