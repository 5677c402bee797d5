"""Block-granular KV cache allocator for paged serving
(``repro/train/kv_pool.py``, the parts continuous paged serving uses).

The paged serve cache is one global pool of ``num_blocks`` fixed-size token
pages per attention layer (plus one reserved *trash* page), addressed
through a per-row ``(batch, max_blocks)`` block table.  This module is the
host side: a free-list allocator with

  * **commitment-based admission**: a request is admitted only if its
    worst-case page count (``ceil((prompt + max_new - 1) / block_size)``:
    slots ``0..P+G-2`` hold K/V, the last sampled token is never cached)
    fits in the outstanding commitment budget.  The invariant
    ``sum(remaining commitments) <= free`` guarantees every later
    ``advance`` finds a page, so admitted requests never starve and the
    scheduler needs no preemption;
  * **alloc-on-advance**: physical pages leave the free list lazily, as
    the prompt is (chunk-)prefilled and as the decode cursor crosses page
    boundaries;
  * **free-on-EOS**: a finished row returns its pages and its remaining
    commitment at once.

Pages carry reference counts so that prefix sharing can map one page into
many rows; the sharing itself (``admit_prefix``, ``cow_page``, tree pins and
the evictor) comes with ROADMAP queue A item 10, speculative rollback
(``truncate_row``) with item 9, and the fault-injection sites with item 11.
Here every referenced page has exactly one reference.

The trash page (id ``num_blocks``, the pool's last page) is where free
rows' block-table entries point and where masked decode writes of inactive
rows are redirected; it is never read unmasked.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class PoolExhausted(RuntimeError):
    """Raised when an allocation violates the admission contract."""


class KVBlockPool:
    """Free-list page allocator + per-row block tables (host side).

    Pages are ``0..num_blocks-1``; id ``num_blocks`` is the reserved trash
    page (so device pools hold ``num_blocks + 1`` pages).  ``table`` is the
    ``(batch, max_blocks)`` int32 block-table mirror the engine uploads to
    the device whenever ``version`` changes.
    """

    def __init__(self, num_blocks: int, block_size: int, batch: int,
                 max_blocks: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"bad pool shape ({num_blocks}, {block_size})")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.batch = batch
        self.max_blocks = max_blocks
        self.trash = num_blocks                      # reserved page id
        self._free: List[int] = list(range(num_blocks))[::-1]  # pop() -> 0
        self._rows: Dict[int, List[int]] = {}        # row -> referenced pages
        self._commit: Dict[int, int] = {}            # row -> worst-case pages
        self._ref: Dict[int, int] = {}               # page -> references
        self.table = np.full((batch, max_blocks), self.trash, np.int32)
        self.version = 0                             # bumped on table change

    # -- accounting ---------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def allocated_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def committed_blocks(self) -> int:
        return sum(self._commit.values())

    @property
    def remaining_commitment(self) -> int:
        """Pages admitted rows may still demand (commitment not yet backed
        by a referenced page)."""
        return sum(self._commit[r] - len(self._rows[r]) for r in self._commit)

    def ref_count(self, page: int) -> int:
        return self._ref.get(page, 0)

    def row_pages(self, row: int) -> Tuple[int, ...]:
        """Row's referenced pages, in table order."""
        return tuple(self._rows[row])

    def blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case pages for one request: slots 0..prompt+max_new-2 hold
        K/V (the last sampled token is never cached).  Floor of one page:
        an admitted row always owns a table row."""
        return max(1, -(-(prompt_len + max_new_tokens - 1) // self.block_size))

    def can_admit(self, n_blocks: int) -> bool:
        """True iff committing ``n_blocks`` more keeps every remaining
        commitment, this one included, backed by a free page."""
        return self.remaining_commitment + n_blocks <= self.free_blocks

    # -- request lifecycle --------------------------------------------------

    def admit(self, row: int, prompt_len: int, max_new_tokens: int) -> None:
        """Commit row's worst case (no physical pages yet: they arrive via
        :meth:`advance` as prefill chunks and decode steps need them)."""
        if row in self._commit:
            raise ValueError(f"row {row} already admitted")
        need = self.blocks_needed(prompt_len, max_new_tokens)
        if not self.can_admit(need):
            raise PoolExhausted(
                f"admit(row={row}): need {need} pages, free "
                f"{self.free_blocks}, remaining commitment "
                f"{self.remaining_commitment}")
        if need > self.max_blocks:
            raise ValueError(f"request needs {need} pages > max_blocks "
                             f"{self.max_blocks}")
        self._commit[row] = need
        self._rows[row] = []

    def _alloc_page(self) -> int:
        if not self._free:
            raise PoolExhausted("free list empty")
        page = self._free.pop()
        self._ref[page] = 1
        return page

    def _deref(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._free.append(page)

    def advance(self, row: int, num_tokens: int) -> bool:
        """Ensure row's first ``num_tokens`` slots are page-backed, taking
        missing pages from the free list.  Returns True iff the block table
        changed.  Cannot fail for an admitted row within its budget."""
        if row not in self._commit:
            raise ValueError(f"row {row} not admitted")
        need = -(-num_tokens // self.block_size)
        if need > self._commit[row]:
            raise PoolExhausted(
                f"advance(row={row}): {need} pages exceeds the admission "
                f"commitment {self._commit[row]}")
        pages = self._rows[row]
        changed = False
        while len(pages) < need:
            page = self._alloc_page()
            self.table[row, len(pages)] = page
            pages.append(page)
            changed = True
        if changed:
            self.version += 1
        return changed

    def free(self, row: int) -> None:
        """Free-on-EOS: drop row's page references and remaining
        commitment; last references return pages to the free list."""
        pages = self._rows.pop(row)
        del self._commit[row]
        for p in pages:
            self._deref(p)
        self.table[row, :] = self.trash
        self.version += 1

    # -- invariants ---------------------------------------------------------

    def check_invariants(self) -> None:
        row_refs: Dict[int, int] = {}
        for row, pages in self._rows.items():
            assert len(pages) == len(set(pages)), \
                f"row {row} references a page twice"
            for p in pages:
                row_refs[p] = row_refs.get(p, 0) + 1
        assert len(self._ref) + len(self._free) == self.num_blocks, \
            "pages leaked or duplicated"
        assert not set(self._ref) & set(self._free), \
            "referenced page on the free list"
        assert self.trash not in self._ref and self.trash not in self._free
        for p, c in self._ref.items():
            assert c == row_refs.get(p, 0), \
                f"page {p}: refcount {c} != table refs"
            assert c >= 1
        assert set(row_refs) <= set(self._ref), "row references a free page"
        # Starvation guarantee: every outstanding commitment is backed by a
        # free page.
        assert self.remaining_commitment <= self.free_blocks, \
            "over-committed"
        for row, pages in self._rows.items():
            assert len(pages) <= self._commit[row], "row exceeds commitment"
            live = self.table[row, :len(pages)]
            assert (live == np.asarray(pages, np.int32)).all(), \
                "table/alloc mismatch"
            assert (self.table[row, len(pages):] == self.trash).all()
        for row in range(self.batch):
            if row not in self._rows:
                assert (self.table[row] == self.trash).all()
