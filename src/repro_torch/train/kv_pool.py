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
    ``sum(remaining commitments) <= free + evictable`` guarantees every
    later ``advance`` finds a page, so admitted requests never starve and
    the scheduler needs no preemption;
  * **alloc-on-advance**: physical pages leave the free list lazily, as
    the prompt is (chunk-)prefilled and as the decode cursor crosses page
    boundaries;
  * **free-on-EOS**: a finished row returns its pages and its remaining
    commitment at once;
  * **refcounted sharing**: a page may back the same token span in many
    rows' tables at once (prefix-cache hits, ``admit_prefix``) and be
    pinned by the radix tree (``train.radix_cache``) past any row's
    lifetime.  A page returns to the free list only when its last
    reference drops; a page whose only references are tree pins is
    *evictable*, and the registered ``evictor`` reclaims it when the free
    list runs dry;
  * **copy-on-write**: a row about to write a shared page swaps in a fresh
    private page first (``cow_page``; the caller copies the bytes), so a
    page with refcount > 1 is never written;
  * **speculative rollback**: ``truncate_row`` releases a row's pages past
    its rewound cursor (pages holding only rejected draft tokens) and
    keeps its commitment; no page data moves.

Page allocation fires the ``pool.alloc`` site, and each eviction it asks
for the ``pool.evict`` site, of the pool's fault plane (``train.faults``)
before the free list moves.

The trash page (id ``num_blocks``, the pool's last page) is where free
rows' block-table entries point and where masked decode writes of inactive
rows are redirected; it is never read unmasked.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.train import faults as faults_lib


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
                 max_blocks: int, faults=None):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"bad pool shape ({num_blocks}, {block_size})")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.batch = batch
        self.max_blocks = max_blocks
        self.faults = faults_lib.resolve(faults)
        self.trash = num_blocks                      # reserved page id
        self._free: List[int] = list(range(num_blocks))[::-1]  # pop() -> 0
        self._rows: Dict[int, List[int]] = {}        # row -> referenced pages
        self._commit: Dict[int, int] = {}            # row -> worst-case pages
        self._ref: Dict[int, int] = {}               # page -> table refs+pins
        self._pins: Dict[int, int] = {}              # page -> tree pins only
        self.evictor = None        # object with evict_one() -> bool, or None
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

    @property
    def evictable_blocks(self) -> int:
        """Pages whose only references are tree pins: no row's table points
        at them, so the evictor may reclaim them on demand."""
        return sum(1 for p, c in self._ref.items()
                   if c == self._pins.get(p, 0))

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
        commitment, this one included, backed by a free or evictable
        page."""
        return (self.remaining_commitment + n_blocks
                <= self.free_blocks + self.evictable_blocks)

    def can_admit_prefix(self, n_blocks: int, shared_pages: Sequence[int],
                         cow_last: bool = False) -> bool:
        """Admission check for a prefix-cache hit: the row will reference
        ``shared_pages`` without allocating them, self-allocate the rest,
        and (``cow_last``) at once clone the last shared page.  Shared
        pages that are pinned-only now stop being evictable the moment the
        row references them, so they count against capacity."""
        n_ev = sum(1 for p in shared_pages
                   if self._ref.get(p, 0) == self._pins.get(p, 0))
        own = n_blocks - len(shared_pages) + (1 if cow_last else 0)
        return (self.remaining_commitment + own + n_ev
                <= self.free_blocks + self.evictable_blocks)

    # -- request lifecycle --------------------------------------------------

    def admit(self, row: int, prompt_len: int, max_new_tokens: int) -> None:
        """Commit row's worst case (no physical pages yet: they arrive via
        :meth:`advance` as prefill chunks and decode steps need them)."""
        self.admit_prefix(row, prompt_len, max_new_tokens, ())

    def admit_prefix(self, row: int, prompt_len: int, max_new_tokens: int,
                     shared_pages: Sequence[int], cow_last: bool = False
                     ) -> Optional[Tuple[int, int]]:
        """Admit ``row`` with ``shared_pages`` (a prefix-cache hit) mapped
        straight into its table: referenced, not allocated.  ``cow_last``
        at once swaps the last shared page for a fresh private clone target
        (the request's tail prefill writes into it); returns the ``(src,
        dst)`` page pair for the caller to copy, else None."""
        if row in self._commit:
            raise ValueError(f"row {row} already admitted")
        shared = list(shared_pages)
        if cow_last and not shared:
            raise ValueError("cow_last without shared pages")
        if len(set(shared)) != len(shared):
            raise ValueError("duplicate shared pages")
        need = self.blocks_needed(prompt_len, max_new_tokens)
        if len(shared) > need:
            raise ValueError(f"{len(shared)} shared pages exceed the "
                             f"request's {need}-page worst case")
        if not self.can_admit_prefix(need, shared, cow_last):
            raise PoolExhausted(
                f"admit(row={row}): need {need - len(shared)} own pages "
                f"(+{int(cow_last)} COW), free {self.free_blocks} + "
                f"evictable {self.evictable_blocks}, remaining commitment "
                f"{self.remaining_commitment}")
        if need > self.max_blocks:
            raise ValueError(f"request needs {need} pages > max_blocks "
                             f"{self.max_blocks}")
        for p in shared:
            if p not in self._ref:
                raise ValueError(f"shared page {p} is not allocated")
        self._commit[row] = need
        self._rows[row] = []
        for i, p in enumerate(shared):
            self._ref[p] += 1
            self.table[row, i] = p
            self._rows[row].append(p)
        if shared:
            self.version += 1
        if cow_last:
            return self.cow_page(row, len(shared) - 1)
        return None

    def _alloc_page(self) -> int:
        """Pop a free page, asking the evictor to reclaim pinned-only pages
        when the free list is dry (admission guarantees one exists).

        The fault sites fire BEFORE any state moves: an injected
        ``pool.alloc`` or ``pool.evict`` fault leaves the free list,
        refcounts and tables untouched, so the caller may retry (or fail
        just its own request) without a cleanup pass."""
        self.faults.fire("pool.alloc")
        while not self._free:
            self.faults.fire("pool.evict")
            if self.evictor is None or not self.evictor.evict_one():
                raise PoolExhausted("free list empty and nothing evictable")
        page = self._free.pop()
        self._ref[page] = 1
        return page

    def _deref(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] == 0:
            assert self._pins.get(page, 0) == 0, "pinned page hit ref 0"
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

    def cow_page(self, row: int, idx: int) -> Tuple[int, int]:
        """Copy-on-write: swap row's page at table slot ``idx`` for a fresh
        private page, returning ``(src, dst)`` for the caller to copy before
        any write lands.  The source keeps its other references (tree pins,
        other rows): a page with refcount > 1 is never written."""
        pages = self._rows[row]
        src = pages[idx]
        dst = self._alloc_page()
        pages[idx] = dst
        self.table[row, idx] = dst
        self._deref(src)
        self.version += 1
        return src, dst

    def free(self, row: int) -> None:
        """Free-on-EOS: drop row's page references and remaining
        commitment.  Pages shared with other rows or pinned by the tree
        stay allocated; last references return pages to the free list."""
        pages = self._rows.pop(row)
        del self._commit[row]
        for p in pages:
            self._deref(p)
        self.table[row, :] = self.trash
        self.version += 1

    def truncate_row(self, row: int, num_tokens: int) -> bool:
        """Speculative-decoding rollback: release row's pages past its first
        ``num_tokens`` slots (the rewound cursor), keeping the commitment.

        The inverse of :meth:`advance`: pages holding only rejected draft
        tokens drop this row's reference (returning to the free list when it
        was the last) and their table entries point back at the trash page.
        Stale K/V on a released page is harmless: a page is always
        re-advanced, and its slots rewritten, before any slot on it is read
        again.  Returns True iff the table changed.  Idempotent for
        ``num_tokens`` at or above the allocated frontier."""
        if row not in self._commit:
            raise ValueError(f"row {row} not admitted")
        if num_tokens < 0:
            raise ValueError(f"truncate_row({row}, {num_tokens})")
        keep = -(-num_tokens // self.block_size)
        pages = self._rows[row]
        if keep >= len(pages):
            return False
        dropped = pages[keep:]
        del pages[keep:]
        for p in reversed(dropped):
            self._deref(p)
        self.table[row, keep:] = self.trash
        self.version += 1
        return True

    # -- tree pins (radix prefix cache) -------------------------------------

    def pin(self, page: int) -> None:
        """Tree reference: keeps ``page`` allocated past any row's lifetime
        (published prefix pages)."""
        if page not in self._ref:
            raise ValueError(f"pin({page}): page not allocated")
        self._ref[page] += 1
        self._pins[page] = self._pins.get(page, 0) + 1

    def unpin(self, page: int) -> None:
        """Drop a tree reference; the page frees if that was the last."""
        if self._pins.get(page, 0) < 1:
            raise ValueError(f"unpin({page}): page not pinned")
        self._pins[page] -= 1
        if self._pins[page] == 0:
            del self._pins[page]
        self._deref(page)

    def is_evictable(self, page: int) -> bool:
        """True iff the page's only references are tree pins."""
        return (page in self._ref
                and self._ref[page] == self._pins.get(page, 0))

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
            assert c == row_refs.get(p, 0) + self._pins.get(p, 0), \
                f"page {p}: refcount {c} != table refs + tree pins"
            assert c >= 1
        for p, n in self._pins.items():
            assert p in self._ref and 1 <= n <= self._ref[p]
        assert set(row_refs) <= set(self._ref), "row references a free page"
        # Starvation guarantee: every outstanding commitment is backed by a
        # free or evictable page (sharing legitimately lets the committed
        # total exceed num_blocks: N rows over one prefix each commit their
        # full worst case but reference the same pages).
        assert self.remaining_commitment \
            <= self.free_blocks + self.evictable_blocks, "over-committed"
        for row, pages in self._rows.items():
            assert len(pages) <= self._commit[row], "row exceeds commitment"
            live = self.table[row, :len(pages)]
            assert (live == np.asarray(pages, np.int32)).all(), \
                "table/alloc mismatch"
            assert (self.table[row, len(pages):] == self.trash).all()
        for row in range(self.batch):
            if row not in self._rows:
                assert (self.table[row] == self.trash).all()
