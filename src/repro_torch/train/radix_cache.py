"""Radix tree over token prefixes for prefix-sharing paged serving
(``repro/train/radix_cache.py``).  ``match`` and ``publish`` fire the
``radix.match`` and ``radix.publish`` fault sites of the pool's plane
(``train.faults``) before they touch the tree.

Production traffic concentrates on a handful of system prompts / few-shot
templates: prefill cost and cache bytes should scale with O(distinct
prefixes), not O(requests).  The block-table indirection of the paged
engine is exactly the mechanism that allows it — a physical page can back
the same token span in many rows' tables at once — and this module is the
host-side index that finds the pages:

  * **publish** — when a request's chunked prefill completes, the full
    pages of its prompt (``floor(P / block_size)`` of them — the pages
    whose every slot holds prompt K/V and is never written again) are
    inserted into a radix tree keyed by their token content, one node per
    page, and pinned in the pool (``KVBlockPool.pin``) so they outlive the
    publishing row.  Where the path already exists the existing node wins
    (first-publisher dedup): the later row's identical private pages stay
    unshared and return to the pool on EOS.
  * **match** — a newly arriving prompt walks the tree page by page; the
    matched pages are mapped straight into the request's block table
    (``KVBlockPool.admit_prefix``: referenced, not allocated) and chunked
    prefill runs only on the unmatched tail.  Numerical exactness is free:
    K/V at a position depends only on the token prefix and absolute
    position, so a shared page's bytes are identical to what the request's
    own prefill would have written.
  * **copy-on-write** — a prompt that is an exact multiple of the page
    size AND fully matched still needs one forward at position P-1 for its
    first-token logits, which re-writes slot P-1 of the *last matched
    page*.  A page with refcount > 1 is never mutated: the pool swaps in a
    fresh private clone (``cow_page``) and the engine device-copies the
    bytes before the tail chunk runs.
  * **carry snapshots** — sliding-window (and recurrent) layers thread a
    B=1 carry through chunked prefill instead of the paged pool, so a
    match must also restore that state.  Publishers snapshot their carry
    at the last page boundary at/below ``P-1`` and attach it to that
    node; matchers with a non-empty carry clamp their match to the
    deepest snapshot-bearing node (pure-paged configs have an EMPTY carry
    and match at any depth, including the COW case above).
  * **evict** — the tree holds pages only as long as memory is cheap:
    when the free list runs dry, the pool calls back (``evict_one``) and
    the least-recently-used *leaf* whose page has no row references is
    unpinned (interior nodes follow as their subtrees drain).  A
    pinned-only interior node stranded above row-referenced descendants
    (possible after publish dedup) is reclaimed with its whole subtree,
    so every page the pool's admission math counted evictable is actually
    reclaimable.  Pages a live row references are never freed, so
    in-flight matches are safe by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class PrefixMatch:
    """One prompt's tree lookup, ready for ``KVBlockPool.admit_prefix``.

    ``pages`` map into the row's first table slots; prefill is skipped for
    the first ``skip`` prompt tokens (chunked prefill starts at ``ctx =
    skip``).  ``cow_last`` marks the exact-boundary full match whose last
    page must be cloned before the one-token tail rerun writes slot P-1.
    ``carry`` is the publisher's B=1 carry snapshot at ``skip`` tokens
    (None when the config's carry is empty)."""
    pages: List[int]
    skip: int
    cow_last: bool = False
    carry: object = None

    @property
    def tokens_matched(self) -> int:
        """Prompt tokens served from shared pages (= skip, except the COW
        rerun which recomputes one already-shared token)."""
        return self.skip + (1 if self.cow_last else 0)


class _Node:
    """One full page of a published prefix: ``key`` is its block_size-token
    content, ``page`` the pinned pool page, ``extent`` the prefix length
    (tokens) through this node, ``carry`` an optional B=1 carry snapshot at
    exactly ``extent`` tokens."""
    __slots__ = ("key", "page", "extent", "children", "parent", "carry",
                 "last_used")

    def __init__(self, key, page, extent, parent):
        self.key = key
        self.page = page
        self.extent = extent
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.carry = None
        self.last_used = 0


class RadixCache:
    """Prefix tree + LRU evictor over one ``KVBlockPool`` (host side).

    Registers itself as the pool's ``evictor``; all timestamps are a
    deterministic integer tick (no wall clock), so eviction order is
    reproducible in tests."""

    def __init__(self, pool):
        self.pool = pool
        self.block_size = pool.block_size
        self.root = _Node(None, None, 0, None)
        self._tick = 0
        pool.evictor = self
        # telemetry (read by the scheduler's prefix_stats)
        self.hits = 0
        self.misses = 0
        self.matched_tokens = 0
        self.published_pages = 0
        self.evicted_pages = 0

    # -- introspection ------------------------------------------------------

    @property
    def num_nodes(self) -> int:
        def count(n):
            return 1 + sum(count(c) for c in n.children.values())
        return count(self.root) - 1

    def pinned_pages(self) -> List[int]:
        out: List[int] = []

        def walk(n):
            for c in n.children.values():
                out.append(c.page)
                walk(c)
        walk(self.root)
        return out

    def _touch(self, node: "_Node") -> None:
        self._tick += 1
        node.last_used = self._tick

    # -- match --------------------------------------------------------------

    def _walk(self, prompt) -> List["_Node"]:
        """Longest tree path whose page contents equal the prompt's full
        pages (page granularity: a page participates only if the prompt
        covers all block_size of its tokens)."""
        bs = self.block_size
        node, path = self.root, []
        while (len(path) + 1) * bs <= len(prompt):
            key = tuple(int(t) for t in
                        prompt[len(path) * bs:(len(path) + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def match(self, prompt, carryless: bool,
              max_pages: Optional[int] = None) -> Optional[PrefixMatch]:
        """Look up ``prompt``; returns the admission-ready match or None.

        ``carryless`` configs (every non-paged layer carries nothing)
        restore no state and may match any depth — including the whole
        prompt, where the last page goes copy-on-write and a one-token
        rerun at P-1 recovers the first-token logits.  Carry configs
        (window rings / recurrent states) clamp to the deepest
        snapshot-bearing node strictly below P (the tail must re-run at
        least one real token; re-running a token already in a window ring
        would double-write it, and a recurrent state cannot be rewound
        mid-page).

        ``max_pages`` caps the match depth: the scheduler re-clamps an
        inadmissible hit shallower (a full match can charge MORE capacity
        than a cold admission — matched pinned-only pages stop being
        evictable) until ``can_admit_prefix`` passes.  Carry configs
        re-clamp to the next-shallower snapshot node automatically."""
        self.pool.faults.fire("radix.match")
        P = len(prompt)
        path = self._walk(prompt)
        if max_pages is not None:
            path = path[:max(max_pages, 0)]
        if carryless:
            m = len(path)
            if m == 0:
                self.misses += 1
                return None
            for n in path:
                self._touch(n)
            pages = [n.page for n in path]
            if m * self.block_size == P:
                match = PrefixMatch(pages=pages, skip=P - 1, cow_last=True)
            else:
                match = PrefixMatch(pages=pages, skip=m * self.block_size)
        else:
            d = 0
            for i, n in enumerate(path):
                if n.carry is not None and n.extent <= P - 1:
                    d = i + 1
            if d == 0:
                self.misses += 1
                return None
            for n in path[:d]:
                self._touch(n)
            match = PrefixMatch(pages=[n.page for n in path[:d]],
                                skip=path[d - 1].extent,
                                carry=path[d - 1].carry)
        self.hits += 1
        self.matched_tokens += match.tokens_matched
        return match

    # -- publish ------------------------------------------------------------

    def publish(self, prompt, row_pages, n_pages: int,
                carry=None, carry_tokens: int = 0) -> int:
        """Insert the first ``n_pages`` full pages of ``prompt`` (backed by
        ``row_pages``, the publishing row's table prefix) into the tree,
        pinning newly published pages.  ``carry`` (with its token extent
        ``carry_tokens``) attaches to the path node at that boundary so
        carry-bearing configs can match up to it.  Existing nodes win
        (first publisher dedup); returns the number of pages newly
        pinned."""
        self.pool.faults.fire("radix.publish")
        bs = self.block_size
        node, new = self.root, 0
        for i in range(n_pages):
            key = tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(row_pages[i]), (i + 1) * bs, node)
                self.pool.pin(child.page)
                node.children[key] = child
                new += 1
            self._touch(child)
            if carry is not None and child.extent == carry_tokens \
                    and child.carry is None:
                child.carry = carry
            node = child
        self.published_pages += new
        return new

    # -- invariants (watchdog: scheduler every N iterations; fuzz always) ---

    def check_invariants(self) -> None:
        """Pin-count audit against the pool: every tree node holds exactly
        ONE pin on an allocated page, the pool's per-page pin counts equal
        the number of tree nodes referencing that page, and the tree's
        structure is internally consistent (extents grow by one page per
        level, parent links close, keys are full-page token spans).

        Paired with ``KVBlockPool.check_invariants`` (refcount
        conservation, commitment <= free + evictable, table/free-list
        disjointness) this is the serving stack's full host-side memory
        audit — cheap enough to run every scheduler iteration under
        fuzz/faults, every N in production."""
        tree_pins: Dict[int, int] = {}

        def walk(n, depth):
            for key, c in n.children.items():
                assert c.parent is n, f"node {c.page}: broken parent link"
                assert c.key == key, f"node {c.page}: key mismatch"
                assert len(key) == self.block_size, \
                    f"node {c.page}: key spans {len(key)} != block_size"
                assert c.extent == (depth + 1) * self.block_size, \
                    f"node {c.page}: extent {c.extent} at depth {depth}"
                assert c.page in self.pool._ref, \
                    f"tree node pins freed page {c.page}"
                tree_pins[c.page] = tree_pins.get(c.page, 0) + 1
                walk(c, depth + 1)
        walk(self.root, 0)
        assert tree_pins == self.pool._pins, \
            (f"pin-count audit: tree implies {tree_pins}, "
             f"pool records {self.pool._pins}")

    # -- evict (KVBlockPool.evictor protocol) -------------------------------

    def evict_one(self) -> bool:
        """Reclaim pinned-only tree pages; returns False when nothing in
        the tree is evictable — the pool then raises ``PoolExhausted``.

        Preferred victim: the least-recently-used CHILDLESS leaf whose
        page has no row references — unpinning frees exactly that page
        and no other request loses a deeper match than necessary.  When
        no such leaf exists the evictor must still uphold the pool's
        admission guarantee (``can_admit*`` counts EVERY pinned-only page
        as reclaimable): first-publisher dedup can leave a pinned-only
        INTERIOR node whose child's page is row-referenced — the later
        publisher kept its own private copy of the parent span, so the
        child is row-referenced while the parent is not, and no childless
        leaf is evictable.  Fallback: drop the LRU evictable node WITH
        its whole subtree — the subtree pages are merely unpinned
        (row-referenced ones stay allocated until their rows free), the
        victim's own page is guaranteed to free, and matches through the
        removed path simply miss afterwards.

        In-flight carry matches are eviction-safe by construction: a
        carry match returns ``pages = path[:d]`` with the snapshot node at
        ``path[d-1]``, so the admitted row's table references the
        snapshot-bearing page until ``free_slot`` — ``is_evictable`` is
        False for it, and eviction (which only runs inside page
        allocation, after ``admit_prefix`` took those references) can
        never FREE it; the fallback may drop its tree node, but an engine
        hands the restored carry out as a device COPY before any
        allocation runs, so dropping a node's snapshot buffers cannot
        invalidate an admitted row's state.  (The port's engine snapshots
        the window rings of sliding-window layers and the recurrent
        carries of Mamba and RWKV6 layers.)"""
        victim, fallback = None, None

        def walk(n):
            nonlocal victim, fallback
            for c in n.children.values():
                if self.pool.is_evictable(c.page):
                    if not c.children and \
                            (victim is None
                             or c.last_used < victim.last_used):
                        victim = c
                    if fallback is None \
                            or c.last_used < fallback.last_used:
                        fallback = c
                if c.children:
                    walk(c)
        walk(self.root)
        if victim is None:
            victim = fallback
        if victim is None:
            return False

        def drop(n):
            for c in list(n.children.values()):
                drop(c)
            self.pool.unpin(n.page)
            self.evicted_pages += 1
            # Dropped nodes sit in parent<->children reference cycles that
            # only the cyclic GC would reclaim; break them and clear the
            # carry so snapshot buffers (device window rings / recurrent
            # states) free by refcount the moment the subtree is unlinked,
            # not at some later gc.collect() under memory pressure.
            n.carry = None
            n.children = {}
            n.parent = None
        del victim.parent.children[victim.key]
        drop(victim)
        return True
