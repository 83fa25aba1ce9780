"""KV-page memory management of the port: the refcounted page
allocator — own copy of ``PageAllocator`` from
``repro/serve/memory.py`` (DESIGN.md §6).  Host-side numpy; the prefix
trie and host tier (§9, §12) arrive with their slice.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class PageAllocator:
    """Refcounted free-list allocator over the global KV page pool.

    Host-side owner of the page tables for the device pools built by
    ``transformer.init_decode_state_paged``: ``n_pages`` real pages plus
    one spare garbage row (id ``sentinel == n_pages``) that unallocated
    page-table entries address, so padded windows and idle slots write
    harmlessly off to the side instead of into another slot's pages.

    Invariants (``assert_consistent``): refcounts >= 0 and a page is
    free iff its count is 0; no page both free and mapped; ``ensure`` is
    all-or-nothing; ``release`` decrefs exactly the slot's pages.
    """

    def __init__(self, n_pages: int, page_tokens: int, slots: int,
                 table_pages: int):
        assert n_pages >= 1 and page_tokens >= 1 and table_pages >= 1
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        self.table_pages = table_pages
        self.sentinel = n_pages
        self.free_list: List[int] = list(range(n_pages))
        self.refcount: List[int] = [0] * n_pages
        self.tables: List[List[int]] = [[] for _ in range(slots)]

    @property
    def free_pages(self) -> int:
        return len(self.free_list)

    def used_pages(self) -> int:
        return self.n_pages - len(self.free_list)

    def utilization(self) -> float:
        return self.used_pages() / max(1, self.n_pages)

    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_tokens)

    def _alloc_page(self) -> int:
        page = self.free_list.pop()
        assert self.refcount[page] == 0, page
        self.refcount[page] = 1
        return page

    def decref(self, page: int) -> bool:
        """Drop one reference; True if the page was freed."""
        assert self.refcount[page] > 0, f"double free of page {page}"
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self.free_list.append(page)
            return True
        return False

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s table to cover positions [0, n_tokens);
        all-or-nothing.  False on pool exhaustion or if the static table
        width would overflow."""
        want = self.pages_for(n_tokens)
        need = want - len(self.tables[slot])
        if need <= 0:
            return True
        if need > len(self.free_list) or want > self.table_pages:
            return False
        for _ in range(need):
            self.tables[slot].append(self._alloc_page())
        return True

    def release(self, slot: int) -> int:
        """Drop the slot's reference on all of its pages; returns how
        many were unmapped."""
        pages = self.tables[slot]
        self.tables[slot] = []
        for p in pages:
            self.decref(p)
        return len(pages)

    def table_array(self) -> np.ndarray:
        """(slots, table_pages) int32 device view; sentinel-padded."""
        t = np.full((len(self.tables), self.table_pages), self.sentinel,
                    np.int32)
        for s, pages in enumerate(self.tables):
            t[s, :len(pages)] = pages
        return t

    def assert_consistent(self, context: str = ""):
        """Raise AssertionError unless every allocator invariant holds:
        refcounts match the references in the slot tables, a page is
        free iff unreferenced, no duplicate free-list entries, the pool
        is conserved, no table is wider than the static width and no
        sentinel is mapped."""
        where = f" [{context}]" if context else ""
        refs: Dict[int, int] = {}
        for s, pages in enumerate(self.tables):
            assert len(pages) <= self.table_pages, \
                f"slot {s} table wider than static width{where}"
            for p in pages:
                assert 0 <= p < self.n_pages, \
                    f"slot {s} maps out-of-pool page {p}{where}"
                refs[p] = refs.get(p, 0) + 1
        free = set(self.free_list)
        assert len(free) == len(self.free_list), \
            f"duplicate free-list entries{where}"
        for p in range(self.n_pages):
            want = refs.get(p, 0)
            assert self.refcount[p] == want, \
                (f"page {p}: refcount {self.refcount[p]} != "
                 f"{want} references{where}")
            assert (p in free) == (want == 0), \
                f"page {p}: free-list / refcount disagree{where}"
        assert len(free) + len(refs) == self.n_pages, \
            (f"pool not conserved: {len(free)} free + {len(refs)} "
             f"referenced != {self.n_pages}{where}")
