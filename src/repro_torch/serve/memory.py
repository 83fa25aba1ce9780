"""KV-page memory management of the port: the refcounted page
allocator, the copy-on-write prefix-cache trie and the host-RAM spill
tier under it, and the page-pool accounting of a non-uniform rank
plan — own copy of ``repro/serve/memory.py`` (DESIGN.md §6, §9, §12,
§14).  Host-side numpy.

The ``HostTier`` holds BYTE COPIES of evicted trie pages keyed by each
node's content chain hash — never page references — so spilled pages
are genuinely freed and every allocator invariant
(``assert_consistent``) holds unchanged with the tier enabled.  The
chain hashes are byte-identical to the reference's for the same salt
and tokens.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _hash_chain(parent_digest: bytes, chunk: bytes) -> bytes:
    """One link of a trie node's content chain hash: the digest of a
    node covering pages [0, i] is a pure function of the salt and the
    token bytes of pages 0..i, independent of node ids (which are not
    stable across evictions — why the host tier keys on this chain)."""
    return hashlib.blake2b(parent_digest + chunk, digest_size=16).digest()


class HostTier:
    """Host-RAM spill tier under the prefix cache (DESIGN.md §12).

    An LRU-bounded ring of spilled KV pages: ``capacity`` page slots,
    each holding the device->host byte copy of one evicted trie page
    (a list of per-KV-leaf numpy slabs, opaque to this class) keyed by
    the trie node's chain hash.  ``put`` overwrites an existing key in
    place (same content by construction: the key is the content
    address) and drops the least-recently-used slot on overflow;
    ``get`` is an LRU touch.  Values are copies, never page references,
    so the tier is invisible to the allocator's refcounts.
    """

    def __init__(self, capacity: int):
        assert capacity >= 1
        self.capacity = capacity
        self._slots: "OrderedDict[bytes, Any]" = OrderedDict()
        # lifetime counters (Engine.stats() reports them)
        self.spills = 0         # pages copied device->host at eviction
        self.restores = 0       # pages copied host->device at admission
        self.dropped = 0        # LRU overflow: oldest slot discarded
        self.hits = 0           # get() found the key
        self.misses = 0         # get() did not

    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, key: bytes) -> bool:
        return key in self._slots

    def put(self, key: bytes, rows) -> None:
        """Store one spilled page's host bytes under its chain hash;
        drops the LRU slot when full."""
        if key in self._slots:
            self._slots.move_to_end(key)
            self._slots[key] = rows
        else:
            if len(self._slots) >= self.capacity:
                self._slots.popitem(last=False)
                self.dropped += 1
            self._slots[key] = rows
        self.spills += 1

    def get(self, key: bytes):
        """The host bytes for ``key`` (LRU touch), or None."""
        rows = self._slots.get(key)
        if rows is None:
            self.misses += 1
            return None
        self.hits += 1
        self._slots.move_to_end(key)
        return rows

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class PageAllocator:
    """Refcounted free-list allocator over the global KV page pool.

    Host-side owner of the page tables for the device pools built by
    ``transformer.init_decode_state_paged``: ``n_pages`` real pages plus
    one spare garbage row (id ``sentinel == n_pages``) that unallocated
    page-table entries address, so padded windows and idle slots write
    harmlessly off to the side instead of into another slot's pages.

    With prefix caching (DESIGN.md §9) a page can be referenced by
    several slot tables at once AND by the prefix trie: ``refcount[p]``
    counts every such reference, and a page returns to the free list
    exactly when its count hits zero.  Shared pages are read-only to
    their mappers; a slot that must write one first clones it (``cow``)
    and repoints its own table entry.

    Invariants (``assert_consistent``): refcounts >= 0 and a page is
    free iff its count is 0; no page both free and mapped or indexed;
    ``ensure`` is all-or-nothing; ``release`` decrefs exactly the
    slot's pages.
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
        """UNIQUE pages in use (shared pages count once)."""
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

    def incref(self, page: int):
        assert 0 <= page < self.n_pages and self.refcount[page] > 0, \
            f"incref of unowned page {page}"
        self.refcount[page] += 1

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

    def map_shared(self, slot: int, pages: List[int]) -> bool:
        """Append already-owned pages (a prefix-trie hit) READ-ONLY to
        the end of ``slot``'s table; each gains one reference.  The
        mapper must never write into them without ``cow`` first."""
        if len(self.tables[slot]) + len(pages) > self.table_pages:
            return False
        for p in pages:
            self.incref(p)
            self.tables[slot].append(p)
        return True

    def cow(self, slot: int, idx: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write fault on table entry ``idx``: if the page is
        shared, allocate a fresh page, repoint the slot's entry and
        drop its reference on the old one.  Returns (src, dst) for the
        caller's device-side content copy, or None when the page was
        exclusively owned.  Caller checks ``free_pages`` first."""
        old = self.tables[slot][idx]
        if self.refcount[old] == 1:
            return None
        new = self._alloc_page()
        self.tables[slot][idx] = new
        self.decref(old)
        return (old, new)

    def release(self, slot: int) -> int:
        """Drop the slot's reference on all of its pages; returns how
        many were unmapped (shared pages survive via their other
        references, e.g. the trie's)."""
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

    def assert_consistent(self, prefix=None, context: str = ""):
        """Raise AssertionError unless every allocator invariant holds:
        refcounts match the references rebuilt from the slot tables plus
        the optional ``prefix`` trie, a page is free iff unreferenced,
        no duplicate free-list entries, no table wider than the static
        width, no sentinel mapped, trie child counts consistent, and
        the pool is conserved.  Without ``prefix`` the slot tables must
        account for every reference: an engine with a trie passes it."""
        where = f" [{context}]" if context else ""
        refs: Dict[int, int] = {}
        for s, pages in enumerate(self.tables):
            assert len(pages) <= self.table_pages, \
                f"slot {s} table wider than static width{where}"
            for p in pages:
                assert 0 <= p < self.n_pages, \
                    f"slot {s} maps out-of-pool page {p}{where}"
                refs[p] = refs.get(p, 0) + 1
        if prefix is not None:
            for p in prefix.pages():
                assert 0 <= p < self.n_pages, \
                    f"trie indexes out-of-pool page {p}{where}"
                refs[p] = refs.get(p, 0) + 1
            for key, node in prefix.nodes.items():
                n_kids = sum(1 for nd in prefix.nodes.values()
                             if nd["parent_key"] == key)
                assert node["children"] == n_kids, \
                    f"trie child count drift at {node['id']}{where}"
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


class PrefixCache:
    """Host-side radix index over PAGE-ALIGNED token prefixes
    (DESIGN.md §9): automatic prefix caching for the paged engine.

    Each node covers exactly one full KV page: the node for the first
    ``i`` pages of a token stream is keyed on ``(salt, stream[: i *
    page_tokens])`` and holds the pool page whose K/V encode those
    positions given the preceding prefix.  ``salt`` folds in the
    model's rank plan (prune ratio, CLOVER ranks, page size) so caches
    produced under different pruning never alias.

    The trie holds one reference on every indexed page.  ``match``
    walks the longest cached run for a prompt and bumps each node's LRU
    clock; ``insert`` publishes a sequence's full-page run (first
    writer wins); ``evict`` reclaims LRU leaf nodes whose page no slot
    maps (refcount == 1: only the trie's own reference is left).

    With a ``HostTier`` attached (``host`` + ``page_reader``, both set
    by the engine — DESIGN.md §12), eviction SPILLS each dropped page
    device->host before freeing it, under the node's content chain
    hash (``hhash``), so a later admission can restore the bytes
    instead of re-prefilling.

    ``match``/``insert``/``chain_hashes`` take an ``extra`` key tuple
    that extends the salt per call: the scheduler passes a request's
    non-zero SV adapter id (DESIGN.md §13), so each tenant's runs, and
    the host-tier chain hashes they spill and restore under, live in a
    namespace of their own.  The default ``extra=()`` hashes
    byte-identically to the reference's un-keyed cache.
    """

    def __init__(self, alloc: PageAllocator, salt: Tuple = ()):
        self.alloc = alloc
        self.pt = alloc.page_tokens
        # the salt IS the root: two caches with different rank plans
        # have disjoint key spaces from the first page on, and it roots
        # the content chain hashes the host tier keys on
        self._root = ("root", salt)
        self._root_hash = hashlib.blake2b(repr(self._root).encode(),
                                          digest_size=16).digest()
        # radix keying: (parent node id, this page's pt tokens) -> node
        # {"id", "page", "clock", "children", "parent_key", "hhash"}
        self.nodes: Dict[tuple, dict] = {}
        self._next_id = 1
        self._clock = 0
        self.inserted = 0
        self.evicted = 0
        # host spill tier: ``host`` is the HostTier, ``page_reader`` a
        # callable page_id -> host byte slabs.  With either unset,
        # evict simply drops pages.
        self.host: Optional[HostTier] = None
        self.page_reader = None

    def _chunk(self, tokens: np.ndarray, i: int) -> bytes:
        """Page ``i``'s token content (0-based), as a hashable key."""
        return np.asarray(tokens[i * self.pt:(i + 1) * self.pt],
                          np.int32).tobytes()

    def _rooted(self, extra: Tuple) -> Tuple[Any, bytes]:
        """(root id, root hash) for a walk keyed by ``extra`` on top of
        the salt; ``extra=()`` is the plain root."""
        if not extra:
            return self._root, self._root_hash
        root = (self._root, tuple(extra))
        return root, hashlib.blake2b(
            self._root_hash + repr(tuple(extra)).encode(),
            digest_size=16).digest()

    def chain_hashes(self, tokens: np.ndarray, n: int,
                     extra: Tuple = ()) -> List[bytes]:
        """Content chain hashes of ``tokens``' first ``n`` full pages:
        entry ``i`` is the digest a node covering pages [0, i] carries
        and the key its page spills under."""
        out: List[bytes] = []
        _, h = self._rooted(extra)
        for i in range(n):
            h = _hash_chain(h, self._chunk(tokens, i))
            out.append(h)
        return out

    def __len__(self) -> int:
        return len(self.nodes)

    def pages(self) -> set:
        return {n["page"] for n in self.nodes.values()}

    def match(self, tokens: np.ndarray, extra: Tuple = ()) -> List[int]:
        """Longest cached page run that is a prefix of ``tokens``: the
        page ids in position order (possibly empty).  LRU-touches every
        node on the path."""
        self._clock += 1
        pages: List[int] = []
        parent, _ = self._rooted(extra)
        for i in range(len(tokens) // self.pt):
            node = self.nodes.get((parent, self._chunk(tokens, i)))
            if node is None:
                break
            node["clock"] = self._clock
            pages.append(node["page"])
            parent = node["id"]
        return pages

    def insert(self, tokens: np.ndarray, pages: List[int],
               extra: Tuple = ()):
        """Publish a full-page run: page ``i`` holds K/V for positions
        [i*pt, (i+1)*pt) of ``tokens``.  Existing nodes win (their page
        stays; the duplicate remains the caller's private copy)."""
        n = min(len(tokens) // self.pt, len(pages))
        self._clock += 1
        root_id, root_hash = self._rooted(extra)
        parent_id, parent_key = root_id, None
        parent_hash = root_hash
        for i in range(n):
            chunk = self._chunk(tokens, i)
            key = (parent_id, chunk)
            node = self.nodes.get(key)
            if node is None:
                self.alloc.incref(pages[i])
                node = {"id": self._next_id, "page": pages[i],
                        "clock": self._clock, "children": 0,
                        "parent_key": parent_key,
                        "hhash": _hash_chain(parent_hash, chunk)}
                self._next_id += 1
                self.nodes[key] = node
                if parent_key is not None:
                    self.nodes[parent_key]["children"] += 1
                self.inserted += 1
            else:
                node["clock"] = self._clock
            parent_id, parent_key = node["id"], key
            parent_hash = node["hhash"]

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pool pages by dropping LRU LEAF nodes
        nobody maps (page refcount == 1).  Leaf-first keeps every
        surviving node's prefix path intact; a parent whose last child
        is dropped re-enters consideration within the same call.

        With the host tier attached, each dropped page is SPILLED
        (device->host byte copy under the node's chain hash) BEFORE its
        decref frees it: the read must complete while the page is live
        (DESIGN.md §12)."""
        freed = 0
        candidates = sorted(
            (k for k, nd in self.nodes.items()
             if nd["children"] == 0
             and self.alloc.refcount[nd["page"]] == 1),
            key=lambda k: self.nodes[k]["clock"], reverse=True)
        while freed < n_pages and candidates:
            key = candidates.pop()
            node = self.nodes.get(key)
            if (node is None or node["children"] != 0
                    or self.alloc.refcount[node["page"]] != 1):
                continue            # state moved under us: re-derived
            self.nodes.pop(key)
            pk = node["parent_key"]
            if pk is not None and pk in self.nodes:
                parent = self.nodes[pk]
                parent["children"] -= 1
                if (parent["children"] == 0
                        and self.alloc.refcount[parent["page"]] == 1):
                    candidates.append(pk)
                    candidates.sort(
                        key=lambda k: self.nodes[k]["clock"],
                        reverse=True)
            if self.host is not None and self.page_reader is not None:
                self.host.put(node["hhash"],
                              self.page_reader(node["page"]))
            self.alloc.decref(node["page"])
            self.evicted += 1
            freed += 1
        return freed


def rank_pool_bytes(plan, *, page_tokens: int, n_pages: int,
                    dtype_bytes: int = 4) -> Dict[str, Any]:
    """Per-layer KV page-pool accounting under a non-uniform
    ``core.prune.RankBudget`` (DESIGN.md §14).

    The physical pools are sized by the plan's global max widths: every
    layer's pool shares one shape ``(n_pages + 1, page_tokens, KV,
    max_rank)``.  This reports the bytes the kept ranks use
    (``kept``), the bytes the stacked pools allocate (``allocated``)
    and the per-layer kept bytes in stack order (``per_layer``: ((j,
    b), bytes)).  The garbage row is counted, as in the real pools;
    ``dtype_bytes`` is the cache element width (4 = float32)."""
    rows = (n_pages + 1) * page_tokens
    per_layer = []
    kept = 0
    allocated = 0
    dq, dv = plan.qk_width, plan.vo_width
    for j, qk_tab in enumerate(plan.qk_ranks):
        vo_tab = plan.vo_ranks[j]
        for b, qk_heads in enumerate(qk_tab):
            vo_heads = vo_tab[b]
            if not qk_heads and not vo_heads:
                continue                      # non-attention position
            layer = rows * dtype_bytes * (sum(qk_heads) + sum(vo_heads))
            per_layer.append(((j, b), layer))
            kept += layer
            allocated += rows * dtype_bytes * (dq + dv) * len(qk_heads)
    return {"per_layer": per_layer, "kept": kept, "allocated": allocated}
