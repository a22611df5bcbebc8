"""Radix-tree prefix cache over the paged KV pool.

Production chat/RAG traffic shares system prompts and conversation
prefixes; without a prefix cache every request re-prefills from token 0
(and the serve-plane failover replay re-prefills the WHOLE spliced
prompt).  This module is the index side of the fix: a radix tree keyed
on page-sized token chunks whose nodes each own exactly one KV page of
the engine's paged pool, with borrow refcounts and LRU eviction.

Ownership/refcount model (the invariant tests assert):

  * Every physical page is in exactly ONE of three places: the
    engine's free list, this index (``pages()``), or a slot's
    allocation (``_slot_pages``).  A *borrowed* page is a cached page
    additionally referenced by one or more slots' block tables — it
    stays owned by the index and never enters the free list directly.
  * ``refs`` counts live borrowers (slots currently mapping the page).
    The cache's own hold is implicit: a node with ``refs == 0`` is
    merely *evictable*, not free.
  * Only full pages are cached, and prefill resumes at the hit
    boundary, so in-flight writes always target positions at or past
    the first uncached page — shared pages are immutable by
    construction.  The single exception is an exact full-prompt hit
    (the last-token re-run lands inside the deepest shared page);
    the engine COW-splits that page before scheduling (see
    ``LLMEngine._admit_slot_for``).

Eviction is refcount-0 LRU over *leaves* only (an interior node's page
backs every cached suffix under it), cascading: evicting a leaf may
expose its parent as the next candidate.  The engine calls ``evict``
from ``_alloc_slot_pages`` under pool pressure, so cached pages never
starve admission.

Cache-aware routing rides ``summary()``: a compact list of chained
CRC32 hashes of the tree's paths, published over the controller's
long-poll broadcast table.  The router recomputes the same chain over
an incoming prompt (``match_depth``) and prefers the replica holding
the longest prefix.  CRC32 (not ``hash()``) because the chain must be
stable across processes — Python's string hashing is salted per
process.
"""

from __future__ import annotations

import itertools
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Set, Tuple


def _chunk_hash(chunk: Sequence[int], parent_hash: int) -> int:
    """Chained CRC32 over one page-sized token chunk.  The chain makes
    each hash identify the whole PATH (prefix), not just the chunk, so
    a flat hash set can answer "how deep does this prompt match"."""
    data = ",".join(str(int(t)) for t in chunk).encode()
    return zlib.crc32(data, parent_hash)


def prefix_hashes(tokens: Sequence[int], page_size: int,
                  max_depth: Optional[int] = None) -> List[int]:
    """Chained hashes of every full-page prefix of ``tokens`` (depth 1
    = first page, …).  Shared by the index (publisher) and the router
    (matcher)."""
    out: List[int] = []
    h = 0
    depth = len(tokens) // page_size
    if max_depth is not None:
        depth = min(depth, max_depth)
    for k in range(depth):
        h = _chunk_hash(tokens[k * page_size:(k + 1) * page_size], h)
        out.append(h)
    return out


def match_depth(tokens: Sequence[int], summary: Optional[dict]) -> int:
    """Longest cached prefix (in TOKENS) a replica's published summary
    claims for this prompt; 0 when the summary is absent/foreign.
    Deliberately tolerant: a summary is a hint for routing, never a
    correctness input (the engine re-matches exactly on admission)."""
    if not isinstance(summary, dict):
        return 0
    page = summary.get("page")
    hashes = summary.get("hashes")
    if not isinstance(page, int) or page <= 0 or not hashes:
        return 0
    have = set(hashes)
    best = 0
    for depth, h in enumerate(prefix_hashes(tokens, page), start=1):
        if h in have:
            best = depth * page
    return best


class _Node:
    __slots__ = ("chunk", "page", "hash", "parent", "children", "refs",
                 "leases", "last_used")

    def __init__(self, chunk: Tuple[int, ...], page: int, h: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.page = page
        self.hash = h
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.refs = 0  # live borrowers (slots), NOT the cache's hold
        self.leases = 0  # in-flight migration leases (kv_transfer)
        self.last_used = 0


class PrefixIndex:
    """Radix tree of full KV pages keyed on page-sized token chunks.

    Thread-safe; the engine loop is the only writer in practice but
    ``summary()``/``stats()`` are read from replica push threads."""

    def __init__(self, page_size: int):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.page_size = page_size
        self._root_children: Dict[Tuple[int, ...], _Node] = {}
        self._by_page: Dict[int, _Node] = {}
        self._clock = itertools.count(1)
        self._lock = threading.Lock()
        self.evicted_total = 0
        self.inserted_total = 0

    # -- queries -----------------------------------------------------------

    @property
    def cached_pages(self) -> int:
        return len(self._by_page)

    def pages(self) -> Set[int]:
        """The set of physical pages this index owns (for the pool
        accounting invariant: free ∪ cached ∪ slot-owned = pool, with
        borrowed = cached ∩ slot-mapped)."""
        with self._lock:
            return set(self._by_page)

    def refcount(self, page: int) -> int:
        with self._lock:
            node = self._by_page.get(page)
            return -1 if node is None else node.refs

    def _match_locked(self, tokens: Sequence[int]) -> List[_Node]:
        nodes: List[_Node] = []
        children = self._root_children
        for k in range(len(tokens) // self.page_size):
            chunk = tuple(
                int(t) for t in
                tokens[k * self.page_size:(k + 1) * self.page_size])
            node = children.get(chunk)
            if node is None:
                break
            nodes.append(node)
            children = node.children
        return nodes

    # -- borrow / return ---------------------------------------------------

    def acquire(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached full-page prefix of ``tokens``: bump each
        matched node's refcount (pinning it and, transitively, its
        ancestors against eviction) and return the page ids in path
        order.  Caller must ``release`` exactly these pages."""
        with self._lock:
            nodes = self._match_locked(tokens)
            stamp = next(self._clock)
            for node in nodes:
                node.refs += 1
                node.last_used = stamp
            return [node.page for node in nodes]

    def release(self, pages: Sequence[int]) -> None:
        """Return borrowed pages (refcount -1 each).  Pages evicted
        while borrowed cannot exist (refs > 0 pins them), so an unknown
        page here is a double-free bug — raise, don't mask."""
        with self._lock:
            stamp = next(self._clock)
            for p in pages:
                node = self._by_page.get(p)
                if node is None or node.refs <= 0:
                    raise RuntimeError(
                        f"prefix cache: release of page {p} not "
                        f"borrowed (refcount underflow)")
                node.refs -= 1
                node.last_used = stamp

    # -- migration leases --------------------------------------------------

    def lease_acquire(self, tokens: Sequence[int]) -> List[int]:
        """Pin the longest cached full-page prefix of ``tokens`` under a
        migration lease (kv_transfer export).  Like ``acquire`` but on a
        separate counter: leases pin pages against eviction without
        looking like slot borrowers, so the free ∪ cached ∪ slot-owned
        pool invariant keeps holding (leased pages stay cached).  Caller
        must ``lease_release`` exactly these pages — including on
        cancel/failure paths."""
        with self._lock:
            nodes = self._match_locked(tokens)
            stamp = next(self._clock)
            for node in nodes:
                node.leases += 1
                node.last_used = stamp
            return [node.page for node in nodes]

    def lease_release(self, pages: Sequence[int]) -> None:
        """Drop a migration lease (one per page).  Leased pages cannot
        be evicted, so an unknown page here is a lease-accounting bug —
        raise, don't mask."""
        with self._lock:
            stamp = next(self._clock)
            for p in pages:
                node = self._by_page.get(p)
                if node is None or node.leases <= 0:
                    raise RuntimeError(
                        f"prefix cache: lease release of page {p} not "
                        f"leased (lease underflow)")
                node.leases -= 1
                node.last_used = stamp

    def leased_pages(self) -> Set[int]:
        """Pages currently pinned by at least one migration lease."""
        with self._lock:
            return {p for p, n in self._by_page.items() if n.leases > 0}

    # -- population --------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> Set[int]:
        """Offer the full-page prefix of ``tokens`` for caching, backed
        by ``pages`` (page k holds tokens [k*page, (k+1)*page)).  For
        each depth: an existing node (same chunk) keeps its page and
        the offered one is NOT adopted; a missing node adopts the
        offered page with refs=0.  Returns the set of adopted page ids
        — the caller frees the rest.  Adoption stops at the first depth
        without an offered page."""
        adopted: Set[int] = set()
        with self._lock:
            stamp = next(self._clock)
            children = self._root_children
            parent: Optional[_Node] = None
            depth = min(len(tokens) // self.page_size, len(pages))
            for k in range(depth):
                chunk = tuple(
                    int(t) for t in
                    tokens[k * self.page_size:(k + 1) * self.page_size])
                node = children.get(chunk)
                if node is None:
                    page = pages[k]
                    if page in self._by_page:  # defensive: never alias
                        break
                    h = _chunk_hash(chunk, parent.hash if parent else 0)
                    node = _Node(chunk, page, h, parent)
                    children[chunk] = node
                    self._by_page[page] = node
                    self.inserted_total += 1
                    adopted.add(page)
                node.last_used = stamp
                parent = node
                children = node.children
        return adopted

    # -- eviction ----------------------------------------------------------

    def evict(self, n: int) -> List[int]:
        """Free up to ``n`` pages: refcount-0 LRU over leaves,
        cascading (an evicted leaf may expose its parent).  Returns the
        freed page ids — the caller returns them to the pool."""
        freed: List[int] = []
        with self._lock:
            while len(freed) < n:
                victim: Optional[_Node] = None
                for node in self._by_page.values():
                    # leases pin against eviction exactly like borrows:
                    # an in-flight migration export must never watch its
                    # source pages get recycled under it.
                    if (node.refs == 0 and node.leases == 0
                            and not node.children):
                        if victim is None or node.last_used < victim.last_used:
                            victim = node
                if victim is None:
                    break
                siblings = (victim.parent.children if victim.parent
                            else self._root_children)
                del siblings[victim.chunk]
                del self._by_page[victim.page]
                freed.append(victim.page)
            self.evicted_total += len(freed)
        return freed

    # -- routing summary ---------------------------------------------------

    def summary(self, max_entries: int = 256) -> dict:
        """Compact cross-process view for cache-aware routing: the
        chained path hashes of the most recently used nodes.  Bounded
        (LRU-most-recent first) so the broadcast table stays small."""
        with self._lock:
            nodes = sorted(self._by_page.values(),
                           key=lambda n: -n.last_used)[:max_entries]
            return {"page": self.page_size,
                    "hashes": [n.hash for n in nodes]}

    def hot_paths(self, max_pages: int = 256,
                  distinct: bool = False) -> List[dict]:
        """Recency-ordered root-to-node paths for prefix migration: each
        entry is ``{"tokens", "pages", "hashes"}`` for one full cached
        path (deepest hot node first), deduplicated so a path that is a
        prefix of an earlier (hotter) one is skipped.  Bounded by the
        total page count across returned paths.

        One insert or acquire stamps a whole path at once.  As in the
        JAX package, nodes of one stamp are visited root first, so a path
        of depth d comes back d times, once a depth (d(d+1)/2 pages, and
        the budget can cut its deeper entries).  ``distinct=True`` visits
        them deepest first instead: each such path comes back once."""

        def depth(node: Optional[_Node]) -> int:
            d = 0
            while node is not None:
                d, node = d + 1, node.parent
            return d

        with self._lock:
            nodes = sorted(self._by_page.values(),
                           key=(lambda n: (-n.last_used, -depth(n)))
                           if distinct else (lambda n: -n.last_used))
        out: List[dict] = []
        covered: Set[int] = set()
        budget = max_pages
        for node in nodes:
            if node.page in covered:
                continue
            path: List[_Node] = []
            cur: Optional[_Node] = node
            while cur is not None:
                path.append(cur)
                cur = cur.parent
            path.reverse()
            if len(path) > budget:
                continue
            tokens: List[int] = []
            for p in path:
                tokens.extend(p.chunk)
            out.append({
                "tokens": tokens,
                "pages": [p.page for p in path],
                "hashes": [p.hash for p in path],
            })
            covered.update(p.page for p in path)
            budget -= len(path)
            if budget <= 0:
                break
        return out

    def audit_snapshot(self) -> dict:
        """Consistent view for the doctor plane (serve/audit): per-page
        refcounts/lease counts from the page index plus a reachability
        walk from the root.  ``pages[p]["reachable"]`` is False for an
        orphaned node (indexed but detached from the tree);
        ``unindexed`` lists pages a root walk reaches that the page
        index has lost — both are corruption, caught by different
        halves of kv.trie_integrity."""
        with self._lock:
            reachable: Set[int] = set()
            stack = list(self._root_children.values())
            while stack:
                node = stack.pop()
                reachable.add(node.page)
                stack.extend(node.children.values())
            return {
                "pages": {p: {"refs": n.refs, "leases": n.leases,
                              "reachable": p in reachable}
                          for p, n in self._by_page.items()},
                "unindexed": sorted(reachable - set(self._by_page)),
            }

    def stats(self) -> dict:
        with self._lock:
            return {
                "cached_pages": len(self._by_page),
                "evicted_pages": self.evicted_total,
                "inserted_pages": self.inserted_total,
                "borrowed_refs": sum(n.refs
                                     for n in self._by_page.values()),
                "leased_pages": sum(1 for n in self._by_page.values()
                                    if n.leases > 0),
            }
