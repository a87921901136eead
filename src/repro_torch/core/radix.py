"""Radix prefix cache over the paged KV pool (a copy of
``src/repro/core/radix.py``; numpy only).

A radix tree keyed by PAGE-ALIGNED token-id spans maps each cached span to
the physical page holding its K/V. Two requests that share a token prefix
share the prefix's pages, across groups and across time, because a paged
cache entry is purely per-token: k_t = W_k emb(tok_t) rotated by pos t,
independent of what follows. A page cached by an earlier request therefore
holds what a cold prefill would write (the prefill and the suffix prefill
run different attention kernels, so the pages agree to rounding; warm
tokens equal cold ones in the parity tests).

Layering on ``core/paged.py``'s refcounts:

  * the tree holds ONE allocator reference per cached page (taken via
    ``PageAllocator.retain`` at insert) on top of the in-flight rows'
    references, so a finishing row never frees a cached page under the
    tree;
  * a page is EVICTABLE exactly when its refcount is 1 (tree only) and no
    cached descendant would be orphaned; eviction is LRU over a monotone
    lookup/insert clock (no wall time);
  * the engine's admission gate calls ``evict`` on a page deficit, so
    cached-but-idle pages are as reclaimable as free pages and the
    page-credit deadlock-freedom argument is unchanged.

Nodes are page-granularity (one node = one ``page_size`` token span). A
node may be a PLACEHOLDER (``page is None``): eviction leaves one while
descendants still hold pages, pruning empty chains upward. The matched
run handed to the engine is the longest CONTIGUOUS live run starting at
the requester's first live page index ``j0`` (0 without a window).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class _Node:
    """One page-aligned token span. ``page is None`` marks a placeholder
    (never cached, or evicted while descendants remain)."""

    __slots__ = ("key", "page", "parent", "children", "last_use")

    def __init__(self, key: Tuple[int, ...], parent: Optional["_Node"]):
        self.key = key
        self.page: Optional[int] = None
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_use = 0


class RadixCache:
    """Token-span radix tree mapping page-aligned prompt prefixes to the
    physical pages that hold them. Not thread-safe on its own — the owning
    engine serialises access under its mutex."""

    def __init__(self, page_size: int, alloc):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page = page_size
        self.alloc = alloc
        self.root = _Node((), None)
        self.cached_pages = 0        # nodes currently holding a page
        self._clock = 0              # monotone LRU clock (no wall time)

    # -- internals ----------------------------------------------------------

    def _span(self, tokens: np.ndarray, j: int) -> Tuple[int, ...]:
        return tuple(int(t) for t in
                     tokens[j * self.page:(j + 1) * self.page])

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- queries ------------------------------------------------------------

    def lookup(self, tokens, *, j0: int = 0) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens`` usable by a row whose first
        live page index is ``j0`` (sliding-window geometry). Returns
        ``(m, pages)``: page indices ``j0..m-1`` are cached as ``pages``
        (contiguous, live); ``m == j0`` means no usable match. The walk is
        capped at ``(len(tokens) - 1) // page_size`` so at least the last
        prompt token is always recomputed — the engine needs its logits.
        Touches every matched node's LRU stamp."""
        tokens = np.asarray(tokens)
        limit = max(0, (len(tokens) - 1) // self.page)
        now = self._tick()
        node = self.root
        m, pages, run = j0, [], []
        for j in range(limit):
            child = node.children.get(self._span(tokens, j))
            if child is None:
                break
            child.last_use = now
            node = child
            if j < j0:
                continue                      # dead-on-arrival page index
            if child.page is None:
                break                         # hole: contiguous run ends
            run.append(child.page)
        if run:
            m, pages = j0 + len(run), run
        return m, pages

    def insert(self, tokens, pages: Dict[int, int]) -> int:
        """Cache ``pages`` (page index -> page id) for ``tokens``, creating
        placeholder nodes along the path (window-dead leading indices, or
        gaps the caller does not own). A span already cached keeps its
        incumbent page — the newcomer's copy stays private to its rows and
        frees with them (concurrent duplicate prefills resolve without a
        leak). Each newly cached page takes one allocator reference for
        the tree. Returns how many pages were newly cached."""
        if not pages:
            return 0
        tokens = np.asarray(tokens)
        top = max(pages) + 1
        assert top * self.page <= len(tokens), \
            "insert may only cache COMPLETE page spans"
        now = self._tick()
        node = self.root
        stored = 0
        for j in range(top):
            key = self._span(tokens, j)
            child = node.children.get(key)
            if child is None:
                child = _Node(key, node)
                node.children[key] = child
            child.last_use = now
            node = child
            if j in pages and child.page is None:
                child.page = pages[j]
                self.alloc.retain([pages[j]])
                self.cached_pages += 1
                stored += 1
        return stored

    # -- eviction -----------------------------------------------------------

    def _collect(self, protect) -> List[_Node]:
        """Evictable nodes: hold a page with allocator refcount 1 (the
        tree's own — no in-flight row sees it), no cached descendant (the
        tree never orphans a reachable suffix), not protected (the pages
        an in-progress admission just matched)."""
        out, sub = [], {}        # id(node) -> subtree holds any page
        stack = [(self.root, False)]
        while stack:
            node, visited = stack.pop()
            if not visited:
                stack.append((node, True))
                stack.extend((c, False) for c in node.children.values())
                continue
            below = any(sub[id(c)] for c in node.children.values())
            sub[id(node)] = (node.page is not None) or below
            if (node.page is not None and not below
                    and node.page not in protect
                    and self.alloc.refcount(node.page) == 1):
                out.append(node)
        return out

    def evict(self, n_pages: int, protect=frozenset()) -> List[int]:
        """Free up to ``n_pages`` cached pages, least-recently-used first,
        restricted to zero-row-ref leaf pages. Returns the freed page ids
        (each goes straight back to the allocator freelist — the tree held
        their last reference). Empty placeholder chains prune upward."""
        freed: List[int] = []
        while len(freed) < n_pages:
            cands = self._collect(protect)
            if not cands:
                break
            victim = min(cands, key=lambda nd: nd.last_use)
            self.alloc.release([victim.page])
            freed.append(victim.page)
            victim.page = None
            self.cached_pages -= 1
            node = victim
            while (node is not self.root and node.page is None
                   and not node.children):
                parent = node.parent
                del parent.children[node.key]
                node = parent
        return freed

    # -- introspection (tests) ----------------------------------------------

    def pages(self) -> List[int]:
        """Every page id the tree currently holds a reference to."""
        out, stack = [], [self.root]
        while stack:
            node = stack.pop()
            if node.page is not None:
                out.append(node.page)
            stack.extend(node.children.values())
        return out

    @property
    def num_nodes(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n
