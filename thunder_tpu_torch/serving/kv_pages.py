"""Block-paged KV cache: a fixed page pool shared by all in-flight sequences.

The port of thunder_tpu/serving/kv_pages.py: each layer owns one
`(n_pages, page_size, n_kv_heads, head_dim)` tensor and every sequence owns
an int32 row of page ids into it. The pool shape never changes, so one
compiled decode step serves every mix of sequence lengths; allocation is
host bookkeeping over a free-list, and a finished request's pages return to
the pool at retirement.

Pages are REFCOUNTED: prefix sharing (PrefixCache below) maps the same
physical page into many sequences' tables, so `free` is a decref and a page
only returns to the free-list when its last owner lets go. A write into a
shared page goes through `PageAllocator.fork` + `PagedKVCache.copy_page`
(copy-on-write).

Page 0 is reserved as the NULL page: unallocated page-table entries and idle
decode slots point at it, keeping every gather in-bounds (attention masks
its values out by position).

The port's pools are written in place by the serving programs (see
executors/passes.py:write_dead_inputs_in_place); ``rebind`` adopts what a
program returns all the same, which is the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

NULL_PAGE = 0


class OutOfPages(Exception):
    """The pool cannot satisfy an allocation; the scheduler queues the
    request until retirements return pages."""


class PageAllocator:
    """Refcounting free-list allocator over page ids [1, n_pages); page 0 is
    the reserved null page and is never handed out.

    alloc() hands out pages at refcount 1; incref() adds an owner (prefix
    sharing); free() is a DECREF — the page returns to the free-list only
    when the count reaches zero. The double-free check and the refcount
    bookkeeping live in one place (free), so a shared page freed by one
    owner can never re-enter the free list while other owners hold it."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"need at least 2 pages (1 usable + null), got {n_pages}")
        self.n_pages = n_pages
        # LIFO free-list: recently-freed pages are re-used first (their pool
        # slices are most likely still warm in cache hierarchies that care).
        # The mirror set makes free()'s double-free check O(1) — retirement
        # runs inside the decode iteration loop, so freeing k pages must not
        # scan a production-sized free list k times.
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self._rc: Dict[int, int] = {}  # page id -> live owner count

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfPages(f"requested {n} pages, {len(self._free)} free "
                             f"of {self.n_pages - 1} usable")
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        for p in out:
            self._rc[p] = 1
        return out

    def incref(self, page: int) -> None:
        """Add an owner to an ALLOCATED page (prefix sharing: a new sequence
        or the prefix cache maps an existing physical page)."""
        if page in self._free_set or page not in self._rc:
            raise ValueError(f"incref of unallocated page {page}")
        self._rc[page] += 1

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    def free(self, pages: List[int]) -> None:
        seen = set()
        for p in pages:
            if not (0 < p < self.n_pages):
                raise ValueError(f"freeing invalid page id {p}")
            if p in self._free_set or p in seen or p not in self._rc:
                # a duplicate WITHIN the call is a double free too: letting
                # it through would hand the same page to two sequences later.
                # (Callers hold at most one reference per page per free()
                # call; a multi-ref owner decrefs across separate calls.)
                raise ValueError(f"double free of page {p}")
            seen.add(p)
        released = []
        for p in pages:
            self._rc[p] -= 1
            if self._rc[p] == 0:
                del self._rc[p]
                released.append(p)
        self._free.extend(released)
        self._free_set.update(released)

    def fork(self, page: int) -> int:
        """Copy-on-write fork: detach THIS owner from a (possibly shared)
        page before writing into it. With other owners present, allocates a
        fresh page, drops this owner's reference on the old one, and returns
        the new id — the caller must then `PagedKVCache.copy_page(old, new)`
        and patch its page table. A sole owner gets the SAME id back (no
        other reader, writing in place is safe and no copy is paid)."""
        if page in self._free_set or page not in self._rc:
            raise ValueError(f"fork of unallocated page {page}")
        if self._rc[page] == 1:
            return page
        new = self.alloc(1)[0]
        self._rc[page] -= 1
        return new

    def utilization(self) -> float:
        usable = self.n_pages - 1
        return self.n_used / usable if usable else 0.0


class _PrefixNode:
    __slots__ = ("key", "page", "children", "parent")

    def __init__(self, key: Tuple[int, ...], page: int, parent):
        self.key = key          # the page's page_size prompt tokens
        self.page = page        # physical page id (cache holds one ref)
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.parent = parent


class PrefixCache:
    """Prefix -> page-id map: a trie over FULL prompt pages, keyed by each
    page's token tuple (content-keyed, so two prompts sharing a system
    prefix hit the same chain whatever request produced it).

    * `match(prompt)` walks the trie page by page, increfs every matched
      page on the caller's behalf, and additionally probes a PARTIAL tail:
      a prompt whose last (< page_size) tokens are a prefix of some cached
      page's tokens is fully covered — the scheduler then skips prefill
      entirely and re-decodes only the last prompt token (the write that
      triggers the copy-on-write fork).
    * `insert(prompt, pages)` registers a freshly prefilled request's full
      prompt pages; the cache holds its OWN reference on each registered
      page, so donors can retire without invalidating the chain.
    * Eviction is LRU over trie nodes (leaves first, so chains stay
      connected) and runs under pool pressure via `evict_until` — an evicted
      page is only decref'd, so sequences still sharing it are untouched.
    """

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self._root: Dict[Tuple[int, ...], _PrefixNode] = {}
        self._lru: Dict[_PrefixNode, None] = {}  # insertion-ordered; end = newest

    def __len__(self) -> int:
        return len(self._lru)

    def _touch(self, node: _PrefixNode) -> None:
        self._lru.pop(node, None)
        self._lru[node] = None

    def match(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """(shared_pages, covered_tokens) for a prompt; every returned page
        has been incref'd for the caller (who must free them like any other
        page it owns). covered_tokens == len(prompt) means full coverage
        (possibly via a partial-tail hit on the last page)."""
        ps = self.page_size
        L = len(prompt)
        pages: List[int] = []
        children = self._root
        n_full = L // ps
        for i in range(n_full):
            key = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            node = children.get(key)
            if node is None:
                break
            self._touch(node)
            self.allocator.incref(node.page)
            pages.append(node.page)
            children = node.children
        covered = len(pages) * ps
        if covered == L:
            return pages, covered
        if len(pages) == n_full and L % ps:
            # partial tail: the remaining (< page_size) prompt tokens may be
            # the LEADING tokens of some cached full page — sharing it covers
            # the whole prompt; the first decode write CoW-forks it
            tail = tuple(int(t) for t in prompt[n_full * ps:])
            for key, child in children.items():
                if key[:len(tail)] == tail:
                    self._touch(child)
                    self.allocator.incref(child.page)
                    pages.append(child.page)
                    return pages, L
        return pages, covered

    def insert(self, prompt: np.ndarray, pages: List[int]) -> int:
        """Register the FULL prompt pages of a prefilled request (partial
        last pages are never registered — they would mix prompt and
        generated tokens). Existing nodes are touched, new ones incref
        their page. Returns the number of newly registered pages."""
        ps = self.page_size
        n_full = len(prompt) // ps
        children = self._root
        parent = None
        added = 0
        for i in range(min(n_full, len(pages))):
            key = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            node = children.get(key)
            if node is None:
                self.allocator.incref(pages[i])
                node = _PrefixNode(key, pages[i], parent)
                children[key] = node
                added += 1
            self._touch(node)
            children = node.children
            parent = node
        return added

    def _evict(self, node: _PrefixNode) -> None:
        siblings = node.parent.children if node.parent is not None else self._root
        siblings.pop(node.key, None)
        self._lru.pop(node, None)
        self.allocator.free([node.page])

    def evict_until(self, n_needed: int) -> bool:
        """Drop LRU leaf nodes until the allocator can serve `n_needed`
        pages (or nothing evictable remains). Only the cache's OWN reference
        is dropped: pages still mapped by live sequences survive; pages only
        the cache held return to the free-list."""
        while not self.allocator.can_alloc(n_needed):
            victim = next((n for n in self._lru if not n.children), None)
            if victim is None:
                return False
            self._evict(victim)
        return True

    def clear(self) -> None:
        while self._lru:
            self._evict(next(n for n in self._lru if not n.children))


class PagedKVCache:
    """Per-layer paged K/V pools plus the allocator that parcels them out.
    A draft model's cache (speculative decoding) passes the target cache's
    ``allocator``: one allocation then covers both pools, and page ids and
    page tables are the same across the two."""

    def __init__(self, n_layer: int, n_pages: int, page_size: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.bfloat16, device=None,
                 allocator: Optional[PageAllocator] = None):
        shape = (n_pages, page_size, n_kv_heads, head_dim)
        self.n_layer = n_layer
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.k_pages = tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layer))
        self.v_pages = tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layer))
        self.allocator = allocator if allocator is not None else PageAllocator(n_pages)

    @staticmethod
    def pages_for(n_tokens: int, page_size: int) -> int:
        return max(1, math.ceil(n_tokens / page_size))

    def rebind(self, k_pages, v_pages) -> None:
        """Adopt the pools returned by a compiled step."""
        self.k_pages = tuple(k_pages)
        self.v_pages = tuple(v_pages)

    def copy_page(self, src: int, dst: int) -> None:
        """Copy page ``src`` into page ``dst`` in every layer's k and v pool
        (the copy-on-write body after `PageAllocator.fork`): an in-place
        device copy on the pools' stream, where thunder_tpu runs a jitted
        functional update."""
        with torch.no_grad():
            for pool in self.k_pages + self.v_pages:
                pool[dst].copy_(pool[src])

    def utilization(self) -> float:
        return self.allocator.utilization()

    def page_table_row(self, pages: List[int], n_pages_max: int) -> np.ndarray:
        """A sequence's page-table row, padded with the null page."""
        row = np.full((n_pages_max,), NULL_PAGE, np.int32)
        row[: len(pages)] = np.asarray(pages, np.int32)
        return row
