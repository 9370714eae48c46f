"""Automatic prefix caching: content-addressed KV page reuse (the port's
own copy of ``quick_tpu/runtime/prefix_cache.py``, over the port's
``PageAllocator``; the hashes are byte-identical).

vLLM-style prefix caching re-derived for this engine's paged cache (no
reference analog — the reference recomputes every prompt from scratch,
quick/awq/models/base.py:87-89). Requests whose prompts share a prefix
reuse the SAME physical pages: causal attention makes a page's KV content
a pure function of the token prefix up to its end, so a chain hash

    h_i = hash(h_{i-1}, tokens[i*page : (i+1)*page])

identifies a reusable page. Admission looks up the longest chain of full
prompt pages already in the index, increments their refcounts, and starts
prefill after the covered tokens; only full pages containing exclusively
PROMPT tokens are ever shared (the last page is capped so at least one
prompt token is always recomputed — the engine needs its logits).

Lifecycle: a page's refcount counts slot owners. Writers register a page
in the index only after their prefill has fully written it (sharers attach
strictly after that, and device programs execute in dispatch order, so a
reader never races its writer). At retirement, refcount-0 registered
pages are RETAINED in an LRU instead of freed — their KV stays warm in
HBM — and are evicted back to the free list on allocation pressure.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

from quick_tpu_torch.modules.paged_cache import TRASH_PAGE, PageAllocator


def page_hashes(prompt: List[int], page_size: int) -> List[bytes]:
    """Chain hashes of the prompt's shareable full pages (at least one
    trailing token is left uncovered — see module docstring).

    SHA-256 chain, not Python ``hash()``: a page-id collision silently
    serves another request's KV (wrong output AND a cross-request context
    leak), and 64-bit hashes are adversarially constructible — the same
    reason vLLM's prefix cache moved to SHA-256."""
    import hashlib
    import struct

    n_full = (len(prompt) - 1) // page_size
    hashes: List[bytes] = []
    h = b""
    for i in range(n_full):
        page = prompt[i * page_size : (i + 1) * page_size]
        h = hashlib.sha256(
            h + struct.pack(f"<{len(page)}q", *page)
        ).digest()
        hashes.append(h)
    return hashes


class PrefixCache:
    """Page index + refcounts + LRU of retained pages, layered over a
    PageAllocator. All operations are host-side (admission control)."""

    def __init__(self, alloc: PageAllocator):
        self._alloc = alloc
        self.index: Dict[bytes, int] = {}  # chain-hash -> page id
        self.rev: Dict[int, bytes] = {}   # page id -> chain-hash
        self.refs: Dict[int, int] = {}    # page id -> slot-owner count
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # retained pages
        self.hits = 0
        self.misses = 0

    # -- admission ------------------------------------------------------------
    def match(self, hashes: List[bytes]) -> List[int]:
        """Longest indexed chain prefix; increments refcounts of the
        matched pages (call release() on admission failure)."""
        got: List[int] = []
        for h in hashes:
            pg = self.index.get(h)
            if pg is None:
                self.misses += 1
                break
            self.hits += 1
            self.refs[pg] = self.refs.get(pg, 0) + 1
            self.lru.pop(pg, None)
            got.append(pg)
        return got

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate n fresh pages (refcount 1), evicting LRU-retained
        pages under pressure."""
        if n > self.n_reusable:
            # infeasible even after evicting everything: fail WITHOUT
            # wiping the warm index (the caller retries after retirements)
            return None
        while self._alloc.n_free < n and self.lru:
            pg, _ = self.lru.popitem(last=False)  # oldest retained page
            h = self.rev.pop(pg)
            del self.index[h]
            self.refs.pop(pg, None)
            self._alloc.release([pg])
        pages = self._alloc.alloc(n)
        if pages is None:
            return None
        for p in pages:
            self.refs[p] = 1
        return pages

    @property
    def n_reusable(self) -> int:
        return self._alloc.n_free + len(self.lru)

    # -- registration ---------------------------------------------------------
    def register(self, h: bytes, page: int) -> None:
        """Publish a fully-written prompt page. First writer wins; later
        identical pages stay private (no dedup-merge)."""
        if h not in self.index and page not in self.rev:
            self.index[h] = page
            self.rev[page] = h

    # -- release --------------------------------------------------------------
    def release(self, pages: List[int]) -> None:
        """Drop one ownership ref per page; refcount-0 registered pages
        are retained in the LRU, unregistered ones return to the free
        list."""
        freed = []
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("cannot release the trash page")
            self.refs[p] = self.refs.get(p, 1) - 1
            if self.refs[p] > 0:
                continue
            del self.refs[p]
            if p in self.rev:
                self.lru[p] = None   # retain warm
            else:
                freed.append(p)
        if freed:
            self._alloc.release(freed)
