"""Radix-tree prefix cache over paged KV (WebLLM multi-round chat reuse).

The dominant browser-serving workload is multi-round chat: every turn
resubmits the whole conversation, so consecutive requests share a long
token prefix (system prompt + history).  This module caches the KV pages
of finished sequences in a radix tree keyed by token ids so a later
request can *adopt* the longest cached prefix instead of re-prefilling
it.

Structure
---------
* One tree node per **full page**: the edge into a node is the exact
  ``page_size``-token tuple stored in that physical page.  Full pages are
  immutable once written, so adopters share them zero-copy (+1 refcount
  via :class:`PageManager`).
* Each node additionally holds **partial tails**: a page whose final
  tokens stop mid-page.  Tails cannot be shared in place (the adopter
  must keep appending into that page), so adoption forks them
  copy-on-write: a private physical page is allocated and the payload is
  copied by the runner.
* Eviction is LRU over leaves (nodes with no children/tails, and tails).
  It triggers two ways: on demand through the ``PageManager.reclaim``
  hook when the free list runs dry, and PROACTIVELY on insert when
  ``max_cached_pages`` is set — the cache then never holds more than
  that many pages, bounding its memory footprint instead of letting it
  grow to whatever allocation pressure tolerates.  Evicting a page still
  referenced by a live sequence merely drops the cache's reference — the
  page returns to the free list when the sequence finishes.

``peek_len`` is a read-only probe (no LRU touch, no hit/miss counters)
the scheduler uses to rank waiting requests by uncached-suffix length
without perturbing the cache.

The cache is pure bookkeeping: page *payloads* live in the runner's torch
page pools and are never touched here.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.paged_cache import PageManager


def page_prefix_keys(ids, page_size: int) -> List[Tuple[int, ...]]:
    """The page-granular key chain the radix tree uses for ``ids``: one
    ``page_size``-token tuple per FULL leading page, in order.  The
    i-th key is the edge into depth-``i+1`` of the tree.  Exposed as a
    module function so supervisors can mirror the cache's keying
    exactly without holding a live tree — ``core/router.py`` builds its
    prefix-affinity map from these same keys, which is what makes
    'route turn 2 to the replica holding turn 1's pages' line up with
    what that replica's ``PrefixCache`` can actually serve."""
    n_full = len(ids) // page_size
    return [tuple(ids[j * page_size:(j + 1) * page_size])
            for j in range(n_full)]


def _common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class _Node:
    """One full cached page; the edge into the node is ``key``."""

    __slots__ = ("parent", "key", "page", "children", "tails",
                 "last_access")

    def __init__(self, parent: Optional["_Node"], key: Tuple[int, ...],
                 page: Optional[int], clock: int):
        self.parent = parent
        self.key = key
        self.page = page                     # physical page id (root: None)
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.tails: List["_Tail"] = []
        self.last_access = clock


class _Tail:
    """A partially filled final page hanging off a node."""

    __slots__ = ("tokens", "page", "last_access")

    def __init__(self, tokens: Tuple[int, ...], page: int, clock: int):
        self.tokens = tokens
        self.page = page
        self.last_access = clock


class PrefixCache:
    """Radix tree token-ids -> physical KV pages, with LRU eviction."""

    # lint (repro.analysis pass 1): the tree and its counters are
    # confined to the engine loop thread; only the declared
    # ``_CROSS_THREAD`` probes may run from stats/worker threads, and
    # they must snapshot before iterating (see ``evictable_pages``).
    _THREAD_CONFINED = ("root", "_clock", "_pages", "hits", "misses",
                        "hit_tokens", "evictions", "cap_evictions",
                        "inserted_pages")
    _CROSS_THREAD = ("stats", "evictable_pages")

    def __init__(self, pm: PageManager,
                 max_cached_pages: Optional[int] = None,
                 max_cached_bytes: Optional[int] = None,
                 page_bytes: Optional[int] = None):
        self.pm = pm
        self.page_size = pm.page_size
        self.max_cached_pages = max_cached_pages
        # byte-based cap: pages x per-model page bytes.  One byte budget
        # can govern the caches of several loaded models whose page
        # sizes/shapes differ — each converts it to its own page count.
        self.max_cached_bytes = max_cached_bytes
        self.page_bytes = page_bytes
        if max_cached_bytes is not None:
            assert page_bytes, "byte cap needs the per-model page_bytes"
            by_bytes = max_cached_bytes // page_bytes
            self.max_cached_pages = (by_bytes if max_cached_pages is None
                                     else min(max_cached_pages, by_bytes))
        self.root = _Node(None, (), None, 0)
        self._clock = 0
        self._pages: set = set()             # pages the cache holds a ref on
        # counters (surfaced via engine stats / usage.extra)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.cap_evictions = 0               # evictions forced by the cap
        self.inserted_pages = 0
        # install the on-demand eviction hooks
        pm.reclaim = self.reclaim
        pm.evictable = self.evictable_pages

    # -- lookup ----------------------------------------------------------
    def match(self, ids: List[int]) -> Tuple[List[int],
                                             Optional[Tuple[int, int]]]:
        """Longest cached prefix of ``ids``.

        Returns ``(full_pages, tail)`` where ``full_pages`` are physical
        pages covering ``len(full_pages) * page_size`` leading tokens
        (shareable in place) and ``tail`` is an optional
        ``(page, n_tokens)`` partial page that must be forked
        copy-on-write by the adopter.
        """
        self._clock += 1
        ps = self.page_size
        node = self.root
        pages: List[int] = []
        i = 0
        for key in page_prefix_keys(ids, ps):
            child = node.children.get(key)
            if child is None:
                break
            child.last_access = self._clock
            pages.append(child.page)
            node = child
            i += ps
        best: Optional[_Tail] = None
        best_n = 0
        rest = ids[i:]
        for t in node.tails:
            n = _common_prefix(t.tokens, rest)
            if n > best_n:
                best, best_n = t, n
        tail = None
        if best is not None:
            best.last_access = self._clock
            tail = (best.page, best_n)
        total = i + best_n
        if total:
            self.hits += 1
            self.hit_tokens += total
        else:
            self.misses += 1
        return pages, tail

    def peek_len(self, ids: List[int]) -> int:
        """Length of the longest cached prefix of ``ids`` WITHOUT touching
        LRU clocks or hit/miss counters — a pure read for scheduling
        (uncached-suffix prioritization of the waiting queue)."""
        ps = self.page_size
        node = self.root
        i = 0
        for key in page_prefix_keys(ids, ps):
            child = node.children.get(key)
            if child is None:
                break
            node = child
            i += ps
        best_n = 0
        rest = ids[i:]
        for t in node.tails:
            best_n = max(best_n, _common_prefix(t.tokens, rest))
        return i + best_n

    def lookup_continuation(self, context: List[int], k: int,
                            max_ngram: int = 3,
                            min_ngram: int = 1) -> List[int]:
        """Prompt-lookup drafting against the tree: find the trailing
        ``n``-gram of ``context`` (longest ``n`` in ``[min_ngram,
        max_ngram]`` wins) inside a cached token path and return up to
        ``k`` tokens that followed it there — the radix tree indexes
        every served token sequence, so a conversation's second turn
        drafts from its first.  Pure read like ``peek_len``: no LRU
        touch, no hit/miss counters (the engine reports draft stats
        itself).  Deterministic: paths are walked in sorted-key order
        and the FIRST match at the winning ``n`` is returned."""
        if k <= 0 or not context:
            return []
        streams: List[List[int]] = []

        def walk(node: _Node, prefix: List[int]):
            for key in sorted(node.children):
                child = node.children[key]
                walk(child, prefix + list(key))
            for t in sorted(node.tails, key=lambda t: t.tokens):
                streams.append(prefix + list(t.tokens))
            if not node.children and not node.tails and prefix:
                streams.append(prefix)

        walk(self.root, [])
        for n in range(min(max_ngram, len(context)), min_ngram - 1, -1):
            tail = list(context[-n:])
            for stream in streams:
                for j in range(len(stream) - n, -1, -1):
                    if stream[j:j + n] == tail and j + n < len(stream):
                        return stream[j + n:j + n + k]
        return []

    # -- publication -----------------------------------------------------
    def insert(self, ids: List[int], pages: List[int]):
        """Publish a finished sequence's tokens/pages into the tree.

        ``pages`` must back ``ids`` contiguously (``pages[j]`` holds
        tokens ``[j*ps, (j+1)*ps)``).  Pages backing already-cached nodes
        are left alone (the existing physical page stays canonical);
        pages that create new nodes/tails gain a cache reference so they
        survive ``free_seq``.
        """
        self._clock += 1
        ps = self.page_size
        node = self.root
        n_full = len(ids) // ps
        for j, key in enumerate(page_prefix_keys(ids, ps)):
            child = node.children.get(key)
            if child is None:
                child = _Node(node, key, pages[j], self._clock)
                node.children[key] = child
                self._take(pages[j])
            child.last_access = self._clock
            node = child
        rem = len(ids) - n_full * ps
        if rem:
            self._insert_tail(node, tuple(ids[n_full * ps:]), pages[n_full])
        self._enforce_cap()

    def _insert_tail(self, node: _Node, tt: Tuple[int, ...], page: int):
        for t in node.tails:
            # an existing tail already covers this one -> nothing to add
            if len(t.tokens) >= len(tt) and t.tokens[:len(tt)] == tt:
                t.last_access = self._clock
                return
        # drop tails that the new, longer tail strictly extends
        keep = []
        for t in node.tails:
            if tt[:len(t.tokens)] == t.tokens:
                self._drop(t.page)
            else:
                keep.append(t)
        keep.append(_Tail(tt, page, self._clock))
        node.tails = keep
        self._take(page)

    def _take(self, page: int):
        self.pm.ref_page(page)
        self._pages.add(page)
        self.inserted_pages += 1

    def _drop(self, page: int):
        self._pages.discard(page)
        self.pm.deref_page(page)

    # -- eviction --------------------------------------------------------
    def _enforce_cap(self):
        """Proactive LRU eviction down to ``max_cached_pages`` (no-op when
        uncapped).  Runs on every insert, so the cache's footprint is
        bounded even without allocation pressure."""
        if self.max_cached_pages is None:
            return
        while len(self._pages) > self.max_cached_pages:
            victim = self._lru_leaf()
            if victim is None:
                break
            self._evict(victim)
            self.cap_evictions += 1

    def evictable_pages(self) -> int:
        """Pages that would return to the free list if evicted now.
        Iterates a snapshot: stats() readers may run on another thread
        (e.g. the worker boundary) while the engine loop mutates the
        cache."""
        return sum(1 for p in list(self._pages)
                   if self.pm.ref.get(p, 0) == 1)

    def reclaim(self, n: int) -> int:
        """Evict LRU leaves until ``n`` pages landed on the free list (or
        the cache is empty).  Returns the number actually freed."""
        freed = 0
        while freed < n:
            victim = self._lru_leaf()
            if victim is None:
                break
            freed += self._evict(victim)
        return freed

    def _lru_leaf(self):
        """Oldest evictable unit: a tail, or a childless/tailless node."""
        best = None
        best_t = None
        stack = [self.root]
        while stack:
            node = stack.pop()
            for t in node.tails:
                if best_t is None or t.last_access < best_t:
                    best, best_t = (node, t), t.last_access
            for c in node.children.values():
                if not c.children and not c.tails:
                    if best_t is None or c.last_access < best_t:
                        best, best_t = (node, c), c.last_access
                else:
                    stack.append(c)
        return best

    def _evict(self, victim) -> int:
        parent, unit = victim
        page = unit.page
        if isinstance(unit, _Tail):
            parent.tails.remove(unit)
        else:
            del parent.children[unit.key]
        was_last_ref = self.pm.ref.get(page, 0) == 1
        self._drop(page)
        self.evictions += 1
        return 1 if was_last_ref else 0

    # -- stats -----------------------------------------------------------
    @property
    def cached_pages(self) -> int:
        return len(self._pages)

    def stats(self) -> dict:
        out = {"hits": self.hits, "misses": self.misses,
               "hit_tokens": self.hit_tokens,
               "evictions": self.evictions,
               "cap_evictions": self.cap_evictions,
               "max_cached_pages": self.max_cached_pages,
               "cached_pages": self.cached_pages,
               "evictable_pages": self.evictable_pages()}
        if self.page_bytes:
            out["cached_bytes"] = self.cached_pages * self.page_bytes
            out["max_cached_bytes"] = self.max_cached_bytes
        return out
