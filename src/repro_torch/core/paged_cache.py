"""Paged KV-cache management (WebLLM's WASM sequence manager, in Python).

``PageManager`` is the pure bookkeeping side: a free list of physical
pages, per-sequence page tables, allocate-on-append, and preemption
support (free a whole sequence).  The page pools themselves (torch
tensors, one pair per attention layer) live in
``repro_torch.core.paged_runner.PagedModelRunner``.

Pages are reference-counted so they can be shared between live sequences
and the prefix cache (``repro_torch.core.prefix_cache``): a page returns to the
free list only when its last reference drops.  ``share_pages`` adopts
already-filled pages into a sequence (+1 ref each) and ``fork_page``
implements copy-on-write of a partially filled tail page — the sequence
gets a private physical page it may write into, while the shared source
page stays immutable.

Non-attention state (SSM/RWKV/conv, MLA latents) is slot-based: O(1) per
sequence, managed by the same slot ids.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


class OutOfPages(Exception):
    pass


@dataclass
class SeqAlloc:
    seq_id: int
    slot: int                      # dense batch slot / state row
    pages: List[int] = field(default_factory=list)
    length: int = 0                # tokens currently stored


class PageManager:
    """Free-list page allocator + refcounted per-sequence page tables."""

    # lint (repro.analysis pass 1): allocator state is confined to the
    # engine loop thread; ``stats``/``num_free_pages`` are the len-only
    # probes other threads may call.
    _THREAD_CONFINED = ("free_pages", "free_slots", "seqs", "ref",
                        "_next_id", "n_shared", "n_cow_forks")
    _CROSS_THREAD = ("stats", "num_free_pages")

    def __init__(self, num_pages: int, page_size: int, max_slots: int,
                 pages_per_seq: int):
        self.page_size = page_size
        self.num_pages = num_pages
        self.pages_per_seq = pages_per_seq
        self.free_pages: List[int] = list(range(num_pages))
        self.free_slots: List[int] = list(range(max_slots))
        self.seqs: Dict[int, SeqAlloc] = {}
        self.ref: Dict[int, int] = {}          # physical page -> refcount
        self._next_id = 0
        self.n_shared = 0                      # pages adopted zero-copy
        self.n_cow_forks = 0                   # tail pages forked CoW
        # hooks installed by the prefix cache: reclaim(n) tries to evict
        # cached pages back to the free list; evictable() reports how many
        # it could free on demand (for admission accounting).
        self.reclaim: Optional[Callable[[int], int]] = None
        self.evictable: Optional[Callable[[], int]] = None

    # -- refcounting --------------------------------------------------
    def ref_page(self, page: int):
        self.ref[page] = self.ref.get(page, 0) + 1

    def deref_page(self, page: int):
        n = self.ref.get(page, 0) - 1
        if n > 0:
            self.ref[page] = n
        else:
            self.ref.pop(page, None)
            self.free_pages.append(page)

    def _alloc_page(self) -> int:
        if not self.free_pages and self.reclaim is not None:
            self.reclaim(1)
        if not self.free_pages:
            raise OutOfPages("page pool exhausted")
        p = self.free_pages.pop()
        self.ref[p] = 1
        return p

    def require_pages(self, n: int):
        """Raise OutOfPages *before* any state mutation unless ``n`` pages
        can be produced (free list + prefix-cache eviction)."""
        if len(self.free_pages) >= n:
            return
        if self.reclaim is not None:
            self.reclaim(n - len(self.free_pages))
        if len(self.free_pages) < n:
            raise OutOfPages(
                f"need {n} pages, have {len(self.free_pages)}")

    # -- lifecycle ----------------------------------------------------
    def new_seq(self) -> SeqAlloc:
        if not self.free_slots:
            raise OutOfPages("no free slots")
        sid = self._next_id
        self._next_id += 1
        alloc = SeqAlloc(seq_id=sid, slot=self.free_slots.pop())
        self.seqs[sid] = alloc
        return alloc

    def free_seq(self, seq_id: int):
        alloc = self.seqs.pop(seq_id)
        for p in alloc.pages:
            self.deref_page(p)
        self.free_slots.append(alloc.slot)

    # -- sharing / copy-on-write ----------------------------------------
    def share_pages(self, seq_id: int, pages: List[int], n_tokens: int):
        """Adopt already-filled ``pages`` (e.g. a cached prefix) into a
        sequence: +1 ref each, no data movement.  The adopted pages must
        be full and must precede any page the sequence will write."""
        alloc = self.seqs[seq_id]
        if len(alloc.pages) + len(pages) > self.pages_per_seq:
            raise OutOfPages("shared prefix exceeds pages_per_seq")
        for p in pages:
            self.ref_page(p)
            alloc.pages.append(p)
        alloc.length += n_tokens
        self.n_shared += len(pages)

    def fork_page(self, seq_id: int, n_tokens: int) -> int:
        """Copy-on-write bookkeeping for a partially filled tail page:
        allocate a private destination page, append it to the sequence,
        and account ``n_tokens`` adopted tokens.  The caller is
        responsible for copying the KV payload src -> returned page."""
        alloc = self.seqs[seq_id]
        if len(alloc.pages) + 1 > self.pages_per_seq:
            raise OutOfPages("fork exceeds pages_per_seq")
        dst = self._alloc_page()
        alloc.pages.append(dst)
        alloc.length += n_tokens
        self.n_cow_forks += 1
        return dst

    # -- growth ---------------------------------------------------------
    def ensure_capacity(self, seq_id: int, new_length: int):
        """Allocate pages so the sequence can hold ``new_length`` tokens."""
        alloc = self.seqs[seq_id]
        need = -(-new_length // self.page_size)          # ceil
        if need > self.pages_per_seq:
            raise OutOfPages(
                f"sequence needs {need} pages > pages_per_seq "
                f"{self.pages_per_seq}")
        while len(alloc.pages) < need:
            alloc.pages.append(self._alloc_page())

    def append_tokens(self, seq_id: int, n: int = 1):
        alloc = self.seqs[seq_id]
        self.ensure_capacity(seq_id, alloc.length + n)
        alloc.length += n

    def rewind_tokens(self, seq_id: int, n: int = 1):
        """Roll the sequence's cursor back ``n`` tokens and drop any
        trailing pages the rolled-back tokens had forced into existence
        (lag-1: the pipelined engine's finish rewind; lag-k: the
        rejected tail of a speculative verify window).  Only pages
        *beyond* the new length are released — appended tokens never
        land in shared pages (``append_tokens`` allocates private
        pages; adoption shares only FULL pages and ``fork`` copies the
        partial tail), so even a rewind that crosses page boundaries,
        follows a CoW fork, or sits next to prefix-cache-published
        pages can only pop pages this sequence privately owns."""
        alloc = self.seqs[seq_id]
        assert 0 <= n <= alloc.length, (seq_id, n, alloc.length)
        alloc.length -= n
        need = -(-alloc.length // self.page_size)
        while len(alloc.pages) > need:
            self.deref_page(alloc.pages.pop())

    # -- views -----------------------------------------------------------
    def page_table(self, seq_ids: List[int]) -> np.ndarray:
        """[len(seq_ids), pages_per_seq] int32 (0-padded)."""
        out = np.zeros((len(seq_ids), self.pages_per_seq), np.int32)
        for i, sid in enumerate(seq_ids):
            pages = self.seqs[sid].pages
            out[i, :len(pages)] = pages
        return out

    def context_lens(self, seq_ids: List[int]) -> np.ndarray:
        return np.array([self.seqs[s].length for s in seq_ids], np.int32)

    def slots(self, seq_ids: List[int]) -> np.ndarray:
        return np.array([self.seqs[s].slot for s in seq_ids], np.int32)

    @property
    def num_free_pages(self) -> int:
        return len(self.free_pages)

    @property
    def available_pages(self) -> int:
        """Free pages plus pages the prefix cache could evict on demand."""
        extra = self.evictable() if self.evictable is not None else 0
        return len(self.free_pages) + extra

    def stats(self) -> dict:
        return {"free_pages": len(self.free_pages),
                "used_pages": self.num_pages - len(self.free_pages),
                "active_seqs": len(self.seqs),
                "shared_pages": self.n_shared,
                "cow_forks": self.n_cow_forks}
