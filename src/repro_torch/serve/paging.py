"""Paged KV-cache bookkeeping for the serving engine (host side).

The device holds one flat slot pool per layer (`models.attention.
init_paged_pool`): `n_pages * page_size` token slots of KV, with NO
per-request layout baked in. This module owns the indirection that maps a
request's logical token positions onto pool slots:

  - `PageAllocator` — a free list + refcounts over pages. Page 0 is the
    reserved TRASH page: chunk rows past a request's `n_valid` scatter
    value-0 writes to slot 0, so it is pinned forever and never handed out.
    Refcounts (not ownership) because the prefix cache shares full prompt
    pages between requests — a page returns to the free list only when its
    last holder releases it.
  - Block tables — per-request page lists, position `p` of a request lives
    at flat slot `table[p // page_size] * page_size + p % page_size`.
  - `gather_plan` — the dense (B, C) `read_slots`/`slot_pos` arrays the
    chunk attention step consumes, built so that gathered column `i` holds
    logical position `i` (the contiguous-cache layout, which is what makes
    paged decode bit-identical to the legacy fixed-slot engine).

Everything here is numpy/python — shapes handed to the jitted step are
padded to static maxima by the engine, so the allocator itself never
triggers a recompile.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

TRASH_PAGE = 0


class PagesExhausted(RuntimeError):
    """Structured refusal: a request needs more KV pages than the pool can
    allocate right now. Carries the accounting so callers can shed load /
    retry instead of parsing a message (mirrors the `_kv_scales` strictness
    rule: never silently truncate a prompt)."""

    def __init__(self, *, needed: int, free: int, n_pages: int,
                 page_size: int, what: str = "request"):
        self.needed = needed
        self.free = free
        self.n_pages = n_pages
        self.page_size = page_size
        super().__init__(
            f"{what} needs {needed} KV page(s) of {page_size} tokens but "
            f"only {free} of {n_pages - 1} allocatable pages are free "
            f"(page {TRASH_PAGE} is the reserved trash page)")


class PageAllocator:
    """Free list + refcounts over `n_pages` pages of `page_size` KV slots.

    Deterministic: pages are handed out in ascending order (a sorted free
    heap), so identical request interleavings produce identical block
    tables — which the differential parity suite relies on to compare
    engines slot-for-slot.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the trash "
                             f"page), got n_pages={n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.n_slots = self.n_pages * self.page_size
        # Ascending hand-out order: keep the free list sorted descending
        # and pop from the tail.
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))
        self._ref = np.zeros(self.n_pages, np.int32)
        self._ref[TRASH_PAGE] = 1       # pinned forever

    # -- allocation -------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        """Pages currently held by at least one owner (excl. trash)."""
        return int(np.count_nonzero(self._ref[1:] > 0))

    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size) if n_tokens > 0 else 0

    def alloc(self, n: int, *, what: str = "request") -> List[int]:
        """Allocate `n` pages (refcount 1 each) or raise PagesExhausted —
        all-or-nothing, never a partial grant."""
        if n > len(self._free):
            raise PagesExhausted(needed=n, free=len(self._free),
                                 n_pages=self.n_pages,
                                 page_size=self.page_size, what=what)
        pages = [self._free.pop() for _ in range(n)]
        self._ref[pages] = 1
        return pages

    def retain(self, pages: Sequence[int]):
        for p in pages:
            if not self._ref[p] > 0:
                raise AssertionError(f"retain of dead page {p}")
            self._ref[p] += 1

    def release(self, pages: Sequence[int]):
        for p in pages:
            if p == TRASH_PAGE:
                raise AssertionError("release of the trash page")
            if not self._ref[p] > 0:
                raise AssertionError(f"double release of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                # Keep the free list sorted (descending) so hand-out order
                # stays ascending and deterministic.
                self._free.append(p)
                self._free.sort(reverse=True)

    # -- invariants (property tests) --------------------------------------

    def check(self):
        """Free-list / refcount accounting invariants; raises on violation."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages in free list")
        if TRASH_PAGE in free:
            raise AssertionError("trash page on the free list")
        live = {int(p) for p in np.nonzero(self._ref[1:] > 0)[0] + 1}
        if free & live:
            raise AssertionError(f"pages both free and live: {free & live}")
        if len(free) + len(live) != self.n_pages - 1:
            raise AssertionError(
                f"page accounting leak: {len(free)} free + {len(live)} "
                f"live != {self.n_pages - 1} allocatable")

    def stats(self) -> Dict[str, float]:
        allocatable = self.n_pages - 1
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "pages_free": self.n_free,
            "pages_live": self.n_live,
            "page_occupancy": self.n_live / max(allocatable, 1),
        }


# ---------------------------------------------------------------------------
# block-table -> dense gather plans
# ---------------------------------------------------------------------------

def flat_slots(table: Sequence[int], page_size: int, start: int,
               count: int) -> np.ndarray:
    """Flat pool slots of logical positions [start, start+count)."""
    pos = np.arange(start, start + count)
    table = np.asarray(table, np.int32)
    return (table[pos // page_size] * page_size
            + pos % page_size).astype(np.int32)


def gather_plan(tables: Sequence[Sequence[int]], lengths: Sequence[int],
                page_size: int, capacity: int):
    """(read_slots, slot_pos): (B, C) int32 gather plan for a batch.

    Gathered column `i` of request `b` holds its logical position `i`
    (`slot_pos[b, i] = i`) for i < lengths[b]; holes point at the trash
    page with slot_pos = -1, which the position mask excludes exactly.
    `capacity` is the static column count (>= max length this step).
    """
    b = len(tables)
    read = np.zeros((b, capacity), np.int32)
    spos = np.full((b, capacity), -1, np.int32)
    for i, (table, n) in enumerate(zip(tables, lengths)):
        n = min(int(n), capacity)
        if n > 0:
            read[i, :n] = flat_slots(table, page_size, 0, n)
            spos[i, :n] = np.arange(n, dtype=np.int32)
    return read, spos
