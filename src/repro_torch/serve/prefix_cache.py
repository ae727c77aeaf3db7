"""Exact prefix/prompt cache over paged KV (host-side bookkeeping).

Bitwise-deterministic serving (frozen per-site scales, RNE eval
quantization) means two requests with the same prompt prefix produce the
SAME KV payload bytes — so prefix reuse is exact, not approximate: a hit
splices the cached pages into the new request's block table and the decode
stream is bit-identical to a cold prefill (locked by the parity suite).

Safety rules that keep exactness without copy-on-write:
  - Only FULL pages are shared, and only pages covering at most
    `prompt_len - 1` tokens: the engine always recomputes at least the
    final prompt token (its logits seed generation), and every write a
    request ever makes lands strictly past its shared prefix, on pages it
    owns alone.
  - Entries are keyed on (scale fingerprint, exact token prefix). The
    fingerprint hashes the frozen scales, per-site formats, recipe and KV
    format — any recalibration or recipe change invalidates the cache by
    construction, because identical tokens would no longer reproduce
    identical payload bytes.
  - Pages are refcounted through the `PageAllocator`; LRU eviction
    releases the cache's hold, and the memory returns to the free list
    once the last in-flight request using those pages finishes.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.paging import PageAllocator


def scale_fingerprint(frozen_scales=None, frozen_formats=None,
                      recipe: str = "", kv_format=None) -> str:
    """Stable hash of everything that determines KV payload bytes for a
    given token prefix (beyond the weights, which are fixed per engine)."""
    h = hashlib.sha256()
    h.update(f"recipe={recipe};kv={kv_format}".encode())
    for key in sorted(frozen_scales or {}):
        h.update(f";{key}={float(frozen_scales[key]):.17g}".encode())
    for key in sorted(frozen_formats or {}):
        h.update(f";fmt:{key}={frozen_formats[key]}".encode())
    return h.hexdigest()


class PrefixCache:
    """LRU map: (fingerprint, token-prefix) -> list of full KV pages."""

    def __init__(self, allocator: PageAllocator, fingerprint: str,
                 max_entries: int = 128):
        self.alloc = allocator
        self.fingerprint = fingerprint
        self.max_entries = max_entries
        self._entries: "OrderedDict[Tuple, List[int]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def _key(self, tokens: Sequence[int]) -> Tuple:
        return (self.fingerprint, tuple(int(t) for t in tokens))

    def shareable_pages(self, prompt_len: int) -> int:
        """Longest cacheable prefix of a prompt, in full pages, leaving at
        least the final token to recompute."""
        if prompt_len <= 1:
            return 0
        return (prompt_len - 1) // self.alloc.page_size

    def lookup(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached full-page prefix of `prompt`. Returns
        (pages, n_tokens) with the pages RETAINED for the caller (the new
        request now co-owns them); ([], 0) on miss."""
        for m in range(self.shareable_pages(len(prompt)), 0, -1):
            n_tok = m * self.alloc.page_size
            key = self._key(prompt[:n_tok])
            pages = self._entries.get(key)
            if pages is not None:
                self._entries.move_to_end(key)
                self.alloc.retain(pages)
                self.hits += 1
                return list(pages), n_tok
        self.misses += 1
        return [], 0

    def insert(self, prompt: Sequence[int], table: Sequence[int]):
        """Offer a freshly prefilled request's full prompt pages. The cache
        retains its own reference on the shared prefix; no-ops when the
        prefix is already cached or too short for a full page."""
        m = self.shareable_pages(len(prompt))
        if m == 0:
            return
        n_tok = m * self.alloc.page_size
        key = self._key(prompt[:n_tok])
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        pages = [int(p) for p in table[:m]]
        self.alloc.retain(pages)
        self._entries[key] = pages
        while len(self._entries) > self.max_entries:
            self._evict_one()

    def _evict_one(self) -> bool:
        if not self._entries:
            return False
        _, pages = self._entries.popitem(last=False)   # LRU
        self.alloc.release(pages)
        return True

    def evict_for(self, n_pages: int) -> bool:
        """Shed LRU entries until the allocator has `n_pages` free (or the
        cache is empty). Returns True if the target was reached. Note a
        released page only becomes free once no in-flight request holds
        it, so eviction is best-effort under sharing."""
        while self.alloc.n_free < n_pages:
            if not self._evict_one():
                return self.alloc.n_free >= n_pages
        return True

    def clear(self):
        while self._evict_one():
            pass

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "prefix_cache_entries": len(self._entries),
            "prefix_cache_hits": self.hits,
            "prefix_cache_misses": self.misses,
            "prefix_cache_hit_rate": self.hits / total if total else 0.0,
        }
