"""Prompt prefix cache over the block-paged KV pool.

Counterpart of ``deeplearning4j_tpu/serving/prefix_cache.py`` (host
only). Each entry maps a full-block prompt prefix to the pool page that
holds its last block's K/V, keyed by ``(parent entry id, block tokens)``:
entry ids are never reused, so a key pins the whole prefix without
storing it, and a lookup walks block by block from the root.

On a hit the engine maps the matched pages into the new slot's table
(refcount + 1, read-only by convention) and primes only the suffix from
the block boundary. A slot never writes into a shared page: its writes
land at positions at or past its prompt end, and full prompt blocks end
at or before it. At least one prompt token is always re-primed, so the
admission draw has a freshly computed distribution. Causal attention
makes a prefix's K/V a function of the prefix tokens alone, so cache-on
output equals cache-off output.

Eviction is LRU; an entry is evictable once no slot maps its page (pool
refcount 1, the cache's own). The fleet's content digests come with the
fleet layer (ROADMAP.md A10).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple

from deeplearning4j_tpu_torch.serving.paging import PagePool

__all__ = ["PrefixCache"]


class PrefixCache:
    """Full-block prompt prefix cache over a :class:`PagePool`."""

    #: root parent id; entry ids start at 1 and are never reused
    _ROOT = 0

    def __init__(self, pool: PagePool):
        self._pool = pool
        self._ps = pool.page_size
        #: (parent entry id, block token tuple) -> (page id, entry id)
        self._entries: "OrderedDict[tuple, Tuple[int, int]]" = OrderedDict()
        self._next_id = 1
        self.hits = 0          # requests that reused >= 1 block
        self.misses = 0        # requests that reused none
        self.reused_tokens = 0  # prompt tokens whose prime was skipped

    def __len__(self) -> int:
        return len(self._entries)

    def _block(self, prompt, i: int) -> tuple:
        return tuple(prompt[i * self._ps:(i + 1) * self._ps])

    def lookup(self, prompt: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached full-block prefix of `prompt`, capped so at
        least one prompt token remains for the suffix prime. Returns
        ``(n_tokens_matched, page_ids)`` and counts a hit or miss; the
        caller retains the returned pages."""
        limit = (len(prompt) - 1) // self._ps
        pages: List[int] = []
        parent = self._ROOT
        for i in range(limit):
            key = (parent, self._block(prompt, i))
            ent = self._entries.get(key)
            if ent is None:
                break
            self._entries.move_to_end(key)   # LRU touch, parent first
            pages.append(ent[0])
            parent = ent[1]
        if pages:
            self.hits += 1
            self.reused_tokens += len(pages) * self._ps
        else:
            self.misses += 1
        return len(pages) * self._ps, pages

    def insert(self, prompt: Sequence[int], table: Sequence[int]) -> None:
        """Register every full block of a just-primed prompt (`table` =
        the slot's block-ordered pages). New entries take a cache
        reference on the slot's page, which then outlives the request."""
        parent = self._ROOT
        for i in range(len(prompt) // self._ps):
            key = (parent, self._block(prompt, i))
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                parent = ent[1]
                continue
            page = table[i]
            self._pool.retain(page)
            ent_id = self._next_id
            self._next_id += 1
            self._entries[key] = (page, ent_id)
            parent = ent_id

    def evictable_pages(self) -> int:
        """Pages reclaimable right now (entries no slot maps)."""
        return sum(1 for ent in self._entries.values()
                   if self._pool.refcount(ent[0]) == 1)

    def evict(self, n_pages: int) -> int:
        """Free up to `n_pages` pages, oldest entries first, skipping
        entries a slot still maps. Returns pages freed."""
        freed = 0
        for key in list(self._entries):
            if freed >= n_pages:
                break
            page = self._entries[key][0]
            if self._pool.refcount(page) != 1:
                continue
            del self._entries[key]
            self._pool.release(page)
            freed += 1
        return freed
