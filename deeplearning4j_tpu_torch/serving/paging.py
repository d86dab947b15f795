"""Block-paged KV storage for the generation engine.

Counterpart of ``deeplearning4j_tpu/serving/paging.py``. The
authoritative KV storage is a page pool: per attention leaf, a
``[P, Hkv, page_size, D]`` tensor of fixed-size token pages, plus one
per-slot page table mapping the slot's token blocks to pool pages.
Capacity is a token budget: admission checks a request's worst-case
pages against the free pages, retirement returns them at once, and
pages are refcounted so the prefix cache can map one page into many
slots' tables read-only.

Decode runs directly on the pool (``direct=True``): the attention layer
appends each step's K/V in place at ``(page, offset)`` and reads through
the table with the paged-attention kernel. ``gather_pages`` serves the
prefix cache's one-row installs.

Page 0 is the reserved null page: table entries past a slot's
allocation point at it, so reads there are masked by length and stray
writes land where nothing is read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

__all__ = ["PageExhausted", "PagePool", "PagedKVConfig", "gather_pages",
           "pages_needed"]


class PageExhausted(RuntimeError):
    """The pool cannot satisfy an allocation (admission should have
    head-blocked: reaching this mid-admission is an engine bug)."""


@dataclass
class PagedKVConfig:
    """Knobs for the block-paged arena.

    ``page_size`` tokens per page; capacity ``total_pages``, defaulting
    to the slot arena's worst case (slots × ceil(L / page_size)).
    ``prefix_cache`` enables shared-prompt page reuse. ``kv_dtype="bf16"``
    keeps the net's own KV dtype (the name of the unquantized path, not
    a cast). The int8 pool (ROADMAP.md B6) and the legacy gather/scatter
    round trip (``direct=False``, ROADMAP.md A7) are not ported yet and
    raise."""

    page_size: int = 8
    total_pages: Optional[int] = None
    prefix_cache: bool = True
    direct: bool = True
    kv_dtype: str = "bf16"

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got "
                             f"{self.page_size}")
        if self.kv_dtype in ("int8", "auto"):
            raise NotImplementedError(
                f"kv_dtype={self.kv_dtype!r}: the int8 KV pool is not "
                f"ported yet (ROADMAP.md B6)")
        if self.kv_dtype != "bf16":
            raise ValueError(f"kv_dtype must be 'bf16', got "
                             f"{self.kv_dtype!r}")
        if not self.direct:
            raise NotImplementedError(
                "direct=False (the legacy gather/scatter round trip) is "
                "not ported (ROADMAP.md A7)")
        if self.total_pages is not None and self.total_pages < 1:
            raise ValueError(f"total_pages must be >= 1, got "
                             f"{self.total_pages}")

    def resolve_pages(self, slots: int, n_max: int) -> int:
        if self.total_pages is not None:
            return int(self.total_pages)
        return int(slots) * int(n_max)


def pages_needed(total_tokens: int, page_size: int) -> int:
    """Pages a request holding `total_tokens` KV positions needs (the
    final drawn token is never fed back, so a request of want = prompt +
    steps ids stores want - 1 positions: callers pass that)."""
    return max(1, -(-int(total_tokens) // int(page_size)))


class PagePool:
    """Host-side page accounting: free list and per-page refcounts.
    Pages allocate in LIFO order, so a replayed trace maps the same
    physical pages. ``alloc`` hands pages out at refcount 1;
    ``retain``/``release`` adjust for more holders (the prefix cache,
    slots sharing a page); a page returns to the free list at 0."""

    def __init__(self, total_pages: int, page_size: int):
        if total_pages < 2:
            raise ValueError(
                f"need >= 2 pages (page 0 is the reserved null page), "
                f"got {total_pages}")
        self.page_size = int(page_size)
        self.total_pages = int(total_pages)
        #: allocatable pages (page 0 reserved)
        self.usable = self.total_pages - 1
        self._free: List[int] = list(range(self.total_pages - 1, 0, -1))
        self._ref = [0] * self.total_pages

    def free_count(self) -> int:
        return len(self._free)

    def used_count(self) -> int:
        return self.usable - len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PageExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"(pool of {self.usable})")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def retain(self, page: int) -> None:
        if self._ref[page] < 1:
            raise ValueError(f"retain of unallocated page {page}")
        self._ref[page] += 1

    def release(self, page: int) -> None:
        if self._ref[page] < 1:
            raise ValueError(f"release of unallocated page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)


def gather_pages(pools, table: torch.Tensor, *, length: int):
    """Dense per-slot views of the pool: for each leaf
    ``[P, Hkv, ps, D]``, gather ``table`` (``[S, n_max]`` page ids) into
    ``[S, Hkv, n_max*ps, D]`` cut to ``length``. Unmapped blocks read the
    null page, which position masks keep invisible."""
    out = []
    for pool in pools:
        _, h, _, d = pool.shape
        g = pool[table.long()].transpose(1, 2)      # [S, Hkv, n, ps, D]
        out.append(g.reshape(g.shape[0], h, -1, d)[:, :, :length])
    return out
