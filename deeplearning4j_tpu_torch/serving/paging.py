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
the table with the paged-attention kernel, the bf16 one or, for an int8
pool (``kv_dtype="int8"``, ``serving/quant.py``), the int8 one.
``gather_pages`` serves the prefix cache's one-row installs of a bf16
pool.

Page 0 is the reserved null page: table entries past a slot's
allocation point at it, so reads there are masked by length and stray
writes land where nothing is read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.serving.quant import KV_DTYPES

__all__ = ["PageExhausted", "PagePool", "PagedKVConfig", "gather_pages",
           "pages_needed"]


class PageExhausted(RuntimeError):
    """The pool cannot satisfy an allocation (admission should have
    head-blocked: reaching this mid-admission is an engine bug)."""


@dataclass
class PagedKVConfig:
    """Knobs for the block-paged arena.

    ``page_size`` tokens per page; capacity from ``total_pages``,
    ``total_tokens`` (rounded down to whole pages) or ``total_bytes`` (a
    byte budget the engine divides by the per-page cost of the net's kv
    leaves, int8 scale sidecars included, so the same budget buys about
    twice the pages under int8), at most one of them; by default the
    slot arena's worst case (slots x ceil(L / page_size)).
    ``prefix_cache`` enables shared-prompt page reuse.

    ``kv_dtype`` is the pool's storage: ``"bf16"`` keeps the net's own
    KV dtype (the name of the unquantized path, not a cast); ``"int8"``
    stores symmetric per-(page, kv-head) int8 with a ``[P, Hkv]`` scale
    sidecar per leaf (``serving/quant.py``: quantized once on write,
    read by the int8 paged-decode kernel); ``"auto"`` takes int8 only
    where the measured ``paged_decode_quant`` store entry for this
    engine's shape, on its device, says int8 won
    (``tuning/plan.resolve_kv_dtype``): uncalibrated runs stay bf16.
    The legacy gather/scatter round trip (``direct=False``, ROADMAP.md
    A7) and the choice of decode read path (``decode_impl``: the port
    reads through its kernels only, ROADMAP.md A.1) are not ported and
    raise."""

    page_size: int = 8
    total_pages: Optional[int] = None
    total_tokens: Optional[int] = None
    total_bytes: Optional[int] = None
    prefix_cache: bool = True
    direct: bool = True
    kv_dtype: str = "bf16"
    decode_impl: Optional[str] = None

    def __post_init__(self):
        if self.decode_impl is not None:
            raise NotImplementedError(
                f"decode_impl={self.decode_impl!r}: the port has one decode "
                f"read path on the card, its kernels (ROADMAP.md A.1)")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got "
                             f"{self.page_size}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                             f"{self.kv_dtype!r}")
        if self.kv_dtype != "bf16" and not self.direct:
            raise ValueError(
                "kv_dtype='int8'/'auto' needs direct=True: the legacy "
                "gather/scatter round trip has no quantized read path")
        if not self.direct:
            raise NotImplementedError(
                "direct=False (the legacy gather/scatter round trip) is "
                "not ported (ROADMAP.md A7)")
        given = [k for k in ("total_pages", "total_tokens", "total_bytes")
                 if getattr(self, k) is not None]
        if len(given) > 1:
            raise ValueError(f"give at most one capacity knob, got {given}")
        if self.total_pages is not None and self.total_pages < 1:
            raise ValueError(f"total_pages must be >= 1, got "
                             f"{self.total_pages}")
        if self.total_tokens is not None and \
                self.total_tokens < self.page_size:
            raise ValueError(f"total_tokens {self.total_tokens} is less "
                             f"than one page ({self.page_size} tokens)")
        if self.total_bytes is not None and self.total_bytes < 1:
            raise ValueError(f"total_bytes must be >= 1, got "
                             f"{self.total_bytes}")

    def resolve_pages_bytes(self, page_bytes: int) -> int:
        """Pages the ``total_bytes`` budget buys at ``page_bytes`` a page
        (``quant.kv_page_bytes`` of the net's kv leaves)."""
        n = int(self.total_bytes) // max(1, int(page_bytes))
        if n < 1:
            raise ValueError(f"total_bytes {self.total_bytes} buys no page "
                             f"({page_bytes} bytes/page)")
        return n

    def resolve_pages(self, slots: int, n_max: int) -> int:
        if self.total_pages is not None:
            return int(self.total_pages)
        if self.total_tokens is not None:
            return int(self.total_tokens) // self.page_size
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
