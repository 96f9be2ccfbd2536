"""Block-table (paged) KV cache allocator (copy of ``PageAllocator`` from
``repro/serving/kv_cache.py``, without the radix prefix cache).

``PageAllocator`` is the host-side control structure the engine drives:
  block_table (n_slots, max_pages) int32 page id (-1 = unmapped)
  lengths     (n_slots,) tokens written per slot
  free list   min-heap of page ids, so allocation is lowest-id-first and
              pop/push order is deterministic regardless of how request
              lifetimes interleave; per-slot page counts are tracked
              incrementally (no O(max_pages) scans on the hot path).

Allocation is a pure function of the alloc/release history, so the port's
engine maps the same pages as the reference's on the same traffic. The
device page store lives in the model (``models/model.py``
``init_paged_cache``). The prefix-cache methods (match/adopt/copy-on-write)
are ROADMAP.md work.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np
import torch


class PageAllocator:
    """Host-side block-table allocator: deterministic, O(1) bookkeeping."""

    def __init__(self, *, n_pages: int, page_size: int, n_slots: int,
                 max_len: int):
        assert page_size % 8 == 0, "page_size should be lane-aligned"
        self.page_size = page_size
        self.n_pages = n_pages
        self.n_slots = n_slots
        self.max_pages = (max_len + page_size - 1) // page_size
        self.block_table = np.full((n_slots, self.max_pages), -1, np.int32)
        self.lengths = np.zeros(n_slots, np.int32)
        # min-heap => allocation is always the lowest-numbered free page and
        # therefore a pure function of the alloc/release history
        self._free: List[int] = list(range(n_pages))
        heapq.heapify(self._free)
        # incremental per-slot page counts: the append hot path must not
        # rescan the block table per token
        self._slot_pages = np.zeros(n_slots, np.int32)

    # ----- queries -----------------------------------------------------
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def live_tokens(self) -> int:
        return int(self.lengths.sum())

    def pages_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.page_size - 1) // self.page_size

    def fragmentation(self) -> float:
        """Internal fragmentation: the fraction of allocated page capacity
        not holding a live token (partially filled tail pages)."""
        used = self.pages_in_use() * self.page_size
        return 1.0 - self.live_tokens() / used if used else 0.0

    def report(self) -> Dict[str, float]:
        """Telemetry snapshot the engine exports (``kv_stats``)."""
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "pages_in_use": self.pages_in_use(),
            "live_tokens": self.live_tokens(),
            "occupancy": self.pages_in_use() / max(self.n_pages, 1),
            "fragmentation": round(self.fragmentation(), 6),
        }

    # ----- allocation --------------------------------------------------
    def ensure_capacity(self, slot: int, new_len: int) -> int:
        """Map enough pages for ``new_len`` tokens in ``slot``. Returns the
        number of pages newly mapped by this call (0 when already covered)."""
        need = self.pages_needed(new_len)
        if need > self.max_pages:
            raise MemoryError(
                f"slot needs {need} pages > max_len capacity {self.max_pages}")
        have = int(self._slot_pages[slot])
        if need > have and need - have > len(self._free):
            raise MemoryError(
                f"paged KV cache exhausted: need {need - have} pages, "
                f"{len(self._free)} free of {self.n_pages}")
        grown = max(0, need - have)
        while have < need:
            self.block_table[slot, have] = heapq.heappop(self._free)
            have += 1
        self._slot_pages[slot] = have
        return grown

    def release(self, slot: int) -> None:
        """Unmap a slot; its pages re-enter the free heap (lowest-id-first
        reuse stays deterministic)."""
        for j in range(int(self._slot_pages[slot])):
            heapq.heappush(self._free, int(self.block_table[slot, j]))
            self.block_table[slot, j] = -1
        self._slot_pages[slot] = 0
        self.lengths[slot] = 0

    # ----- device views ------------------------------------------------
    def device_tables(self, device, rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Block table and lengths on ``device``; ``rows`` (slot indices)
        picks the rows on the host, so only those are copied."""
        bt, ln = self.block_table, self.lengths
        if rows is not None:
            bt, ln = bt[rows], ln[rows]
        return torch.from_numpy(bt).to(device), torch.from_numpy(ln).to(device)
