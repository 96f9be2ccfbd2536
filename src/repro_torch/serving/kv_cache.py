"""Block-table (paged) KV cache allocator (copy of ``PageAllocator`` from
``repro/serving/kv_cache.py``, radix prefix cache included).

``PageAllocator`` is the host-side control structure the engine drives:
  block_table (n_slots, max_pages) int32 page id (-1 = unmapped)
  lengths     (n_slots,) tokens written per slot
  free list   min-heap of page ids, so allocation is lowest-id-first and
              pop/push order is deterministic regardless of how request
              lifetimes interleave; per-slot page counts are tracked
              incrementally (no O(max_pages) scans on the hot path).

With ``prefix_cache=True`` the allocator is also a **radix prefix cache**
(DESIGN.md §13): every FULL page of prompt tokens is keyed by a blake2b
hash chained on its parent page's key, so a page's key encodes its whole
prefix and a flat dict is the radix tree. Pages are refcounted (slot
holds); a slot that adopts indexed pages shares them read-only, and a
write into a shared page goes through copy-on-write (``prepare_append``).
Released prompt pages whose refcount reaches zero are retained in the
index (an LRU of "cached" pages) and evicted oldest-first under
allocation pressure. A page freshly allocated is *owned* by (charged to)
its slot's admission reservation; an adopted page whose owner released
is *pinned*, and the engine's admission gate counts ``pinned`` beside the
committed reservations, so shared pages are paid for exactly once.

Allocation and indexing are a pure function of the op history, so the
port's engine maps the same pages as the reference's on the same traffic.
The device page store lives in the model (``models/model.py``
``init_paged_cache``); the engine copies a page for copy-on-write.
"""
from __future__ import annotations

import hashlib
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class PageAllocator:
    """Host-side block-table allocator: deterministic, O(1) bookkeeping."""

    def __init__(self, *, n_pages: int, page_size: int, n_slots: int,
                 max_len: int, prefix_cache: bool = False,
                 kv_salt: str = ""):
        assert page_size % 8 == 0, "page_size should be lane-aligned"
        self.page_size = page_size
        self.n_pages = n_pages
        self.n_slots = n_slots
        self.max_pages = (max_len + page_size - 1) // page_size
        self.block_table = np.full((n_slots, self.max_pages), -1, np.int32)
        self.lengths = np.zeros(n_slots, np.int32)
        # min-heap => allocation is always the lowest-numbered free page and
        # therefore a pure function of the alloc/release history, never of
        # list-order accidents (reuse order used to depend on interleaving)
        self._free: List[int] = list(range(n_pages))
        heapq.heapify(self._free)
        # incremental per-slot page counts: the append hot path must not
        # rescan the block table per token
        self._slot_pages = np.zeros(n_slots, np.int32)
        # ----- radix prefix cache (DESIGN.md §13) ----------------------
        self.prefix_cache = prefix_cache
        # blake2b, NOT hash(): the chain keys must be identical across
        # PYTHONHASHSEEDs (SPL003) and across processes, and 128-bit
        # digests make a content collision — which would serve another
        # prompt's KV — practically impossible. The salt folds in the KV
        # dtype/quant mode so an int8 page can never satisfy an fp chain.
        self._root = hashlib.blake2b(
            f"{kv_salt}/{page_size}".encode(), digest_size=16).digest()
        self._index: Dict[bytes, int] = {}       # chain hash -> page id
        self._page_hash: Dict[int, bytes] = {}   # page id -> chain hash
        # ref-0 indexed pages, insertion-ordered = LRU (oldest first);
        # values unused (dict-as-ordered-set keeps pops deterministic)
        self._cached: Dict[int, None] = {}
        # slot holds per page; the index itself holds no refcount — a
        # cached page is exactly (refcount 0, indexed)
        self.refcount = np.zeros(n_pages, np.int32)
        # slot whose admission reservation the page is charged to; -1 for
        # adopted-only (pinned), cached, and free pages
        self._owner = np.full(n_pages, -1, np.int32)
        # active pages charged to NO reservation (owner released, adopters
        # remain): the engine's admission gate adds this to _committed
        self.pinned = 0
        # telemetry
        self.pages_adopted = 0
        self.cow_copies = 0
        self.cache_evictions = 0
        self.shared_peak = 0

    # ----- queries -----------------------------------------------------
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def free_pages(self) -> int:
        return len(self._free)

    def cached_pages(self) -> int:
        """Indexed pages with no live holder — retained for future prefix
        hits, reclaimed LRU-first under allocation pressure."""
        return len(self._cached)

    def reclaimable_pages(self) -> int:
        """Pages an allocation can actually obtain: free + cached."""
        return len(self._free) + len(self._cached)

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
        """Telemetry snapshot the engine exports (serving/engine.py
        ``kv_stats``)."""
        rep = {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "pages_in_use": self.pages_in_use(),
            "live_tokens": self.live_tokens(),
            "occupancy": self.pages_in_use() / max(self.n_pages, 1),
            "fragmentation": round(self.fragmentation(), 6),
        }
        if self.prefix_cache:
            rep.update(cached_pages=self.cached_pages(),
                       pinned_pages=self.pinned,
                       pages_adopted=self.pages_adopted,
                       cow_copies=self.cow_copies,
                       cache_evictions=self.cache_evictions,
                       shared_pages_peak=self.shared_peak)
        return rep

    # ----- allocation --------------------------------------------------
    def _alloc_page(self) -> int:
        """One free page id — reclaiming the LRU cached page when the heap
        is dry (its index entry dies with it; any chain suffix hanging off
        it becomes unreachable and ages out the same way)."""
        if self._free:
            return heapq.heappop(self._free)
        if self._cached:
            pid = next(iter(self._cached))
            del self._cached[pid]
            del self._index[self._page_hash.pop(pid)]
            self.cache_evictions += 1
            return pid
        raise MemoryError("paged KV cache exhausted")

    def ensure_capacity(self, slot: int, new_len: int) -> int:
        """Map enough pages for ``new_len`` tokens in ``slot``. Returns the
        number of pages newly mapped by this call (0 when already covered)
        so callers — e.g. the engine's per-chunk page growth — can account
        for incremental allocation."""
        need = self.pages_needed(new_len)
        if need > self.max_pages:
            raise MemoryError(
                f"slot needs {need} pages > max_len capacity {self.max_pages}")
        have = int(self._slot_pages[slot])
        if need > have and need - have > self.reclaimable_pages():
            raise MemoryError(
                f"paged KV cache exhausted: need {need - have} pages, "
                f"{self.reclaimable_pages()} reclaimable of {self.n_pages}")
        grown = max(0, need - have)
        while have < need:
            pid = self._alloc_page()
            self.block_table[slot, have] = pid
            self.refcount[pid] = 1
            self._owner[pid] = slot
            have += 1
        self._slot_pages[slot] = have
        return grown

    def _drop_hold(self, slot: int, pid: int) -> None:
        """Release one slot's hold on one page, with the owner/pinned and
        cached/free transitions (the single place refcounts go down)."""
        self.refcount[pid] -= 1
        r = int(self.refcount[pid])
        if int(self._owner[pid]) == slot:
            self._owner[pid] = -1
            if r > 0:
                # remaining holders adopted it: active but charged to no
                # reservation — the admission gate must count it
                self.pinned += 1
        elif int(self._owner[pid]) == -1 and r == 0:
            self.pinned -= 1
        if r == 0:
            if pid in self._page_hash:
                self._cached[pid] = None        # retained: future hits
            else:
                heapq.heappush(self._free, int(pid))

    def release(self, slot: int) -> None:
        """Unmap a slot: every hold is *decremented*, never blindly freed
        — shared pages survive their co-holders, and indexed pages whose
        refcount reaches zero are retained as cached (prefix_cache) or
        re-enter the free heap (plain paging; lowest-id-first reuse stays
        deterministic)."""
        for j in range(int(self._slot_pages[slot])):
            self._drop_hold(slot, int(self.block_table[slot, j]))
            self.block_table[slot, j] = -1
        self._slot_pages[slot] = 0
        self.lengths[slot] = 0

    # ----- radix prefix cache (DESIGN.md §13) --------------------------
    def _chain_hashes(self, token_ids: Sequence[int]) -> List[bytes]:
        """Chain key per FULL page of ``token_ids``: page j's key digests
        (parent key, page-j tokens), so equal keys imply equal whole
        prefixes — partial tail pages are never keyed (their content would
        change under every append)."""
        out: List[bytes] = []
        h = self._root
        ps = self.page_size
        for j in range(len(token_ids) // ps):
            chunk = b"".join(
                int(t).to_bytes(8, "little", signed=True)
                for t in token_ids[j * ps:(j + 1) * ps])
            h = hashlib.blake2b(h + chunk, digest_size=16).digest()
            out.append(h)
        return out

    def match_prefix(self, token_ids: Sequence[int]
                     ) -> Tuple[int, List[int], int]:
        """Longest indexed full-page prefix of ``token_ids``: returns
        (pages matched, their page ids, how many of them are currently
        cached ref-0 — i.e. would become *pinned* if adopted, which the
        engine's admission gate must budget for). Pure query: no state
        changes."""
        if not self.prefix_cache:
            return 0, [], 0
        pids: List[int] = []
        newly_pinned = 0
        for h in self._chain_hashes(token_ids):
            pid = self._index.get(h)
            if pid is None:
                break
            pids.append(pid)
            if int(self.refcount[pid]) == 0:
                newly_pinned += 1
        return len(pids), pids, newly_pinned

    def adopt(self, slot: int, page_ids: Sequence[int]) -> None:
        """Map an indexed page chain into ``slot``'s block table, sharing
        the pages (incref; zero new pages, zero prefill FLOPs for the
        span). The slot must be empty. Cached pages leave the LRU and
        become pinned; pages still held by their allocator just gain a
        reader."""
        assert int(self._slot_pages[slot]) == 0, "adopt into a mapped slot"
        for j, pid in enumerate(page_ids):
            if int(self.refcount[pid]) == 0:
                self._cached.pop(pid, None)
                self.pinned += 1                 # active, owned by no one
            self.refcount[pid] += 1
            self.block_table[slot, j] = pid
        self._slot_pages[slot] = len(page_ids)
        self.pages_adopted += len(page_ids)
        self.shared_peak = max(self.shared_peak,
                               int((self.refcount > 1).sum()))

    def register_prefix(self, slot: int, token_ids: Sequence[int]) -> int:
        """Index ``slot``'s full prompt pages under their chain keys (after
        the prompt K/V has been written). First registration wins: a key
        already present keeps its page (the slot keeps its private copy and
        future requests dedup against the incumbent). Returns pages newly
        indexed."""
        if not self.prefix_cache:
            return 0
        new = 0
        for j, h in enumerate(self._chain_hashes(token_ids)):
            if h in self._index:
                continue
            pid = int(self.block_table[slot, j])
            if pid < 0 or pid in self._page_hash:
                break
            self._index[h] = pid
            self._page_hash[pid] = h
            new += 1
        return new

    def prepare_append(self, slot: int, pos: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write gate for a write at position ``pos``: if the page
        holding it is shared (refcount > 1, or adopted — not owned by this
        slot), remap the slot onto a fresh page and return (src, dst) so
        the caller copies the shared contents device-side BEFORE the write.
        An exclusively-owned page that is merely indexed is de-indexed in
        place (its content is about to change; no copy needed). Returns
        None when the write needs nothing."""
        j = pos // self.page_size
        if j >= int(self._slot_pages[slot]):
            return None                          # will be freshly mapped
        pid = int(self.block_table[slot, j])
        if pid < 0:
            return None
        if int(self.refcount[pid]) == 1 and int(self._owner[pid]) == slot:
            h = self._page_hash.pop(pid, None)
            if h is not None:
                del self._index[h]
            return None
        npid = self._alloc_page()
        self.block_table[slot, j] = npid
        self.refcount[npid] = 1
        self._owner[npid] = slot
        self.cow_copies += 1
        self._drop_hold(slot, pid)
        return pid, npid

    def invalidate_slot(self, slot: int) -> int:
        """Drop ``slot``'s OWNED pages from the index (quarantine path:
        their content is suspect and must never serve a future hit).
        Adopted pages stay indexed — this slot never wrote them (COW
        guarantees it), so their content is not implicated. Returns pages
        de-indexed."""
        n = 0
        for j in range(int(self._slot_pages[slot])):
            pid = int(self.block_table[slot, j])
            if pid >= 0 and int(self._owner[pid]) == slot:
                h = self._page_hash.pop(pid, None)
                if h is not None:
                    del self._index[h]
                    self._cached.pop(pid, None)
                    n += 1
        return n

    def exclusive_pages(self, slot: int) -> np.ndarray:
        """Per-table-entry mask of pages this slot may mutate wholesale
        (refcount 1, owned, unindexed) — the lane-fill paths (poison /
        scrub) must not touch shared or cached-index pages."""
        out = np.zeros(self.max_pages, bool)
        for j in range(int(self._slot_pages[slot])):
            pid = int(self.block_table[slot, j])
            out[j] = (pid >= 0 and int(self.refcount[pid]) == 1
                      and int(self._owner[pid]) == slot
                      and pid not in self._page_hash)
        return out

    # ----- device views ------------------------------------------------
    def device_tables(self, device, rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Block table and lengths on ``device``; ``rows`` (slot indices)
        picks the rows on the host, so only those are copied."""
        bt, ln = self.block_table, self.lengths
        if rows is not None:
            bt, ln = bt[rows], ln[rows]
        return torch.from_numpy(bt).to(device), torch.from_numpy(ln).to(device)
