"""Slot-based continuous-batching inference engine over a dense or paged
KV store (counterpart of ``repro/serving/engine.py``).

A fixed set of ``n_slots`` slots. **Dense layout** (``paged=False``, the
reference's default): every slot owns ``max_len`` rows of K/V and their
positions, plus a sink row that no slot owns, where pad rows write. Queued
requests are admitted into free slots, FIFO. **Paged layout**
(``paged=True``): K/V live in pages of a shared store, mapped per slot by a
block table, and queued requests are admitted while their worst-case page
reservation fits the page budget.

On an idle engine admitted requests are prefilled as whole prompts in
batches grouped by padded length (the prompt K/V is written straight into
the slots' rows or pages; prefill attention runs the hand-written CUDA
flash kernel on the card). Admitted requests are then
decoded in blocks of up to ``decode_block`` steps. Within a block
every step runs on the device with no host round trip: per-lane
positions, last tokens, generation counters and the live mask are device
tensors, and the finish rule (EOS, token budget, KV cap) is applied
in-block. The host reads the block's tokens back with ONE device-to-host
copy per block. The block length shrinks to the soonest deterministic
finish (``_pick_k``), so a freed slot is refilled at the earliest step it
can matter. Paged decode attention runs the hand-written CUDA
paged-attention kernel on the card (``kernels/ops.py``); dense decode
attention is the reference's plain ``_sdpa`` over each lane's row, in
PyTorch on the card too. A CPU engine runs the kernels' plain versions.
On a dense engine every lane of a block writes its K/V at its position,
dead or not, as in the reference; a bucket smaller than ``n_slots`` reads
and writes its lanes' rows in place, its pad rows the sink row.

**Chunked prefill** (``prefill_chunk > 0``): a request that arrives while
lanes decode is not prefilled in a whole-prompt stall. It is admitted as a
chunk task, and each step of the next blocks runs the decode step of
every lane plus one ``prefill_chunk``-token chunk pass of its prompt
(``models.model.prefill_chunk_step``; a pass past the last chunk has
length 0 and writes only the sink row or the trash page), with pages
mapped per chunk on a paged engine.
The final chunk's first token and the lane's flip to live stay on the
device, so first tokens arrive through the same one copy per block.

**Radix prefix cache** (``prefix_cache=True`` on a paged engine; a dense
engine keeps none, as in the reference; DESIGN.md §13): the
allocator indexes every full prompt page under a key chained on its
prefix. A queued request whose prompt starts with indexed pages (Sprout's
directive system prompt is the same at the head of every request of a
level) adopts those pages instead of prefilling them: it is admitted as a
chunk task, even on an idle engine, whose first chunk starts past the
shared span (``page_size``-token chunks when ``prefill_chunk`` is 0), and
its admission charge leaves the adopted pages out. A write into a shared
page (only the one-token recompute of a fully cached page-aligned prompt
makes one) first copies the page (``_copy_page``) onto a fresh one.
``FinishedRequest.cached_tokens`` carries the skipped span to the
gateway's Eq. 1 credit.

**Sampling** (``SamplingParams`` per request: greedy, temperature,
top-k/top-p): greedy and sampled requests decode in one batch. The host
picks the block's sampler from the bucket's rows (``greedy``: argmax, no
sampler; ``temp``: temperature only, no sort; ``full``: top-k/top-p too),
and the draws follow jax's threefry key stream (``serving/prng.py``) as
the reference's do: the host key is split once per prefill group and once
per block, greedy ones included; inside a block each step splits the
carried key, and a row folds by its slot id in a bucket smaller than
``n_slots`` (by lane position otherwise), so a seeded run draws the
reference's tokens.

**Entry points** (``entry_points``, the reference's table of compiled
programs, under its names): a decode block is
``decode_bs{N}_k{K}_{greedy|temp|full}``, a block that also streams chunks
``mixed_bs{N}_k{K}_c{C}_{mode}``, a whole-prompt prefill group
``prefill_bs{N}_p{P}`` (its first tokens drawn inside). Lanes are padded
to a power-of-two bucket of rows and prefill groups to a power-of-two
batch, as in the reference, so few shapes exist. No entry branches on a
host value: every per-dispatch value (tokens, positions, counters,
block-table rows, chunk arrays, the chunk lane, sampling parameters and
the block's key) is an input tensor. On a CUDA engine each entry is a
CUDA graph, captured at its first use and replayed after
(``serving/graphs.py``); on a CPU engine it runs eagerly.

Host bookkeeping (admission, page growth, chunk schedule, finish order,
block tables) follows the reference line for line, so on the same traffic
the port fills the same rows or maps the same pages and emits the same
tokens, greedy or seeded.

**Faults** (DESIGN.md §12): ``poison_lane`` fills a lane's K/V with NaN
(its row on a dense store, its exclusive pages on a page store), so the
next block's logits for that lane are truly non-finite. Each step of a
block folds ``isfinite(logits)`` into a sticky per-lane verdict (dead
lanes do not count; a dispatched chunk pass counts for its lane), which
leaves the graph with the block's one device-to-host copy. The host then
quarantines a lane whose verdict is False: its tokens stay on the request
for the waste ledger, its K/V is scrubbed to 0, its slot and pages are
released, and the request goes to ``faulted`` for the scheduler's
bounded-retry requeue. Every fill runs in place between blocks, since the
captured graphs hold the store's addresses. Still to port (ROADMAP.md):
tensor parallelism.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import model as MD
from repro_torch.models.common import ModelConfig, resolve_device
from repro_torch.serving import prng
from repro_torch.serving.graphs import Entry, GraphPool
from repro_torch.serving.kv_cache import PageAllocator
from repro_torch.serving.sampler import (SamplingParams, greedy_sample,
                                         sample_logits_batched,
                                         sample_temperature_only)
from repro_torch.serving.tokenizer import ByteTokenizer


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@dataclasses.dataclass
class RequestState:
    rid: int
    prompt_ids: List[int]
    max_new_tokens: int
    sampling: SamplingParams
    directive_level: int = 0
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    prompt_len: int = 0
    done: bool = False
    # t_submit is the ORIGINAL submission time: preserved across failover
    # requeue (engine.submit accepts it), so latency is end to end
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    tenant: str = ""
    deadline_at: float = float("inf")
    priority: int = 1
    retries: int = 0
    last_fault: str = ""
    # decode-only seconds attributed to THIS request: each decode block's
    # wall time is partitioned per step across the slots decoding in it
    decode_s: float = 0.0
    # the exact page count this request was charged at admission (with the
    # prefix cache it depends on the cache's state then); every release
    # site repays this stored amount
    reserved_pages: int = 0
    # prompt tokens served from the radix prefix cache (prefill skipped);
    # reported on FinishedRequest so Eq. 1 accounting can credit them
    cached_tokens: int = 0


@dataclasses.dataclass
class _ChunkTask:
    """An admitted request still prefilling: its prompt streams into the
    decode blocks ``chunk`` tokens per step; ``next`` is the first prompt
    position not yet dispatched (past the adopted span on a prefix hit)."""
    slot: int
    ids: List[int]
    plen: int
    next: int = 0
    chunk: int = 0


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    token_ids: List[int]
    text: str
    prompt_tokens: int
    gen_tokens: int
    ttft_s: float
    latency_s: float
    directive_level: int
    decode_s: float = 0.0
    tenant: str = ""
    deadline_at: float = float("inf")
    t_done: float = 0.0
    retries: int = 0
    cached_tokens: int = 0  # prompt tokens served from the prefix cache

    @property
    def slo_met(self) -> bool:
        """Did this request finish by its deadline? (True when untagged.)"""
        return self.t_done <= self.deadline_at


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 4,
                 max_len: int = 256, eos_id: int = ByteTokenizer.EOS,
                 tokenizer: Optional[ByteTokenizer] = None, seed: int = 0,
                 decode_block: int = 8, paged: bool = False,
                 page_size: int = 32, n_pages: Optional[int] = None,
                 kv_int8: bool = False, paged_impl: str = "auto",
                 prefill_chunk: int = 0, prefix_cache: bool = False,
                 tp_degree: int = 1, device="cuda"):
        """Same signature as the reference engine plus ``device``.
        ``seed`` makes the host PRNG key (``prng.PRNGKey``, on the CPU)
        from which every sampled token is drawn. ``params`` must already
        live on ``device``; the KV store is allocated once and never
        replaced, since every captured entry writes it in place."""
        if tp_degree > 1:
            raise NotImplementedError(
                "tp_degree > 1: not in the port yet (ROADMAP.md, modules "
                "still to port: tensor-parallel decode)")
        if paged_impl != "auto":
            raise ValueError("paged_impl: the port dispatches decode attention "
                             "by tensor device; only 'auto' is accepted")
        if decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got {decode_block}")
        if kv_int8:
            cfg = cfg.replace(kv_cache_dtype="int8")
        self.device = resolve_device(device)
        weights_dev = params["embed"]["tok"].device
        if weights_dev != self.device:
            raise ValueError(f"params live on {weights_dev}, engine device is "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        # the gateway's migration planner reads the layout, as on the
        # reference engine
        self.paged = paged
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.decode_block = decode_block
        self.prefill_chunk = prefill_chunk
        # the cache rides the page store; every stack the port serves
        # pages and chunks, so it needs nothing more (the reference's
        # _prefix_ok). A dense engine keeps none, as the reference's does
        self.prefix_cache = paged and prefix_cache
        self._task: Optional[_ChunkTask] = None
        self.tok = tokenizer or ByteTokenizer()
        if paged:
            max_pages = (max_len + page_size - 1) // page_size
            # default budget: the dense layout's worst-case footprint
            n_pages = n_pages if n_pages is not None else n_slots * max_pages
            self.pages = PageAllocator(n_pages=n_pages, page_size=page_size,
                                       n_slots=n_slots, max_len=max_len,
                                       prefix_cache=self.prefix_cache,
                                       kv_salt=cfg.kv_cache_dtype)
            # sum of slotted requests' admission-time reservations; the
            # standing invariant _committed + pages.pinned <= n_pages
            # means mid-decode page growth can never hit MemoryError
            self._committed = 0
            self.cache = MD.init_paged_cache(cfg, n_pages, page_size,
                                             device=self.device)
        else:
            self.pages = None
            # n_slots rows of max_len tokens, and the sink row n_slots
            self.cache = MD.init_cache(cfg, n_slots, max_len,
                                       device=self.device)
        # the host key: split once per prefill group and once per block
        # (never read from the card), as the reference's self.key
        self.key = prng.PRNGKey(seed)
        self.slots: List[Optional[RequestState]] = [None] * n_slots
        # host mirrors of the per-lane decode state (scheduling decisions;
        # gathered into the entry's staging buffer per block, refreshed from
        # the block's copy)
        self.positions = np.zeros(n_slots, np.int64)   # next position per slot
        self.last_token = np.zeros(n_slots, np.int64)
        self.live = np.zeros(n_slots, bool)
        self.gen_count = np.zeros(n_slots, np.int64)
        self.max_new = np.ones(n_slots, np.int64)
        self.temp = np.zeros(n_slots, np.float32)
        self.top_k = np.zeros(n_slots, np.int64)
        self.top_p = np.ones(n_slots, np.float32)
        self.queue: List[RequestState] = []
        self.finished: List[FinishedRequest] = []
        # lanes quarantined by the in-block finiteness verdict, harvested
        # by the scheduler for its bounded-retry requeue
        self.faulted: List[RequestState] = []
        # high-water marks, sampled at maximal residency inside step()
        self.peak_concurrent = 0
        self.peak_pages_in_use = 0
        # forward passes, by kind: whole-prompt prefill groups, decode
        # steps (``steps``) and prompt chunks (``chunk_steps``)
        self.prefill_groups = 0
        self.steps = 0
        self.chunk_steps = 0           # prompt chunks streamed into blocks
        # chunk passes run: every step of a mixed block runs one, the
        # length-0 passes past the last chunk included
        self.chunk_passes = 0
        self.pages_grown_chunked = 0   # pages mapped per chunk, not at insert
        self.prefill_tokens_computed = 0   # prompt tokens actually prefilled
        self.prefill_tokens_cached = 0     # prompt tokens served from cache
        self.decode_tokens = 0
        self.decode_syncs = 0          # host round trips on the decode path
        self.last_decode_s = 0.0       # decode wall time, last dispatch
        self._next_rid = 1000
        # compiled entry-point table (the reference's names); the graphs of
        # one engine share one memory pool
        self.entry_points: Dict[str, Entry] = {}
        self.graphs = GraphPool(self.device)

    # ------------------------------------------------------------------
    def submit(self, prompt_ids: List[int], *, max_new_tokens: int = 64,
               sampling: Optional[SamplingParams] = None,
               directive_level: int = 0, rid: Optional[int] = None,
               tenant: str = "", deadline_at: float = float("inf"),
               priority: int = 1, t_submit: Optional[float] = None,
               retries: int = 0, last_fault: str = "") -> int:
        sampling = sampling if sampling is not None else SamplingParams()
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if max_new_tokens + 1 >= self.max_len:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} leaves no room for a prompt "
                f"in a max_len={self.max_len} KV region; need "
                f"max_new_tokens + 1 < max_len")
        if not prompt_ids:
            raise ValueError("empty prompt")
        if self.paged:
            need = self._pages_for(
                len(prompt_ids[: self.max_len - max_new_tokens - 1]),
                max_new_tokens)
            if need > self.pages.n_pages:
                raise ValueError(
                    f"request needs {need} pages > page budget "
                    f"{self.pages.n_pages} (page_size="
                    f"{self.pages.page_size})")
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        st = RequestState(rid, list(prompt_ids), max_new_tokens, sampling,
                          directive_level,
                          t_submit=(time.monotonic() if t_submit is None
                                    else t_submit),
                          tenant=tenant, deadline_at=deadline_at,
                          priority=priority, retries=retries,
                          last_fault=last_fault)
        self.queue.append(st)
        return rid

    # ------------------------------------------------------------------
    def load(self) -> int:
        """In-flight work: queued requests + occupied slots. The load
        signal scheduler dispatch keys on."""
        return len(self.queue) + sum(s is not None for s in self.slots)

    @property
    def chunked_admission(self) -> bool:
        """True when this engine admits new work by streaming prompt
        chunks into the live decode blocks (no whole-prompt stall): the
        signal the scheduler's dispatch ordering keys on."""
        return self.prefill_chunk > 0

    @staticmethod
    def _bucket(n: int) -> int:
        return max(16, _next_pow2(n))

    def _slot_cap(self, prompt_len: int, max_new: int) -> int:
        """Most tokens a request can ever write into its KV region: the
        single cap both the admission reservation and per-block page
        growth derive from, so growth never exceeds the reservation."""
        return min(prompt_len + max_new, self.max_len - 1)

    def _pages_for(self, prompt_len: int, max_new: int,
                   cached_pages: int = 0, cow_pages: int = 0) -> int:
        """Worst-case page reservation for a request — the admission unit.
        Directive-aware by construction: ``max_new`` is the budget the
        drawn directive level selected, so brief requests reserve fewer
        pages and more of them fit a fixed page budget. Prefix-aware on
        top: adopted cached pages cost nothing new and are subtracted; a
        fully cached page-aligned prompt adds ``cow_pages`` (one) back for
        the copy-on-write its 1-token recompute triggers."""
        return (self.pages.pages_needed(self._slot_cap(prompt_len, max_new))
                - cached_pages + cow_pages)

    def _try_prefill(self) -> None:
        """Fill free slots from the queue (FIFO, page-budget gated), then
        prefill the admitted requests grouped by padded prompt length.
        With chunked prefill and live lanes, the queue head is admitted as
        the chunk task instead (one at a time); the whole-prompt path runs
        only on an idle engine. A prefix hit at the head of the queue is
        always admitted as the chunk task (its suffix must attend over the
        adopted pages, which the whole-prompt prefill cannot read); while
        the task lane is busy the head waits (FIFO)."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return
        if self.prefix_cache:
            head = self.queue[0]
            ids0 = head.prompt_ids[: self.max_len - head.max_new_tokens - 1]
            if self.pages.match_prefix(ids0)[0] > 0:
                if self._task is None:
                    self._admit_chunk_task(free[0])
                return
        if self.prefill_chunk > 0 and self.live.any():
            if self._task is None:
                self._admit_chunk_task(free[0])
            return
        taken: List[Tuple[int, RequestState, List[int]]] = []
        for slot in free:
            if not self.queue:
                break
            st = self.queue[0]
            # submit() guarantees max_len - max_new_tokens - 1 >= 1, so the
            # truncated prompt is never empty
            ids = st.prompt_ids[: self.max_len - st.max_new_tokens - 1]
            if self.prefix_cache and self.pages.match_prefix(ids)[0] > 0:
                break     # hits admit via the chunk task on a later call
            if self.paged:
                need = self._pages_for(len(ids), st.max_new_tokens)
                # pinned: shared pages charged to no reservation (0 without
                # the prefix cache)
                if (self._committed + need + self.pages.pinned
                        > self.pages.n_pages):
                    break              # wait for pages to free up
                self._committed += need
                st.reserved_pages = need
            self.queue.pop(0)
            st.prompt_len = len(ids)
            taken.append((slot, st, ids))
        # grouped as the reference groups its compiled prefill shapes, so
        # pages are allocated in the same order
        groups: Dict[int, List[Tuple[int, RequestState, List[int]]]] = {}
        for slot, st, ids in taken:
            plen = min(self._bucket(len(ids)), self.max_len)
            groups.setdefault(plen, []).append((slot, st, ids))
        for plen, grp in groups.items():
            self._prefill_group(plen, grp)

    def _prefill_group(self, plen: int,
                       grp: List[Tuple[int, RequestState, List[int]]]) -> None:
        # padded to a power of two (at most log2(n_slots) + 1 shapes a
        # prompt bucket); pad rows write to the sink row (dense) or the
        # trash page (index n_pages, which no block table maps), and so do
        # a paged row's positions past its prompt
        nb = len(grp)
        npad = _next_pow2(nb)
        toks = np.zeros((npad, plen), np.int64)
        lengths = np.ones(npad, np.int64)
        temps = np.zeros(npad, np.float32)
        topks = np.zeros(npad, np.int64)
        topps = np.ones(npad, np.float32)
        for b, (slot, st, ids) in enumerate(grp):
            toks[b, : len(ids)] = ids
            lengths[b] = len(ids)
            temps[b] = st.sampling.temperature
            topks[b] = st.sampling.top_k
            topps[b] = st.sampling.top_p
        if self.paged:
            ps = self.pages.page_size
            page_ids = np.full((npad, plen), self.pages.n_pages, np.int64)
            offs = np.zeros((npad, plen), np.int64)
            for b, (slot, st, ids) in enumerate(grp):
                self.pages.ensure_capacity(slot, len(ids))
                self.pages.lengths[slot] = len(ids)
                t = np.arange(len(ids))
                page_ids[b, : len(ids)] = self.pages.block_table[slot, t // ps]
                offs[b, : len(ids)] = t % ps
            dest = dict(page_ids=page_ids, offs=offs)
        else:
            slots = np.full(npad, self.n_slots, np.int64)
            slots[:nb] = [slot for slot, _, _ in grp]
            dest = dict(slots=slots)
        prefill = self._prefill_for(npad, plen)
        # the group draws its first tokens with its own split of the host
        # key, folded by row position in the group (ref engine.py:565)
        self.key, sk = prng.split(self.key)
        out = prefill(toks=toks, lengths=lengths, **dest, temp=temps,
                      topk=topks, topp=topps, key=sk.numpy())  # noqa: SPL001 — a host key
        if self.prefix_cache:
            # index the full prompt pages the entry just wrote, so later
            # requests sharing this prefix adopt instead of recompute
            for slot, _, ids in grp:
                self.pages.register_prefix(slot, ids)
        self.prefill_groups += 1
        self.prefill_tokens_computed += int(lengths[:nb].sum())
        # sproutlint: allow(SPL001) — the one device-to-host copy a group
        firsts = out.tolist()
        t_first = time.monotonic()
        for b, (slot, st, _) in enumerate(grp):
            first = firsts[b]
            st.slot = slot
            st.generated = [first]
            st.t_first_token = t_first
            self.slots[slot] = st
            self.positions[slot] = st.prompt_len
            self.last_token[slot] = first
            self.gen_count[slot] = 1
            self.max_new[slot] = st.max_new_tokens
            self._set_sampling(slot, st.sampling)
            alive = (first != self.eos_id
                     and st.max_new_tokens > 1
                     and st.prompt_len + 1 < self.max_len - 1)
            self.live[slot] = alive
            if not alive:
                self._finish(slot)

    def _set_sampling(self, slot: int, sampling: SamplingParams) -> None:
        """The slot's sampling mirrors, gathered per bucket like ``last``."""
        self.temp[slot] = sampling.temperature
        self.top_k[slot] = sampling.top_k
        self.top_p[slot] = sampling.top_p

    def _prefill_for(self, npad: int, plen: int) -> Entry:
        """The entry ``prefill_bs{npad}_p{plen}``: whole-prompt prefill of
        ``npad`` rows padded to ``plen`` tokens, writing each row's K/V
        into its slot's row (``slots``; the whole row's positions reset, as
        the reference's insert of a fresh row resets them) or through its
        page ids (``page_ids``, ``offs``), to each row's first token
        (npad,), drawn by ``sample_logits_batched`` with the group's key
        and each row's ``temp``, ``topk`` and ``topp`` (argmax where temp
        is 0, the pad rows' value)."""
        name = f"prefill_bs{npad}_p{plen}"
        if name not in self.entry_points:
            cfg, params, cache = self.cfg, self.params, self.cache

            def prefill(toks, lengths, temp, topk, topp, key, slots=None,
                        page_ids=None, offs=None):
                to = ((slots, MD.kpos_of(lengths, plen)) if slots is not None
                      else (page_ids, offs))
                logits = MD.prefill_last(cfg, params, toks, lengths, cache=cache,
                                         prompt_to=to)
                return sample_logits_batched(logits, key, temp, topk, topp)

            layout = {"toks": ((npad, plen), 0), "lengths": ((npad,), 1)}
            if self.paged:
                layout.update(page_ids=((npad, plen), self.pages.n_pages),
                              offs=((npad, plen), 0))
            else:
                layout["slots"] = ((npad,), self.n_slots)
            layout.update(temp=((npad,), 0.0, torch.float32), topk=((npad,), 0),
                          topp=((npad,), 1.0, torch.float32), key=((2,), 0))
            self.entry_points[name] = Entry(name, prefill, layout, self.graphs)
        return self.entry_points[name]

    def _admit_chunk_task(self, slot: int) -> None:
        """Admit the queue head into ``slot`` as the chunk task: host
        mirrors are pre-staged (position at prompt_len, lane dead) and the
        prompt streams into the following blocks. The lane flips live, and
        its first token is emitted, inside the block its final chunk lands
        in. On a prefix hit the slot adopts the matched pages and the task
        starts past them."""
        st = self.queue[0]
        ids = st.prompt_ids[: self.max_len - st.max_new_tokens - 1]
        cached_tokens = 0
        adopted: List[int] = []
        newly_pinned = 0
        cow = 0
        if self.prefix_cache:
            m, pids, newly_pinned = self.pages.match_prefix(ids)
            if m > 0:
                # always leave >= 1 prompt token to compute: the last
                # prompt token's logits give the first token, so a fully
                # cached page-aligned prompt still streams a 1-token chunk,
                # whose K/V write lands inside the last shared page and
                # takes the copy-on-write budgeted here
                cached_tokens = min(m * self.pages.page_size, len(ids) - 1)
                cow = 1 if m * self.pages.page_size > cached_tokens else 0
                adopted = pids
        if self.paged:
            need = self._pages_for(len(ids), st.max_new_tokens,
                                   cached_pages=len(adopted), cow_pages=cow)
            # shared pages are paid for once: the pinned ones, and the
            # cached ones this adoption would pin, join the reservations
            if (self._committed + need + self.pages.pinned + newly_pinned
                    > self.pages.n_pages):
                return                 # wait for pages to free up (FIFO)
            self._committed += need
            st.reserved_pages = need
        self.queue.pop(0)
        st.prompt_len = len(ids)
        st.slot = slot
        st.generated = []
        if adopted:
            self.pages.adopt(slot, adopted)
            self.pages.lengths[slot] = cached_tokens
            st.cached_tokens = cached_tokens
            self.prefill_tokens_cached += cached_tokens
        self.prefill_tokens_computed += len(ids) - cached_tokens
        self.slots[slot] = st
        self.positions[slot] = len(ids)
        self.last_token[slot] = 0
        self.live[slot] = False
        self.gen_count[slot] = 0
        self.max_new[slot] = st.max_new_tokens
        self._set_sampling(slot, st.sampling)
        # a prefix engine admits hits here with prefill_chunk == 0: it
        # streams page_size-token chunks (a dense engine has no prefix
        # cache, so its prefill_chunk is set)
        self._task = _ChunkTask(slot=slot, ids=ids, plen=len(ids),
                                next=cached_tokens,
                                chunk=self.prefill_chunk or self.pages.page_size)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate page ``src`` onto ``dst`` in every leaf
        of every layer and segment (int8 K/V and their scales too), bit for
        bit and in place, since every captured graph holds the store's
        addresses. Runs eagerly on the engine's stream, between blocks,
        before the replay that writes the page; reads nothing back."""
        for seg in self.cache:
            for leaf in seg.values():
                leaf[:, dst].copy_(leaf[:, src])

    # ------------------------------------------------------------------
    def _finish(self, slot: int) -> None:
        st = self.slots[slot]
        assert st is not None
        st.done = True
        st.t_done = time.monotonic()
        gen = st.generated[:-1] if st.generated and st.generated[-1] == self.eos_id \
            else st.generated
        self.finished.append(FinishedRequest(
            st.rid, gen, self.tok.decode(gen), st.prompt_len, len(gen),
            st.t_first_token - st.t_submit, st.t_done - st.t_submit,
            st.directive_level, st.decode_s, st.tenant, st.deadline_at,
            st.t_done, st.retries, st.cached_tokens))
        self.slots[slot] = None
        self.live[slot] = False
        if self.paged:
            self.pages.release(slot)
            self._committed -= st.reserved_pages

    # the block's sampler by mode (ref engine.py:702-704)
    _SAMPLE_FNS = {"greedy": greedy_sample,
                   "temp": sample_temperature_only,
                   "full": sample_logits_batched}

    def _fused_for(self, k: int, mode: str, bs: int,
                   chunk_c: int) -> Tuple[Entry, bool]:
        """The entry of a k-step block over a ``bs``-row bucket, optionally
        running one ``chunk_c``-token prompt chunk pass per step
        (``engine.py:705-824``). Returns (entry, was-already-warm).

        Inputs, one row per lane: ``last``, ``pos``, ``gc``, ``max_new``,
        ``live`` (bs,), and on a paged engine the block-table rows ``bt``
        (bs, max_pages), on a dense one the lanes' slot ids ``rows`` (bs,),
        their store rows. Pad rows are dead, with table rows of -1 (their
        writes go to the trash page) or slot id n_slots (the sink row).
        A dense bucket as large as ``n_slots`` has ``rows`` 0..n_slots-1
        (the sink row in capture's dead inputs) and reads the store in
        place; a smaller one reads its rows through ``rows`` and writes them
        in place, where the reference gathers the store's rows on entry and
        scatters them back on exit. A mixed block adds the chunk arrays
        ``ctoks`` (k, C),
        ``cpos0``, ``clen``, ``cfin`` (k,) and the chunk lane ``lane``
        (0-dim): step s runs the chunk pass of row s (length 0 past the
        last chunk), and on the final chunk samples the request's first
        token, flips the lane live and emits the token in-band. Returns
        (2k + 2, bs) int64: the tokens of each step, which of them were
        emitted, the live mask after the block, and each lane's finiteness
        verdict (0 once a step of the block gave a live lane non-finite
        logits, or a dispatched chunk pass gave the chunk lane non-finite
        logits).

        ``mode`` is the host's choice of sampler over the bucket's rows:
        ``greedy`` has no sampler and no sampling input; ``temp`` and
        ``full`` add each row's ``temp``, ``topk``, ``topp``, its slot id
        ``rows`` (pad rows n_slots; a dense engine has it already) and the
        block's ``key``. Each step
        splits the carried key in two (three in a mixed block: the third
        draws the chunk lane's first token, folded by its slot id); the
        decode rows fold by slot id when the bucket is smaller than
        ``n_slots``, by lane position otherwise."""
        name = (f"decode_bs{bs}_k{k}_{mode}" if chunk_c == 0
                else f"mixed_bs{bs}_k{k}_c{chunk_c}_{mode}")
        warm = name in self.entry_points
        if not warm:
            cfg, params, cache = self.cfg, self.params, self.cache
            eos_id, max_len = self.eos_id, self.max_len
            sample_fn = self._SAMPLE_FNS[mode]
            sampled = mode != "greedy"
            bucketed = bs < self.n_slots
            has_chunk = chunk_c > 0
            paged = self.paged

            def fused(last, pos, gc, max_new, live, bt=None, rows=None,
                      ctoks=None, cpos0=None, clen=None, cfin=None, lane=None,
                      temp=None, topk=None, topp=None, key=None):
                live = live != 0
                if paged:
                    bt = bt.to(torch.int32)
                sampling = (temp, topk, topp) if sampled else ()
                fold = rows if sampled and bucketed else None
                sk = ck = None
                if has_chunk:
                    at_lane = torch.arange(bs, device=live.device) == lane
                    at = lane.reshape(1)
                    lane_max_new = max_new.index_select(0, at)
                    lane_sampling = tuple(x.index_select(0, at) for x in sampling)
                    lane_fold = rows.index_select(0, at) if sampled else None
                    # the chunk's store row (dense) or block-table row
                    chunk_row = at if paged else rows.index_select(0, at)
                toks, emitted = [], []
                ok = torch.ones(bs, dtype=torch.bool, device=live.device)
                for s in range(k):
                    if sampled:
                        keys = prng.split(key, 3 if has_chunk else 2)
                        key, sk = keys[0], keys[1]
                        if has_chunk:
                            ck = keys[2]
                    # the page store takes the step's live mask; a dense
                    # lane writes dead or not, as in the reference
                    store = (dict(block_table=bt, live=live) if paged
                             else dict(rows=rows, in_place=not bucketed))
                    nxt, rowok = MD.decode_sample_step(
                        cfg, params, last[:, None], pos, cache, sk, sampling,
                        sample_fn, fold_ids=fold, **store)
                    # sticky per-lane health; dead lanes' logits are scratch
                    ok = ok & (rowok | ~live)
                    nxt = torch.where(live, nxt, last)
                    pos2 = torch.where(live, pos + 1, pos)
                    gc2 = torch.where(live, gc + 1, gc)
                    # same finish rule as the host bookkeeping: EOS, token
                    # budget, or KV-region cap (prompt_len + gen >= max_len - 1)
                    hit = ((nxt == eos_id) | (gc2 >= max_new)
                           | (pos2 >= max_len - 2))
                    live2 = live & ~hit
                    emit_t, emit_v = nxt, live
                    if has_chunk:
                        logits = MD.prefill_chunk_step(
                            cfg, params, ctoks[s], cpos0[s], clen[s], chunk_row,
                            cache, block_table=bt)
                        # a dispatched chunk with non-finite logits marks
                        # the chunk lane bad: its K/V is garbage already
                        cok = (clen[s] == 0) | torch.isfinite(logits).all()
                        ok = ok & (cok | ~at_lane)
                        # the first token and the lane's flip to live stay
                        # on the device; they reach the host with the block
                        first = sample_fn(logits[None], ck, *lane_sampling,
                                          fold_ids=lane_fold)
                        plen = cpos0[s] + clen[s]
                        alive = ((first != eos_id) & (lane_max_new > 1)
                                 & (plen + 1 < max_len - 1))
                        upd = at_lane & (cfin[s] != 0)
                        nxt = torch.where(upd, first, nxt)
                        pos2 = torch.where(upd, plen, pos2)
                        gc2 = torch.where(upd, 1, gc2)
                        live2 = torch.where(upd, alive, live2)
                        emit_t = torch.where(upd, first, emit_t)
                        emit_v = emit_v | upd
                    toks.append(emit_t)
                    emitted.append(emit_v)
                    live, last, pos, gc = live2, nxt, pos2, gc2
                return torch.cat([torch.stack(toks), torch.stack(emitted).long(),
                                  live.long()[None], ok.long()[None]])

            layout = {"last": ((bs,), 0), "pos": ((bs,), 0), "gc": ((bs,), 0),
                      "max_new": ((bs,), 1), "live": ((bs,), 0)}
            if paged:
                layout["bt"] = ((bs, self.pages.max_pages), -1)
            if not paged or sampled:
                layout["rows"] = ((bs,), self.n_slots)
            if has_chunk:
                layout.update(ctoks=((k, chunk_c), 0), cpos0=((k,), 0),
                              clen=((k,), 0), cfin=((k,), 0), lane=((), 0))
            if sampled:
                layout.update(temp=((bs,), 0.0, torch.float32), topk=((bs,), 0),
                              topp=((bs,), 1.0, torch.float32), key=((2,), 0))
            self.entry_points[name] = Entry(name, fused, layout, self.graphs)
        return self.entry_points[name], warm

    def _grow_pages(self, k: int, task: Optional[_ChunkTask], nxt_p: int,
                    finishing: bool) -> None:
        """A paged block's page work before it runs: copy-on-write of shared
        pages its appends land in, and page growth to cover its appends."""
        if self.prefix_cache:
            # copy-on-write before this block's appends: a write landing in
            # a shared or adopted page remaps the lane onto a fresh page and
            # copies the contents first. Only the 1-token recompute of a
            # fully cached page-aligned prompt fires it (its admission
            # budgeted the page); decode appends land past the shared span
            targets = [(int(i), int(self.positions[i]))
                       for i in np.nonzero(self.live)[0]]
            if task is not None:
                targets.append((task.slot, task.next))
            for tslot, tpos in targets:
                cw = self.pages.prepare_append(tslot, tpos)
                if cw is not None:
                    self._copy_page(*cw)
        # grow each live slot's page map to cover this block's appends
        # (bounded by the slot's own cap, so growth never exceeds the
        # admission-time reservation and can never throw here)
        for i in np.nonzero(self.live)[0]:
            st = self.slots[i]
            self.pages.ensure_capacity(
                int(i), min(int(self.positions[i]) + k,
                            self._slot_cap(st.prompt_len, st.max_new_tokens)))
        if task is not None:
            # per-chunk page growth: map only what this block writes
            # (prompt chunks, plus up to k decode appends after an
            # in-block transition) instead of the whole prompt at once
            st = self.slots[task.slot]
            tgt = min(nxt_p + (k if finishing else 0),
                      self._slot_cap(st.prompt_len, st.max_new_tokens))
            self.pages_grown_chunked += self.pages.ensure_capacity(
                task.slot, tgt)
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages.pages_in_use())

    def _pick_k(self) -> int:
        """Block length: the power-of-two ceiling of the soonest
        *deterministic* finish (token budget / KV cap), capped at
        ``decode_block``. Steps past a slot's finish run dead (live-masked,
        nothing emitted)."""
        live_idx = np.nonzero(self.live)[0]
        rem = int(min(
            min(self.max_new[i] - self.gen_count[i],
                self.max_len - 1 - (self.positions[i] + 1))
            for i in live_idx))
        return min(self.decode_block, _next_pow2(max(1, rem)))

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One continuous-batching dispatch: refill free slots (chunk-task
        admission when lanes are live, grouped whole-prompt prefill when
        idle), then run up to ``decode_block`` steps, each decoding
        every live lane and streaming at most one prompt chunk, in the entry
        point bucketed to live occupancy, with one device-to-host copy at
        the end. Returns tokens emitted (0 if idle)."""
        self._try_prefill()
        self.peak_concurrent = max(
            self.peak_concurrent, sum(s is not None for s in self.slots))
        if self.paged:
            self.peak_pages_in_use = max(self.peak_pages_in_use,
                                         self.pages.pages_in_use())
        task = self._task
        if not self.live.any() and task is None:
            return 0
        # ----- bucket selection: live lanes plus the chunk-task lane ----
        lanes = set(int(i) for i in np.nonzero(self.live)[0])
        if task is not None:
            lanes.add(task.slot)
        rows = np.sort(np.fromiter(lanes, np.int64))
        bs = min(self.n_slots, _next_pow2(len(rows)))
        if bs == self.n_slots:
            rows_full = np.arange(self.n_slots, dtype=np.int64)
        else:
            # pad rows carry slot id n_slots: dead, unmapped, budget 1
            rows_full = np.full(bs, self.n_slots, np.int64)
            rows_full[: len(rows)] = rows
        # ----- block length + per-step chunk arrays ---------------------
        k = self._pick_k() if self.live.any() else self.decode_block
        chunk_c = 0
        finishing = False
        nxt_p = 0
        if task is not None:
            chunk_c = task.chunk
            rem = -(-(task.plen - task.next) // chunk_c)
            # shrink the block toward the chunks actually left
            k = max(1, min(k, _next_pow2(rem)))
            ctoks = np.zeros((k, chunk_c), np.int64)
            cpos0 = np.zeros(k, np.int64)
            clen = np.zeros(k, np.int64)
            cfin = np.zeros(k, bool)
            nxt_p = task.next
            for s in range(k):
                if nxt_p < task.plen:
                    n = min(chunk_c, task.plen - nxt_p)
                    ctoks[s, :n] = task.ids[nxt_p:nxt_p + n]
                    cpos0[s] = nxt_p
                    clen[s] = n
                    cfin[s] = nxt_p + n == task.plen
                    nxt_p += n
                    self.chunk_steps += 1
            finishing = nxt_p == task.plen
        # greedy rows (temp <= 0) draw by argmax and ignore top-k/top-p, so
        # only the sampled rows' params pick the sampler; the chunk lane
        # counts, since its first token is drawn in the block
        consider = np.zeros(self.n_slots, bool)
        consider[rows] = True
        drawn = consider & (self.temp > 0)
        if not drawn.any():
            mode = "greedy"
        elif np.any((self.top_k[drawn] > 0) | (self.top_p[drawn] < 1.0)):
            mode = "full"
        else:
            mode = "temp"
        if self.paged:
            self._grow_pages(k, task, nxt_p, finishing)
        # ----- the bucket's inputs, gathered from the host mirrors ------
        real = rows_full < self.n_slots

        def gath(a, fill, dtype=np.int64):
            out = np.full(bs, fill, dtype)
            out[real] = a[rows_full[real]]
            return out

        # every block advances the host key, greedy ones too, so a greedy
        # neighbour never shifts a later sampled token (ref engine.py:959)
        self.key, bk = prng.split(self.key)
        inputs = dict(last=gath(self.last_token, 0), pos=gath(self.positions, 0),
                      gc=gath(self.gen_count, 0), max_new=gath(self.max_new, 1),
                      live=gath(self.live, 0))
        if self.paged:
            bt = np.full((bs, self.pages.max_pages), -1, np.int64)
            bt[real] = self.pages.block_table[rows_full[real]]
            inputs["bt"] = bt
        if not self.paged or mode != "greedy":
            inputs["rows"] = rows_full
        if task is not None:
            inputs.update(ctoks=ctoks, cpos0=cpos0, clen=clen, cfin=cfin,
                          lane=int(np.searchsorted(rows_full, task.slot)))
        if mode != "greedy":
            inputs.update(temp=gath(self.temp, 0.0, np.float32),
                          topk=gath(self.top_k, 0),
                          topp=gath(self.top_p, 1.0, np.float32),
                          key=bk.numpy())  # noqa: SPL001 — a host key
        fn, warm = self._fused_for(k, mode, bs, chunk_c)
        t_dec = time.monotonic()
        out = fn(**inputs)
        # sproutlint: allow(SPL001) — the one device-to-host copy a block,
        # its <= k*bs tokens with the per-lane finiteness verdict riding it
        block = out.cpu().numpy()
        # decode wall time for this dispatch; 0.0 when it built its entry,
        # so the straggler detector never samples a capture
        self.last_decode_s = (time.monotonic() - t_dec) if warm else 0.0
        toks_h, valid = block[:k], block[k:2 * k].astype(bool)
        live_final = block[2 * k].astype(bool)
        ok_final = block[2 * k + 1].astype(bool)
        self.decode_syncs += 1
        self.steps += k
        if task is not None:
            self.chunk_passes += k
        finish_order: List[Tuple[int, int]] = []
        n_decoded = 0
        # partition each step's share of the block wall time across the
        # slots live at that step; dead tail steps are spread pro rata
        dt_step = self.last_decode_s / k
        live_steps = valid.sum(axis=1)                       # (k,)
        share = dt_step / np.maximum(live_steps, 1)
        dead_s = dt_step * int((live_steps == 0).sum())
        total_valid = max(int(valid.sum()), 1)
        for b, i in enumerate(int(x) for x in rows_full):
            if i >= self.n_slots:
                continue
            st = self.slots[i]
            if st is None:
                continue
            col = valid[:, b]
            news = [int(t) for t in toks_h[col, b]]
            st.decode_s += float(share[col].sum()) \
                + dead_s * len(news) / total_valid
            if not ok_final[b]:
                # non-finite logits: the lane's tokens of this block stay on
                # the request (the waste ledger charges them) and the lane
                # is quarantined; no finish, no mirror advance
                st.generated.extend(news)
                self._quarantine(i, "decode.nonfinite")
                continue
            st.generated.extend(news)
            n_decoded += len(news)
            self.decode_tokens += len(news)
            self.gen_count[i] += len(news)
            self.positions[i] += len(news)
            if self.paged:     # live tokens in pages == appended positions
                self.pages.lengths[i] = self.positions[i]
            if news:
                self.last_token[i] = news[-1]
            self.live[i] = bool(live_final[b])
            # a dead lane finishes only if it emitted in this block: the
            # chunk-task lane sits occupied but dead until its final chunk
            if not live_final[b] and news:
                finish_order.append((int(np.nonzero(col)[0][-1]), i))
        # a quarantine above may have torn the chunk task down with its
        # lane: advance the task only if it is still the one dispatched
        if task is not None and self._task is task:
            i = task.slot
            task.next = nxt_p
            if finishing:
                # the first token was emitted from inside the block: it
                # lands at the pre-staged position, not a position advance
                self.positions[i] -= 1
                st = self.slots[i]
                if st.t_first_token == 0.0:
                    st.t_first_token = time.monotonic()
                if self.prefix_cache:
                    # the whole prompt's K/V is written: index its full
                    # pages (adopted ones are indexed already)
                    self.pages.register_prefix(i, task.ids)
                self._task = None
            if self.paged:
                self.pages.lengths[i] = (int(self.positions[i]) if finishing
                                         else task.next)
        # finish in (step-within-block, slot) order so completion order is
        # identical to single-step execution
        for _, i in sorted(finish_order):
            self._finish(i)
        return n_decoded

    # ------------------------------------------------------------------
    def run_to_completion(self, max_steps: int = 100000) -> List[FinishedRequest]:
        while (self.queue or any(s is not None for s in self.slots)) \
                and self.steps < max_steps:
            self.step()
        return self.finished

    # ------------------------------------------------------------------
    def drain_slots(self) -> List[RequestState]:
        """Preemption support: evict live requests for requeueing (their
        generation restarts on another replica — prompt tokens preserved)."""
        out = []
        for i, st in enumerate(self.slots):
            if st is not None:
                st.slot = -1
                out.append(st)
                self.slots[i] = None
                self.live[i] = False
                if self.paged:
                    self.pages.release(i)
                    self._committed -= st.reserved_pages
                st.reserved_pages = 0
                st.cached_tokens = 0
        # a mid-prefill chunk task leaves with its slot; its prompt ids are
        # verbatim, so a resubmission elsewhere restarts identically
        self._task = None
        return out

    def evict(self, rid: int) -> Optional[RequestState]:
        """Pull ONE request out of the engine for requeue: queued requests
        are unqueued; a slotted one releases its slot (and on a paged
        engine its pages and admission reservation). Generated-so-far
        tokens are discarded. ``None`` if the rid is unknown or already
        finished."""
        for j, st in enumerate(self.queue):
            if st.rid == rid:
                return self.queue.pop(j)
        for i, st in enumerate(self.slots):
            if st is not None and st.rid == rid:
                st.slot = -1
                st.generated = []
                self.slots[i] = None
                self.live[i] = False
                if self.paged:
                    self.pages.release(i)
                    self._committed -= st.reserved_pages
                st.reserved_pages = 0
                st.cached_tokens = 0
                if self._task is not None and self._task.slot == i:
                    self._task = None
                return st
        return None

    # ------------------------------------------------------------------
    def _fill_lane(self, slot: int, value: float) -> None:
        """Constant-fill one lane's K/V with ``value`` in every float leaf
        of every layer (K/V, or an int8 store's scales: non-finiteness
        rides them; ``kpos`` and int8 codes stay). A dense engine fills the
        slot's row, never the sink row. A paged engine fills the pages the
        lane's table row maps, with the prefix cache only those it owns
        alone (never a page another lane or the index can read), and never
        the trash page. In place, eagerly between blocks, since every
        captured graph holds the store's addresses; reads nothing back."""
        if self.paged:
            bt = self.pages.block_table[slot]
            keep = bt >= 0
            if self.prefix_cache:
                keep &= self.pages.exclusive_pages(slot)
            # through pinned memory, so the copy to the card does not sync
            ids = torch.from_numpy(bt[keep].astype(np.int64))
            if self.device.type == "cuda":
                ids = ids.pin_memory()
            ids = ids.to(self.device, non_blocking=True)
        for seg in self.cache:
            for leaf in seg.values():
                if not leaf.is_floating_point():
                    continue
                if self.paged:
                    leaf.index_fill_(1, ids, value)
                else:
                    leaf[:, slot].fill_(value)

    def poison_lane(self, slot: int) -> None:
        """Fault injection: fill a lane's K/V with NaN, so the next block's
        logits for that lane are truly non-finite (a masked token's weight
        is 0, and 0 * NaN is NaN through P·V). The in-block verdict, not
        the injector, must then catch it."""
        self._fill_lane(slot, float("nan"))

    def _scrub_lane(self, slot: int) -> None:
        """Zero a quarantined lane's K/V before its row or pages are
        reused: NaN left there would reach the next occupant by the same
        0 * NaN that made detection possible."""
        self._fill_lane(slot, 0.0)

    def _quarantine(self, slot: int, reason: str) -> None:
        """Pull a poisoned lane out of service: drop its owned pages from
        the prefix index, scrub its K/V, release its slot, pages and
        admission reservation, reset the host mirrors, and hand the request
        to ``faulted``. Its prompt ids are verbatim, so a retry regenerates
        the same tokens."""
        st = self.slots[slot]
        assert st is not None
        st.slot = -1
        st.last_fault = reason
        if self.prefix_cache:
            # suspect content must never serve a later hit; adopted pages
            # stay indexed (copy-on-write kept this lane from writing them)
            self.pages.invalidate_slot(slot)
        self._scrub_lane(slot)       # before release: needs the block table
        self.slots[slot] = None
        self.live[slot] = False
        self.positions[slot] = 0
        self.last_token[slot] = 0
        self.gen_count[slot] = 0
        if self._task is not None and self._task.slot == slot:
            self._task = None
        if self.paged:
            self.pages.release(slot)
            self._committed -= st.reserved_pages
        st.reserved_pages = 0
        st.cached_tokens = 0
        self.faulted.append(st)

    # ------------------------------------------------------------------
    def kv_stats(self) -> Dict[str, float]:
        """KV-memory telemetry, as the reference engine reports it. A paged
        engine: allocator occupancy/fragmentation plus bytes mapped
        (pages_in_use x page_bytes, across every layer's store), with the
        page budget's bytes as capacity (the trash page, which no request
        can map, is not capacity). A dense engine: its fixed n_slots x
        max_len footprint, every leaf (``kpos`` too) without the sink row,
        which no slot owns."""
        leaves = [x for seg in self.cache for x in seg.values()]
        if not self.paged:
            total = sum(x[:, :self.n_slots].numel() * x.element_size()
                        for x in leaves)
            live = int(sum(self.positions[i] for i, s in enumerate(self.slots)
                           if s is not None))
            return {"layout": "dense", "kv_bytes_capacity": total,
                    "kv_bytes_in_use": total, "live_tokens": live,
                    "pages_in_use": 0, "occupancy": 1.0,
                    "fragmentation": 0.0}
        page_bytes = sum(x[:, 0].numel() * x.element_size() for x in leaves)
        rep = self.pages.report()
        rep.update(layout="paged", page_bytes=page_bytes,
                   kv_bytes_capacity=self.pages.n_pages * page_bytes,
                   kv_bytes_in_use=rep["pages_in_use"] * page_bytes,
                   peak_pages_in_use=self.peak_pages_in_use,
                   peak_kv_bytes_in_use=self.peak_pages_in_use * page_bytes,
                   committed_pages=self._committed)
        if self.prefix_cache:
            rep.update(prefill_tokens_computed=self.prefill_tokens_computed,
                       prefill_tokens_cached=self.prefill_tokens_cached)
        return rep
