"""Slot-based continuous-batching inference engine over a paged KV store
(counterpart of ``repro/serving/engine.py``, paged greedy path).

A fixed set of ``n_slots`` slots. Queued requests are admitted while their
worst-case page reservation fits the page budget, prefilled as whole
prompts in batches grouped by padded length (the prompt K/V is written
straight into pages), and then decoded in blocks of up to ``decode_block``
greedy steps. Within a block every step runs on the device with no host
round trip: per-lane positions, last tokens, generation counters and the
live mask are device tensors, and the finish rule (EOS, token budget, KV
cap) is applied in-block. The host reads the block's tokens back with ONE
device-to-host copy per block. The block length shrinks to the soonest
deterministic finish (``_pick_k``), so a freed slot is refilled at the
earliest step it can matter. Decode attention runs the hand-written CUDA
paged-attention kernel on the card (``kernels/ops.py``); a CPU engine runs
its plain version.

Host bookkeeping (admission, page growth, finish order, block tables)
follows the reference line for line, so on the same traffic the port maps
the same pages and emits the same greedy tokens. Still to port
(ROADMAP.md): the dense layout, chunked prefill, the prefix cache, sampled
modes, tensor parallelism and fault injection into lanes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import model as MD
from repro_torch.models.common import ModelConfig, resolve_device
from repro_torch.serving.kv_cache import PageAllocator
from repro_torch.serving.sampler import SamplingParams, greedy_sample
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
    # the exact page count this request was charged at admission; every
    # release site repays this stored amount
    reserved_pages: int = 0


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
        ``seed`` is accepted for that parity; greedy decoding draws no
        random numbers. ``params`` must already live on ``device``."""
        for flag, on, item in (
                ("paged=False", not paged, "dense KV layout"),
                ("prefill_chunk > 0", prefill_chunk > 0, "chunked prefill"),
                ("prefix_cache=True", prefix_cache, "radix prefix cache"),
                ("tp_degree > 1", tp_degree > 1, "tensor-parallel decode")):
            if on:
                raise NotImplementedError(
                    f"{flag}: not in the port yet (ROADMAP.md, modules still "
                    f"to port: {item})")
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
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.decode_block = decode_block
        self.tok = tokenizer or ByteTokenizer()
        max_pages = (max_len + page_size - 1) // page_size
        # default budget: the dense layout's worst-case footprint
        n_pages = n_pages if n_pages is not None else n_slots * max_pages
        self.pages = PageAllocator(n_pages=n_pages, page_size=page_size,
                                   n_slots=n_slots, max_len=max_len)
        # sum of slotted requests' admission-time reservations; the
        # standing invariant _committed <= n_pages means mid-decode page
        # growth can never hit MemoryError
        self._committed = 0
        self.cache = MD.init_paged_cache(cfg, n_pages, page_size,
                                         device=self.device)
        self.slots: List[Optional[RequestState]] = [None] * n_slots
        # host mirrors of the per-lane decode state (scheduling decisions;
        # pushed to the device per block, refreshed from the block's copy)
        self.positions = np.zeros(n_slots, np.int64)   # next position per slot
        self.last_token = np.zeros(n_slots, np.int64)
        self.live = np.zeros(n_slots, bool)
        self.gen_count = np.zeros(n_slots, np.int64)
        self.max_new = np.ones(n_slots, np.int64)
        self.queue: List[RequestState] = []
        self.finished: List[FinishedRequest] = []
        # quarantined lanes; the port has no in-block finiteness verdict
        # yet, so this stays empty (the scheduler still harvests it)
        self.faulted: List[RequestState] = []
        # high-water marks, sampled at maximal residency inside step()
        self.peak_concurrent = 0
        self.peak_pages_in_use = 0
        self.steps = 0
        self.decode_tokens = 0
        self.decode_syncs = 0          # host round trips on the decode path
        self.last_decode_s = 0.0       # decode wall time, last dispatch
        self._next_rid = 1000

    # ------------------------------------------------------------------
    def submit(self, prompt_ids: List[int], *, max_new_tokens: int = 64,
               sampling: Optional[SamplingParams] = None,
               directive_level: int = 0, rid: Optional[int] = None,
               tenant: str = "", deadline_at: float = float("inf"),
               priority: int = 1, t_submit: Optional[float] = None,
               retries: int = 0, last_fault: str = "") -> int:
        sampling = sampling if sampling is not None else SamplingParams()
        if sampling.temperature > 0:
            raise NotImplementedError(
                "sampled decoding (temperature > 0): the port decodes "
                "greedily so far (ROADMAP.md, modules still to port: "
                "sampled modes)")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if max_new_tokens + 1 >= self.max_len:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} leaves no room for a prompt "
                f"in a max_len={self.max_len} KV region; need "
                f"max_new_tokens + 1 < max_len")
        if not prompt_ids:
            raise ValueError("empty prompt")
        need = self._pages_for(
            len(prompt_ids[: self.max_len - max_new_tokens - 1]),
            max_new_tokens)
        if need > self.pages.n_pages:
            raise ValueError(
                f"request needs {need} pages > page budget "
                f"{self.pages.n_pages} (page_size={self.pages.page_size})")
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

    @staticmethod
    def _bucket(n: int) -> int:
        return max(16, _next_pow2(n))

    def _slot_cap(self, prompt_len: int, max_new: int) -> int:
        """Most tokens a request can ever write into its KV region: the
        single cap both the admission reservation and per-block page
        growth derive from, so growth never exceeds the reservation."""
        return min(prompt_len + max_new, self.max_len - 1)

    def _pages_for(self, prompt_len: int, max_new: int) -> int:
        """Worst-case page reservation for a request — the admission unit.
        Directive-aware by construction: ``max_new`` is the budget the
        drawn directive level selected, so brief requests reserve fewer
        pages and more of them fit a fixed page budget."""
        return self.pages.pages_needed(self._slot_cap(prompt_len, max_new))

    def _try_prefill(self) -> None:
        """Fill free slots from the queue (FIFO, page-budget gated), then
        prefill the admitted requests grouped by padded prompt length."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return
        taken: List[Tuple[int, RequestState, List[int]]] = []
        for slot in free:
            if not self.queue:
                break
            st = self.queue[0]
            # submit() guarantees max_len - max_new_tokens - 1 >= 1, so the
            # truncated prompt is never empty
            ids = st.prompt_ids[: self.max_len - st.max_new_tokens - 1]
            need = self._pages_for(len(ids), st.max_new_tokens)
            if self._committed + need > self.pages.n_pages:
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
        nb = len(grp)
        ps = self.pages.page_size
        toks = np.zeros((nb, plen), np.int64)
        lengths = np.ones(nb, np.int64)
        # rows past a prompt's length write to the trash page (index
        # n_pages), which no block table maps
        page_ids = np.full((nb, plen), self.pages.n_pages, np.int64)
        offs = np.zeros((nb, plen), np.int64)
        for b, (slot, st, ids) in enumerate(grp):
            toks[b, : len(ids)] = ids
            lengths[b] = len(ids)
            self.pages.ensure_capacity(slot, len(ids))
            self.pages.lengths[slot] = len(ids)
            t = np.arange(len(ids))
            page_ids[b, : len(ids)] = self.pages.block_table[slot, t // ps]
            offs[b, : len(ids)] = t % ps
        dev = self.device
        logits = MD.prefill_last(
            self.cfg, self.params, torch.from_numpy(toks).to(dev),
            torch.from_numpy(lengths).to(dev), cache=self.cache,
            prompt_pages=(torch.from_numpy(page_ids).to(dev),
                          torch.from_numpy(offs).to(dev)))
        # the one device-to-host copy per prefill group
        firsts = greedy_sample(logits).tolist()
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
            alive = (first != self.eos_id
                     and st.max_new_tokens > 1
                     and st.prompt_len + 1 < self.max_len - 1)
            self.live[slot] = alive
            if not alive:
                self._finish(slot)

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
            st.t_done, st.retries))
        self.slots[slot] = None
        self.live[slot] = False
        self.pages.release(slot)
        self._committed -= st.reserved_pages

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
        """One continuous-batching dispatch: refill free slots, then run up
        to ``decode_block`` greedy decode steps over the live lanes with one
        device-to-host copy at the end. Returns tokens emitted (0 if idle)."""
        self._try_prefill()
        self.peak_concurrent = max(
            self.peak_concurrent, sum(s is not None for s in self.slots))
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages.pages_in_use())
        if not self.live.any():
            return 0
        rows = np.nonzero(self.live)[0]
        k = self._pick_k()
        # grow each live slot's page map to cover this block's appends
        # (bounded by the slot's own cap, so growth never exceeds the
        # admission-time reservation and can never throw here)
        for i in rows:
            st = self.slots[i]
            self.pages.ensure_capacity(
                int(i), min(int(self.positions[i]) + k,
                            self._slot_cap(st.prompt_len, st.max_new_tokens)))
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages.pages_in_use())
        dev = self.device
        bt, _ = self.pages.device_tables(dev, rows)
        last = torch.from_numpy(self.last_token[rows]).to(dev)
        pos = torch.from_numpy(self.positions[rows]).to(dev)
        gc = torch.from_numpy(self.gen_count[rows]).to(dev)
        max_new = torch.from_numpy(self.max_new[rows]).to(dev)
        live = torch.ones(len(rows), dtype=torch.bool, device=dev)
        toks, emitted = [], []
        t_dec = time.monotonic()
        for _ in range(k):
            nxt = MD.decode_sample_step(self.cfg, self.params, last[:, None],
                                        pos, self.cache, bt, greedy_sample,
                                        live=live)
            nxt = torch.where(live, nxt, last)
            pos2 = torch.where(live, pos + 1, pos)
            gc2 = torch.where(live, gc + 1, gc)
            # same finish rule as the host bookkeeping: EOS, token budget,
            # or KV-region cap (prompt_len + gen >= max_len - 1)
            hit = ((nxt == self.eos_id) | (gc2 >= max_new)
                   | (pos2 >= self.max_len - 2))
            toks.append(nxt)
            emitted.append(live)
            live = live & ~hit
            last, pos, gc = nxt, pos2, gc2
        # the single device-to-host copy for this block of <= k*bs tokens
        block = torch.cat([torch.stack(toks), torch.stack(emitted).long(),
                           live.long()[None]]).cpu().numpy()
        self.last_decode_s = time.monotonic() - t_dec
        toks_h, valid = block[:k], block[k:2 * k].astype(bool)
        live_final = block[2 * k].astype(bool)
        self.decode_syncs += 1
        self.steps += k
        finish_order: List[Tuple[int, int]] = []
        n_decoded = 0
        # partition each step's share of the block wall time across the
        # slots live at that step; dead tail steps are spread pro rata
        dt_step = self.last_decode_s / k
        live_steps = valid.sum(axis=1)                       # (k,)
        share = dt_step / np.maximum(live_steps, 1)
        dead_s = dt_step * int((live_steps == 0).sum())
        total_valid = max(int(valid.sum()), 1)
        for b, i in enumerate(int(x) for x in rows):
            st = self.slots[i]
            col = valid[:, b]
            news = [int(t) for t in toks_h[col, b]]
            st.decode_s += float(share[col].sum()) \
                + dead_s * len(news) / total_valid
            st.generated.extend(news)
            n_decoded += len(news)
            self.decode_tokens += len(news)
            self.gen_count[i] += len(news)
            self.positions[i] += len(news)
            self.pages.lengths[i] = self.positions[i]
            if news:
                self.last_token[i] = news[-1]
            self.live[i] = bool(live_final[b])
            if not live_final[b] and news:
                finish_order.append((int(np.nonzero(col)[0][-1]), i))
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
                self.pages.release(i)
                self._committed -= st.reserved_pages
                st.reserved_pages = 0
        return out

    def evict(self, rid: int) -> Optional[RequestState]:
        """Pull ONE request out of the engine for requeue: queued requests
        are unqueued; a slotted one releases its slot, pages and admission
        reservation. Generated-so-far tokens are discarded. ``None`` if the
        rid is unknown or already finished."""
        for j, st in enumerate(self.queue):
            if st.rid == rid:
                return self.queue.pop(j)
        for i, st in enumerate(self.slots):
            if st is not None and st.rid == rid:
                st.slot = -1
                st.generated = []
                self.slots[i] = None
                self.live[i] = False
                self.pages.release(i)
                self._committed -= st.reserved_pages
                st.reserved_pages = 0
                return st
        return None

    def poison_lane(self, slot: int) -> None:
        raise NotImplementedError(
            "poison_lane: lane fault injection and in-block finiteness "
            "detection are not in the port yet (ROADMAP.md, modules still "
            "to port: fault injection)")

    # ------------------------------------------------------------------
    def kv_stats(self) -> Dict[str, float]:
        """KV-memory telemetry: allocator occupancy/fragmentation plus bytes
        mapped (pages_in_use x page_bytes, across every layer's store).
        Capacity counts the trash page too."""
        leaves = [x for seg in self.cache for x in seg.values()]
        total_bytes = sum(x.numel() * x.element_size() for x in leaves)
        page_bytes = sum(x[:, 0].numel() * x.element_size() for x in leaves)
        rep = self.pages.report()
        rep.update(layout="paged", page_bytes=page_bytes,
                   kv_bytes_capacity=total_bytes,
                   kv_bytes_in_use=rep["pages_in_use"] * page_bytes,
                   peak_pages_in_use=self.peak_pages_in_use,
                   peak_kv_bytes_in_use=self.peak_pages_in_use * page_bytes,
                   committed_pages=self._committed)
        return rep
