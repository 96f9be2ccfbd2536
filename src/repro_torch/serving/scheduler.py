"""Carbon-aware scheduler: SPROUT's directive selector in the request path
(Fig. 5 components 1–3) + fleet-level fault tolerance.

* directive selection: draws a level from the optimizer's current x and
  renders the directive as a system prompt before tokenization;
* replica pool: least-loaded dispatch over multiple InferenceEngines;
* fault tolerance (DESIGN.md §12): replicas carry a health state machine
  (healthy → suspect → dead) instead of the old one-way ``fail_replica``.
  A faulting replica is drained (its in-flight requests requeue over the
  verbatim-token path — the serving analogue of checkpoint/restart) and
  benched with *probation*: after an exponentially growing cooldown it is
  re-admitted as suspect, and a clean window promotes it back to healthy,
  so transient faults never permanently shrink the fleet. Fault-caused
  requeues are bounded per request: ``retries`` counts them, dispatch is
  deferred by an exponential step-based backoff, and a request past the
  retry budget parks in ``rejected`` with a reason — never a crash loop.
* straggler mitigation: replicas whose *per-decode-step* latency exceeds
  ``straggler_factor`` x fleet median are drained and benched (with
  probation — a transient slowdown earns its way back). Engines decode
  in fused multi-token blocks (engine.decode_block), so wall time per
  ``step()`` is normalized by the lockstep decode steps that dispatch
  executed — a batch-wide matmul costs the same whether 1 or n_slots lanes
  are live, so per-step (not per-token) time is the occupancy-independent
  hardware-speed signal.
* fault injection: every chaos entry point (replica crash, lane poison)
  consults the pool's seed-deterministic ``FaultInjector``; the injected
  failure then flows through the genuine mechanism (drain/health/requeue,
  in-scan finiteness detection) rather than a parallel test-only path.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.directives import DirectiveSet
from repro_torch.serving.engine import FinishedRequest, InferenceEngine, RequestState
from repro_torch.serving.faults import FaultInjector, no_faults
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.tokenizer import ByteTokenizer


@dataclasses.dataclass
class ServeRequest:
    rid: int
    user_prompt: str
    system_prompt: Optional[str] = None
    max_new_tokens: int = 64
    # default_factory, NOT a class-level instance: a single shared default
    # object across every request would alias all of their sampling state
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    # failover requeue: user_prompt is already directive-rendered ChatML —
    # dispatch must not wrap it again (the prompt would nest and grow on
    # every failover); directive_level records the original draw
    pre_rendered: bool = False
    directive_level: int = 0
    # failover also carries the ORIGINAL token ids: a decode()/encode()
    # round trip is lossy in general (byte fallbacks, specials typed as
    # text, BOS placement), so dispatch submits these verbatim when set
    prompt_token_ids: Optional[List[int]] = None
    # per-directive-level generation budget (the serving-side effect of a
    # brevity directive); indexed by the drawn level at dispatch time
    max_new_by_level: Optional[Sequence[int]] = None
    # ----- SLO identity (gateway-side service classes) -----
    # tenant class name + task family: the gateway's composite level_fn
    # draws this request's directive level from the (pool, tenant) LP mix
    tenant: str = ""
    task: str = ""
    # absolute completion deadline on the monotonic clock (inf = none);
    # the gateway stamps it from the tenant's TTFT/TPOT targets when the
    # caller leaves ``deadline_s`` (relative seconds) unset
    deadline_at: float = float("inf")
    deadline_s: float = float("inf")
    # dispatch order within a pool (lower first; stable within a class) —
    # premium work never queues behind batch work on the same fleet
    priority: int = 1
    # original submission time (stamped once by the first scheduler.submit
    # and preserved across requeue/migration): deadlines and latency are
    # end-to-end properties of the REQUEST, not of any one engine
    t_submit: float = 0.0
    # fault-recovery bookkeeping: fault-caused requeues survived so far and
    # the last fault class — carried through requeue/migration so the retry
    # budget is a property of the request, not of any one replica
    retries: int = 0
    last_fault: str = ""


@dataclasses.dataclass
class ReplicaHealth:
    """One replica's health-state record (healthy → suspect → dead).

    ``engine`` parks the benched engine object while dead-on-probation;
    ``permanent=True`` (the deprecated ``fail_replica`` path, and genuine
    hardware loss) means no re-admission. ``probations`` counts bench
    cycles and doubles the next cooldown, so a flapping replica spends
    exponentially more time on the bench."""
    state: str = "healthy"
    faults: int = 0           # faults since the last healthy promotion
    clean_steps: int = 0      # consecutive fault-free steps while suspect
    probations: int = 0      # bench cycles so far (backs off re-admission)
    benched_at_step: int = -1
    engine: Optional[InferenceEngine] = None
    permanent: bool = False


class CarbonAwareScheduler:
    def __init__(self, engines: Sequence[InferenceEngine],
                 directives: DirectiveSet = DirectiveSet(),
                 level_fn: Optional[Callable[[], int]] = None,
                 tokenizer: Optional[ByteTokenizer] = None,
                 straggler_factor: float = 4.0,
                 fault_injector: Optional[FaultInjector] = None,
                 retry_budget: int = 3, backoff_base_steps: int = 2,
                 fault_threshold: int = 2, probation_steps: int = 8,
                 clean_window: int = 16):
        self.engines: List[Optional[InferenceEngine]] = list(engines)
        self.directives = directives
        self.level_fn = level_fn or (lambda: 0)
        self.tok = tokenizer or ByteTokenizer()
        self.straggler_factor = straggler_factor
        # chaos wiring (DESIGN.md §12): the injector is always present —
        # the default empty plan makes every consult a cheap no — and the
        # fault parameters bound recovery work per request / per replica
        self.fault_injector = fault_injector or no_faults()
        self.retry_budget = retry_budget
        self.backoff_base_steps = backoff_base_steps
        self.fault_threshold = fault_threshold
        self.probation_steps = probation_steps
        self.clean_window = clean_window
        self.name = ""              # pool key (gateway-stamped) for targets
        self.pending: List[ServeRequest] = []
        self.finished: List[FinishedRequest] = []
        # requests no engine can serve (e.g. token budget exceeds the KV
        # region, or the retry budget is exhausted): kept with the
        # rejection reason instead of being lost
        self.rejected: List[tuple] = []
        self._rid = 0
        self._step_times: Dict[int, List[float]] = {}
        # fleet-step counter: the time base for retry backoff and probation
        # cooldowns (steps, not wall-clock, so chaos runs replay exactly)
        self.steps = 0
        self.health: Dict[int, ReplicaHealth] = {
            i: ReplicaHealth() for i in range(len(self.engines))}
        # rid -> earliest scheduler step at which dispatch may retry it
        self._backoff: Dict[int, int] = {}
        # (reason, RequestState) per fault-caused requeue this harvest
        # window: the gateway drains these into its wasted-work ledger and
        # brownout fault score
        self.fault_events: List[Tuple[str, RequestState]] = []

    # ------------------------------------------------------------------
    def submit(self, req: ServeRequest) -> int:
        if req.rid == 0:
            self._rid += 1
            req.rid = self._rid
        if req.t_submit == 0.0:
            # first entry into the serving system: the end-to-end latency
            # clock (and any relative deadline) starts here, and survives
            # failover requeue / cross-pool migration untouched
            req.t_submit = time.monotonic()
            if req.deadline_at == float("inf") and \
                    req.deadline_s != float("inf"):
                req.deadline_at = req.t_submit + req.deadline_s
        self.pending.append(req)
        return req.rid

    def _draw_level(self, req: ServeRequest) -> int:
        """Directive draw for one request. A gateway-installed composite
        ``level_fn`` marks itself ``per_request`` and receives the request
        (its tenant/task select the mix); plain zero-arg selectors keep
        working unchanged."""
        fn = self.level_fn
        return int(fn(req) if getattr(fn, "per_request", False) else fn())

    def _dispatch(self) -> None:
        live = [(i, e) for i, e in enumerate(self.engines) if e is not None]
        if not live:
            return
        # priority order, stable within a class (sorted is stable): premium
        # dispatches — and therefore prefills — before batch every step
        self.pending.sort(key=lambda r: r.priority)
        deferred: List[ServeRequest] = []
        while self.pending:
            req = self.pending.pop(0)
            if self._backoff.get(req.rid, 0) > self.steps:
                # retry backoff: the request sits out until its stamp —
                # an immediate redispatch onto a fleet that just poisoned
                # or crashed under it tends to fault again
                deferred.append(req)
                continue
            if req.prompt_token_ids is not None:
                # failover requeue: resubmit the original ids verbatim
                level = req.directive_level
                ids = list(req.prompt_token_ids)
            else:
                if req.pre_rendered:
                    level = req.directive_level
                    text = req.user_prompt
                else:
                    level = self._draw_level(req)
                    text = self.directives.apply(req.user_prompt, level,
                                                 req.system_prompt)
                ids = self.tok.encode(text, bos=True)
            max_new = req.max_new_tokens
            if req.max_new_by_level is not None:
                max_new = int(req.max_new_by_level[
                    min(level, len(req.max_new_by_level) - 1)])
            # least-loaded first; on ties prefer chunked-admission engines
            # — their prefill interleaves into the live decode scan, so
            # the same load implies a shorter time-to-first-token there
            by_load = sorted(
                live, key=lambda ie: (ie[1].load(),
                                      not getattr(ie[1], "chunked_admission",
                                                  False)))
            last_err = None
            for idx, eng in by_load:
                try:
                    eng.submit(ids, max_new_tokens=max_new,
                               sampling=req.sampling, directive_level=level,
                               rid=req.rid, tenant=req.tenant,
                               deadline_at=req.deadline_at,
                               priority=req.priority,
                               t_submit=req.t_submit or None,
                               retries=req.retries,
                               last_fault=req.last_fault)
                    self._backoff.pop(req.rid, None)
                    break
                except ValueError as err:
                    # engine precondition (budget/empty prompt); a pool may
                    # be heterogeneous (different max_len), so try the rest
                    last_err = err
            else:
                # no engine can serve it: park the request with the reason
                # instead of losing it or aborting the fleet step
                self.rejected.append((req, str(last_err)))
        self.pending.extend(deferred)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One fleet step; returns number of tokens decoded fleet-wide."""
        self.steps += 1
        self._consult_injector()
        self._tick_probation()
        self._dispatch()
        lanes = 0
        for i, eng in enumerate(self.engines):
            if eng is None:
                continue
            steps0 = eng.steps
            n_tok = eng.step()
            lanes += n_tok
            n_steps = eng.steps - steps0
            if n_steps > 0 and eng.last_decode_s > 0:
                # idle dispatches would poison the latency distribution with
                # near-zero samples; per-step (not per-token) keeps the
                # signal independent of how many slots happen to be live,
                # and engine-reported decode-only time excludes prefill and
                # compile dispatches (reported as 0.0)
                dt = eng.last_decode_s / n_steps
                self._step_times.setdefault(i, []).append(dt)
                if len(self._step_times[i]) > 50:
                    self._step_times[i] = self._step_times[i][-50:]
            if eng.finished:
                self.finished.extend(eng.finished)
                eng.finished = []
            if eng.faulted:
                # lanes the engine quarantined this block (non-finite
                # logits): bounded-retry requeue + a health strike on the
                # replica that produced them
                for st in eng.faulted:
                    self._requeue_faulted(st, st.last_fault
                                          or "decode.nonfinite")
                eng.faulted = []
                self._record_fault(i)
            elif self.health.setdefault(i, ReplicaHealth()).state \
                    == "suspect":
                h = self.health[i]
                h.clean_steps += 1
                if h.clean_steps >= self.clean_window:
                    # served a full clean window: promoted back to
                    # healthy with a clean slate (probation debt cleared)
                    h.state, h.faults, h.probations = "healthy", 0, 0
        self._check_stragglers()
        return lanes

    # ------------------------------------------------------------------
    def _consult_injector(self) -> None:
        """One injection opportunity per live replica (crash) and per
        occupied lane (KV poison) per fleet step. The injected failure
        then flows through the genuine mechanism: a crash drains through
        the health machine; a poisoned lane is caught by the engine's
        in-scan finiteness verdict, not by the injector."""
        inj = self.fault_injector
        for i, eng in enumerate(self.engines):
            if eng is None:
                continue
            if inj.fire("replica.crash", f"{self.name}/{i}"):
                self._bench(i, fault_reason="replica.crash")
                continue
            for slot, st in enumerate(eng.slots):
                if st is not None and inj.fire("decode.nonfinite",
                                               str(st.rid)):
                    eng.poison_lane(slot)

    def _tick_probation(self) -> None:
        """Re-admit benched replicas whose probation cooldown elapsed.
        The cooldown doubles with each bench cycle, so a replica that
        keeps faulting spends exponentially longer on the bench."""
        for idx, h in list(self.health.items()):
            if h.state != "dead" or h.engine is None:
                continue
            wait = self.probation_steps * (2 ** max(h.probations - 1, 0))
            if self.steps - h.benched_at_step >= wait:
                self._readmit(idx)

    def _readmit(self, idx: int) -> None:
        h = self.health[idx]
        eng, h.engine = h.engine, None
        h.state = "suspect"
        # one strike from re-benching: a probationary replica that faults
        # again goes straight back to the bench (with a longer cooldown)
        h.faults = max(self.fault_threshold - 1, 0)
        h.clean_steps = 0
        if self.engines[idx] is None:
            self.engines[idx] = eng
        else:
            # its old index was taken by elastic scale-up: append, and
            # move the health record to the replica's new index
            self.engines.append(eng)
            new_idx = len(self.engines) - 1
            self.health[new_idx] = h
            self.health[idx] = ReplicaHealth(state="healthy")

    def _record_fault(self, idx: int) -> None:
        """One health strike against a replica: healthy → suspect on the
        first, bench (with probation) at ``fault_threshold``."""
        h = self.health.setdefault(idx, ReplicaHealth())
        h.faults += 1
        h.clean_steps = 0
        if h.state == "healthy":
            h.state = "suspect"
        if h.faults >= self.fault_threshold and \
                self.engines[idx] is not None:
            self._bench(idx, fault_reason=None)

    def _requeue_faulted(self, st: RequestState, reason: str) -> None:
        """Bounded-retry requeue of a fault-interrupted request: retries
        increment, dispatch backs off exponentially (in fleet steps), and
        a request past the budget parks in ``rejected`` with the reason —
        the fleet never spins on a poisoned request."""
        st.retries += 1
        st.last_fault = reason
        self.fault_events.append((reason, st))
        req = self._as_requeue(st)
        if st.retries > self.retry_budget:
            self.rejected.append((
                req, f"retry budget exhausted ({self.retry_budget}) "
                     f"after fault {reason}"))
            return
        self._backoff[st.rid] = self.steps + \
            self.backoff_base_steps * (2 ** (st.retries - 1))
        self.pending.append(req)

    def _check_stragglers(self) -> None:
        meds = {i: float(np.median(t)) for i, t in self._step_times.items()
                if len(t) >= 20 and self.engines[i] is not None}
        if len(meds) < 2:
            return
        fleet_med = float(np.median(list(meds.values())))
        for i, m in meds.items():
            if m > self.straggler_factor * fleet_med:
                # bench + requeue its work; a transient slowdown (noisy
                # neighbor, thermal) earns re-admission through probation
                self._bench(i, fault_reason=None)

    # ------------------------------------------------------------------
    def _as_requeue(self, st: RequestState) -> ServeRequest:
        """Wrap an engine RequestState for resubmission — anywhere.

        Carries the ORIGINAL token ids so dispatch resubmits them verbatim:
        a decode()/encode(bos=True) round trip would re-tokenize lossily
        (the decoded text is kept for debugging). Shared by failover
        requeue and cross-pool migration — migration is a routing decision
        over this same path, not a new serialization format."""
        return ServeRequest(
            st.rid, self.tok.decode(st.prompt_ids),
            max_new_tokens=st.max_new_tokens, sampling=st.sampling,
            pre_rendered=True, directive_level=st.directive_level,
            prompt_token_ids=list(st.prompt_ids), tenant=st.tenant,
            deadline_at=st.deadline_at, priority=st.priority,
            t_submit=st.t_submit, retries=st.retries,
            last_fault=st.last_fault)

    def _bench(self, idx: int, *, permanent: bool = False,
               fault_reason: Optional[str] = None) -> int:
        """Take a replica out of service: drain its in-flight work back
        into the backlog and mark it dead. ``fault_reason`` set means the
        replica crashed under its slotted requests — those requeue through
        the bounded-retry path (their generated-so-far tokens are wasted
        work the gateway will charge); queued-but-unstarted requests lost
        nothing and requeue plain either way. Unless ``permanent``, the
        engine object is parked on the health record for probation
        re-admission."""
        eng = self.engines[idx]
        if eng is None:
            return 0
        drained = eng.drain_slots()
        requeued = 0
        for st in drained:
            if fault_reason is not None:
                self._requeue_faulted(st, fault_reason)
            else:
                self.pending.append(self._as_requeue(st))
            requeued += 1
        for st in eng.queue:
            self.pending.append(self._as_requeue(st))
            requeued += 1
        eng.queue = []
        h = self.health.setdefault(idx, ReplicaHealth())
        h.state = "dead"
        h.permanent = permanent
        h.engine = None if permanent else eng
        h.benched_at_step = self.steps
        h.probations += 1
        h.faults = 0
        h.clean_steps = 0
        self.engines[idx] = None
        self._step_times.pop(idx, None)
        return requeued

    def fail_replica(self, idx: int) -> int:
        """Deprecated: permanent replica loss with plain requeue (the
        pre-health-machine semantics, kept for callers that model
        irrecoverable node loss). New code should let the health machine
        bench replicas — ``_bench`` via fault strikes — so transients
        recover through probation."""
        warnings.warn(
            "fail_replica is deprecated: replicas now carry health states "
            "(healthy/suspect/dead) with probation re-admission; this "
            "alias benches the replica permanently",
            DeprecationWarning, stacklevel=2)
        return self._bench(idx, permanent=True)

    def has_recoverable_replica(self) -> bool:
        """True while any benched replica is parked for probation — the
        pool can still regain capacity without outside help (the gateway's
        drain logic keys on this before parking stranded work)."""
        return any(h.state == "dead" and h.engine is not None
                   for h in self.health.values())

    def tp_degree(self) -> int:
        """Widest tensor-parallel sharding across live replicas — the
        fleet geometry the gateway's energy accounting prices a request
        at (GatewayPool.tp_degree forwards here-equivalent logic;
        DESIGN.md §14). 1 when the fleet is empty or unsharded."""
        return max((getattr(e, "tp_degree", 1)
                    for e in self.engines if e is not None), default=1)

    # ------------------------------------------------------------------
    def evict(self, rid: int) -> Optional[ServeRequest]:
        """Pull one request out of this pool for cross-pool migration,
        wherever it currently lives: the scheduler backlog, the parked
        rejected list, an engine queue, or a live slot (engine.evict —
        which releases the slot and its KV pages). Returns a requeue-ready
        ``ServeRequest`` (token ids verbatim for already-dispatched work),
        or ``None`` if the rid is unknown or already finished."""
        for j, req in enumerate(self.pending):
            if req.rid == rid:
                return self.pending.pop(j)
        for j, (req, _reason) in enumerate(self.rejected):
            if req.rid == rid:
                return self.rejected.pop(j)[0]
        for eng in self.engines:
            if eng is None:
                continue
            st = eng.evict(rid)
            if st is not None:
                return self._as_requeue(st)
        return None

    def add_replica(self, eng: InferenceEngine) -> None:
        """Elastic scale-up: plug a fresh engine into the pool (a fresh
        replica starts healthy, clearing any stale record — but never a
        benched-on-probation slot, whose parked engine must keep its
        health record for re-admission)."""
        for i, e in enumerate(self.engines):
            if e is None:
                h = self.health.get(i)
                if h is not None and h.state == "dead" \
                        and h.engine is not None:
                    continue         # reserved: probation will refill it
                self.engines[i] = eng
                self.health[i] = ReplicaHealth()
                return
        self.engines.append(eng)
        self.health[len(self.engines) - 1] = ReplicaHealth()

    # ------------------------------------------------------------------
    def run(self, max_steps: int = 100000) -> List[FinishedRequest]:
        steps = 0
        while (self.pending or any(
                e is not None and (e.queue or any(s is not None for s in e.slots))
                for e in self.engines)) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
