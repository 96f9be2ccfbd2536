"""SproutGateway: the live control loop between the LP optimizer and the
serving fleet (Fig. 5, closed for real engines).

Until now the repo had two halves that never talked: a paper-faithful
control plane (``core/``) exercised only in simulation, and a device-
resident serving engine (``serving/``) whose ``CarbonAwareScheduler`` drew
directive levels from a static ``level_fn``. The gateway is the missing
component 1 of Fig. 5 — it owns

* one or more regional pools, each a ``CarbonIntensityProvider`` plus a
  ``CarbonAwareScheduler`` over real ``InferenceEngine`` replicas;
* a mix-exposing ``core.policies.Policy`` — ``SproutPolicy``,
  ``SproutStaticPolicy``, or anything whose ``begin_hour`` maintains a
  directive-level distribution ``.x`` — and ONE shared ``LevelProfiles``
  (per-level energy/time are properties of the model, not of the region);

and closes the loop in both directions:

  plan:      every ``replan_every`` simulated hours, each pool's current
             carbon intensity feeds ``policy.begin_hour`` (the Eq. 2-7 LP)
             and the resulting mix x is installed as that pool's scheduler
             ``level_fn`` — the LP is now literally in the request path;
  feedback:  every finished request's ENGINE-MEASURED telemetry (prompt /
             generated token counts and per-request decode-only seconds,
             ``FinishedRequest.decode_s``) is converted to (kWh, s) by
             ``EnergyModel.measure`` and fed to ``LevelProfiles.update``
             plus Eq. 1 carbon accounting via ``request_carbon`` — so the
             next re-plan optimizes over what the fleet actually did.

Multi-region routing (the new scenario axis): ``submit`` sends each
request to the greenest pool whose in-flight load is under ``load_cap``;
when every pool is saturated it falls back to the least-loaded one, so
carbon-chasing never starves throughput.

Two levers track the grid WITHIN the hour (DESIGN.md §8):

  forecast:  with ``forecast_horizon > 0`` each re-plan solves the LP at
             the forecast-weighted effective intensity over the next
             ``forecast_horizon`` hours (``provider.forecast`` +
             ``core.lp.forecast_weighted_intensity``) instead of the
             instantaneous value, so a pool facing a dirty hour shifts
             its directive mix pre-emptively;
  migration: a ``MigrationPlanner`` runs at every re-plan tick and moves
             queued / rejected / preempted work from dirty pools to green
             ones over the SAME verbatim-token requeue path failover uses
             (scheduler.evict -> submit), evicting decode-in-flight
             requests only when the redo economics clear a hysteresis
             band — admission chose a pool once; migration lets the
             choice follow the grid.

SLOs (DESIGN.md §10) make the quality/carbon trade per tenant and per
deadline. With ``tenants=[TenantSpec, ...]`` the gateway solves ONE LP
per (pool, tenant class) — each class carries its own Eq. 3 relaxation,
an absolute quality floor, and TTFT/TPOT latency targets — and installs
a composite per-request ``level_fn`` that draws each request's directive
level from its tenant's mix. Admission then routes on *predicted
completion time* (queue depth × measured per-level decode seconds from
``LevelProfiles`` telemetry) jointly with the planning intensity: the
greenest pool wins only while its queue would not bust the request's
deadline, so a dirty-but-idle pool beats a green-but-queued one for
latency-sensitive work. The ``MigrationPlanner`` prices SLO risk (a
request within its migration-redo time of its deadline never moves) and
``drain_pool`` migrates a pool's whole backlog ahead of maintenance over
the same verbatim-token requeue path.

``policy=None`` (and ``tenants=None``) degenerates to an L0-only gateway
(the BASE scheme over the same fleet) — the paired baseline
``benchmarks/serving_bench.py`` measures against.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.carbon import PUE, CarbonIntensityProvider, request_carbon
from repro_torch.core.energy import A100_40GB, LLAMA2_13B, EnergyModel, \
    HardwareSpec, ModelProfile
from repro_torch.core.lp import TenantSpec, forecast_weighted_intensity, \
    solve_tenant_lps
from repro_torch.core.policies import LevelProfiles, Policy
from repro_torch.core.workload import N_LEVELS, Request
from repro_torch.serving.engine import FinishedRequest
from repro_torch.serving.faults import FaultInjector, no_faults
from repro_torch.serving.scheduler import CarbonAwareScheduler, ServeRequest


@dataclasses.dataclass
class GatewayPool:
    """One regional serving pool: its grid signal, its fleet, its plan."""
    key: str
    provider: CarbonIntensityProvider
    scheduler: CarbonAwareScheduler
    x: np.ndarray                      # installed directive mix (aggregate)
    routed: int = 0                    # requests routed here
    # per-tenant-class mixes from the (pool, tenant) LP solves; the
    # composite level_fn draws each request's level from its class's mix
    x_by_tenant: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)

    def load(self, max_priority: Optional[int] = None) -> int:
        """In-flight work: scheduler backlog + engine queues + live slots.

        With ``max_priority``, scheduler backlog at a worse priority is
        excluded: scheduler dispatch is priority-ordered, so a premium
        request jumps the batch work still PENDING at the scheduler.
        Work already inside an engine is counted in full regardless of
        priority — engine queues admit FIFO and occupied slots cannot be
        jumped — so the filtered count stays an honest wait estimate,
        never an optimistic one. This is the queue-depth that
        predicted-completion routing multiplies by."""
        in_engines = sum(eng.load() for eng in self.scheduler.engines
                         if eng is not None)
        if max_priority is None:
            return len(self.scheduler.pending) + in_engines
        return in_engines + sum(1 for r in self.scheduler.pending
                                if r.priority <= max_priority)

    def slot_count(self) -> int:
        """Decode parallelism: total slots across the pool's live engines
        — the divisor that turns queue depth into service waves."""
        return sum(eng.n_slots for eng in self.scheduler.engines
                   if eng is not None)

    def tp_degree(self) -> int:
        """Tensor-parallel width of the pool's fleet: the max sharding
        degree over live engines (DESIGN.md §14). A pool is a sharded
        fleet, not N independent replicas — the gateway prices its carbon
        with ``EnergyModel.with_chips(tp_degree())`` so the LP mix and
        migration economics see multi-chip energy. Defaults to 1 for
        engines predating the ``tp_degree`` attribute (test doubles)."""
        sched_tp = getattr(self.scheduler, "tp_degree", None)
        if callable(sched_tp):
            return sched_tp()
        return max((getattr(eng, "tp_degree", 1)
                    for eng in self.scheduler.engines if eng is not None),
                   default=1)

    def chunked_fraction(self) -> float:
        """Fraction of the pool's slots served by engines with chunked
        (continuous-batching) admission. 1.0 means an arrival never waits
        for a slot-epoch boundary: its prefill interleaves into the live
        decode scan; 0.0 is the whole-prompt-stall world."""
        slots = self.slot_count()
        if slots == 0:
            return 0.0
        chunked = sum(eng.n_slots for eng in self.scheduler.engines
                      if eng is not None
                      and getattr(eng, "chunked_admission", False))
        return chunked / slots

    def kv_stats(self) -> Dict[str, float]:
        """Fleet KV-memory telemetry: allocator occupancy/fragmentation
        summed over the pool's live engines (engine.kv_stats)."""
        stats = [eng.kv_stats() for eng in self.scheduler.engines
                 if eng is not None]
        if not stats:
            return {"engines": 0}
        layouts = {s.get("layout", "dense") for s in stats}
        out: Dict[str, float] = {
            "engines": len(stats),
            "layout": layouts.pop() if len(layouts) == 1 else "mixed",
        }
        # .get defaults: a pool may mix paged and dense replicas (elastic
        # scale-up can add either), and their stat schemas differ
        for key in ("pages_in_use", "live_tokens", "kv_bytes_in_use",
                    "kv_bytes_capacity", "committed_pages",
                    "prefill_tokens_computed", "prefill_tokens_cached"):
            if any(key in s for s in stats):
                out[key] = sum(s.get(key, 0) for s in stats)
        for key in ("occupancy", "fragmentation"):
            out[key] = float(np.mean([s.get(key, 0.0) for s in stats]))
        return out


@dataclasses.dataclass
class PlanRecord:
    """One LP re-plan: what the optimizer saw and what it installed.
    ``k0`` is the PLANNING intensity (forecast-weighted when a horizon is
    set); ``k0_now`` keeps the instantaneous value for comparison."""
    t: float
    pool: str
    k0: float
    x: np.ndarray
    q_lb: float = 0.0
    expected_quality: float = 0.0
    solver: str = "warmup"
    k0_now: float = 0.0
    horizon_h: float = 0.0
    tenant: str = ""           # "" = the aggregate (tenant-less) plan
    # degraded-mode plan (DESIGN.md §12): the LP solve failed (solver is
    # "hold" — last-good mix held — or "static-safe" after N consecutive
    # holds) or the pool's carbon signal watchdog is past its staleness
    # bound; consumers treat the mix as a fallback, not a fresh optimum
    degraded: bool = False


@dataclasses.dataclass
class MigrationRecord:
    """One cross-pool move the MigrationPlanner executed."""
    t: float
    rid: int
    src: str
    dst: str
    kind: str                  # pending | rejected | queued | decoding
    level: int                 # -1 when the level is not yet drawn
    est_saving_g: float        # planner's estimate, not realized carbon
    trigger: str = "carbon"    # carbon (greener grid) | drain (maintenance)


@dataclasses.dataclass
class TelemetryRecord:
    """One finished request as the control plane saw it."""
    pool: str
    rid: int
    level: int
    prompt_tokens: int
    gen_tokens: int
    decode_s: float
    energy_kwh: float                  # incl. PUE
    carbon_g: float
    k0: float
    tenant: str = ""
    latency_s: float = 0.0             # end-to-end (incl. any migration redo)
    slo_met: bool = True               # finished by its deadline (or none)
    cached_tokens: int = 0             # prompt tokens the prefix cache served


@dataclasses.dataclass
class GatewayStats:
    carbon_g: float = 0.0
    energy_kwh: float = 0.0
    requests: int = 0
    level_counts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(N_LEVELS))
    telemetry: List[TelemetryRecord] = dataclasses.field(default_factory=list)
    plans: List[PlanRecord] = dataclasses.field(default_factory=list)
    rejected: int = 0
    migrated: int = 0
    migrations: List[MigrationRecord] = dataclasses.field(
        default_factory=list)
    # per-tenant SLO bookkeeping: requests finished / deadlines met, keyed
    # by tenant class name ("" = untagged traffic)
    tenant_requests: Dict[str, int] = dataclasses.field(default_factory=dict)
    tenant_slo_met: Dict[str, int] = dataclasses.field(default_factory=dict)
    # ----- fault/chaos ledger (DESIGN.md §12) -----
    # carbon_g above is the POOL-ATTRIBUTED total: served + wasted.
    # wasted_g is the discarded-work share (migration redos, fault
    # requeues); per-pool splits let the chaos suite assert the ledger
    # stays conserved under churn (served + wasted sums match the
    # fault-free total within accounting tolerance).
    wasted_g: float = 0.0
    carbon_by_pool: Dict[str, float] = dataclasses.field(default_factory=dict)
    wasted_by_pool: Dict[str, float] = dataclasses.field(default_factory=dict)
    faults: int = 0            # fault-caused requeues harvested fleet-wide
    shed: int = 0              # admissions shed by brownout
    plan_holds: int = 0        # LP failures answered by holding last-good
    # (rid, reason) for every request drain() parked as rejected — the
    # audit trail that lets a chaos run prove zero work was STRANDED
    # (every submitted rid is either served or here, with a reason)
    rejected_reasons: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list)

    @property
    def carbon_per_request(self) -> float:
        return self.carbon_g / max(self.requests, 1)

    def slo_attainment(self, tenant: Optional[str] = None) -> float:
        """Fraction of finished requests that met their deadline — for one
        tenant class, or fleet-wide when ``tenant`` is None. 1.0 when the
        class has served nothing (no deadline has been missed)."""
        if tenant is None:
            n = sum(self.tenant_requests.values())
            met = sum(self.tenant_slo_met.values())
        else:
            n = self.tenant_requests.get(tenant, 0)
            met = self.tenant_slo_met.get(tenant, 0)
        return met / n if n else 1.0


@dataclasses.dataclass(frozen=True)
class _Candidate:
    """One migratable unit of work in a source pool, with the numbers the
    decision rule needs. ``remaining`` is the token budget still unserved
    (equal to ``budget`` for anything that has not started decoding);
    ``prompt_len`` is 0 until the prompt has been tokenized/admitted."""
    rid: int
    kind: str                  # pending | rejected | queued | decoding
    level: Optional[int]       # None until the directive level is drawn
    budget: int                # full max_new budget on a (re)start
    remaining: int
    prompt_len: int = 0
    deadline_at: float = math.inf      # absolute deadline (monotonic clock)
    tenant: str = ""


class MigrationPlanner:
    """Cross-region request migration at re-plan ticks (DESIGN.md §8).

    Every tick the planner compares pools' PLANNING intensities (forecast-
    weighted when the gateway has a horizon) and moves work from dirty
    pools into the greenest pool with spare capacity, over the exact
    verbatim-token requeue path failover already uses. The decision rule,
    per candidate request:

      queued work  (pending / rejected / engine queue — nothing invested):
          save = (k_src − k_dst) · kwh_tok(level) · remaining
      decoding work (a live slot — prefill + partial decode invested):
          save = k_src · kwh_tok · remaining  −  k_dst · kwh_tok · budget
          (finish-here cost vs redo-from-the-prompt cost at the
          destination; eviction releases the slot and its KV pages)

    and the move happens only when ALL of:
      * the destination clears the hysteresis band:
        k_dst < (1 − hysteresis) · k_src — small crossings don't trigger;
      * save > min_saving_g (grams over the request's remaining budget);
      * the request hasn't migrated within ``cooldown_h`` simulated hours
        (a band alone cannot stop ping-pong when the oscillation exceeds
        it; the cooldown bounds moves per request regardless of trace);
      * the destination stays under the gateway's load cap.

    What never migrates: work inside a prefill or decode dispatch (the
    planner only runs between fleet steps, at re-plan ticks), and decoding
    requests whose redo cost exceeds the saving. ``kwh_tok`` comes from
    the gateway's LevelProfiles telemetry (per-level kWh over mean
    generated tokens), falling back to the roofline model until profiles
    exist. Savings are planner ESTIMATES for ordering/thresholding;
    realized carbon is still accounted at finish time from the serving
    pool's live intensity.
    """

    def __init__(self, *, hysteresis: float = 0.15,
                 min_saving_g: float = 0.0, cooldown_h: float = 2.0,
                 evict_decoding: bool = True,
                 respect_load_cap: bool = True,
                 max_moves_per_tick: int = 256,
                 slo_margin: float = 2.0):
        assert 0.0 <= hysteresis < 1.0
        assert slo_margin >= 1.0, "a margin below 1 would plan to miss"
        self.hysteresis = hysteresis
        self.min_saving_g = min_saving_g
        self.cooldown_h = cooldown_h
        self.evict_decoding = evict_decoding
        self.respect_load_cap = respect_load_cap
        self.max_moves_per_tick = max_moves_per_tick
        self.slo_margin = slo_margin
        self._last_move: Dict[int, float] = {}

    # ----- candidate enumeration --------------------------------------
    @staticmethod
    def _candidates(sched: CarbonAwareScheduler) -> List[_Candidate]:
        """Cheapest-to-move first: parked/queued work costs nothing to
        move; decoding work (listed last) forfeits its progress."""
        out: List[_Candidate] = []
        for req, _reason in sched.rejected:
            lvl = req.directive_level if (req.pre_rendered
                                          or req.prompt_token_ids) else None
            out.append(_Candidate(req.rid, "rejected", lvl,
                                  req.max_new_tokens, req.max_new_tokens,
                                  deadline_at=req.deadline_at,
                                  tenant=req.tenant))
        for req in sched.pending:
            lvl = req.directive_level if (req.pre_rendered
                                          or req.prompt_token_ids) else None
            out.append(_Candidate(req.rid, "pending", lvl,
                                  req.max_new_tokens, req.max_new_tokens,
                                  deadline_at=req.deadline_at,
                                  tenant=req.tenant))
        for eng in sched.engines:
            if eng is None:
                continue
            for st in eng.queue:
                out.append(_Candidate(st.rid, "queued", st.directive_level,
                                      st.max_new_tokens, st.max_new_tokens,
                                      len(st.prompt_ids),
                                      deadline_at=st.deadline_at,
                                      tenant=st.tenant))
            for st in eng.slots:
                if st is not None:
                    rem = max(st.max_new_tokens - len(st.generated), 0)
                    out.append(_Candidate(st.rid, "decoding",
                                          st.directive_level,
                                          st.max_new_tokens, rem,
                                          st.prompt_len,
                                          deadline_at=st.deadline_at,
                                          tenant=st.tenant))
        return out

    def _slo_safe(self, gw: "SproutGateway", cand: _Candidate,
                  dst: "GatewayPool") -> bool:
        """SLO risk pricing: a request within its migration-redo time of
        its deadline never moves. The redo time is the predicted
        completion of the FULL budget at the destination (queue depth ×
        measured per-level decode seconds), padded by ``slo_margin`` —
        the estimate rides on telemetry, so plan conservatively."""
        if math.isinf(cand.deadline_at):
            return True
        redo = gw.predicted_completion_s(dst, max_new=cand.budget,
                                         tenant=cand.tenant)
        return cand.deadline_at - time.monotonic() >= self.slo_margin * redo

    def _dst_has_room(self, gw: "SproutGateway", dst: "GatewayPool") -> bool:
        return (not self.respect_load_cap) or dst.load() < gw.load_cap

    @staticmethod
    def _dst_can_serve(dst: "GatewayPool", cand: _Candidate) -> bool:
        """Fleets can be heterogeneous (max_len / page budgets differ):
        never migrate a request into a pool where no live engine can hold
        its budget — or where its prompt would be TRUNCATED to fit, which
        would silently change the output. Without this guard an evicted
        request could end up parked as rejected at the destination (lost
        work the admission-only gateway would have finished)."""
        for eng in dst.scheduler.engines:
            if eng is None:
                continue
            if cand.budget + 1 >= eng.max_len:
                continue           # engine.submit would reject the budget
            if cand.prompt_len and \
                    cand.prompt_len + cand.budget >= eng.max_len:
                continue           # dispatch would truncate the prompt
            if eng.paged and cand.prompt_len and \
                    eng._pages_for(cand.prompt_len,
                                   cand.budget) > eng.pages.n_pages:
                continue           # worst-case reservation can never fit
            return True
        return False

    # ----- the tick ----------------------------------------------------
    def plan(self, gw: "SproutGateway") -> int:
        """Run one migration pass; returns the number of requests moved.
        Called by the gateway at every re-plan tick, after mixes install."""
        if len(gw.pools) < 2:
            return 0
        # a draining pool is leaving the fleet: never a migration target
        alive = [p for p in gw.pools
                 if any(e is not None for e in p.scheduler.engines)
                 and p.key not in gw.draining]
        if not alive:
            return 0
        k = {p.key: gw.plan_intensity(p) for p in gw.pools}
        dst_order = sorted(alive, key=lambda p: k[p.key])
        moved = 0
        for src in sorted(gw.pools, key=lambda p: -k[p.key]):
            k_src = k[src.key]
            dsts = [d for d in dst_order if d is not src
                    and k[d.key] < (1.0 - self.hysteresis) * k_src]
            if not dsts:
                continue
            for cand in self._candidates(src.scheduler):
                if moved >= self.max_moves_per_tick:
                    return moved
                if gw.t - self._last_move.get(cand.rid,
                                              -np.inf) < self.cooldown_h:
                    continue
                if cand.kind == "decoding" and not self.evict_decoding:
                    continue
                if not any(self._dst_has_room(gw, d) for d in dsts):
                    break              # every green pool is at capacity
                dst = next((d for d in dsts
                            if self._dst_has_room(gw, d)
                            and self._dst_can_serve(d, cand)
                            and self._slo_safe(gw, cand, d)), None)
                if dst is None:
                    continue           # no green pool can hold THIS request
                kwh_tok = gw.kwh_per_token(cand.level, mix=dst.x)
                if cand.kind == "decoding":
                    save = kwh_tok * (k_src * cand.remaining
                                      - k[dst.key] * cand.budget)
                else:
                    save = (k_src - k[dst.key]) * kwh_tok * cand.remaining
                if save <= self.min_saving_g:
                    continue
                req = src.scheduler.evict(cand.rid)
                if req is None:        # finished between enumeration/evict
                    continue
                if cand.kind == "decoding":
                    # the eviction discards the source's prefill + partial
                    # decode; charge that work to the source pool NOW so
                    # realized carbon never flatters migration (the redo
                    # cost the decision rule priced in is real)
                    gw.account_wasted(src, cand.prompt_len,
                                      cand.budget - cand.remaining)
                if gw.fault_injector.fire("migrate.dst_vanish", dst.key):
                    # the destination fleet dies between evict and submit:
                    # its replicas crash through the health machine (their
                    # own in-flight work fault-requeues there), and the
                    # evicted request goes home to its source pool under
                    # the bounded-retry rules — never stranded in limbo
                    for di, deng in enumerate(dst.scheduler.engines):
                        if deng is not None:
                            dst.scheduler._bench(
                                di, fault_reason="migrate.dst_vanish")
                    gw._requeue_vanished(src, req)
                    continue
                dst.scheduler.submit(req)
                self._last_move[cand.rid] = gw.t
                moved += 1
                st = gw.stats
                st.migrated += 1
                st.migrations.append(MigrationRecord(
                    gw.t, cand.rid, src.key, dst.key, cand.kind,
                    -1 if cand.level is None else cand.level, save))
                if len(st.migrations) > 2 * SproutGateway.PLAN_CAP:
                    del st.migrations[: -SproutGateway.PLAN_CAP]
        return moved

    # ----- capacity drain ---------------------------------------------
    def drain(self, gw: "SproutGateway", src: "GatewayPool") -> int:
        """Capacity-drain trigger (maintenance, not carbon): move EVERY
        movable request out of ``src`` over the same verbatim-token
        requeue path, spreading across the least-loaded capable pools.

        Unlike the carbon pass this ignores the hysteresis band, savings
        threshold, cooldown and load cap — the pool is going away, so the
        only questions are "can the destination serve it at all"
        (``_dst_can_serve``) and "is redoing a decoding request SLO-safe"
        (a near-deadline decoding request finishes faster in place; the
        pool keeps serving until the maintenance deadline, so leaving it
        is safe — and strands nothing). Returns the number moved."""
        dsts = [p for p in gw.pools
                if p is not src and p.key not in gw.draining
                and any(e is not None for e in p.scheduler.engines)]
        if not dsts:
            return 0
        moved = 0
        for cand in self._candidates(src.scheduler):
            # a decoding request only moves to a destination where the
            # redo is itself SLO-safe — checking "some safe pool exists"
            # and then shipping to a different one would waste the
            # partial decode AND miss the deadline
            ok = [d for d in dsts if self._dst_can_serve(d, cand)
                  and (cand.kind != "decoding"
                       or self._slo_safe(gw, cand, d))]
            dst = min(ok, key=lambda d: d.load(), default=None)
            if dst is None:
                continue       # no pool can take it: finish here pre-drain
            req = src.scheduler.evict(cand.rid)
            if req is None:    # finished between enumeration and evict
                continue
            if cand.kind == "decoding":
                gw.account_wasted(src, cand.prompt_len,
                                  cand.budget - cand.remaining)
            dst.scheduler.submit(req)
            moved += 1
            st = gw.stats
            st.migrated += 1
            st.migrations.append(MigrationRecord(
                gw.t, cand.rid, src.key, dst.key, cand.kind,
                -1 if cand.level is None else cand.level, 0.0,
                trigger="drain"))
            if len(st.migrations) > 2 * SproutGateway.PLAN_CAP:
                del st.migrations[: -SproutGateway.PLAN_CAP]
        return moved


PoolSpec = Tuple[Union[str, CarbonIntensityProvider], CarbonAwareScheduler]


class SproutGateway:
    """Fig. 5 component 1 over real engines — see the module docstring."""

    # long-lived control loop: aggregates run forever, per-record logs are
    # ring-buffered (oldest trimmed) so memory is bounded under real traffic
    TELEMETRY_CAP = 100_000
    PLAN_CAP = 10_000
    # each pool's scheduler draws rids from a disjoint range: migration
    # preserves a request's rid across pools, so per-pool counters starting
    # at 1 would let a migrated rid collide with a destination-native one
    # (evict-by-rid would then pop the wrong request)
    RID_STRIDE = 10_000_000

    def __init__(self, pools: Sequence[PoolSpec], *,
                 policy: Optional[Policy] = None,
                 tenants: Optional[Sequence[TenantSpec]] = None,
                 energy: Optional[EnergyModel] = None,
                 model_profile: ModelProfile = LLAMA2_13B,
                 hw: HardwareSpec = A100_40GB,
                 n_levels: int = N_LEVELS,
                 q: Optional[np.ndarray] = None,
                 k1: Optional[float] = None,
                 replan_every: float = 1.0,
                 load_cap: int = 16,
                 forecast_horizon: float = 0.0,
                 forecast_decay: float = 0.5,
                 migration: Optional[MigrationPlanner] = None,
                 seed: int = 0,
                 fault_injector: Optional["FaultInjector"] = None,
                 max_plan_holds: int = 3,
                 brownout_threshold: float = 4.0,
                 brownout_decay: float = 0.5):
        assert pools, "gateway needs at least one regional pool"
        if policy is not None and tenants is None:
            # the gateway installs the policy's directive-level mix x as
            # each pool's level_fn (it never routes via policy.assign), so
            # only mix-exposing policies fit — SproutPolicy,
            # SproutStaticPolicy, or anything with a matching .x
            x = getattr(policy, "x", None)
            if x is None or len(np.asarray(x)) != n_levels:
                raise ValueError(
                    f"policy {type(policy).__name__} must expose a "
                    f"directive-level mix .x of length {n_levels}; got "
                    f"{'none' if x is None else len(np.asarray(x))}")
        self.policy = policy
        # tenant classes by name; with tenants set the gateway solves its
        # own per-(pool, tenant) LPs (the policy's single mix would lose
        # the per-class floors) and stamps deadlines/priorities at submit
        self.tenants: Optional[Dict[str, TenantSpec]] = (
            {t.name: t for t in tenants} if tenants else None)
        if self.tenants:
            self.default_tenant = ("standard" if "standard" in self.tenants
                                   else next(iter(self.tenants)))
        self.energy = energy or EnergyModel(hw)
        self.model_profile = model_profile
        self.hw = hw
        self.n_levels = n_levels
        self.k1 = (k1 if k1 is not None
                   else hw.embodied_gco2 / hw.lifetime_s)
        self.replan_every = replan_every
        self.load_cap = load_cap
        self.forecast_horizon = forecast_horizon
        self.forecast_decay = forecast_decay
        self.migration = migration
        # pools being emptied ahead of maintenance: key -> deadline hour
        # (admission skips them; re-plan ticks keep draining their backlog)
        self.draining: Dict[str, float] = {}
        self.rng = np.random.default_rng(seed)
        self.profiles = LevelProfiles.fresh(n_levels)
        # REAL per-level decode seconds (engine-measured wall time, not the
        # roofline model): the .p vector is the "measured per-level decode
        # seconds" predicted-completion routing multiplies queue depth by.
        # Kept separate from self.profiles, whose .p carries target-hardware
        # modeled seconds for the Eq. 2 embodied-carbon term.
        self.latency_profiles = LevelProfiles.fresh(n_levels)
        # per-level generated-token sums from telemetry: with level_counts
        # they give mean tokens per level, the denominator that turns the
        # LevelProfiles per-REQUEST energies into the per-TOKEN energies
        # the migration decision rule prices budgets with
        self._tok_sum = np.zeros(n_levels)
        self.q = (np.asarray(q, float) if q is not None
                  else np.ones(n_levels) / n_levels)
        # observed task mix (decayed counts): the weights each tenant's
        # per-task q vectors are combined with at its LP solve
        self._task_counts: Dict[str, float] = {}
        self.stats = GatewayStats(level_counts=np.zeros(n_levels))
        self.t = 0.0
        self._last_replan: Optional[float] = None
        # ----- degraded-mode control plane (DESIGN.md §12) -----
        # ONE injector is shared by every layer (gateway, schedulers,
        # watchdog providers wired by the caller): its per-(point, target)
        # counters make a scripted FaultPlan land at the same opportunity
        # regardless of which layer consults first
        self.fault_injector = fault_injector or no_faults()
        self.max_plan_holds = max_plan_holds
        self.brownout_threshold = brownout_threshold
        self.brownout_decay = brownout_decay
        # consecutive LP-solve failures per pool: held plans past
        # max_plan_holds fall back to the static safe mix
        self._plan_holds: Dict[str, int] = {}
        # decayed fault pressure driving brownout (decays each replan)
        self._fault_score = 0.0
        # optional observer called as on_finish(pool_key, FinishedRequest)
        # after each request is accounted — benches/tests use it to keep
        # the full FinishedRequest (telemetry records drop token ids)
        self.on_finish = None

        self.pools: List[GatewayPool] = []
        for j, (spec, sched) in enumerate(pools):
            provider = (spec if isinstance(spec, CarbonIntensityProvider)
                        else CarbonIntensityProvider(spec))
            if len(sched.directives) < n_levels:
                raise ValueError(
                    f"pool {provider.region.key}: scheduler renders "
                    f"{len(sched.directives)} directive levels but the "
                    f"gateway plans over {n_levels} — pass a matching "
                    f"DirectiveSet to the CarbonAwareScheduler")
            pool = GatewayPool(provider.region.key, provider, sched,
                               x=np.eye(n_levels)[0])
            # the scheduler's level_fn now reads the pool's LIVE plan —
            # this is the wire that puts the LP in the request path. It is
            # a COMPOSITE per-request selector: each request draws from
            # its service class's (pool, tenant) mix (untagged requests
            # are mapped onto the default class at submit, so their
            # deadlines/priorities AND their SLO ledger entries are the
            # default class's).
            sched.level_fn = self._level_fn_for(pool)
            # disjoint rid ranges per pool (see RID_STRIDE): only bump a
            # fresh counter so a scheduler reused across gateways keeps
            # its sequence monotonic
            sched._rid = max(sched._rid, j * self.RID_STRIDE)
            # chaos wiring: the pool key names the scheduler's injection
            # targets ("CA/0" = replica 0 of pool CA); a gateway-supplied
            # injector replaces the schedulers' default no-fault ones so
            # one plan scripts the whole fleet
            sched.name = pool.key
            if fault_injector is not None:
                sched.fault_injector = self.fault_injector
            self.pools.append(pool)

    def _level_fn_for(self, pool: GatewayPool):
        """Composite per-request directive selector for one pool (the
        ``per_request`` mark tells the scheduler to pass the request).
        Gateway-routed traffic always carries a tenant tag by the time it
        dispatches (``submit`` maps untagged requests onto the default
        class); the ``pool.x`` fallback covers requests fed straight into
        the scheduler and mixes installed before the first tenant plan."""
        def fn(req: Optional[ServeRequest] = None) -> int:
            x = pool.x
            if req is not None and self.tenants:
                x = pool.x_by_tenant.get(self._tenant_of(req).name, pool.x)
            return int(self.rng.choice(self.n_levels, p=x))
        fn.per_request = True
        return fn

    def _tenant_of(self, req: ServeRequest) -> TenantSpec:
        """The request's service class (the default class when untagged).
        Only meaningful when the gateway runs with tenants."""
        assert self.tenants is not None
        return self.tenants.get(req.tenant) or \
            self.tenants[self.default_tenant]

    # ----- planning ---------------------------------------------------
    def set_quality(self, q: np.ndarray) -> None:
        """Install a fresh evaluator preference vector (Eq. 5's q)."""
        self.q = np.asarray(q, float)

    def plan_intensity(self, pool: GatewayPool) -> float:
        """The intensity the control plane PLANS against for a pool: the
        forecast-weighted effective value over ``forecast_horizon`` hours
        when a horizon is set (the LP objective is linear in k0, so this
        scalar solves the window exactly), else the instantaneous signal.
        Accounting always uses the live instantaneous intensity."""
        if self.forecast_horizon > 0:
            return forecast_weighted_intensity(
                pool.provider.forecast(self.t, self.forecast_horizon),
                decay=self.forecast_decay)
        return pool.provider.intensity(self.t)

    def kwh_per_token(self, level: Optional[int] = None,
                      mix: Optional[np.ndarray] = None) -> float:
        """Per-generated-token energy (kWh, incl. PUE) at a directive
        level, from LevelProfiles telemetry (per-level kWh over mean
        generated tokens); ``level=None`` takes the expectation under
        ``mix`` (the destination pool's plan — an undrawn request will
        draw its level there). Roofline fallback until telemetry exists."""
        fallback = self.energy.request_energy_kwh(
            self.model_profile, 0, 1) * PUE
        counts = np.maximum(self.stats.level_counts, 1)
        mean_tok = np.maximum(self._tok_sum / counts, 1.0)
        per_level = np.where(self.stats.level_counts > 0,
                             self.profiles.e / mean_tok, fallback)
        if level is not None:
            return float(per_level[min(level, self.n_levels - 1)])
        w = (np.asarray(mix, float) if mix is not None
             else np.ones(self.n_levels) / self.n_levels)
        return float(per_level @ w)

    def service_s(self, level: Optional[int] = None,
                  mix: Optional[np.ndarray] = None) -> float:
        """Measured decode seconds per request at a directive level (from
        the ``latency_profiles`` telemetry — real engine wall time), or
        the expectation under ``mix``. 0.0 until telemetry exists: with
        nothing measured, predicted completion degrades to "everything is
        feasible" and routing falls back to pure greenness."""
        per_level = np.where(self.latency_profiles.counts > 0,
                             self.latency_profiles.p, 0.0)
        if level is not None:
            return float(per_level[min(level, self.n_levels - 1)])
        w = (np.asarray(mix, float) if mix is not None
             else np.ones(self.n_levels) / self.n_levels)
        return float(per_level @ w)

    def predicted_completion_s(self, pool: GatewayPool,
                               max_new: Optional[int] = None,
                               tenant: str = "") -> float:
        """How long a request admitted NOW would take to finish in this
        pool: queue depth over decode parallelism (service waves) times
        the measured per-level decode seconds, under the mix the request
        would draw from. This is the latency half of admission routing —
        a green pool with a deep queue loses to a dirty idle one when the
        wait would bust the deadline. ``max_new`` is accepted for callers
        that price a specific budget; the estimate currently keys on the
        profiled per-mix mean (budgets enter via the mix's level draw).

        Chunked-admission engines change the wait model: an arrival's
        prefill streams into the live decode scan instead of stalling
        behind a slot-epoch boundary, so service overlaps the residual
        current wave — on average half a wave of alignment wait vanishes
        per chunked slot. The estimate subtracts that overlap credit,
        scaled by the pool's chunked slot fraction, and never drops below
        the request's own service time."""
        del max_new
        slots = pool.slot_count()
        if slots == 0:
            return math.inf
        x = pool.x
        prio = None
        if self.tenants and tenant in self.tenants:
            x = pool.x_by_tenant.get(tenant, pool.x)
            # priority-ordered dispatch: the queue this class waits behind
            # is its own class and better, not the whole backlog
            prio = self.tenants[tenant].priority
        svc = self.service_s(mix=x)
        queued = pool.load(prio) / slots
        waves = 1.0 + queued
        if queued > 0:
            waves = max(1.0, waves - 0.5 * pool.chunked_fraction())
        return svc * waves

    def replan(self, t: Optional[float] = None) -> None:
        """Re-solve the directive LP per pool at its planning intensity
        (forecast-weighted when a horizon is set) and install the mixes;
        then run the migration pass, so backlog follows the same signal
        the fresh plans were solved against. ``policy=None`` pins every
        pool to L0 (migration still runs — it is a routing decision)."""
        if t is not None:
            self.t = t
        self._last_replan = self.t
        # halve EVERY task count each re-plan (not just arriving tasks):
        # a task that stops arriving decays away instead of skewing the
        # tenant LPs' task weighting forever; tiny tails are dropped
        self._task_counts = {k: v / 2 for k, v in self._task_counts.items()
                             if v / 2 >= 0.01}
        # amortized trim: cut back to the cap only at 2x, so steady state
        # is O(1) per replan rather than a full shift every time
        if len(self.stats.plans) > 2 * self.PLAN_CAP:
            del self.stats.plans[: -self.PLAN_CAP]
        # fault pressure decays per replan tick: brownout lifts once the
        # fleet stops faulting, without a manual all-clear
        self._fault_score *= self.brownout_decay
        for pool in self.pools:
            k0_now = pool.provider.intensity(self.t)
            k0 = self.plan_intensity(pool)
            # degraded signal: the pool's watchdog (when wrapped) is past
            # its staleness bound — plans still solve, flagged degraded
            sick = bool(getattr(pool.provider, "degraded", False))
            k0_solve = k0
            if self.fault_injector.fire("lp.fail", pool.key):
                # bad telemetry reaching the solver; the injected NaN is
                # rejected by solve_directive_lp's input validation — the
                # genuine failure path, not an injector shortcut
                k0_solve = float("nan")
            if self.tenants is not None:
                try:
                    self._replan_tenants(pool, k0_solve, k0_now, sick)
                    self._plan_holds[pool.key] = 0
                except (ValueError, FloatingPointError):
                    self._plan_hold(pool, k0, k0_now)
                continue
            if self.policy is None:
                pool.x = np.eye(self.n_levels)[0]
                self.stats.plans.append(PlanRecord(
                    self.t, pool.key, k0, pool.x.copy(), solver="l0-fixed",
                    k0_now=k0_now, horizon_h=self.forecast_horizon,
                    degraded=sick))
                continue
            try:
                self.policy.begin_hour(self.t, k0_solve, self.profiles,
                                       self.q, {})
            except (ValueError, FloatingPointError):
                self._plan_hold(pool, k0, k0_now)
                continue
            self._plan_holds[pool.key] = 0
            pool.x = np.asarray(self.policy.x, float).copy()
            sol = getattr(self.policy, "last_solution", None)
            if self.brownout and sol is not None:
                # overload/fault pressure: push the mix toward the cheap
                # levels as far as the solved quality floor allows — the
                # floor itself (Eq. 3 + any q_lb_floor) is never crossed
                pool.x = self._brownout_clamp(pool.x, self.q, sol.q_lb)
            self.stats.plans.append(PlanRecord(
                self.t, pool.key, k0, pool.x.copy(),
                q_lb=(sol.q_lb if sol else 0.0),
                expected_quality=(sol.expected_quality if sol
                                  else float(self.q @ pool.x)),
                solver=(sol.solver if sol else "warmup"),
                k0_now=k0_now, horizon_h=self.forecast_horizon,
                degraded=sick))
        # capacity drains run before the carbon pass: a draining pool's
        # backlog must leave regardless of where the grid is greener
        for key in list(self.draining):
            self._drain_planner().drain(self, self._pool(key))
        if self.migration is not None:
            self.migration.plan(self)

    def _replan_tenants(self, pool: GatewayPool, k0: float,
                        k0_now: float, sick: bool = False) -> None:
        """One LP per (pool, tenant class): each class's xi, absolute
        quality floor and task-weighted q vector shape its own mix. The
        pool's aggregate ``x`` (used by migration's energy expectation
        and untagged traffic) is the served-share-weighted mean of the
        class mixes. Warmup matches SproutPolicy: uniform mixes until
        every level has ≥5 profiled requests."""
        if self.profiles.counts.min() < 5:
            uniform = np.ones(self.n_levels) / self.n_levels
            pool.x = uniform.copy()
            for name in self.tenants:
                pool.x_by_tenant[name] = uniform.copy()
            self.stats.plans.append(PlanRecord(
                self.t, pool.key, k0, uniform.copy(), solver="warmup",
                k0_now=k0_now, horizon_h=self.forecast_horizon,
                degraded=sick))
            return
        k_min = min(p.provider.k_min for p in self.pools)
        k_max = max(p.provider.k_max for p in self.pools)
        sols = solve_tenant_lps(
            self.profiles.e, self.profiles.p, list(self.tenants.values()),
            self.q, k0=k0, k1=self.k1, k0_min=k_min, k0_max=k_max,
            task_weights=self._task_counts)
        share = np.array([max(self.stats.tenant_requests.get(n, 0), 1)
                          for n in sols], float)
        share = share / share.sum()
        pool.x = np.zeros(self.n_levels)
        for w, (name, sol) in zip(share, sols.items()):
            x_t = sol.x.copy()
            if self.brownout:
                # brownout presses each class toward its cheapest levels;
                # sol.q_lb already folds in the class's absolute floor
                # (q_floor_frac · q0), so a premium guarantee holds by
                # construction even while batch work gets clamped hard
                q_eff = self.tenants[name].effective_q(self.q,
                                                       self._task_counts)
                x_t = self._brownout_clamp(x_t, q_eff, sol.q_lb)
            pool.x_by_tenant[name] = x_t
            pool.x += w * x_t
            self.stats.plans.append(PlanRecord(
                self.t, pool.key, k0, x_t.copy(), q_lb=sol.q_lb,
                expected_quality=sol.expected_quality, solver=sol.solver,
                k0_now=k0_now, horizon_h=self.forecast_horizon,
                tenant=name, degraded=sick))

    # ----- degraded mode (DESIGN.md §12) ------------------------------
    @property
    def brownout(self) -> bool:
        """Fleet under fault pressure: decayed fault score past the
        threshold. While true, admission sheds batch-priority work and
        fresh plans are clamped toward the cheap levels."""
        return self._fault_score >= self.brownout_threshold

    def _plan_hold(self, pool: GatewayPool, k0: float,
                   k0_now: float) -> None:
        """The LP solve failed (non-finite telemetry / carbon terms): hold
        the pool's last-good mix. After ``max_plan_holds`` CONSECUTIVE
        failures the held plan itself is stale — fall to the static safe
        mix (pure L0: full quality, no optimizer in the loop), the same
        configuration the policy-less BASE gateway runs."""
        n = self._plan_holds.get(pool.key, 0) + 1
        self._plan_holds[pool.key] = n
        self.stats.plan_holds += 1
        self._fault_score += 1.0
        if n > self.max_plan_holds:
            safe = np.eye(self.n_levels)[0]
            pool.x = safe.copy()
            if self.tenants:
                for name in self.tenants:
                    pool.x_by_tenant[name] = safe.copy()
            solver = "static-safe"
        else:
            solver = "hold"            # pool.x keeps its last-good mix
        self.stats.plans.append(PlanRecord(
            self.t, pool.key, k0, pool.x.copy(), solver=solver,
            k0_now=k0_now, horizon_h=self.forecast_horizon, degraded=True))

    def _brownout_clamp(self, x: np.ndarray, q_vec: np.ndarray,
                        floor: float) -> np.ndarray:
        """Blend a solved mix toward the cheapest level exactly as far as
        its quality floor allows: the result is ``(1-a)·x + a·e_cheap``
        with the largest ``a`` in [0, 1] keeping ``q·x' >= floor``. The
        solved mix already satisfies the floor, so the clamp can only
        move along a segment whose floor-feasible prefix we stay inside —
        quality guarantees survive brownout by construction."""
        q_vec = np.asarray(q_vec, float)
        x = np.asarray(x, float)
        cheap = np.eye(self.n_levels)[self.n_levels - 1]
        qx = float(q_vec @ x)
        q_cheap = float(q_vec[-1])
        if q_cheap >= floor - 1e-12:
            return cheap               # even all-cheap clears the floor
        a = (qx - floor) / max(qx - q_cheap, 1e-12)
        a = float(np.clip(a, 0.0, 1.0))
        return (1.0 - a) * x + a * cheap

    def _requeue_vanished(self, src: GatewayPool, req: ServeRequest) -> None:
        """A migration's destination vanished between evict and submit:
        the evicted request goes home to its SOURCE pool under the same
        bounded-retry rules engine faults use — retry counted, backoff
        stamped, rejected with a reason once the budget is spent."""
        req.retries += 1
        req.last_fault = "migrate.dst_vanish"
        self.stats.faults += 1
        self._fault_score += 1.0
        sched = src.scheduler
        if req.retries > sched.retry_budget:
            sched.rejected.append(
                (req, f"retry budget exhausted ({sched.retry_budget}) "
                      f"after fault migrate.dst_vanish"))
            return
        sched._backoff[req.rid] = sched.steps + \
            sched.backoff_base_steps * 2 ** (req.retries - 1)
        sched.submit(req)

    def _pool(self, key: str) -> GatewayPool:
        for p in self.pools:
            if p.key == key:
                return p
        raise KeyError(f"no pool for region {key!r}")

    def _drain_planner(self) -> MigrationPlanner:
        """The planner drains ride on: the configured one, else a lazily
        created default (drain must work on admission-only gateways)."""
        if self.migration is not None:
            return self.migration
        if not hasattr(self, "_fallback_planner"):
            self._fallback_planner = MigrationPlanner()
        return self._fallback_planner

    def tick(self, t: float) -> None:
        """Advance the gateway clock; re-plan when the interval elapsed."""
        self.t = t
        if (self._last_replan is None
                or t - self._last_replan >= self.replan_every - 1e-9):
            self.replan()

    # ----- request path ----------------------------------------------
    def submit(self, req: ServeRequest) -> Tuple[int, str]:
        """Route a request; returns (rid, pool key).

        Without a deadline: the greenest pool under ``load_cap``
        (least-loaded when all pools are saturated). Greenness is the
        PLANNING intensity — the same forecast-weighted signal
        re-planning and migration use — so admission never sends work to
        an instantaneously-green pool the next tick's migration pass
        would immediately pull it back out of.

        With a deadline (stamped here from the tenant's TTFT/TPOT targets
        when the caller left it unset): pools are scored on PREDICTED
        COMPLETION TIME jointly with greenness — greenest-first among the
        pools whose predicted completion fits the deadline, falling back
        to the fastest pool when no green pool can make it. That is the
        quality/latency/carbon triangle in one line: a dirty-but-idle
        pool wins exactly when the green pool's queue would bust the
        deadline.

        Pools whose fleet is entirely gone, and pools draining ahead of
        maintenance, are skipped while any alternative exists. The
        ``pool.x`` aggregate installed by re-planning remains in use for
        migration's energy expectation and for requests fed straight
        into a pool's scheduler, bypassing this router."""
        if self.tenants is not None:
            spec = self._tenant_of(req)
            req.tenant = spec.name
            req.priority = spec.priority
            if math.isinf(req.deadline_s) and math.isinf(req.deadline_at):
                req.deadline_s = spec.deadline_for(req.max_new_tokens)
        if self.brownout and req.priority >= 2:
            # brownout sheds the BATCH tier first: deferrable work is
            # turned away at the door (rid 0 = not admitted) so the
            # faulting fleet's remaining capacity serves latency- and
            # quality-bound tenants; premium/standard always admit
            self.stats.shed += 1
            return 0, "shed"
        if req.task:
            self._task_counts[req.task] = \
                self._task_counts.get(req.task, 0.0) + 1.0
        alive = [p for p in self.pools
                 if any(e is not None for e in p.scheduler.engines)]
        open_ = [p for p in alive if p.key not in self.draining]
        candidates = open_ or alive or self.pools
        by_carbon = sorted(candidates, key=self.plan_intensity)
        deadline = req.deadline_s if math.isinf(req.deadline_at) else \
            req.deadline_at - time.monotonic()
        if not math.isinf(deadline):
            fits = [p for p in by_carbon
                    if self.predicted_completion_s(
                        p, max_new=req.max_new_tokens,
                        tenant=req.tenant) <= deadline]
            pool = (next((p for p in fits if p.load() < self.load_cap),
                         fits[0]) if fits
                    else min(candidates, key=lambda p:
                             self.predicted_completion_s(
                                 p, max_new=req.max_new_tokens,
                                 tenant=req.tenant)))
        else:
            pool = next((p for p in by_carbon if p.load() < self.load_cap),
                        min(candidates, key=lambda p: p.load()))
        rid = pool.scheduler.submit(req)
        pool.routed += 1
        return rid, pool.key

    def drain_pool(self, region: str, deadline: Optional[float] = None
                   ) -> int:
        """Capacity-drain trigger: empty a pool ahead of maintenance.

        Marks the pool as draining — admission stops routing to it and
        every re-plan tick keeps moving its backlog to the least-loaded
        capable pools over the verbatim-token requeue path — and runs one
        drain pass immediately. ``deadline`` (simulated hours) is an
        operator RECORD of when maintenance begins (inspectable via
        ``self.draining``); it does not alter the decision rule — what
        governs each move is the REQUEST's own deadline (a decoding
        request whose redo elsewhere would bust it finishes in place,
        which is safe because the pool keeps serving until maintenance
        actually starts). Returns the number of requests moved by the
        immediate pass. Call ``undrain_pool`` after maintenance to
        rejoin the fleet."""
        pool = self._pool(region)
        self.draining[region] = self.t if deadline is None else deadline
        return self._drain_planner().drain(self, pool)

    def undrain_pool(self, region: str) -> None:
        """Maintenance over: the pool takes traffic again."""
        self.draining.pop(self._pool(region).key, None)

    def step(self) -> int:
        """One fleet step across every pool; harvests finished telemetry
        and the schedulers' fault events (each fault feeds the brownout
        pressure score and charges the discarded work to the pool's
        wasted-carbon ledger — a retried request's first attempt burned
        real energy that conservation accounting must not drop)."""
        tokens = 0
        for pool in self.pools:
            tokens += pool.scheduler.step()
            ev = pool.scheduler.fault_events
            if ev:
                pool.scheduler.fault_events = []
                for _reason, rst in ev:
                    self.stats.faults += 1
                    self._fault_score += 1.0
                    self.account_wasted(pool, rst.prompt_len,
                                        len(rst.generated))
            if pool.scheduler.finished:
                for fin in pool.scheduler.finished:
                    self._account(pool, fin)
                pool.scheduler.finished = []
        return tokens

    def drain(self, max_steps: int = 100000) -> None:
        """Serve until every pool is idle. A pool whose fleet is entirely
        gone can never serve its backlog — its pending requests are parked
        as rejected instead of spinning here and skewing routing load."""
        for _ in range(max_steps):
            tokens = self.step()
            if not any(p.load() for p in self.pools):
                break
            if tokens == 0:
                for p in self.pools:
                    # only park a backlog when the pool can NEVER serve it:
                    # no live engines and none benched on probation (a
                    # probationary replica will be re-admitted in a few
                    # scheduler steps and the backlog drains through it)
                    if p.scheduler.pending and not any(
                            e is not None for e in p.scheduler.engines) \
                            and not p.scheduler.has_recoverable_replica():
                        p.scheduler.rejected.extend(
                            (req, "no live engines in pool")
                            for req in p.scheduler.pending)
                        p.scheduler.pending = []
        for pool in self.pools:
            self.stats.rejected += len(pool.scheduler.rejected)
            self.stats.rejected_reasons.extend(
                (req.rid, reason) for req, reason in pool.scheduler.rejected)
            if len(self.stats.rejected_reasons) > 2 * self.PLAN_CAP:
                del self.stats.rejected_reasons[: -self.PLAN_CAP]
            pool.scheduler.rejected = []

    # ----- feedback ---------------------------------------------------
    def energy_for(self, pool: GatewayPool) -> EnergyModel:
        """The energy model priced for this pool's fleet geometry: a
        tp-sharded pool is metered as ``n_chips = tp_degree`` (per-chip
        HBM + collective bytes, fleet power — DESIGN.md §14). tp=1 pools
        get ``self.energy`` back unchanged (``with_chips`` is identity),
        so single-chip accounting stays bit-identical."""
        return self.energy.with_chips(pool.tp_degree())

    def account_wasted(self, pool: GatewayPool, prompt_tokens: int,
                       gen_tokens: int) -> None:
        """Charge the source pool for work a decoding eviction discards
        (its prefill + partial generation restart from scratch at the
        destination). Adds carbon/energy WITHOUT incrementing the request
        count, so carbon-per-request comparisons against the admission-only
        gateway include the redo cost the migration decision rule priced
        in — realized savings are never flattered by free restarts."""
        k0 = pool.provider.intensity(self.t)
        kwh, secs = self.energy_for(pool).measure(
            self.model_profile, prompt_tokens, max(gen_tokens, 0))
        kwh *= PUE
        wasted = request_carbon(k0, kwh, secs, self.hw.embodied_gco2,
                                self.hw.lifetime_s, pue=1.0)
        st = self.stats
        st.carbon_g += wasted
        st.energy_kwh += kwh
        # conservation ledger: carbon_g = Σ carbon_by_pool + Σ wasted_by_pool
        st.wasted_g += wasted
        st.wasted_by_pool[pool.key] = \
            st.wasted_by_pool.get(pool.key, 0.0) + wasted

    def _account(self, pool: GatewayPool, fin: FinishedRequest) -> None:
        """Engine telemetry -> kWh (EnergyModel.measure) -> Eq. 1 carbon +
        LevelProfiles feedback. This is the loop's return edge: the next
        ``replan`` solves over exactly these measured profiles."""
        k0 = pool.provider.intensity(self.t)
        # Eq. 1 credit for the radix prefix cache (DESIGN.md §13): prompt
        # tokens served from cached pages were never prefilled, so the
        # prefill term of the energy model only charges the computed span
        cached = getattr(fin, "cached_tokens", 0)
        kwh, secs = self.energy_for(pool).measure(
            self.model_profile, max(fin.prompt_tokens - cached, 0),
            fin.gen_tokens, fin.decode_s)
        kwh *= PUE
        carbon = request_carbon(k0, kwh, secs, self.hw.embodied_gco2,
                                self.hw.lifetime_s, pue=1.0)
        self.profiles.update(fin.directive_level, kwh, secs)
        # real decode seconds feed the latency profiles that predicted-
        # completion routing and migration SLO pricing multiply queue
        # depth by (self.profiles.p stays modeled target-hardware time)
        self.latency_profiles.update(fin.directive_level, 0.0, fin.decode_s)
        st = self.stats
        st.carbon_g += carbon
        st.carbon_by_pool[pool.key] = \
            st.carbon_by_pool.get(pool.key, 0.0) + carbon
        st.energy_kwh += kwh
        st.requests += 1
        st.level_counts[fin.directive_level] += 1
        self._tok_sum[fin.directive_level] += fin.gen_tokens
        st.tenant_requests[fin.tenant] = \
            st.tenant_requests.get(fin.tenant, 0) + 1
        st.tenant_slo_met[fin.tenant] = \
            st.tenant_slo_met.get(fin.tenant, 0) + int(fin.slo_met)
        st.telemetry.append(TelemetryRecord(
            pool.key, fin.rid, fin.directive_level, fin.prompt_tokens,
            fin.gen_tokens, fin.decode_s, kwh, carbon, k0,
            tenant=fin.tenant, latency_s=fin.latency_s,
            slo_met=fin.slo_met, cached_tokens=cached))
        if len(st.telemetry) > 2 * self.TELEMETRY_CAP:
            # amortized: one O(cap) shift per cap appends, not per request
            del st.telemetry[: -self.TELEMETRY_CAP]
        if self.on_finish is not None:
            self.on_finish(pool.key, fin)

    # ----- convenience ------------------------------------------------
    def run_hour(self, t: float, requests: Sequence[ServeRequest],
                 on_inflight=None, steps: Optional[int] = None) -> Dict:
        """One simulated hour: tick (re-plan if due), route, serve, account.
        Returns a summary of what this hour did. ``on_inflight(gateway)``,
        if given, runs after one fleet step with the hour's work in flight —
        the hook for fault/elasticity scenarios (fail a replica, scale up)
        without hand-rolling the hour's accounting.

        ``steps=None`` drains the fleet to idle (every request finishes
        inside its hour). ``steps=k`` runs exactly k fleet steps instead,
        so unfinished backlog RIDES OVER to the next hour — the load shape
        that gives the next tick's forecast re-plan and migration pass
        something to act on (the intensity-crossover scenario in
        examples/carbon_aware_serving.py and the migration benchmark)."""
        n0 = self.stats.requests
        c0 = self.stats.carbon_g
        m0 = self.stats.migrated
        f0 = self.stats.faults
        s0 = self.stats.shed
        w0 = self.stats.wasted_g
        lv0 = self.stats.level_counts.copy()
        tr0 = dict(self.stats.tenant_requests)
        tm0 = dict(self.stats.tenant_slo_met)
        self.tick(t)
        routes: Dict[str, int] = {p.key: 0 for p in self.pools}
        for req in requests:
            _, key = self.submit(req)
            # .get: brownout shedding introduces the synthetic "shed" key
            routes[key] = routes.get(key, 0) + 1
        # KV telemetry is sampled with the hour's work in flight (after
        # drain the pages are back on the free heap and occupancy is 0)
        self.step()
        kv = {p.key: p.kv_stats() for p in self.pools}
        if on_inflight is not None:
            on_inflight(self)
        if steps is None:
            self.drain()
        else:
            for _ in range(max(steps - 1, 0)):
                self.step()
        mix = self.stats.level_counts - lv0
        # per-tenant deadline attainment over THIS hour's finishes
        slo: Dict[str, float] = {}
        for name, n in self.stats.tenant_requests.items():
            dn = n - tr0.get(name, 0)
            if dn > 0:
                dm = self.stats.tenant_slo_met.get(name, 0) - tm0.get(name, 0)
                slo[name] = dm / dn
        return {
            "t": t,
            "k0": {p.key: p.provider.intensity(t) for p in self.pools},
            "x": {p.key: p.x.copy() for p in self.pools},
            "routes": routes,
            "served": self.stats.requests - n0,
            "carbon_g": self.stats.carbon_g - c0,
            "level_mix": mix / max(mix.sum(), 1),
            "kv": kv,
            "migrated": self.stats.migrated - m0,
            "slo": slo,
            "draining": sorted(self.draining),
            "faults": self.stats.faults - f0,
            "shed": self.stats.shed - s0,
            "wasted_g": self.stats.wasted_g - w0,
            "brownout": self.brownout,
        }


def serve_request_from(req: Request, *, token_scale: float = 8.0,
                       min_new: int = 2, max_new: int = 40,
                       prompt: Optional[str] = None,
                       tenant: str = "",
                       deadline_s: float = float("inf")) -> ServeRequest:
    """Bridge a synthetic ``core.workload.Request`` onto the real engine:
    the per-level generation lengths the workload model predicts become
    per-level token budgets (scaled down to the reduced config), so the
    engine's MEASURED telemetry carries the paper's L0>=L1>=L2 brevity
    structure without needing an instruction-following model. The task
    family rides along so tenant LPs can weight their per-task q vectors
    by the live mix; ``tenant``/``deadline_s`` tag the request for the
    gateway's SLO layer (an unset deadline is stamped from the tenant's
    TTFT/TPOT targets at submit)."""
    budgets = [int(np.clip(round(g / token_scale), min_new, max_new))
               for g in req.gen_tokens]
    return ServeRequest(
        0, prompt or f"[{req.task}] request {req.rid}",
        max_new_tokens=budgets[0], max_new_by_level=budgets,
        task=req.task, tenant=tenant, deadline_s=deadline_s)
