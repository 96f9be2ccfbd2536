"""Scripted chaos scenario for the port's serving stack (DESIGN.md §12;
counterpart of ``repro/serving/chaos.py``, on the card by default):

    PYTHONPATH=src python -m repro_torch.serving.chaos [--device cpu]

One deterministic four-hour storyline:

  hour 0  fault-free warmup, drained — profiles warm past the LP's
          warmup gate (>=5 finishes per level) so later plans SOLVE;
  hour 1  fault-free, cut off after 2 fleet steps — the carried-over
          backlog is what hour 2's migration pass and lane poisons bite;
  hour 2  the injector ARMS and every fault class fires inside one
          ``run_hour``: the grid feed NaNs, stales and raises; the LP
          solve fails (plan-hold); a replica crashes mid-block; live
          lanes are KV-poisoned (caught by the in-scan finiteness
          verdict); a migration's destination fleet vanishes between
          evict and submit;
  hour 3  aftermath: the decayed fault score holds brownout, so batch
          admissions shed while premium/standard still serve under
          clamped-but-floor-respecting mixes.

Everything observable is a pure function of the fault plan + seeds: no
wall-clock feeds routing (tenant specs carry no latency targets, the
straggler detector is disabled), energy is token-count-derived, and
sampling is greedy — so two runs byte-diff equal under any
PYTHONHASHSEED, and a paired fault-free control run pins down what the
chaos run must still produce: the same greedy tokens per request, a
conserved carbon ledger, zero stranded work.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.carbon import CarbonIntensityProvider, WatchdogProvider
from repro_torch.core.lp import TenantSpec
from repro_torch.core.workload import N_LEVELS
from repro_torch.serving.faults import FaultInjector, FaultPlan, FaultSpec, POINTS
from repro_torch.serving.gateway import MigrationPlanner, SproutGateway
from repro_torch.serving.scheduler import CarbonAwareScheduler, ServeRequest

# deadline-free tenant classes: latency targets would route on measured
# wall-clock decode seconds, which no two runs share — the chaos contract
# is bit-reproducibility, so only priorities and quality floors remain
CHAOS_TENANTS = (
    TenantSpec("premium", xi=0.03, q_floor_frac=0.97, priority=0),
    TenantSpec("standard", xi=0.12, q_floor_frac=0.80, priority=1),
    TenantSpec("batch", xi=0.35, priority=2),
)

RETRY_BUDGET = 3
ARMED_HOUR = 2


def _twin_provider(scale: float = 0.95) -> Tuple[CarbonIntensityProvider,
                                                 CarbonIntensityProvider]:
    """Two pools on near-identical grids: pool B's trace is pool A's
    scaled by ``scale``. The 5% differential is enough for the migration
    planner (hysteresis 0) to move backlog — giving migrate.dst_vanish
    a genuine attempt to sabotage — while keeping the served-carbon
    ledger comparable to the control run within a tight tolerance."""
    a = CarbonIntensityProvider("TX", "jun")
    b = CarbonIntensityProvider("TX", "jun")
    b.trace = b.trace * scale
    b.region = dataclasses.replace(b.region, key="TX2")
    return a, b


def default_plan() -> FaultPlan:
    """All seven injection points, occurrence-scripted relative to the
    arming step (hour 2's tick is the first armed opportunity)."""
    return FaultPlan([
        # hour-2 replan, pool TX: 1st fetch NaNs, 2nd re-serves stale
        FaultSpec("carbon.nan", "TX", occurrences=(0,)),
        FaultSpec("carbon.stale", "TX", occurrences=(1,)),
        # pool TX2's first fetch raises (transport timeout / 5xx)
        FaultSpec("carbon.exception", "TX2", occurrences=(0,)),
        # pool TX's LP solve sees non-finite carbon terms -> plan-hold
        FaultSpec("lp.fail", "TX", occurrences=(0,)),
        # replica 0 of pool TX dies on its 2nd armed step (work in flight)
        FaultSpec("replica.crash", "TX/0", occurrences=(1,)),
        # the 1st and 9th occupied lane consulted anywhere get KV-poisoned
        FaultSpec("decode.nonfinite", "*", occurrences=(0, 8)),
        # the first migration attempt's destination fleet vanishes
        FaultSpec("migrate.dst_vanish", "*", occurrences=(0,)),
    ])


def chaos_requests(hour: int, n: int) -> List[ServeRequest]:
    """Pre-rendered, fixed-level, greedy requests: the directive level is
    part of the request (no RNG draw at dispatch), so a retried request
    re-decodes the exact same prompt at the exact same level."""
    out = []
    for i in range(n):
        out.append(ServeRequest(
            0, f"chaos h{hour} i{i:02d}",
            max_new_tokens=4 + (i % 4),
            pre_rendered=True, directive_level=i % N_LEVELS,
            tenant=CHAOS_TENANTS[i % len(CHAOS_TENANTS)].name))
    return out


def build_model(device="cuda"):
    """The reduced model the scenario serves: the port's seed-0 weights,
    drawn on the CPU and copied to ``device``, so every device serves the
    same weights."""
    from repro_torch.configs import reduced
    from repro_torch.models import model as MD
    from repro_torch.models.common import resolve_device
    device = resolve_device(device)     # raises where there is no card
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    params = MD.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")

    def to(x):
        return ({k: to(v) for k, v in x.items()} if isinstance(x, dict)
                else [to(v) for v in x] if isinstance(x, list)
                else x.to(device))
    return cfg, to(params)


def _build_gateway(cfg, params,
                   injector: Optional[FaultInjector]) -> SproutGateway:
    from repro_torch.serving.engine import InferenceEngine
    prov_a, prov_b = _twin_provider()
    wd_a = WatchdogProvider(prov_a, max_stale_h=0.5, fault_injector=injector)
    wd_b = WatchdogProvider(prov_b, max_stale_h=0.5, fault_injector=injector)
    device = params["embed"]["tok"].device      # the engines serve there
    mk = lambda seed: InferenceEngine(cfg, params, n_slots=2, max_len=64,
                                      seed=seed, device=device)
    sched_kw = dict(straggler_factor=1e9, retry_budget=RETRY_BUDGET,
                    backoff_base_steps=1, probation_steps=4, clean_window=8)
    sched_a = CarbonAwareScheduler([mk(0)], **sched_kw)
    sched_b = CarbonAwareScheduler([mk(1)], **sched_kw)
    return SproutGateway(
        [(wd_a, sched_a), (wd_b, sched_b)],
        tenants=list(CHAOS_TENANTS), n_levels=N_LEVELS,
        replan_every=1.0, load_cap=4,
        migration=MigrationPlanner(hysteresis=0.0, cooldown_h=0.0,
                                   slo_margin=1.0),
        seed=7, fault_injector=injector,
        max_plan_holds=2, brownout_threshold=1.5, brownout_decay=0.5)


def _schedule() -> List[Tuple[List[ServeRequest], Optional[int]]]:
    return [
        (chaos_requests(0, 18), None),   # warmup, drained
        (chaos_requests(1, 10), 2),      # 2 steps only: backlog carries
        (chaos_requests(2, 12), None),   # the chaos hour (injector arms)
        (chaos_requests(3, 9), None),    # brownout aftermath
    ]


def run_scenario(cfg, params, *, plan: Optional[FaultPlan] = None,
                 seed: int = 0) -> Dict:
    """One full scenario run on the device ``params`` live on;
    ``plan=None`` is the fault-free control. Returns a JSON-serializable
    report of every deterministic observable."""
    inj = FaultInjector(plan, seed=seed) if plan is not None else None
    gw = _build_gateway(cfg, params, inj)
    if inj is not None:
        inj.armed = False
    order: List[int] = []            # submission index -> rid (0 = shed)
    tenants: List[str] = []
    orig_submit = gw.submit
    def recording_submit(req):
        tenants.append(req.tenant
                       or CHAOS_TENANTS[len(order) % 3].name)
        rid, key = orig_submit(req)
        order.append(rid)
        return rid, key
    gw.submit = recording_submit
    fins: Dict[int, object] = {}
    gw.on_finish = lambda _key, fin: fins.__setitem__(fin.rid, fin)

    hour_rows = []
    for h, (reqs, steps) in enumerate(_schedule()):
        if inj is not None and h == ARMED_HOUR:
            inj.armed = True
        row = gw.run_hour(float(h), reqs, steps=steps)
        hour_rows.append({
            "t": h, "routes": dict(sorted(row["routes"].items())),
            "served": row["served"], "faults": row["faults"],
            "shed": row["shed"], "brownout": bool(row["brownout"]),
            "wasted_g": round(row["wasted_g"], 9),
        })

    rejected = dict(gw.stats.rejected_reasons)
    carbon_by_rid: Dict[int, float] = {}
    for tr in gw.stats.telemetry:
        carbon_by_rid[tr.rid] = carbon_by_rid.get(tr.rid, 0.0) + tr.carbon_g
    requests = []
    for i, rid in enumerate(order):
        fin = fins.get(rid)
        if rid == 0:
            status, tokens, retries = "shed", [], 0
        elif fin is not None:
            status = "served"
            tokens = [int(t) for t in fin.token_ids]
            retries = int(fin.retries)
        elif rid in rejected:
            status, tokens, retries = "rejected", [], -1
        else:
            status, tokens, retries = "stranded", [], -1
        requests.append({"i": i, "tenant": tenants[i], "status": status,
                         "tokens": tokens, "retries": retries,
                         "carbon_g": round(carbon_by_rid.get(rid, 0.0), 9)})

    st = gw.stats
    report = {
        "requests": requests,
        "hours": hour_rows,
        "ledger": {
            "carbon_g": round(st.carbon_g, 9),
            "wasted_g": round(st.wasted_g, 9),
            "carbon_by_pool": {k: round(v, 9) for k, v
                               in sorted(st.carbon_by_pool.items())},
            "wasted_by_pool": {k: round(v, 9) for k, v
                               in sorted(st.wasted_by_pool.items())},
        },
        "served": st.requests,
        "faults": st.faults,
        "shed": st.shed,
        "plan_holds": st.plan_holds,
        "rejected": sorted(rejected.items()),
        "plans": [[p.pool, p.tenant, p.solver, bool(p.degraded)]
                  for p in st.plans],
        "watchdog": {p.key: dict(p.provider.faults) for p in gw.pools},
        "injected": ([[e.point, e.target, e.occurrence]
                      for e in inj.events] if inj is not None else []),
        "residual_load": int(sum(p.load() for p in gw.pools)),
    }
    return report


def check_pair(control: Dict, chaos: Dict,
               ledger_rtol: float = 0.10) -> Dict[str, bool]:
    """The chaos contract, as named booleans (all must hold)."""
    by_i = lambda rep: {r["i"]: r for r in rep["requests"]}
    ctl, cha = by_i(control), by_i(chaos)
    common = [i for i in ctl if ctl[i]["status"] == "served"
              and cha[i]["status"] == "served"]
    retried = [i for i in common if cha[i]["retries"] > 0]
    # served-side carbon must track the control's over the SAME request
    # set (brownout sheds some the control serves); within that set chaos
    # may serve a request in the sister pool (5% intensity skew) or a
    # different hour, hence the tolerance
    ctl_carbon = sum(ctl[i]["carbon_g"] for i in common)
    cha_served = sum(cha[i]["carbon_g"] for i in common)
    pool_sum = (sum(chaos["ledger"]["carbon_by_pool"].values())
                + sum(chaos["ledger"]["wasted_by_pool"].values()))
    return {
        "zero_stranded": (
            not any(r["status"] == "stranded" for r in chaos["requests"])
            and chaos["residual_load"] == 0),
        "all_points_fired": (
            {e[0] for e in chaos["injected"]} == set(POINTS)),
        "outputs_bit_identical": all(
            cha[i]["tokens"] == ctl[i]["tokens"] for i in common),
        "retried_requests_recovered": (
            len(retried) > 0
            and all(cha[i]["tokens"] == ctl[i]["tokens"] for i in retried)),
        "retries_bounded": all(
            r["retries"] <= RETRY_BUDGET for r in chaos["requests"]
            if r["status"] == "served"),
        "ledger_internally_conserved": (
            abs(chaos["ledger"]["carbon_g"] - pool_sum)
            <= 1e-8 + 1e-6 * chaos["ledger"]["carbon_g"]),
        "ledger_tracks_control": (
            abs(cha_served - ctl_carbon) <= ledger_rtol * ctl_carbon),
        "waste_accounted": chaos["ledger"]["wasted_g"] > 0,
        "plan_held": chaos["plan_holds"] >= 1,
        "degraded_plan_recorded": any(p[3] for p in chaos["plans"]),
        "brownout_shed_batch_only": (
            chaos["shed"] > 0
            and all(r["tenant"] == "batch" for r in chaos["requests"]
                    if r["status"] == "shed")),
        "control_untouched": (
            control["faults"] == 0 and control["shed"] == 0
            and control["plan_holds"] == 0
            and not any(r["status"] != "served"
                        for r in control["requests"])),
    }


def digest(control: Dict, chaos: Dict) -> str:
    """Canonical hash of both reports — byte-equal across interpreter
    runs and PYTHONHASHSEEDs, the value scripts/chaos.sh diffs."""
    blob = json.dumps({"control": control, "chaos": chaos},
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def run_chaos(cfg=None, params=None, seed: int = 0, device="cuda") -> Dict:
    """Paired control + chaos runs, the checks, and the digest. Given
    ``params`` are served on the device they live on; without them
    ``build_model`` draws the weights onto ``device``."""
    if cfg is None or params is None:
        cfg, params = build_model(device)
    control = run_scenario(cfg, params, plan=None, seed=seed)
    chaos = run_scenario(cfg, params, plan=default_plan(), seed=seed)
    checks = check_pair(control, chaos)
    return {"control": control, "chaos": chaos, "checks": checks,
            "ok": all(checks.values()),
            "digest": digest(control, chaos)}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="dump the full paired reports, not the summary")
    args = ap.parse_args()
    out = run_chaos(seed=args.seed, device=args.device)
    if args.full:
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        summary = {
            "digest": out["digest"], "ok": out["ok"],
            "checks": out["checks"],
            "chaos": {k: out["chaos"][k] for k in
                      ("served", "faults", "shed", "plan_holds")},
            "injected": out["chaos"]["injected"],
        }
        print(json.dumps(summary, indent=2, sort_keys=True))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
