"""Serving launcher of the port: the SPROUT carbon-aware service as a CLI
(counterpart of ``repro/launch/serve.py``, with its flags).

    PYTHONPATH=src python -m repro_torch.launch.serve --gateway \
        --regions CA,TX --replicas 1 --slots 8 --hours 3 --requests 12

Runs the port's engine (dense KV rows, or with ``--paged`` a block-table
page store) with the full SPROUT control plane:
hourly LP re-planning from the regional carbon-intensity trace, directive
rendering into system prompts, level-cost profiling, and preemption-safe
scheduling. ``--arch`` defaults to the paper's model, llama2_13b, as in
the reference. ``--device cuda`` (the default) serves the architecture
at full width on the card; ``--device cpu`` serves its reduced config
(vocab 512), as the reference's launcher does. Weights are random, drawn
from seed 0. Nothing falls back from one device to the other.

``--gateway`` switches to the closed-loop SproutGateway: one scheduler
pool per ``--regions`` entry, the LP re-planned per pool from its live
intensity, engine telemetry fed back into the level profiles, and requests
routed to the greenest pool under a load cap. ``--tenants``, ``--slo``,
``--migrate``, ``--forecast-horizon`` and ``--drain-at`` act as in the
reference (DESIGN.md §8, §10). ``--prefix-cache`` (with ``--paged``)
serves the shared directive system prompts from indexed pages (DESIGN.md
§13). ``--chaos`` arms the reference's default fault script (DESIGN.md
§12: one fault of every class against the first pool, lanes poisoned on
the engines) and prints the recovery counters. Accounting is the
reference's: the
``LLAMA2_13B`` profile priced on ``A100_40GB`` with modeled (not wall)
decode time.

Flags the port cannot serve yet raise ``NotImplementedError`` when the
arguments are parsed, naming their ROADMAP.md item: ``--tp-degree`` above
1, and an architecture the port does not hold. ``--prefix-cache`` without
``--paged`` raises ``ValueError``: the reference's flag requires
``--paged``, and the port drops no flag.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.core import (A100_40GB, DEFAULT_TENANTS, LLAMA2_13B,
                              CarbonIntensityProvider, DirectiveSet,
                              EnergyModel, GridSignalClient, QualityEvaluator,
                              Workload, solve_directive_lp)
from repro_torch.core.carbon import WatchdogProvider
from repro_torch.core.policies import LevelProfiles, SproutPolicy
from repro_torch.models import model as MD
from repro_torch.models.common import resolve_device
from repro_torch.serving import (CarbonAwareScheduler, FaultInjector,
                                 FaultPlan, FaultSpec, InferenceEngine,
                                 MigrationPlanner, ServeRequest,
                                 SproutGateway, no_faults, serve_request_from)


# request mix across service classes for --tenants runs (premium is the
# minority class with the hard floor; batch soaks up the brief levels)
TENANT_CYCLE = ("premium", "standard", "standard", "batch")


def tenant_specs(slo: bool) -> tuple:
    """The default service classes; without --slo their latency targets
    are disarmed (quality floors only, no deadlines)."""
    if slo:
        return DEFAULT_TENANTS
    return tuple(dataclasses.replace(t, ttft_s=math.inf, tpot_s=math.inf)
                 for t in DEFAULT_TENANTS)


def chaos_plan(regions) -> FaultPlan:
    """The CLI's default chaos script: one fault of every class a plain
    --gateway run can reach, aimed at the first pool so the others keep
    absorbing its recovered work."""
    r0 = regions[0]
    return FaultPlan([
        FaultSpec("carbon.nan", r0, occurrences=(0,)),
        FaultSpec("carbon.stale", r0, occurrences=(1,)),
        FaultSpec("carbon.exception", r0, occurrences=(2,)),
        FaultSpec("lp.fail", r0, occurrences=(0,)),
        FaultSpec("decode.nonfinite", "*", occurrences=(0,)),
        FaultSpec("replica.crash", f"{r0}/0", occurrences=(2,)),
        FaultSpec("migrate.dst_vanish", "*", occurrences=(0,)),
    ])


def grid_provider(region: str, args) -> CarbonIntensityProvider:
    """Trace-backed by default; --grid-provider switches to the live
    Electricity Maps / WattTime client (tokenless = immediate trace
    fallback, so the flag is safe to try offline)."""
    if args.grid_provider == "trace":
        return CarbonIntensityProvider(region, "jun")
    return GridSignalClient(region, "jun", provider=args.grid_provider,
                            token=args.grid_token)


def run_gateway(args, cfg, params) -> SproutGateway:
    """Closed-loop mode: LP -> scheduler pools -> engine telemetry -> LP.
    Prints the reference's lines and returns the gateway it drove."""
    regions = [r.strip() for r in args.regions.split(",") if r.strip()]
    workload = Workload(seed=0)
    evaluator = QualityEvaluator(sample_size=200)
    injector = (FaultInjector(chaos_plan(regions), seed=args.chaos_seed)
                if args.chaos else no_faults())
    # the watchdog wraps every feed (live or trace): staleness aging,
    # last-good fallback, and the chaos injection points for --chaos
    providers = [WatchdogProvider(grid_provider(r, args),
                                  fault_injector=injector)
                 for r in regions]
    k_min = min(p.k_min for p in providers)
    k_max = max(p.k_max for p in providers)
    pools = []
    for j, prov in enumerate(providers):
        engines = [
            # eos_id=-1: random weights have no meaningful EOS, so
            # decoding is budget-bound and measured token counts carry the
            # per-level brevity structure
            InferenceEngine(cfg, params, n_slots=args.slots, max_len=96,
                            seed=100 * j + i, decode_block=args.decode_block,
                            eos_id=-1, device=args.device,
                            **engine_kv_kwargs(args))
            for i in range(args.replicas)]
        pools.append((prov, CarbonAwareScheduler(
            engines, fault_injector=injector)))
    tenants = tenant_specs(args.slo) if args.tenants else None
    # tenant mode solves its own per-(pool, tenant) LPs with per-class xi
    # values — a single-mix SproutPolicy (and --xi) only applies without
    # --tenants, so don't build one that would be silently ignored
    policy = None if tenants else SproutPolicy(
        k0_min=k_min, k0_max=k_max, xi=args.xi,
        k1=A100_40GB.embodied_gco2 / A100_40GB.lifetime_s)
    # the accounting profile mirrors the engine's KV dtype, so the int8
    # flag halves modeled decode KV bytes end to end (roofline -> level
    # profiles -> LP -> Eq. 1 carbon)
    profile = LLAMA2_13B.with_int8_kv() if args.kv_int8 else LLAMA2_13B
    migration = MigrationPlanner() if args.migrate else None
    gw = SproutGateway(pools, policy=policy, tenants=tenants,
                       energy=EnergyModel(A100_40GB),
                       model_profile=profile, load_cap=args.load_cap,
                       forecast_horizon=args.forecast_horizon,
                       migration=migration, fault_injector=injector)

    for hour in range(args.hours):
        pool_sample = [workload.sample_request(hour + i * 0.01)
                       for i in range(300)]
        gw.set_quality(evaluator.evaluate(pool_sample).q)
        reqs = [serve_request_from(workload.sample_request(hour + i * 0.01),
                                   token_scale=320.0 / args.max_new,
                                   max_new=args.max_new,
                                   tenant=(TENANT_CYCLE[i % len(TENANT_CYCLE)]
                                           if tenants else ""))
                for i in range(args.requests)]
        # >= (not ==): --drain-at takes a float hour, and the loop steps
        # in whole hours — drain fires at the first hour past the mark.
        # The drain runs through run_hour's on_inflight hook, i.e. with
        # the hour's work IN FLIGHT — each hour is served to idle, so
        # draining between hours would always find an empty backlog and
        # demonstrate nothing but the admission skip.
        on_inflight = None
        if args.drain_at >= 0 and hour >= args.drain_at \
                and not gw.draining:

            def on_inflight(g, hour=hour):
                # default target: the pool holding the most in-flight
                # work — the interesting maintenance case; --drain-region
                # pins a specific one
                region = args.drain_region or max(
                    g.pools, key=lambda p: p.load()).key
                moved = g.drain_pool(region, deadline=float(hour))
                print(f"  [hour {hour}] draining {region} ahead of "
                      f"maintenance; moved {moved} backlogged requests")
        s = gw.run_hour(float(hour), reqs, on_inflight=on_inflight)
        ks = " ".join(f"{k}={v:4.0f}" for k, v in s["k0"].items())
        xs = " ".join(f"{k}:{np.round(v, 2)}" for k, v in s["x"].items())
        rt = " ".join(f"{k}={v}" for k, v in s["routes"].items())
        kv = " ".join(
            f"{k}={v.get('kv_bytes_in_use', 0) / 1024:.0f}KiB"
            f"@{v.get('occupancy', 1.0):.0%}"
            for k, v in s["kv"].items())
        mig = f"  migrated={s['migrated']}" if migration or s["draining"] \
            else ""
        slo = ""
        if s["slo"]:
            slo = "  slo[" + " ".join(
                f"{k}={v:.0%}" for k, v in sorted(s["slo"].items())) + "]"
        print(f"hour {hour}: CI[{ks}]  served={s['served']:3d}  "
              f"carbon={s['carbon_g']:.4f}g  routes[{rt}]  x[{xs}]  "
              f"kv[{kv}]{mig}{slo}", flush=True)
    st = gw.stats
    print(f"total: {st.carbon_g:.4f} gCO2 across {st.requests} requests "
          f"({1000 * st.carbon_per_request:.3f} mg/req, "
          f"{st.rejected} rejected, {st.migrated} migrated)")
    print(f"level mix: {np.round(st.level_counts / max(st.requests, 1), 3)}")
    if args.chaos:
        inj = " ".join(f"{e.point}@{e.target}" for e in injector.events)
        wd = sum(sum(p.provider.faults.values()) for p in gw.pools
                 if hasattr(p.provider, "faults"))
        print(f"chaos: injected[{inj}]  recovered_faults={st.faults}  "
              f"watchdog_faults={wd}  plan_holds={st.plan_holds}  "
              f"shed={st.shed}  wasted={st.wasted_g:.4f}g")
    if tenants:
        att = " ".join(f"{name}={st.slo_attainment(name):.0%}"
                       f"({st.tenant_requests.get(name, 0)})"
                       for name in ("premium", "standard", "batch"))
        print(f"slo attainment: {att}")
    print(f"profiled e (kWh/level): {np.round(gw.profiles.e, 9)}")
    return gw


def engine_kv_kwargs(args) -> dict:
    """KV-layout engine kwargs shared by both serving modes: dense rows
    unless ``--paged``, as in the reference. ``--tp-degree`` above 1
    raises at parsing, so the engine's default holds for it."""
    kw = {"kv_int8": args.kv_int8, "prefill_chunk": args.prefill_chunk}
    if args.paged:
        kw.update(paged=True, page_size=args.page_size,
                  n_pages=args.pages if args.pages > 0 else None,
                  prefix_cache=args.prefix_cache)
    return kw


def refuse_unported(args) -> None:
    """Raise ``NotImplementedError`` for an architecture or a flag the port
    cannot serve yet, naming its ROADMAP.md item (modules still to port),
    and ``ValueError`` for ``--prefix-cache`` without ``--paged``, which
    the reference's engine would drop. No flag is ignored, and none is
    switched to something else."""
    if args.prefix_cache and not args.paged:
        raise ValueError("--prefix-cache rides the paged KV store "
                         "(requires --paged)")
    arch = args.arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"--arch {args.arch}: the port serves {ARCH_IDS} so far "
            f"(ROADMAP.md, modules still to port: item 10, other families "
            f"(layernorm, GELU, biases, sliding window))")
    if args.tp_degree > 1:
        raise NotImplementedError(
            f"--tp-degree {args.tp_degree}: not in the port yet (ROADMAP.md, "
            f"modules still to port: item 7, tensor-parallel decode)")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The reference's flags plus ``--device``; raises for what the port
    cannot serve yet (``refuse_unported``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2_13b",
                    help="architecture (the port holds granite_3_2b, "
                         "llama2_7b, llama2_13b and minicpm_2b; the "
                         "default is the paper's model, as in the "
                         "reference)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: the architecture at full width on the card; "
                         "cpu: its reduced config (vocab 512)")
    ap.add_argument("--region", default="CA")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--hours", type=int, default=4)
    ap.add_argument("--requests", type=int, default=6,
                    help="requests per simulated hour")
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--decode-block", type=int, default=8,
                    help="tokens decoded per fused device dispatch")
    ap.add_argument("--xi", type=float, default=0.1,
                    help="Eq. 3 quality relaxation for the single-mix LP; "
                         "inert under --tenants (each class carries its "
                         "own xi)")
    ap.add_argument("--gateway", action="store_true",
                    help="closed-loop SproutGateway over regional pools")
    ap.add_argument("--regions", default="CA,TX",
                    help="comma-separated regions for --gateway pools")
    ap.add_argument("--load-cap", type=int, default=8,
                    help="per-pool in-flight cap for green routing")
    ap.add_argument("--migrate", action="store_true",
                    help="cross-region MigrationPlanner: move queued/"
                         "preempted work to greener pools at re-plan ticks "
                         "(--gateway only)")
    ap.add_argument("--forecast-horizon", type=float, default=0.0,
                    help="hours of intensity forecast the per-pool LP "
                         "re-plan (and migration) solves against; 0 = "
                         "instantaneous (--gateway only)")
    ap.add_argument("--tenants", action="store_true",
                    help="premium/standard/batch service classes: one LP "
                         "per (pool, tenant) with per-class quality "
                         "floors (--gateway only)")
    ap.add_argument("--slo", action="store_true",
                    help="arm the tenant classes' TTFT/TPOT latency "
                         "targets: requests carry deadlines and admission "
                         "routes on predicted completion time jointly "
                         "with greenness (implies --tenants)")
    ap.add_argument("--drain-at", type=float, default=-1.0,
                    help="simulated hour at which to drain a pool ahead "
                         "of maintenance (-1 = never; --gateway only)")
    ap.add_argument("--drain-region", default="",
                    help="region to drain at --drain-at (default: the "
                         "pool holding the most in-flight work at the "
                         "drain moment)")
    ap.add_argument("--paged", action="store_true",
                    help="block-table paged KV cache + paged decode kernel "
                         "(default: the dense per-slot KV layout)")
    ap.add_argument("--page-size", type=int, default=32,
                    help="tokens per KV page")
    ap.add_argument("--pages", type=int, default=0,
                    help="page budget per engine (0 = dense-equivalent "
                         "n_slots * max_len worth of pages)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (halves decode HBM traffic; "
                         "accounting profile follows)")
    ap.add_argument("--tp-degree", type=int, default=1,
                    help="tensor-parallel sharding per engine (not in the "
                         "port yet: above 1 raises)")
    ap.add_argument("--chaos", action="store_true",
                    help="arm the default fault-injection script (one "
                         "fault of every class aimed at the first pool) "
                         "and report recovery counters (--gateway only)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="FaultInjector seed for --chaos")
    ap.add_argument("--grid-provider", default="trace",
                    choices=("trace", "electricitymaps", "watttime"),
                    help="carbon-signal source: bundled synthetic traces "
                         "(default) or the live grid APIs via "
                         "GridSignalClient (needs --grid-token; tokenless "
                         "falls straight back to the traces)")
    ap.add_argument("--grid-token", default="",
                    help="API token for --grid-provider (never bundled; "
                         "empty = trace fallback)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="continuous batching: admit arrivals against live "
                         "decode lanes as prefill chunks of this many "
                         "tokens interleaved into the decode blocks "
                         "(0 = whole-prompt prefill)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over the paged KV store "
                         "(requires --paged): requests sharing full prompt "
                         "pages (the directive system prompts) adopt them "
                         "instead of prefilling them")
    args = ap.parse_args(argv)
    if args.slo:
        args.tenants = True
    refuse_unported(args)
    return args


def build_model(args):
    """(cfg, params): the architecture at full width on the card, its
    reduced config (vocab 512) on the CPU; random weights from seed 0."""
    dev = resolve_device(args.device)
    cfg = (reduced(args.arch).replace(vocab_size=512) if dev.type == "cpu"
           else get_config(args.arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, MD.init_model(cfg, gen, device=dev)


def main(argv: Optional[Sequence[str]] = None) -> Optional[SproutGateway]:
    """Serve as the flags say; returns the gateway under ``--gateway``."""
    args = parse_args(argv)
    cfg, params = build_model(args)
    if args.gateway:
        return run_gateway(args, cfg, params)
    grid = CarbonIntensityProvider(args.region, "jun")
    energy = EnergyModel(A100_40GB)
    profile = LLAMA2_13B.with_int8_kv() if args.kv_int8 else LLAMA2_13B
    directives = DirectiveSet()
    profiles = LevelProfiles.fresh()
    evaluator = QualityEvaluator(sample_size=200)
    workload = Workload(seed=0)
    rng = np.random.default_rng(0)
    q = np.ones(3) / 3
    plan = {"x": np.ones(3) / 3}

    sched = CarbonAwareScheduler(
        [InferenceEngine(cfg, params, n_slots=args.slots, max_len=96, seed=i,
                         decode_block=args.decode_block, device=args.device,
                         **engine_kv_kwargs(args))
         for i in range(args.replicas)],
        directives,
        level_fn=lambda: int(rng.choice(3, p=plan["x"])))

    total_g = served = 0
    for hour in range(args.hours):
        k0 = grid.intensity(hour)
        if profiles.counts.min() >= 2:
            sol = solve_directive_lp(
                profiles.e, profiles.p, q, k0=k0,
                k1=A100_40GB.embodied_gco2 / A100_40GB.lifetime_s,
                k0_min=grid.k_min, k0_max=grid.k_max, xi=args.xi)
            plan["x"] = sol.x
        pool = [workload.sample_request(hour + i * 0.01) for i in range(300)]
        q = evaluator.evaluate(pool).q
        for i in range(args.requests):
            sched.submit(ServeRequest(0, f"request {hour}:{i} — explain "
                                      "briefly.", max_new_tokens=args.max_new))
        for f in sched.run():
            kwh = energy.request_energy_kwh(profile, f.prompt_tokens,
                                            f.gen_tokens)
            total_g += k0 * kwh * 1.2
            profiles.update(f.directive_level, kwh, f.latency_s)
            served += 1
        mixes = np.round(plan["x"], 2)
        print(f"hour {hour}: CI={k0:5.0f} gCO2/kWh  served={served:3d}  "
              f"x={mixes}", flush=True)
        sched.finished = []
    for req, reason in sched.rejected:
        print(f"rejected rid={req.rid}: {reason}", flush=True)
    print(f"total (13B-scale estimate): {total_g:.3f} gCO2 "
          f"across {served} requests")
    return None


if __name__ == "__main__":
    main()
