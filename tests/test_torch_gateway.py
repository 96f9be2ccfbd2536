"""The port's SproutGateway over port engines against the JAX package's
gateway over reference engines, on the same weights (the reference's
params, converted with ``params_from_jax``) and the same traffic.

Each scenario mirrors one of ``test_gateway.py``, ``test_migration.py``
and ``test_slo.py`` in which wall time decides nothing: no request has a
finite deadline, ``EnergyModel(trust_wall_time=False)`` prices modeled
time, and no scheduler collects the 20 decode-time samples on two
engines that its straggler detector needs. Both stacks must then agree
exactly on the finished tokens, directive levels, routes, per-hour mixes,
plans and migrations, and within 1e-12 relative on the carbon and energy
ledger.
"""
import dataclasses
import math
import warnings

import jax
import numpy as np
import pytest

import repro.core as jcore
import repro.core.policies as jpolicies
import repro.serving as jserving
from repro.configs import reduced as jreduced
from repro.models import model as JMD
import repro_torch.core as tcore
import repro_torch.core.policies as tpolicies
import repro_torch.serving as tserving
from repro_torch.configs import reduced
from repro_torch.models import model as MD

REL = 1e-12


class Stack:
    """One package's control plane and serving layer. Its engines are
    built once per (index, geometry) and reused by every scenario, emptied
    first: a reference engine compiles its entries on first use."""

    def __init__(self, core, policies, serving, make_engine):
        self.core, self.policies, self.serving = core, policies, serving
        self._make = make_engine
        self._engines = {}

    def engine(self, i=0, **kw):
        kw = {"n_slots": 2, "max_len": 128, "page_size": 16, **kw}
        key = (i, tuple(sorted(kw.items())))
        if key not in self._engines:
            # eos_id=-1: budget-bound decoding on the random model
            self._engines[key] = self._make(paged=True, eos_id=-1, **kw)
        eng = self._engines[key]
        eng.drain_slots()
        eng.queue, eng.finished, eng.faulted = [], [], []
        return eng

    def provider(self, trace, region="CA"):
        prov = self.core.CarbonIntensityProvider(region, "jun")
        prov.trace = np.asarray(trace, float)
        return prov

    def sched(self, *engines):
        return self.serving.CarbonAwareScheduler(list(engines))

    def req(self, *a, **kw):
        return self.serving.ServeRequest(0, *a, **kw)

    def gateway(self, pools, **kw):
        kw.setdefault("energy", self.core.EnergyModel(self.core.A100_40GB))
        gw = self.serving.SproutGateway(pools, **kw)
        gw.finished = []
        gw.on_finish = lambda key, fin: gw.finished.append(
            (key, fin.rid, fin.directive_level, list(fin.token_ids),
             fin.prompt_tokens, fin.gen_tokens, fin.tenant))
        return gw

    def two_pools(self, trace_a, trace_b, **kw):
        return self.gateway(
            [(self.provider(trace_a, "CA"), self.sched(self.engine(0))),
             (self.provider(trace_b, "TX"), self.sched(self.engine(1)))],
            **kw)


@pytest.fixture(scope="module")
def stacks():
    jcfg = jreduced("granite_3_2b").replace(vocab_size=512)
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    params = MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return (Stack(jcore, jpolicies, jserving,
                  lambda **kw: jserving.InferenceEngine(jcfg, jp, **kw)),
            Stack(tcore, tpolicies, tserving,
                  lambda **kw: tserving.InferenceEngine(cfg, params,
                                                        device="cpu", **kw)))


def _outcome(gw, hours=()):
    """Everything a scenario decided, split into what must be identical
    and the carbon/energy ledger (compared within ``REL``)."""
    st = gw.stats
    for pool in gw.pools:
        # the straggler detector stayed inert (it compares engines with 20
        # decode-time samples each, two at least): wall time decided nothing
        assert sum(len(t) >= 20
                   for t in pool.scheduler._step_times.values()) < 2
    exact = {
        "finished": gw.finished,
        "hours": [{k: s[k] for k in ("t", "k0", "x", "routes", "served",
                                     "level_mix", "migrated", "draining",
                                     "faults", "shed")} for s in hours],
        "plans": [(p.t, p.pool, p.k0, p.x, p.q_lb, p.expected_quality,
                   p.solver, p.k0_now, p.tenant, p.degraded)
                  for p in st.plans],
        "migrations": [dataclasses.astuple(m) for m in st.migrations],
        "telemetry": [(r.pool, r.rid, r.level, r.prompt_tokens, r.gen_tokens,
                       r.k0, r.tenant, r.slo_met) for r in st.telemetry],
        "counts": (st.requests, st.rejected, st.migrated, st.faults,
                   st.level_counts, st.tenant_requests, st.tenant_slo_met,
                   [p.routed for p in gw.pools], gw.profiles.counts,
                   [(p.key, p.x) for p in gw.pools]),
        "rejected_reasons": st.rejected_reasons,
    }
    ledger = {
        "carbon_g": st.carbon_g, "energy_kwh": st.energy_kwh,
        "wasted_g": st.wasted_g, "carbon_by_pool": st.carbon_by_pool,
        "wasted_by_pool": st.wasted_by_pool,
        "telemetry": [(r.energy_kwh, r.carbon_g) for r in st.telemetry],
        "hours": [s["carbon_g"] for s in hours],
        "profiles": (gw.profiles.e, gw.profiles.p),
    }
    return exact, ledger


def _assert_exact(want, got, where):
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_exact(want[k], got[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{where}: {len(got)} != {len(want)}"
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_exact(w, g, f"{where}[{i}]")
    else:
        assert got == want, f"{where}: {got!r} != {want!r}"


def _assert_close(want, got, where):
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_close(want[k], got[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_close(w, g, f"{where}[{i}]")
    else:
        np.testing.assert_allclose(got, want, rtol=REL, atol=0, err_msg=where)


# ----------------------------------------------------------------------
# scenarios: each drives one stack and returns its gateway's outcome
# ----------------------------------------------------------------------

def mix_tracks_grid(S):
    """test_gateway: a dirty hour moves the LP mix off L0, a green hour
    pins it back."""
    ca = S.core.CarbonIntensityProvider("CA")
    prov = S.provider([ca.k_max, ca.k_min])
    pol = S.policies.SproutPolicy(
        k0_min=prov.k_min, k0_max=prov.k_max, xi=0.25,
        k1=S.core.A100_40GB.embodied_gco2 / S.core.A100_40GB.lifetime_s,
        explore=0.0)
    gw = S.gateway([(prov, S.sched(S.engine()))], policy=pol,
                   q=np.array([0.50, 0.33, 0.17]), load_cap=64, seed=3)
    gw.profiles.e[:] = [4e-6, 2e-6, 1e-6]
    gw.profiles.p[:] = [0.2, 0.1, 0.05]
    gw.profiles.counts[:] = 5
    hours = [gw.run_hour(float(t), [
        S.req(f"q{t}-{i}", max_new_tokens=12, max_new_by_level=[12, 6, 3])
        for i in range(10)]) for t in range(2)]
    assert hours[0]["x"]["CA"][1:].sum() > 0.2 and hours[1]["x"]["CA"][0] > 0.99
    return _outcome(gw, hours)


def profiles_converge(S):
    """test_gateway: warm-up mixes feed measured telemetry back into the
    level profiles."""
    prov = S.provider([300.0])
    pol = S.policies.SproutPolicy(
        k0_min=prov.k_min, k0_max=prov.k_max, xi=0.25,
        k1=S.core.A100_40GB.embodied_gco2 / S.core.A100_40GB.lifetime_s,
        explore=0.0)
    gw = S.gateway([(prov, S.sched(S.engine()))], policy=pol, load_cap=64)
    hours = [gw.run_hour(float(t), [
        S.req("telemetry check", max_new_tokens=12, max_new_by_level=[12, 6, 3])
        for _ in range(8)]) for t in range(3)]
    assert gw.stats.requests == 24
    return _outcome(gw, hours)


def green_under_load_cap(S):
    """test_gateway: the greenest pool fills to its cap, then work spills
    to the dirtier one, then balances by load."""
    gw = S.gateway([(S.provider([400.0], "TX"), S.sched(S.engine(0))),
                    (S.provider([50.0], "CA"), S.sched(S.engine(1)))],
                   policy=None, load_cap=3)
    gw.tick(0.0)
    keys = [gw.submit(S.req(f"r{i}", max_new_tokens=4))[1] for i in range(8)]
    assert keys[:6] == ["CA"] * 3 + ["TX"] * 3
    gw.drain()
    assert gw.stats.requests == 8 and gw.stats.rejected == 0
    return _outcome(gw)


def failover_in_flight(S):
    """test_gateway: a replica fails with the hour's work in flight; every
    request is still served."""
    gw = S.gateway([(S.provider([300.0]),
                     S.sched(S.engine(0), S.engine(1)))],
                   policy=None, load_cap=64)

    def fail_first(g):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            assert g.pools[0].scheduler.fail_replica(0) >= 0

    hours = [gw.run_hour(0.0, [S.req(f"f{i}", max_new_tokens=8)
                               for i in range(6)], on_inflight=fail_first)]
    assert hours[0]["served"] == 6 and gw.stats.rejected == 0
    return _outcome(gw, hours)


def dead_pool(S):
    """test_gateway: a pool with no fleet is skipped by routing, and its
    stranded backlog is parked as rejected instead of spinning drain()."""
    gw = S.gateway([(S.provider([50.0], "TX"), S.sched()),
                    (S.provider([400.0], "CA"), S.sched(S.engine()))],
                   policy=None, load_cap=4)
    gw.tick(0.0)
    keys = [gw.submit(S.req(f"r{i}", max_new_tokens=4))[1] for i in range(3)]
    assert keys == ["CA"] * 3
    gw.drain()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        gw.pools[1].scheduler.fail_replica(0)
    gw.pools[0].scheduler.submit(S.req("stranded", max_new_tokens=4))
    gw.drain()
    assert gw.stats.rejected >= 1
    return _outcome(gw)


def migrate_backlog(S):
    """test_migration: at an intensity crossover the dirty pool's backlog
    (pending, queued and decoding work) moves to the green pool."""
    gw = S.two_pools([100.0, 450.0], [450.0, 80.0],
                     policy=None, migration=S.serving.MigrationPlanner(),
                     load_cap=64)
    reqs = [S.req(f"xover {i}", max_new_tokens=12) for i in range(8)]
    hours = [gw.run_hour(0.0, reqs, steps=1), gw.run_hour(1.0, [])]
    assert hours[1]["migrated"] > 0 and gw.stats.requests == 8
    return _outcome(gw, hours)


def migrate_decoding(S):
    """test_migration: a decoding request is evicted at the crossover, its
    discarded work charged to the source pool, and it restarts from its
    verbatim prompt ids at the destination."""
    prompt = S.serving.ByteTokenizer().encode(
        "crossover request, long enough to span pages and keep decoding",
        bos=True)
    gw = S.two_pools([100.0, 450.0], [450.0, 80.0], policy=None,
                     migration=S.serving.MigrationPlanner(min_saving_g=0.0),
                     load_cap=64)
    gw.submit(S.req("ignored", max_new_tokens=20,
                    prompt_token_ids=list(prompt), pre_rendered=True))
    gw.step()
    gw.tick(1.0)
    assert [m.kind for m in gw.stats.migrations] == ["decoding"]
    assert gw.stats.requests == 0 and gw.stats.wasted_g > 0
    gw.drain()
    assert gw.stats.telemetry[0].pool == "TX"
    return _outcome(gw)


def migrate_cannot_serve(S):
    """test_migration: the green pool's engines cannot hold the budget, so
    nothing moves and the work finishes at the source."""
    gw = S.gateway(
        [(S.provider([100.0, 450.0], "CA"), S.sched(S.engine(0))),
         (S.provider([450.0, 80.0], "TX"), S.sched(S.engine(1, max_len=16)))],
        policy=None, migration=S.serving.MigrationPlanner(), load_cap=64)
    hours = [gw.run_hour(0.0, [S.req(f"big {i}", max_new_tokens=20)
                               for i in range(4)], steps=1),
             gw.run_hour(1.0, [])]
    assert gw.stats.migrated == 0 and gw.stats.requests == 4
    return _outcome(gw, hours)


def migrate_queued(S):
    """The engine repair: the planner reads ``paged``, ``max_len`` and
    ``_pages_for`` of the destination's engine and moves a request queued
    inside the source's engine."""
    gw = S.two_pools([100.0, 450.0], [450.0, 80.0], policy=None,
                     migration=S.serving.MigrationPlanner(cooldown_h=0.0),
                     load_cap=64)
    src = gw.pools[0].scheduler
    for i in range(3):                   # 2 slots: the third queues
        src.submit(S.req(f"queued {i}", max_new_tokens=10))
    src.step()
    assert len(src.engines[0].queue) == 1
    gw.tick(1.0)
    assert "queued" in [m.kind for m in gw.stats.migrations]
    gw.drain()
    assert gw.stats.requests == 3
    return _outcome(gw)


def drain_pool(S):
    """test_slo: a pool drained ahead of maintenance hands its backlog to
    the other pool, admission avoids it, and it takes traffic again after."""
    gw = S.two_pools([100.0], [400.0], policy=None, migration=None,
                     load_cap=64)
    for i in range(6):
        assert gw.submit(S.req(f"r {i}", max_new_tokens=8))[1] == "CA"
    gw.step()
    assert gw.drain_pool("CA", deadline=1.0) > 0
    assert gw.pools[0].load() == 0
    assert gw.submit(S.req("post-drain", max_new_tokens=8))[1] == "TX"
    gw.drain()
    gw.undrain_pool("CA")
    assert gw.submit(S.req("back", max_new_tokens=8))[1] == "CA"
    gw.drain()
    assert gw.stats.requests == 8 and gw.stats.rejected == 0
    return _outcome(gw)


def _served_hours(S, *, tenants, migrate, horizon, hours=4, n=10):
    """The serving launcher's loop (``run_gateway``) over two real-trace
    pools behind watchdogs: workload requests with per-level budgets, the
    evaluator's q installed every hour, and a load cap that spills work
    into the dirtier pool, which has two replicas. The LP leaves its
    warm-up once every level has five profiled requests. The last hour but
    one is cut after one fleet step, so its backlog rides into the last
    hour's re-plan, where migration moves it to the green pool."""
    carbon = S.core
    provs = [carbon.WatchdogProvider(carbon.CarbonIntensityProvider(r, "jun"))
             for r in ("CA", "TX")]
    specs = None
    if tenants:
        specs = tuple(dataclasses.replace(t, ttft_s=math.inf, tpot_s=math.inf)
                      for t in carbon.DEFAULT_TENANTS)
    pol = None if tenants else S.policies.SproutPolicy(
        k0_min=min(p.k_min for p in provs), k0_max=max(p.k_max for p in provs),
        xi=0.1, k1=carbon.A100_40GB.embodied_gco2 / carbon.A100_40GB.lifetime_s)
    gw = S.gateway([(provs[0], S.sched(S.engine(0))),
                    (provs[1], S.sched(S.engine(1), S.engine(2)))],
                   policy=pol, tenants=specs, load_cap=3,
                   forecast_horizon=horizon,
                   migration=(S.serving.MigrationPlanner(respect_load_cap=False)
                              if migrate else None))
    wl, ev = carbon.Workload(seed=0), carbon.QualityEvaluator(sample_size=200)
    cycle = ("premium", "standard", "standard", "batch")
    out = []
    for hour in range(hours):
        gw.set_quality(ev.evaluate([wl.sample_request(hour + i * 0.01)
                                    for i in range(300)]).q)
        reqs = [S.serving.serve_request_from(
            wl.sample_request(hour + i * 0.01), token_scale=320.0 / 24,
            max_new=24, tenant=cycle[i % 4] if tenants else "")
            for i in range(n)]
        out.append(gw.run_hour(float(hour), reqs, steps=1 if hour == hours - 2
                               else None))
    gw.drain()
    assert gw.stats.requests == hours * n and gw.stats.rejected == 0
    assert {r.pool for r in gw.stats.telemetry} == {"CA", "TX"}
    assert not migrate or gw.stats.migrated > 0
    assert {p.solver for p in gw.stats.plans} == {"warmup", "highs-ds"}
    return _outcome(gw, out)


def sprout_policy_hours(S):
    return _served_hours(S, tenants=False, migrate=False, horizon=0.0)


def tenants_migrate_forecast(S):
    return _served_hours(S, tenants=True, migrate=True, horizon=2.0)


SCENARIOS = [mix_tracks_grid, profiles_converge, green_under_load_cap,
             failover_in_flight, dead_pool, migrate_backlog, migrate_decoding,
             migrate_cannot_serve, migrate_queued, drain_pool,
             sprout_policy_hours, tenants_migrate_forecast]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_gateway_matches_reference(stacks, scenario):
    ref, port = stacks
    want_exact, want_ledger = scenario(ref)
    got_exact, got_ledger = scenario(port)
    assert want_exact["finished"], "the scenario finished nothing"
    _assert_exact(want_exact, got_exact, scenario.__name__)
    _assert_close(want_ledger, got_ledger, scenario.__name__)
    # the ledger balances: every gram is a served or a wasted one
    st = got_ledger
    total = sum(st["carbon_by_pool"].values()) + sum(
        st["wasted_by_pool"].values())
    np.testing.assert_allclose(st["carbon_g"], total, rtol=REL, atol=0)


def test_port_engine_answers_what_the_gateway_reads(stacks):
    """The attributes and methods the gateway and scheduler read on an
    engine mean on a port engine what they mean on a reference engine:
    ``paged`` (the migration planner's guard), ``tp_degree`` (read with a
    default of 1), ``load``,
    ``n_slots``, ``max_len``, ``chunked_admission``, ``_pages_for`` and
    ``kv_stats`` with work in flight (capacity is the page budget; the
    port's extra trash page is not capacity)."""
    ref, port = stacks
    seen = []
    for S in (ref, port):
        eng = S.engine(3, prefill_chunk=8)
        tok = S.serving.ByteTokenizer()
        for text, n in (("first request", 20), ("second, a bit longer", 12),
                        ("third waits in the queue", 8)):
            eng.submit(tok.encode(text, bos=True), max_new_tokens=n)
        eng.step()
        seen.append((eng.paged, getattr(eng, "tp_degree", 1), eng.load(),
                     eng.n_slots, eng.max_len, eng.chunked_admission,
                     eng.pages.n_pages,
                     [eng._pages_for(p, b) for p in (1, 16, 17, 100)
                      for b in (1, 10, 27)],
                     eng.kv_stats()))
        eng.run_to_completion()
        seen[-1] += ([(f.rid, f.token_ids) for f in eng.finished],)
    want, got = seen
    assert got[0] is True and got[1] == 1
    _assert_exact(want, got, "engine")
