"""The port's copies of Sprout's numpy control plane (``repro_torch.core``)
against the JAX package's (``repro.core``): each public function and class
runs through both on the same seeded inputs and gives the same result.
The code is the same numpy, so results are compared exactly (``==`` and
``np.testing.assert_array_equal``), never within a tolerance."""
import dataclasses
import importlib
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

MODULES = ("carbon", "energy", "workload", "quality", "lp", "policies",
           "invoker", "grid_client", "controller")


def _package(root):
    mods = {m: importlib.import_module(f"{root}.core.{m}") for m in MODULES}
    mods["core"] = importlib.import_module(f"{root}.core")
    mods["faults"] = importlib.import_module(f"{root}.serving.faults")
    return SimpleNamespace(**mods)


REF, PORT = _package("repro"), _package("repro_torch")


def _plain(x):
    """A result as plain data: dataclasses as (class name, fields), numpy
    scalars as Python scalars, containers recursively."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, np.generic):
        return x.item()
    return x


def _assert_same(want, got, where="result"):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_same(want[k], got[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_same(w, g, f"{where}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), where
    else:
        assert type(got) is type(want) and got == want, \
            f"{where}: {got!r} != {want!r}"


# ----------------------------------------------------------------------
# cases: each takes one package and returns what it computed
# ----------------------------------------------------------------------

def _trace(region, season):
    return lambda P: P.carbon.carbon_intensity_trace(region, season)


def _provider(P):
    out = []
    for region in P.carbon.REGIONS:
        prov = P.carbon.CarbonIntensityProvider(region, "oct", hours=72)
        out.append((prov.k_min, prov.k_max,
                    [prov.intensity(t) for t in (0.0, 5.5, 71.9, 100.0)],
                    prov.forecast(2.7, 3), prov.forecast(70.2, 5.5),
                    prov.forecast(1.2, 0)))
    return out


def _watchdog(point, occurrences):
    def case(P):
        inj = P.faults.FaultInjector(P.faults.FaultPlan(
            [P.faults.FaultSpec(point, "CA", occurrences=occurrences)]))
        wd = P.carbon.WatchdogProvider(
            P.carbon.CarbonIntensityProvider("CA", "jun"), max_stale_h=2.0,
            fault_injector=inj)
        seen = []
        for t in range(8):
            seen.append((wd.intensity(float(t)), wd.degraded))
            seen.append((wd.forecast(float(t) + 0.5, 3), wd.degraded))
        return (seen, dict(wd.faults),
                [(e.point, e.target) for e in inj.events])
    return case


def _watchdog_no_good_sample(P):
    inj = P.faults.FaultInjector(P.faults.FaultPlan(
        [P.faults.FaultSpec("carbon.exception", "TX",
                            occurrences=(0, 1, 2))]))
    wd = P.carbon.WatchdogProvider(P.carbon.CarbonIntensityProvider("TX"),
                                   fault_injector=inj)
    return [(wd.intensity(float(t)), wd.degraded) for t in range(4)]


def _request_carbon(P):
    return [P.carbon.request_carbon(ci, kwh, s, 150_000.0,
                                    5 * 365 * 24 * 3600.0, pue=pue)
            for ci in (0.0, 55.0, 331.7) for kwh in (0.0, 1e-6, 3.2e-4)
            for s in (0.0, 0.25, 7.0) for pue in (1.0, P.carbon.PUE)]


def _energy(trust, n_chips):
    def case(P):
        E = P.energy
        out = []
        for hw in (E.A100_40GB, E.TPU_V5E):
            em = E.EnergyModel(hw, trust_wall_time=trust).with_chips(n_chips)
            for m in (E.LLAMA2_13B, E.LLAMA2_7B, E.LLAMA2_13B.with_int8_kv()):
                for prompt, gen, dec in ((0, 1, 0.0), (17, 40, 0.31),
                                         (300, 7, 0.0), (64, 128, 2.5)):
                    out.append(em.measure(m, prompt, gen, dec))
                out.append((em.joules_per_token(m),
                            em.decode_bytes_per_token(m, 100),
                            em.collective_bytes_per_token(m),
                            em.request_time(m, 50, 20)))
        return out
    return case


def _int8_kv(P):
    E = P.energy
    return [E.LLAMA2_13B.with_int8_kv(), E.LLAMA2_7B.with_int8_kv(64),
            E.LLAMA2_13B.with_int8_kv().pbytes, E.LLAMA2_7B.active]


def _workload(P):
    wl = P.workload.Workload(seed=3)
    reqs = [wl.sample_request(t * 0.37) for t in range(40)]
    return (reqs, wl.mixture(13.0), wl.rps(20.0),
            [(r.rid, r.weight) for r in wl.requests_for_hour(9.0, cap=15)])


def _quality(P):
    wl = P.workload.Workload(seed=5)
    pool = [wl.sample_request(2.0 + i * 0.01) for i in range(300)]
    ev = P.quality.QualityEvaluator(sample_size=200)
    return [ev.evaluate(pool), ev.evaluate(pool[:50]), ev.evaluate([])]


E_VEC, P_VEC, Q_VEC = [1.74e-5, 8.3e-6, 3.8e-6], [0.32, 0.15, 0.06], \
    [0.45, 0.39, 0.16]


def _lp(solver):
    def case(P):
        out = []
        for k0 in (55.0, 120.0, 250.0, 331.0, 500.0):
            for xi, floor in ((0.1, 0.0), (0.35, 0.0), (0.03, 0.44)):
                out.append(P.lp.solve_directive_lp(
                    E_VEC, P_VEC, Q_VEC, k0=k0, k1=9.5e-4, k0_min=55.0,
                    k0_max=331.0, xi=xi, q_lb_floor=floor, solver=solver))
        # infeasible floor: best effort is the highest-quality level
        out.append(P.lp.solve_directive_lp(
            E_VEC, P_VEC, Q_VEC, k0=100.0, k1=9.5e-4, k0_min=55.0,
            k0_max=331.0, q_lb_floor=0.9, solver=solver))
        out.append(P.lp.solve_tenant_lps(
            E_VEC, P_VEC, P.lp.DEFAULT_TENANTS, np.array(Q_VEC), k0=300.0,
            k1=9.5e-4, k0_min=55.0, k0_max=331.0, solver=solver))
        task = P.lp.TenantSpec(
            "task", xi=0.2, q_floor_frac=0.5,
            q_by_task={"gsm8k": [0.6, 0.3, 0.1], "mmlu": [0.3, 0.4, 0.3]})
        out.append(P.lp.solve_tenant_lps(
            E_VEC, P_VEC, (task,) + P.lp.DEFAULT_TENANTS, np.array(Q_VEC),
            k0=200.0, k1=9.5e-4, k0_min=55.0, k0_max=331.0,
            task_weights={"gsm8k": 3.0, "mmlu": 1.0}, solver=solver))
        return out
    return case


def _lp_helpers(P):
    L = P.lp
    return ([L.quality_lower_bound(0.45, k0, 55.0, 331.0, 0.1)
             for k0 in (0.0, 55.0, 200.0, 331.0, 900.0)],
            [L.forecast_weighted_intensity([100.0, 400.0, 250.0], decay=d)
             for d in (1.0, 0.5, 0.1)],
            [t.deadline_for(n) for t in L.DEFAULT_TENANTS for n in (1, 64)],
            L.STANDARD.effective_q(np.array(Q_VEC)))


def _lp_rejects_nonfinite(P):
    msgs = []
    for kw in (dict(k0=float("nan")), dict(k0=100.0, xi=float("inf"))):
        with pytest.raises(ValueError) as err:
            P.lp.solve_directive_lp(E_VEC, P_VEC, Q_VEC, k1=1e-3,
                                    k0_min=55.0, k0_max=331.0, **kw)
        msgs.append(str(err.value))
    return msgs


def _profiles(P, seed=0):
    prof = P.policies.LevelProfiles.fresh()
    rng = np.random.default_rng(seed)
    for _ in range(24):
        lvl = int(rng.integers(3))
        prof.update(lvl, float(rng.uniform(1e-6, 2e-5)) / (lvl + 1),
                    float(rng.uniform(0.05, 0.4)) / (lvl + 1))
    return prof


def _policy(name):
    def case(P):
        pol_mod, k_min, k_max, k1 = P.policies, 55.0, 331.0, 9.5e-4
        make = {
            "BasePolicy": lambda: pol_mod.BasePolicy(),
            "CO2OptPolicy": lambda: pol_mod.CO2OptPolicy(),
            "ModelOptPolicy": lambda: pol_mod.ModelOptPolicy(
                k0_min=k_min, k0_max=k_max, k1=k1),
            "SproutPolicy": lambda: pol_mod.SproutPolicy(
                k0_min=k_min, k0_max=k_max, k1=k1),
            "SproutStaticPolicy": lambda: pol_mod.SproutStaticPolicy.sweep(
                np.array(E_VEC), np.array(Q_VEC), k0_avg=180.0,
                k0_min=k_min, k0_max=k_max),
            "SproutTaskPolicy": lambda: pol_mod.SproutTaskPolicy(
                k0_min=k_min, k0_max=k_max, k1=k1),
            "OraclePolicy": lambda: pol_mod.OraclePolicy(
                k0_min=k_min, k0_max=k_max),
        }
        pol = make[name]()
        prof = _profiles(P)
        wl = P.workload.Workload(seed=11)
        ctx = {"model_e": [2.1e-5, 1.1e-5], "model_p": [0.3, 0.16],
               "model_q": [0.62, 0.38],
               "task_q": {"gsm8k": np.array([0.6, 0.3, 0.1]),
                          "mmlu": np.array([0.3, 0.4, 0.3]),
                          "alpaca": np.array([0.5, 0.3, 0.2])},
               "task_w": {"gsm8k": 2.0, "mmlu": 1.0, "alpaca": 1.0}}
        rng = np.random.default_rng(4)
        out = []
        for t, k0 in enumerate((300.0, 80.0, 210.0)):
            reqs = [wl.sample_request(float(t)) for _ in range(20)]
            if name == "OraclePolicy":
                carbon = np.random.default_rng(t).uniform(0.1, 1.0, (20, 3))
                pol.plan_hour(reqs, carbon, k0)
            else:
                pol.begin_hour(float(t), k0, prof, np.array(Q_VEC), ctx)
            out.append((getattr(pol, "x", None),
                        getattr(pol, "x_by_task", None),
                        [pol.assign(r, rng) for r in reqs]))
        return out
    return case


def _invoker(P):
    trace = P.carbon.carbon_intensity_trace("GB", "feb", hours=24 * 7)
    inv = P.invoker.EvaluationInvoker(k_hist_max=float(trace.max()))
    fired = [t for t, k2 in enumerate(trace) if inv.observe(float(t), k2)]
    flat = P.invoker.EvaluationInvoker(k_hist_max=500.0)
    stale = [t for t in range(120) if flat.observe(float(t), 100.0)]
    return fired, stale, inv.last_eval_t, inv.urgency_adjusted(200.0, 300.0)


def _simulation(P):
    sim = P.controller.SproutSimulation(
        region="CA", season="jun", hours=40, seed=0,
        requests_per_hour_cap=12)
    stats = sim.run()
    return stats, P.controller.summarize(stats)


def _grid_client(P):
    G = P.grid_client
    tokenless = G.GridSignalClient("CA", "jun")
    calls = []

    def transport(url, headers, timeout_s):
        calls.append((url, sorted(headers)))
        if len(calls) % 3 == 1:
            raise ConnectionError("flaky")
        if "forecast" in url:
            return json.dumps({"forecast": [{"carbonIntensity": 120.0},
                                            {"carbonIntensity": 140.0}]})
        return json.dumps({"carbonIntensity": 212.5}).encode()

    live = G.GridSignalClient("TX", "jun", provider="watttime", token="t",
                              transport=transport, sleep=lambda s: None)
    dead = G.GridSignalClient("GB", provider="electricitymaps", token="t",
                              transport=lambda *a: "not json",
                              sleep=lambda s: None, max_retries=2)
    out = [tokenless.intensity(3.0), tokenless.forecast(3.0, 4),
           tokenless.fallbacks, live.intensity(1.0), live.forecast(1.0, 4),
           live.forecast(1.0, 1), live.fetches, live.retries_used,
           dead.intensity(2.0), dead.forecast(2.0, 2), dead.fallbacks,
           dead.retries_used]
    return out, calls


CASES = {f"trace-{r}-{s}": _trace(r, s)
         for r in REF.carbon.REGIONS for s in REF.carbon.SEASONS}
CASES.update({
    "provider": _provider,
    "watchdog-nan": _watchdog("carbon.nan", (0, 3)),
    "watchdog-stale": _watchdog("carbon.stale", (0, 1, 2, 3, 4, 5, 6)),
    "watchdog-exception": _watchdog("carbon.exception", (1, 2, 3, 4, 5, 6)),
    "watchdog-no-good-sample": _watchdog_no_good_sample,
    "request-carbon": _request_carbon,
    "int8-kv": _int8_kv,
    "workload": _workload,
    "quality": _quality,
    "lp-highs": _lp("auto"),
    "lp-fallback": _lp("fallback"),
    "lp-helpers": _lp_helpers,
    "lp-rejects-nonfinite": _lp_rejects_nonfinite,
    "invoker": _invoker,
    "simulation": _simulation,
    "grid-client": _grid_client,
})
CASES.update({f"energy-trust{int(trust)}-chips{n}": _energy(trust, n)
              for trust in (False, True) for n in (1, 2)})
CASES.update({f"policy-{name}": _policy(name)
              for name in ("BasePolicy", "CO2OptPolicy", "ModelOptPolicy",
                           "SproutPolicy", "SproutStaticPolicy",
                           "SproutTaskPolicy", "OraclePolicy")})


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_reference(case):
    want = _plain(CASES[case](REF))
    got = _plain(CASES[case](PORT))
    _assert_same(want, got)


def test_scipy_path_is_taken_where_scipy_is_installed():
    """``solver="auto"`` reaches HiGHS exactly where the reference does, and
    the port keeps the reference's optional import."""
    assert PORT.lp._HAVE_SCIPY == REF.lp._HAVE_SCIPY
    sol = PORT.lp.solve_directive_lp(E_VEC, P_VEC, Q_VEC, k0=200.0, k1=1e-3,
                                     k0_min=55.0, k0_max=331.0)
    assert sol.solver == ("highs-ds" if REF.lp._HAVE_SCIPY else "fallback")


def test_h100_spec_holds_its_data_sheet():
    """The port's deployment target beside the reference's A100 entry: the
    data-sheet rates, and the A100's idle power and embodied carbon, for
    which the repo holds no H100 figure."""
    E = PORT.energy
    h = E.H100_SXM_80GB
    assert (h.name, h.peak_flops, h.hbm_bw, h.power_peak, h.ici_bw) == \
        ("h100-sxm-80gb", 989e12, 3.35e12, 700.0, 450e9)
    a = E.A100_40GB
    assert (h.power_idle, h.embodied_gco2, h.lifetime_s) == \
        (a.power_idle, a.embodied_gco2, a.lifetime_s)
    assert PORT.core.H100_SXM_80GB is h
    # a faster card prices the same request lower on the roofline
    m = E.LLAMA2_13B
    assert E.EnergyModel(h).request_time(m, 64, 64) < \
        E.EnergyModel(a).request_time(m, 64, 64)


def test_port_core_exports_the_reference_names():
    assert set(PORT.core.__all__) == set(REF.core.__all__) | {"H100_SXM_80GB"}
