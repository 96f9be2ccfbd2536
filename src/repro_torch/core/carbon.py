"""Carbon accounting (Eq. 1) and regional carbon-intensity traces (Table II).

C_req = CI · E_req + (CO2_embed / T_life) · T_req        (Eq. 1)

Traces: the paper uses hourly Electricity Maps data for five grid regions in
Feb/Jun/Oct 2023. Offline here, we synthesize hourly traces with the same
resolution, deterministic per (region, season), calibrated to each region's
published annual min/max and qualitative shape: solar duck curve (CA, SA),
wind-driven volatility (GB, NL), fossil baseline (TX). The provider
interface (``intensity(t)``) matches a live Electricity Maps client.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class Region:
    key: str
    name: str
    operator: str
    ci_min: float      # annual min, gCO2/kWh (Table II)
    ci_max: float      # annual max
    solar_share: float  # depth of the midday solar dip, 0..1
    wind_vol: float     # wind-driven hour-to-hour volatility, 0..1
    base_level: float   # fossil baseline position within [min, max], 0..1


REGIONS: Dict[str, Region] = {
    "TX": Region("TX", "Texas (US)", "ERCOT", 124, 494, 0.25, 0.30, 0.55),
    "CA": Region("CA", "California (US)", "CISO", 55, 331, 0.65, 0.20, 0.45),
    "SA": Region("SA", "South Australia", "AEMO", 10, 526, 0.70, 0.45, 0.40),
    "NL": Region("NL", "Netherlands", "TenneT", 23, 463, 0.30, 0.50, 0.50),
    "GB": Region("GB", "Great Britain", "ESO", 24, 282, 0.20, 0.55, 0.45),
}

SEASONS = ("feb", "jun", "oct")
_SEASON_IDX = {s: i for i, s in enumerate(SEASONS)}
# seasonal modifiers: (baseline shift, solar-dip multiplier)
_SEASON_MOD = {"feb": (+0.12, 0.55), "jun": (-0.08, 1.30), "oct": (0.0, 1.0)}

HOURS_PER_MONTH = 24 * 28
PUE = 1.2  # paper §II-B


def carbon_intensity_trace(region: str, season: str = "jun",
                           hours: int = HOURS_PER_MONTH) -> np.ndarray:
    """Hourly gCO2/kWh trace, deterministic per (region, season)."""
    r = REGIONS[region]
    shift, dipmul = _SEASON_MOD[season]
    # stable digest, NOT Python's salted str hash: hash((str, str)) varies
    # with PYTHONHASHSEED, which silently changed the "deterministic" traces
    # across interpreter invocations and machines
    rng = np.random.default_rng(zlib.crc32(f"{r.key}-{season}".encode()))
    t = np.arange(hours, dtype=np.float64)
    span = r.ci_max - r.ci_min
    base = r.ci_min + (r.base_level + shift) * span

    # diurnal: demand peak in the evening, solar dip at midday
    hour_of_day = t % 24.0
    evening = 0.18 * span * np.cos((hour_of_day - 19.0) / 24.0 * 2 * math.pi)
    solar = -r.solar_share * dipmul * 0.38 * span * np.exp(
        -0.5 * ((hour_of_day - 13.0) / 3.0) ** 2)
    # multi-day weather systems drive wind output (smooth random walk)
    steps = rng.standard_normal(hours)
    weather = np.convolve(steps, np.ones(36) / 36.0, mode="same")
    weather = r.wind_vol * 0.9 * span * weather / max(1e-9, np.abs(weather).max())
    noise = 0.03 * span * rng.standard_normal(hours)

    ci = base + evening + solar + weather + noise
    return np.clip(ci, r.ci_min, r.ci_max)


class CarbonIntensityProvider:
    """Hourly carbon-intensity lookups (stand-in for Electricity Maps API).

    Two methods shape the live-client interface:

    * ``intensity(t)`` — the current signal (Electricity Maps "latest").
    * ``forecast(t, horizon_hours)`` — hourly gCO2/kWh for the next
      ``horizon_hours`` starting at the hour containing ``t`` (Electricity
      Maps "forecast" endpoint). The trace-backed stand-in has perfect
      foresight — it reads the synthetic trace ahead — which is the right
      oracle for testing forecast-aware re-planning; a live client returns
      the grid operator's published forecast through the same signature.
    """

    def __init__(self, region: str, season: str = "jun",
                 hours: int = HOURS_PER_MONTH):
        self.region = REGIONS[region]
        self.trace = carbon_intensity_trace(region, season, hours)

    def intensity(self, t_hours: float) -> float:
        return float(self.trace[int(t_hours) % len(self.trace)])

    def forecast(self, t_hours: float, horizon_hours: float) -> np.ndarray:
        """Hourly intensities for hours [t, t + horizon). Always returns at
        least one entry (the current hour), so ``forecast(t, 0)[0]`` ==
        ``intensity(t)`` and a degenerate horizon degrades gracefully to
        instantaneous planning."""
        n = max(1, int(math.ceil(horizon_hours)))
        idx = (int(t_hours) + np.arange(n)) % len(self.trace)
        return np.asarray(self.trace, dtype=float)[idx]

    @property
    def k_min(self) -> float:
        return self.region.ci_min

    @property
    def k_max(self) -> float:
        return self.region.ci_max


class WatchdogProvider(CarbonIntensityProvider):
    """Validating wrapper around any carbon-intensity provider.

    Production grid feeds misbehave in three ways the planner must survive
    (DESIGN.md §12): the transport fails (timeout / 5xx), the payload is
    garbage (non-finite), or the feed silently re-serves an old sample.
    The watchdog validates every fetch, keeps the last good sample, and
    answers from it when the feed is sick — flipping ``degraded`` only
    once the last good sample is older than ``max_stale_h`` simulated
    hours, so a single blip never pushes the LP into degraded planning.
    With no good sample at all it falls back to the region climatology
    (trace mean): finite, conservative, and honest about being degraded.

    ``fault_injector`` (duck-typed; ``repro_torch.serving.faults.FaultInjector``
    — not imported here to keep core/ serving-independent) scripts the
    three failure modes at named points ``carbon.exception``,
    ``carbon.nan``, ``carbon.stale`` with the provider's region key as
    target. Injected garbage flows through the SAME validation gate as
    genuine garbage: a NaN payload is rejected by the isfinite check, not
    short-circuited by the injector.
    """

    def __init__(self, inner: CarbonIntensityProvider, *,
                 max_stale_h: float = 3.0, fault_injector=None):
        # deliberately no super().__init__ — everything proxies ``inner``
        self.inner = inner
        self.max_stale_h = max_stale_h
        self.injector = fault_injector
        self.degraded = False
        self.faults = {"stale": 0, "nan": 0, "exception": 0}
        self._last_good = None      # (t_hours, gCO2/kWh) of last valid fetch

    # ----- proxied identity ------------------------------------------
    @property
    def region(self) -> Region:
        return self.inner.region

    @property
    def trace(self) -> np.ndarray:
        return self.inner.trace

    @property
    def k_min(self) -> float:
        return self.inner.k_min

    @property
    def k_max(self) -> float:
        return self.inner.k_max

    # ----- validated fetch -------------------------------------------
    def _fire(self, point: str) -> bool:
        return self.injector is not None and \
            self.injector.fire(point, self.region.key)

    def _fetch(self, t_hours: float):
        """One validated fetch. Returns a fresh finite sample, or None
        (transport failure / garbage payload / stale re-serve)."""
        inj_nan = self._fire("carbon.nan")
        inj_stale = self._fire("carbon.stale")
        try:
            if self._fire("carbon.exception"):
                raise ConnectionError("injected: carbon feed down")
            v = float(self.inner.intensity(t_hours))
        except Exception:
            self.faults["exception"] += 1
            return None
        if inj_nan:
            v = float("nan")         # garbage payload, pre-validation
        if not math.isfinite(v):     # the genuine validation gate
            self.faults["nan"] += 1
            return None
        if inj_stale:
            # the feed answered, but with a sample it already served: no
            # fresh information — the last-good age keeps growing
            self.faults["stale"] += 1
            return None
        return v

    def _fallback(self, t_hours: float) -> float:
        """Last-good sample (aging toward ``degraded``), else climatology."""
        if self._last_good is not None:
            self.degraded = (t_hours - self._last_good[0]) > self.max_stale_h
            return self._last_good[1]
        self.degraded = True
        return float(np.mean(np.asarray(self.inner.trace, dtype=float)))

    def intensity(self, t_hours: float) -> float:
        v = self._fetch(t_hours)
        if v is not None:
            self._last_good = (float(t_hours), v)
            self.degraded = False
            return v
        return self._fallback(t_hours)

    def forecast(self, t_hours: float, horizon_hours: float) -> np.ndarray:
        n = max(1, int(math.ceil(horizon_hours)))
        inj_nan = self._fire("carbon.nan")
        inj_stale = self._fire("carbon.stale")
        try:
            if self._fire("carbon.exception"):
                raise ConnectionError("injected: carbon feed down")
            f = np.asarray(self.inner.forecast(t_hours, horizon_hours),
                           dtype=float)
            if inj_nan and f.size:
                f = f.copy()
                f[0] = float("nan")
            if f.size == n and np.isfinite(f).all():
                if inj_stale:
                    self.faults["stale"] += 1
                else:
                    return f
            else:
                self.faults["nan"] += 1
        except Exception:
            self.faults["exception"] += 1
        # persistence forecast: hold the fallback level flat across the
        # horizon — the planner keeps planning, just without foresight
        return np.full(n, self._fallback(t_hours), dtype=float)


def request_carbon(ci_g_per_kwh: float, energy_kwh: float, time_s: float,
                   embodied_gco2: float, lifetime_s: float,
                   pue: float = PUE) -> float:
    """Eq. 1 with datacenter PUE applied to operational energy."""
    operational = ci_g_per_kwh * energy_kwh * pue
    embodied = (embodied_gco2 / lifetime_s) * time_s
    return operational + embodied
