"""Live grid carbon-signal client (Electricity Maps / WattTime).

The paper's traces are hourly Electricity Maps data (Table II); this
client serves the SAME ``CarbonIntensityProvider`` interface from the
live API so a deployment can point the gateway at the real grid without
touching the planner. Design constraints (DESIGN.md §12):

* **Transport is injectable.** ``transport(url, headers, timeout_s)``
  returns the response body (bytes/str). The default is a lazy
  ``urllib.request`` adapter, but tests pass a stub — CI never touches
  the network, and the retry/fallback logic is unit-testable without it.
* **Bounded retries.** Each fetch attempts the transport up to
  ``1 + max_retries`` times with capped exponential backoff
  (``backoff_base_s * 2^attempt``, capped at ``backoff_cap_s``), sleeping
  through an injectable ``sleep`` so tests run instantly.
* **Automatic trace fallback.** Any terminal failure (retries exhausted,
  malformed payload) answers from the bundled synthetic trace for the
  region — the planner always gets a finite number. Pair with
  ``WatchdogProvider`` to also get staleness aging and degraded-state
  reporting on top.

No API tokens ship with the repo: construct with ``token=""`` and the
client never builds a default transport (it falls back immediately),
which is the CI-safe configuration.
"""
from __future__ import annotations

import json
import math
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.carbon import HOURS_PER_MONTH, CarbonIntensityProvider

# repo region keys -> Electricity Maps zone ids (Table II regions)
EMAPS_ZONES = {
    "TX": "US-TEX-ERCO",
    "CA": "US-CAL-CISO",
    "SA": "AU-SA",
    "NL": "NL",
    "GB": "GB",
}

# repo region keys -> WattTime balancing-authority abbrevs
WATTTIME_BA = {
    "TX": "ERCOT",
    "CA": "CAISO_NORTH",
    "SA": "AEMO_SA",
    "NL": "NL",
    "GB": "UK",
}


def _urllib_transport(url: str, headers: dict, timeout_s: float):
    """Default transport: stdlib-only GET (built lazily, never in tests)."""
    import urllib.request
    req = urllib.request.Request(url, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return resp.read()


class GridSignalClient(CarbonIntensityProvider):
    """``CarbonIntensityProvider`` backed by a live grid-signal API.

    ``intensity(t)``/``forecast(t, h)`` keep the trace-backed signature
    (hours into the run); the live payload supplies the *value* while
    ``t`` keeps indexing the bundled fallback trace, so swapping this in
    for the synthetic provider changes no call sites.
    """

    def __init__(self, region: str, season: str = "jun",
                 hours: int = HOURS_PER_MONTH, *,
                 provider: str = "electricitymaps", token: str = "",
                 timeout_s: float = 5.0, max_retries: int = 3,
                 backoff_base_s: float = 0.5, backoff_cap_s: float = 8.0,
                 transport: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep):
        super().__init__(region, season, hours)   # bundled-trace fallback
        if provider not in ("electricitymaps", "watttime"):
            raise ValueError(f"unknown grid provider {provider!r}")
        self.provider = provider
        self.token = token
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        # no token -> never build a network transport: CI-safe by default
        self._transport = transport if transport is not None else (
            _urllib_transport if token else None)
        self._sleep = sleep
        self.fetches = 0          # successful live fetches
        self.fallbacks = 0        # answers served from the bundled trace
        self.retries_used = 0     # transport attempts beyond the first

    # ----- endpoint shapes -------------------------------------------
    def _url(self, kind: str) -> str:
        key = self.region.key
        if self.provider == "electricitymaps":
            zone = EMAPS_ZONES.get(key, key)
            return (f"https://api.electricitymap.org/v3/carbon-intensity/"
                    f"{kind}?zone={zone}")
        ba = WATTTIME_BA.get(key, key)
        sig = "co2_moer" if kind == "latest" else "co2_moer_forecast"
        return (f"https://api.watttime.org/v3/{kind}?region={ba}"
                f"&signal_type={sig}")

    def _headers(self) -> dict:
        if self.provider == "electricitymaps":
            return {"auth-token": self.token}
        return {"Authorization": f"Bearer {self.token}"}

    # ----- bounded-retry fetch ---------------------------------------
    def _get_json(self, kind: str):
        """Fetch + parse one endpoint, or None after bounded retries."""
        if self._transport is None:
            return None
        for attempt in range(1 + self.max_retries):
            if attempt:
                self.retries_used += 1
                self._sleep(min(self.backoff_cap_s,
                                self.backoff_base_s * 2 ** (attempt - 1)))
            try:
                body = self._transport(self._url(kind), self._headers(),
                                       self.timeout_s)
                if isinstance(body, bytes):
                    body = body.decode("utf-8")
                return json.loads(body)
            except Exception:
                continue
        return None

    @staticmethod
    def _parse_latest(payload) -> Optional[float]:
        try:
            v = float(payload.get("carbonIntensity",
                                  payload.get("value", float("nan"))))
        except (AttributeError, TypeError, ValueError):
            return None
        return v if math.isfinite(v) else None

    @staticmethod
    def _parse_forecast(payload) -> Optional[np.ndarray]:
        try:
            rows = payload.get("forecast", payload.get("data", []))
            vals = [float(r.get("carbonIntensity", r.get("value")))
                    for r in rows]
        except (AttributeError, TypeError, ValueError):
            return None
        arr = np.asarray(vals, dtype=float)
        if arr.size == 0 or not np.isfinite(arr).all():
            return None
        return arr

    # ----- provider interface ----------------------------------------
    def intensity(self, t_hours: float) -> float:
        v = self._parse_latest(self._get_json("latest") or {})
        if v is not None:
            self.fetches += 1
            return v
        self.fallbacks += 1
        return super().intensity(t_hours)

    def forecast(self, t_hours: float, horizon_hours: float) -> np.ndarray:
        n = max(1, int(math.ceil(horizon_hours)))
        f = self._parse_forecast(self._get_json("forecast") or {})
        if f is not None:
            self.fetches += 1
            if f.size >= n:
                return f[:n]
            # short horizon from the API: persist its last value
            return np.concatenate([f, np.full(n - f.size, f[-1])])
        self.fallbacks += 1
        return super().forecast(t_hours, horizon_hours)
