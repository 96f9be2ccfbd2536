"""Opportunistic offline-evaluation invoker (paper §III-C, Eq. 8, Fig. 6).

Urgency-adjusted carbon intensity:  k2'(t) = exp(-beta (t - t0)) * k2(t)

An evaluation fires when, causally observing hourly k2' samples:
  (i)   the previous sample was a local minimum of k2' (discrete positive
        second derivative: k'[t-2] > k'[t-1] <= k'[t]);
  (ii)  the grace period since the last evaluation has elapsed;
  (iii) that minimum lies below the threshold (default 50% of the
        historical maximum carbon intensity).

beta = 0.028/hr halves the urgency-adjusted intensity after 24 h (paper),
so under persistently high intensity the decay alone eventually drops k2'
below the threshold — evaluation always happens (Fig. 6b).
"""
from __future__ import annotations

import math
from typing import List


class EvaluationInvoker:
    def __init__(self, *, beta: float = 0.028, grace_hours: float = 12.0,
                 threshold_frac: float = 0.5, k_hist_max: float = 500.0,
                 max_staleness_hours: float = 48.0):
        self.beta = beta
        self.grace = grace_hours
        self.threshold = threshold_frac * k_hist_max
        # hard deadline: a perfectly flat trace has no k2' local minima, but
        # "increasing evaluation urgency ensures offline evaluation always
        # occurs" (Fig. 6b) — enforce it explicitly.
        self.max_staleness = max_staleness_hours
        self.last_eval_t: float = 0.0
        self._hist: List[float] = []   # recent urgency-adjusted samples
        self._hist_t: List[float] = []

    def urgency_adjusted(self, t: float, k2: float) -> float:
        return math.exp(-self.beta * (t - self.last_eval_t)) * k2

    def observe(self, t: float, k2: float) -> bool:
        """Feed one hourly sample; returns True if evaluation should fire."""
        kprime = self.urgency_adjusted(t, k2)
        self._hist.append(kprime)
        self._hist_t.append(t)
        if len(self._hist) > 3:
            self._hist = self._hist[-3:]
            self._hist_t = self._hist_t[-3:]
        if t - self.last_eval_t < self.grace:
            return False
        if t - self.last_eval_t >= self.max_staleness \
                and kprime <= self.threshold:
            self.fire(t)                   # staleness deadline (Fig. 6b)
            return True
        if len(self._hist) < 3:
            return False
        a, b, c = self._hist[-3], self._hist[-2], self._hist[-1]
        if not (a > b <= c):               # (i) local minimum at t-1
            return False
        if b > self.threshold:             # (iii) below threshold
            return False
        self.fire(t)
        return True

    def fire(self, t: float) -> None:
        self.last_eval_t = t
        self._hist.clear()
        self._hist_t.clear()
