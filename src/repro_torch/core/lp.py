"""SPROUT's generation-directive optimizer (paper §III-B, Eq. 2–7).

  min_x  f(x) = k0 · eᵀx + k1 · pᵀx                                 (Eq. 2)
  s.t.   qᵀx ≥ q_lb                                                 (Eq. 5)
         0 ≤ x_i ≤ 1                                                (Eq. 6)
         Σ x_i = 1                                                  (Eq. 7)
  q_lb = (1 − (k0 − k0_min)/(k0_max − k0_min) · ξ) · q0             (Eq. 3)

Solved with HiGHS dual simplex (paper ref. [30]) via scipy; a dependency-
free dense two-phase simplex is included as fallback and as a cross-check
oracle in tests.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

try:
    from scipy.optimize import linprog as _scipy_linprog
    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False


@dataclasses.dataclass(frozen=True)
class DirectiveSolution:
    x: np.ndarray              # probability per directive level
    expected_carbon: float     # f(x), gCO2 per request
    expected_quality: float    # qᵀx
    q_lb: float
    feasible: bool
    solver: str


def quality_lower_bound(q0: float, k0: float, k0_min: float, k0_max: float,
                        xi: float) -> float:
    """Eq. 3: quality floor tightens when the grid is green."""
    k0c = min(max(k0, k0_min), k0_max)
    frac = (k0c - k0_min) / max(k0_max - k0_min, 1e-12)
    return (1.0 - frac * xi) * q0


def forecast_weighted_intensity(window, *, decay: float = 0.5) -> float:
    """Collapse an hourly intensity forecast window into the effective k0
    the LP should plan against.

    The Eq. 2 objective is linear in k0, so planning the next H hours
    against weights w is EXACTLY solving the LP at the scalar
    k0_eff = Σ_h w_h · k0_h — no new solver needed, just a weighted
    effective intensity. Weights decay geometrically (w_h ∝ decay^h):
    requests admitted under this plan mostly finish within the current
    hour, but a dirty hour ahead still pulls the mix toward brevity
    pre-emptively (the Fig. 12 adaptivity signal, one hour early).
    ``decay=1`` is a plain window mean; ``decay→0`` recovers the
    instantaneous value.
    """
    window = np.asarray(window, float)
    assert window.size > 0, "forecast window must hold at least one hour"
    if not (0.0 < decay <= 1.0):
        raise ValueError(f"decay must be in (0, 1], got {decay}")
    w = decay ** np.arange(window.size)
    return float(w @ window / w.sum())


def solve_directive_lp(e: Sequence[float], p: Sequence[float],
                       q: Sequence[float], *, k0: float, k1: float,
                       k0_min: float, k0_max: float, xi: float = 0.1,
                       q_lb_floor: float = 0.0,
                       solver: str = "auto") -> DirectiveSolution:
    """Configure directive-level probabilities x (Eq. 4–7).

    ``q_lb_floor`` clamps the Eq. 3 floor from below (absolute units of
    q): a premium tenant's quality guarantee must hold even when the grid
    is at its dirtiest and Eq. 3 would relax the floor all the way to
    ``(1 - xi) * q0``.
    """
    e = np.asarray(e, float)
    p = np.asarray(p, float)
    q = np.asarray(q, float)
    n = len(e)
    assert len(p) == n and len(q) == n
    # validate BEFORE solving (DESIGN.md §12): a NaN carbon price or
    # telemetry vector would not crash the solver — it would return a
    # garbage mix that silently misplans the hour. Fail loudly here so
    # the gateway's plan-hold degraded mode can catch it.
    if not (np.isfinite(e).all() and np.isfinite(p).all()
            and np.isfinite(q).all()):
        raise ValueError("non-finite LP inputs: e/p/q telemetry")
    if not all(math.isfinite(v) for v in (k0, k1, k0_min, k0_max, xi)):
        raise ValueError(
            f"non-finite LP carbon terms: k0={k0} k1={k1} "
            f"k0_min={k0_min} k0_max={k0_max} xi={xi}")
    c = k0 * e + k1 * p                      # objective coefficients
    q_lb = max(quality_lower_bound(q[0], k0, k0_min, k0_max, xi),
               q_lb_floor)

    if solver in ("auto", "highs") and _HAVE_SCIPY:
        res = _scipy_linprog(
            c,
            A_ub=(-q)[None, :], b_ub=[-q_lb],          # qᵀx ≥ q_lb
            A_eq=np.ones((1, n)), b_eq=[1.0],
            bounds=[(0.0, 1.0)] * n,
            method="highs-ds")                          # dual simplex [30]
        if res.status == 0:
            x = np.clip(res.x, 0.0, 1.0)
            x = x / x.sum()
            return DirectiveSolution(x, float(c @ x), float(q @ x), q_lb,
                                     True, "highs-ds")
        # infeasible: fall through to the fallback path below

    return _solve_fallback(c, q, q_lb)


def _solve_fallback(c: np.ndarray, q: np.ndarray,
                    q_lb: float) -> DirectiveSolution:
    """Dense exact solver for this specific LP structure.

    With one simplex constraint and one quality inequality, a vertex optimum
    mixes at most TWO levels (n-variable LP with 2 active constraints).
    Enumerate single levels and all 2-level mixes that hit qᵀx = q_lb.
    """
    n = len(c)
    best_x, best_f = None, np.inf
    for i in range(n):
        if q[i] >= q_lb - 1e-12 and c[i] < best_f:
            x = np.zeros(n)
            x[i] = 1.0
            best_x, best_f = x, c[i]
    for i in range(n):
        for j in range(n):
            if i == j or q[i] <= q[j]:
                continue
            # mix a (high-quality i) with (1-a) (low j) to hit the floor
            denom = q[i] - q[j]
            a = (q_lb - q[j]) / denom
            if not (0.0 <= a <= 1.0):
                continue
            f = a * c[i] + (1 - a) * c[j]
            if f < best_f - 1e-15:
                x = np.zeros(n)
                x[i], x[j] = a, 1 - a
                best_x, best_f = x, f
    if best_x is None:  # infeasible: best effort = highest-quality level
        x = np.zeros(n)
        x[int(np.argmax(q))] = 1.0
        return DirectiveSolution(x, float(c @ x), float(q @ x), q_lb,
                                 False, "fallback")
    return DirectiveSolution(best_x, float(best_f), float(q @ best_x), q_lb,
                             True, "fallback")


# ---------------------------------------------------------------------------
# Per-tenant service classes (gateway-side SLOs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant service class: its quality floor AND its latency targets.

    The directive optimizer trades quality for carbon; a production fleet
    makes that trade per tenant. Each class carries

    * ``xi`` — its own Eq. 3 relaxation (how far quality may drop as the
      grid greens); a premium class keeps xi small;
    * ``q_floor_frac`` — an ABSOLUTE floor as a fraction of the pure-L0
      preference rate q0: ``q_lb >= q_floor_frac * q0`` no matter how
      dirty the grid is (Eq. 3 alone would keep relaxing);
    * ``ttft_s`` / ``tpot_s`` — latency targets: when a request arrives
      without an explicit deadline, the gateway derives one as
      ``ttft_s + tpot_s * max_new_tokens``;
    * ``priority`` — dispatch order within a pool (lower dispatches
      first), so a premium request never queues behind batch work;
    * ``q_by_task`` — optional per-task preference vectors (the evaluator
      reports them per SPROUT task family); the tenant's LP then solves
      over its task-weighted quality vector instead of the aggregate.
    """
    name: str
    xi: float = 0.1
    q_floor_frac: float = 0.0
    ttft_s: float = math.inf
    tpot_s: float = math.inf
    priority: int = 1
    q_by_task: Optional[Mapping[str, Sequence[float]]] = None

    def deadline_for(self, max_new_tokens: int) -> float:
        """Per-class completion deadline for a request of this budget."""
        if math.isinf(self.ttft_s) and math.isinf(self.tpot_s):
            return math.inf
        ttft = 0.0 if math.isinf(self.ttft_s) else self.ttft_s
        tpot = 0.0 if math.isinf(self.tpot_s) else self.tpot_s
        return ttft + tpot * max_new_tokens

    def effective_q(self, q_default: np.ndarray,
                    task_weights: Optional[Mapping[str, float]] = None
                    ) -> np.ndarray:
        """The quality vector this tenant's LP solves over: the task-
        weighted mix of its per-task q vectors when it has them (weights
        default to uniform over the tenant's known tasks), else the
        fleet-wide aggregate."""
        if not self.q_by_task:
            return np.asarray(q_default, float)
        tasks = list(self.q_by_task)
        if task_weights:
            w = np.array([max(float(task_weights.get(t, 0.0)), 0.0)
                          for t in tasks])
            if w.sum() <= 0:
                w = np.ones(len(tasks))
        else:
            w = np.ones(len(tasks))
        w = w / w.sum()
        qs = np.stack([np.asarray(self.q_by_task[t], float) for t in tasks])
        return w @ qs


# Default service classes. Premium holds ~97% of L0 preference no matter
# the grid and dispatches first; batch has no latency target and lets the
# optimizer chase carbon almost freely.
PREMIUM = TenantSpec("premium", xi=0.03, q_floor_frac=0.97,
                     ttft_s=0.5, tpot_s=0.05, priority=0)
STANDARD = TenantSpec("standard", xi=0.12, q_floor_frac=0.80,
                      ttft_s=2.0, tpot_s=0.25, priority=1)
BATCH = TenantSpec("batch", xi=0.35, q_floor_frac=0.0, priority=2)
DEFAULT_TENANTS: Tuple[TenantSpec, ...] = (PREMIUM, STANDARD, BATCH)


def solve_tenant_lps(e: Sequence[float], p: Sequence[float],
                     tenants: Sequence[TenantSpec], q_default: np.ndarray,
                     *, k0: float, k1: float, k0_min: float, k0_max: float,
                     task_weights: Optional[Mapping[str, float]] = None,
                     solver: str = "auto") -> Dict[str, DirectiveSolution]:
    """One directive LP per tenant class at a shared grid signal.

    Each tenant's solve uses its own xi, its absolute quality floor
    (``q_floor_frac * q_t[0]``), and its task-weighted quality vector.
    The LPs are independent (per-tenant floors, not one aggregate
    constraint), so solving them separately IS the exact optimum — and
    stays microseconds-scale on the control plane.
    """
    out: Dict[str, DirectiveSolution] = {}
    for t in tenants:
        q_t = t.effective_q(q_default, task_weights)
        out[t.name] = solve_directive_lp(
            e, p, q_t, k0=k0, k1=k1, k0_min=k0_min, k0_max=k0_max,
            xi=t.xi, q_lb_floor=t.q_floor_frac * float(q_t[0]),
            solver=solver)
    return out
