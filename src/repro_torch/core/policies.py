"""Competing schemes (paper §IV): BASE, CO2_OPT, MODEL_OPT, SPROUT_STA,
SPROUT, ORACLE. Each policy maps a request to (model_key, directive level);
SPROUT/SPROUT_STA draw the level from a probability vector x.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.lp import quality_lower_bound, solve_directive_lp
from repro_torch.core.workload import N_LEVELS, Request


@dataclasses.dataclass
class LevelProfiles:
    """Running per-level energy (kWh) / time (s) estimates — the e, p vectors."""
    e: np.ndarray
    p: np.ndarray
    counts: np.ndarray

    @classmethod
    def fresh(cls, n: int = N_LEVELS):
        return cls(np.zeros(n), np.zeros(n), np.zeros(n))

    def update(self, level: int, energy_kwh: float, time_s: float,
               window: float = 500.0):
        c = min(self.counts[level], window)
        self.e[level] = (self.e[level] * c + energy_kwh) / (c + 1)
        self.p[level] = (self.p[level] * c + time_s) / (c + 1)
        self.counts[level] += 1


def _simplex_grid(n: int, levels: int):
    """All integer compositions of ``n`` into ``levels`` parts (the step-1/n
    grid over the probability simplex)."""
    if levels == 1:
        yield (n,)
        return
    for i in range(n + 1):
        for rest in _simplex_grid(n - i, levels - 1):
            yield (i,) + rest


class Policy:
    name = "policy"
    uses_lp = False

    def begin_hour(self, t: float, k0: float, profiles: LevelProfiles,
                   q: np.ndarray, ctx: Dict) -> None:
        pass

    def assign(self, req: Request, rng: np.random.Generator) -> Tuple[str, int]:
        raise NotImplementedError


class BasePolicy(Policy):
    """Vanilla serving: big model, no directive."""
    name = "BASE"

    def assign(self, req, rng):
        return "13b", 0


class CO2OptPolicy(Policy):
    """Always the lowest-carbon directive level, quality-blind."""
    name = "CO2_OPT"

    def __init__(self):
        self.level = N_LEVELS - 1

    def begin_hour(self, t, k0, profiles, q, ctx):
        if profiles.counts.min() > 0:
            self.level = int(np.argmin(profiles.e))

    def assign(self, req, rng):
        return "13b", self.level


class ModelOptPolicy(Policy):
    """Prior-work scheme [10,13,14]: optimize over MODEL VARIANTS (7B vs 13B
    at L0), blind to generation directives. Solves the same LP but with
    model variants as the options."""
    name = "MODEL_OPT"
    uses_lp = True

    def __init__(self, *, k0_min: float, k0_max: float, xi: float = 0.1,
                 k1: float = 1e-3):
        self.k0_min, self.k0_max, self.xi, self.k1 = k0_min, k0_max, xi, k1
        self.x = np.array([1.0, 0.0])  # P(13b), P(7b)

    def begin_hour(self, t, k0, profiles, q, ctx):
        e = ctx.get("model_e")      # per-variant kWh [13b, 7b]
        p = ctx.get("model_p")
        qm = ctx.get("model_q")     # head-to-head preference rates
        if e is None:
            return
        sol = solve_directive_lp(e, p, qm, k0=k0, k1=self.k1,
                                 k0_min=self.k0_min, k0_max=self.k0_max,
                                 xi=self.xi)
        self.x = sol.x

    def assign(self, req, rng):
        pick = rng.choice(2, p=self.x)
        return ("13b", 0) if pick == 0 else ("7b", 0)


class SproutPolicy(Policy):
    """The full system: hourly LP over directive levels with live carbon
    intensity and evaluator feedback (Eq. 2–7)."""
    name = "SPROUT"
    uses_lp = True

    def __init__(self, *, k0_min: float, k0_max: float, xi: float = 0.1,
                 k1: float = 1e-3, explore: float = 0.01,
                 n_levels: int = N_LEVELS):
        self.k0_min, self.k0_max, self.xi, self.k1 = k0_min, k0_max, xi, k1
        self.explore = explore
        self.n_levels = n_levels
        self.x = np.ones(n_levels) / n_levels
        self.last_solution = None

    def begin_hour(self, t, k0, profiles, q, ctx):
        if profiles.counts.min() < 5:   # warmup: uniform to build profiles
            self.x = np.ones(self.n_levels) / self.n_levels
            return
        sol = solve_directive_lp(profiles.e, profiles.p, q, k0=k0,
                                 k1=self.k1, k0_min=self.k0_min,
                                 k0_max=self.k0_max, xi=self.xi)
        self.last_solution = sol
        x = (1 - self.explore) * sol.x + self.explore / self.n_levels
        self.x = x / x.sum()

    def assign(self, req, rng):
        return "13b", int(rng.choice(self.n_levels, p=self.x))


class SproutStaticPolicy(Policy):
    """SPROUT_STA: one month-long static directive mix, chosen by sweeping
    static configurations offline against month-average conditions."""
    name = "SPROUT_STA"

    def __init__(self, x: np.ndarray):
        self.x = np.asarray(x, float)

    @classmethod
    def sweep(cls, e: np.ndarray, q: np.ndarray, *, k0_avg: float,
              k0_min: float, k0_max: float, xi: float = 0.1,
              step: float = 0.05) -> "SproutStaticPolicy":
        """Grid-sweep the simplex for min avg carbon s.t. the month-average
        quality constraint (the paper's 'best static configuration').

        Works for any number of directive levels (the grid enumerates the
        full ``len(e)``-dimensional simplex, not a hardcoded 3-level walk);
        Eq. 3 guarantees q_lb <= q[0], so the pure-L0 point is always
        feasible and seeds the search."""
        e = np.asarray(e, float)
        q = np.asarray(q, float)
        assert len(e) == len(q)
        q_lb = quality_lower_bound(q[0], k0_avg, k0_min, k0_max, xi)
        n = int(round(1 / step))
        best, best_c = np.eye(len(e))[0], float(e[0])
        for comp in _simplex_grid(n, len(e)):
            x = np.asarray(comp, float) / n
            if q @ x >= q_lb - 1e-12:
                c = float(e @ x)
                if c < best_c:
                    best, best_c = x, c
        return cls(best)

    def assign(self, req, rng):
        return "13b", int(rng.choice(len(self.x), p=self.x))


class SproutTaskPolicy(Policy):
    """BEYOND-PAPER extension: task-conditioned LP.

    The request's task family is observable from the prompt (a lightweight
    classifier in production; exact here). Solving the same LP *per task*
    with per-task preference vectors q_t — subject to the same aggregate
    quality floor — recovers most of the per-prompt ORACLE's advantage while
    staying a system-level (low-dimensional) optimization: n_tasks small LPs
    instead of one, still microseconds on the control plane.

    Decomposition: min Σ_t w_t c_tᵀx_t  s.t. Σ_t w_t q_tᵀx_t ≥ q_lb. We
    lagrangian-split by sweeping a shared quality price λ (bisection), which
    is exact for this separable LP.
    """
    name = "SPROUT_TASK"
    uses_lp = True

    def __init__(self, *, k0_min: float, k0_max: float, xi: float = 0.1,
                 k1: float = 1e-3, explore: float = 0.01):
        self.k0_min, self.k0_max, self.xi, self.k1 = k0_min, k0_max, xi, k1
        self.explore = explore
        self.x_by_task: Dict[str, np.ndarray] = {}
        self.x_default = np.ones(N_LEVELS) / N_LEVELS

    def begin_hour(self, t, k0, profiles, q, ctx):
        task_q = ctx.get("task_q")       # {task: q_t}, from the evaluator
        task_w = ctx.get("task_w")       # {task: mixture weight}
        if not task_q or profiles.counts.min() < 5:
            return
        tasks = list(task_q)
        w = np.array([task_w[t_] for t_ in tasks])
        w = w / w.sum()
        qs = np.stack([task_q[t_] for t_ in tasks])     # (T, L)
        c = k0 * profiles.e + self.k1 * profiles.p       # (L,)
        q0 = float(w @ qs[:, 0])
        q_lb = quality_lower_bound(q0, k0, self.k0_min, self.k0_max, self.xi)

        def assign_for(lam):
            # per task: pick level minimizing c - lam * q  (pointwise LP)
            scores = c[None, :] - lam * qs               # (T, L)
            pick = np.argmin(scores, axis=1)
            qual = float(w @ qs[np.arange(len(tasks)), pick])
            return pick, qual

        lo, hi = 0.0, 10.0 * float(np.max(c)) / max(1e-9, np.min(np.ptp(qs, 1)))
        pick, qual = assign_for(lo)
        if qual < q_lb:
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                pick, qual = assign_for(mid)
                if qual < q_lb:
                    lo = mid
                else:
                    hi = mid
            pick, qual = assign_for(hi)
        self.x_by_task = {}
        for i, t_ in enumerate(tasks):
            x = np.full(N_LEVELS, self.explore / N_LEVELS)
            x[pick[i]] += 1 - self.explore
            self.x_by_task[t_] = x / x.sum()

    def assign(self, req, rng):
        x = self.x_by_task.get(req.task, self.x_default)
        return "13b", int(rng.choice(N_LEVELS, p=x))


class OraclePolicy(Policy):
    """Impractical upper bound: exact per-request carbon AND quality
    knowledge, no profiling/sampling error. Greedy per-hour assignment =
    fractional-knapsack optimum of the per-request LP."""
    name = "ORACLE"

    def __init__(self, *, k0_min: float, k0_max: float, xi: float = 0.1):
        self.k0_min, self.k0_max, self.xi = k0_min, k0_max, xi
        self._assignment: Dict[int, int] = {}

    def plan_hour(self, reqs: Sequence[Request], carbon_rl: np.ndarray,
                  k0: float) -> None:
        """carbon_rl: (N, L) exact per-request carbon at each level."""
        N = len(reqs)
        if N == 0:
            self._assignment = {}
            return
        pref = np.array([r.preferred for r in reqs])
        q0 = float(np.mean(pref == 0))
        q_lb = quality_lower_bound(q0, k0, self.k0_min, self.k0_max, self.xi)
        cheapest = np.argmin(carbon_rl, axis=1)
        lvl = cheapest.copy()
        quality = np.mean(lvl == pref)
        if quality < q_lb:
            # upgrade requests to their preferred level, cheapest-first
            cand = np.where(lvl != pref)[0]
            penalty = carbon_rl[cand, pref[cand]] - carbon_rl[cand, lvl[cand]]
            order = cand[np.argsort(penalty)]
            need = int(np.ceil((q_lb - quality) * N))
            for i in order[:need]:
                lvl[i] = pref[i]
        self._assignment = {r.rid: int(l) for r, l in zip(reqs, lvl)}

    def assign(self, req, rng):
        return "13b", self._assignment.get(req.rid, 0)
