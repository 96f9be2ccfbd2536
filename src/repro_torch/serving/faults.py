"""Deterministic fault injection for the serving stack (DESIGN.md §12).

Chaos engineering only pays off when a failure is *reproducible*: a fault
that fires from wall-clock jitter or an unseeded coin flip cannot anchor a
regression test, and CI cannot byte-diff two runs of it. Everything here
is therefore a pure function of the committed ``FaultPlan`` plus a seed:

* ``FaultSpec`` — one scripted fault: a named injection ``point``, an
  optional ``target`` (pool key, replica index, rid — "*" matches any),
  and the zero-based ``occurrences`` of that (point, target) pair at
  which it fires. A probabilistic ``prob`` mode exists for soak-style
  plans; its draws come from a PRNG seeded by ``zlib.crc32(point)`` xor
  the plan seed, never from global random state.
* ``FaultPlan`` — an ordered collection of specs. Plans are data: tests
  and ``scripts/chaos.sh`` build them inline, and the same plan replayed
  against the same fleet produces the same faults at the same steps
  under any PYTHONHASHSEED.
* ``FaultInjector`` — the runtime: every instrumented site calls
  ``fire(point, target)`` exactly once per opportunity; the injector
  counts the opportunity deterministically and answers "does a scripted
  fault land here, now?". Fired faults are logged to ``events``.

Injection points threaded through the stack (the site consults the
injector; the *failure itself* then happens through the genuine
mechanism — a poisoned KV lane really produces non-finite logits, a
crashed replica really drains through the health machine):

=======================  ====================================================
point                    site / genuine failure
=======================  ====================================================
``carbon.stale``         WatchdogProvider: the grid feed stops updating
``carbon.nan``           WatchdogProvider: feed returns a non-finite value
``carbon.exception``     WatchdogProvider: feed raises (timeout, 5xx, ...)
``lp.fail``              SproutGateway.replan: the directive LP solve fails
``replica.crash``        CarbonAwareScheduler.step: replica dies mid-block
                         (or mid-chunk-prefill — whatever is in flight)
``decode.nonfinite``     CarbonAwareScheduler.step: a live lane's KV is
                         poisoned (InferenceEngine.poison_lane) so the next
                         fused block's logits are genuinely non-finite
``migrate.dst_vanish``   MigrationPlanner: the destination fleet vanishes
                         between evict and submit
=======================  ====================================================
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

POINTS = (
    "carbon.stale",
    "carbon.nan",
    "carbon.exception",
    "lp.fail",
    "replica.crash",
    "decode.nonfinite",
    "migrate.dst_vanish",
)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault. ``occurrences`` are zero-based indices into the
    deterministic per-(point, target) opportunity counter; ``prob`` adds
    seeded per-opportunity firing on top (0.0 = scripted-only)."""
    point: str
    target: str = "*"
    occurrences: Tuple[int, ...] = (0,)
    prob: float = 0.0

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r}; known: {POINTS}")
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault that actually fired (the injector's audit log)."""
    point: str
    target: str
    occurrence: int


class FaultPlan:
    """An ordered, immutable-ish set of FaultSpecs (plans are data)."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: List[FaultSpec] = list(specs)

    def for_point(self, point: str) -> List[FaultSpec]:
        return [s for s in self.specs if s.point == point]

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)


class FaultInjector:
    """Seed-deterministic runtime for a FaultPlan.

    Each instrumented site calls ``fire(point, target)`` once per
    opportunity. The injector keeps one opportunity counter per
    (point, target) pair — NOT per spec — so a plan edit never shifts
    when an unrelated spec fires. ``fire`` with a concrete target also
    advances the wildcard counter for that point, so "the 3rd carbon
    fetch anywhere" and "the 3rd fetch for pool CA" are both scriptable.

    The probabilistic mode draws from ``np.random.default_rng`` seeded by
    ``seed ^ crc32(point)``: per-point streams, so adding a prob spec on
    one point never perturbs another point's draws.
    """

    def __init__(self, plan: Optional[FaultPlan] = None, seed: int = 0):
        self.plan = plan or FaultPlan()
        self.seed = seed
        self.counts: Dict[Tuple[str, str], int] = {}
        self.events: List[FaultEvent] = []
        self._rngs: Dict[str, np.random.Generator] = {}
        # sites set this False to disarm injection in a fault-free control
        # run sharing the same wiring (the chaos tests' paired baseline)
        self.armed = True

    # ------------------------------------------------------------------
    def _rng(self, point: str) -> np.random.Generator:
        if point not in self._rngs:
            self._rngs[point] = np.random.default_rng(
                self.seed ^ zlib.crc32(point.encode()))
        return self._rngs[point]

    def _bump(self, point: str, target: str) -> int:
        key = (point, target)
        n = self.counts.get(key, 0)
        self.counts[key] = n + 1
        return n

    def fire(self, point: str, target: str = "*") -> bool:
        """One injection opportunity at (point, target); True = fault."""
        if not self.armed:
            # disarmed consults do not count: a plan's occurrence indices
            # are relative to ARMING, so a scenario can run a fault-free
            # warmup phase of any length and still script "the 2nd armed
            # opportunity" without counting the warmup's consults
            return False
        n = self._bump(point, target)
        n_any = n if target == "*" else self._bump(point, "*")
        for spec in self.plan.for_point(point):
            if spec.target == target and n in spec.occurrences:
                break
            if spec.target == "*" and target != "*" \
                    and n_any in spec.occurrences:
                break
            if spec.prob > 0.0 and spec.target in ("*", target) \
                    and float(self._rng(point).random()) < spec.prob:
                break
        else:
            return False
        self.events.append(FaultEvent(point, target, n))
        return True

    # ------------------------------------------------------------------
    def fired(self, point: Optional[str] = None) -> int:
        """How many faults actually fired (optionally for one point)."""
        if point is None:
            return len(self.events)
        return sum(1 for e in self.events if e.point == point)


def no_faults() -> FaultInjector:
    """An armed injector with an empty plan: every site runs clean. The
    default wiring, so instrumented code never branches on None."""
    return FaultInjector(FaultPlan())
