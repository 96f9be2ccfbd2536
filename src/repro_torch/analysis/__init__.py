"""The port's static checks (counterpart of ``repro/analysis/``).

Layer 1 — ``sproutlint``: AST rules SPL001, SPL003 and SPL004 over
``src/repro_torch``, SPL001 rooted at the port's block loop
(``InferenceEngine.step``); pure AST, no torch.
Layer 2 — ``graph_audit``: drives a small engine per variant, runs every
entry point it built under a ``TorchDispatchMode`` and checks what the
ops do (no float64, no host read, the store written in place, store
writes in bounds, the committed inventory); import it lazily, it builds
engines.

Also home to the entry-point-table guard that measured windows use: a
window must build no entry, or its time silently includes a capture.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

from repro_torch.analysis.findings import (BASELINE_DEFAULT, Finding,
                                           apply_baseline, load_baseline,
                                           save_baseline)
from repro_torch.analysis.sproutlint import LintResult, lint_module, run_lint

__all__ = [
    "BASELINE_DEFAULT", "Finding", "apply_baseline", "load_baseline",
    "save_baseline", "LintResult", "lint_module", "run_lint",
    "entry_point_snapshot", "frozen_entry_points",
]


def entry_point_snapshot(engine) -> Tuple[str, ...]:
    """Sorted, immutable view of the engine's entry-point names."""
    return tuple(sorted(engine.entry_points))


@contextlib.contextmanager
def frozen_entry_points(engine, label: str = "measured window",
                        ) -> Iterator[Tuple[str, ...]]:
    """Assert the entry-point table is identical on exit — i.e. the body
    built (captured) nothing new and retired nothing. Wrap every measured
    window in this."""
    before = entry_point_snapshot(engine)
    yield before
    after = entry_point_snapshot(engine)
    if after != before:
        added = sorted(set(after) - set(before))
        removed = sorted(set(before) - set(after))
        raise AssertionError(
            f"entry-point table changed during {label}: "
            f"added={added} removed={removed} — build every entry "
            "before the measured window starts")
