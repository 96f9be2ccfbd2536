"""Finding record + baseline file IO for the port's lint (a copy of
``repro/analysis/findings.py``; the port imports nothing of the reference).

A finding is identified by ``(rule, path, scope, snippet)`` — the stripped
source line rather than a line number, so a baseline entry survives
unrelated edits above it but dies with the line it describes. Baselines
are committed JSON (the port's own ``src/repro_torch/analysis/baseline.json``,
beside the reference's ``ANALYSIS_baseline.json``): findings
present in the baseline do not fail the lint, and — mirroring the tier-1
xpassed-xfail rule — a baseline entry whose finding no longer fires FAILS
the lint as *stale* until it is removed (the defect was fixed; the
suppression must not outlive it). ``--write-baseline`` regenerates the
file from the current findings.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Tuple

BASELINE_DEFAULT = "src/repro_torch/analysis/baseline.json"

Key = Tuple[str, str, str, str]


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str        # "SPL001".."SPL004"
    path: str        # repo-relative posix path
    scope: str       # "Class.method", "func", or "<module>"
    line: int        # 1-indexed; informational only (not part of the key)
    snippet: str     # stripped source line
    message: str

    @property
    def key(self) -> Key:
        return (self.rule, self.path, self.scope, self.snippet)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} [{self.scope}] "
                f"{self.message}\n    {self.snippet}")


def save_baseline(path: Path, findings: List[Finding]) -> None:
    entries = [{"rule": f.rule, "path": f.path, "scope": f.scope,
                "snippet": f.snippet} for f in findings]
    entries.sort(key=lambda e: (e["path"], e["rule"], e["scope"], e["snippet"]))
    path.write_text(json.dumps({"findings": entries}, indent=2) + "\n")


def load_baseline(path: Path) -> List[Key]:
    """Baseline keys as a list (a multiset: the same line firing twice needs
    two entries)."""
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    return [(e["rule"], e["path"], e["scope"], e["snippet"])
            for e in data.get("findings", [])]


def apply_baseline(findings: List[Finding], baseline: List[Key],
                   ) -> Tuple[List[Finding], List[Finding], List[Key]]:
    """Split ``findings`` against ``baseline``.

    Returns ``(new, baselined, stale)``: findings not covered by the
    baseline, findings the baseline absorbs, and baseline keys that no
    longer match any finding (stale entries — these FAIL the lint)."""
    budget: Dict[Key, int] = {}
    for k in baseline:
        budget[k] = budget.get(k, 0) + 1
    new: List[Finding] = []
    baselined: List[Finding] = []
    for f in findings:
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
            baselined.append(f)
        else:
            new.append(f)
    stale: List[Key] = []
    for k, n in budget.items():
        stale.extend([k] * n)
    return new, baselined, stale
