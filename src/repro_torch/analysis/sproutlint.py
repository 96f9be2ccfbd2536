"""The port's lint driver (counterpart of ``repro/analysis/sproutlint.py``):
walk ``config.SCAN_DIRS``, run SPL001, SPL003 and SPL004, apply noqa,
allowlist budgets and the committed baseline, and report.

Pure AST: it imports no torch and takes no device, so it runs wherever
the source tree is (``python -m repro_torch.analysis lint``).
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis import config
from repro_torch.analysis.callgraph import CallGraph
from repro_torch.analysis.findings import (BASELINE_DEFAULT, Finding, Key,
                                     apply_baseline, load_baseline,
                                     save_baseline)
from repro_torch.analysis.rules import parse_module, spl001, spl003, spl004

_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<codes>[A-Z0-9, ]+))?", re.I)

Allowlist = Dict[Tuple[str, str, str], int]


def _noqa_codes(line: str) -> Optional[Set[str]]:
    """None = no noqa on this line; empty set = bare ``# noqa`` (all rules);
    else the specific rule codes."""
    m = _NOQA_RE.search(line)
    if m is None:
        return None
    codes = m.group("codes")
    if not codes:
        return set()
    return {c.strip().upper() for c in codes.split(",") if c.strip()}


def _apply_noqa(findings: List[Finding], lines: List[str]) -> List[Finding]:
    kept = []
    for f in findings:
        line = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        codes = _noqa_codes(line)
        if codes is None or (codes and f.rule not in codes):
            kept.append(f)
    return kept


def _apply_allowlist(findings: List[Finding], allowlist: Allowlist,
                     ) -> Tuple[List[Finding], List[Finding]]:
    """Consume per-(path, scope, rule) budgets in line order; findings past
    the budget are kept (and annotated so the overflow is obvious)."""
    budget = dict(allowlist)
    kept: List[Finding] = []
    allowed: List[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        key = (f.path, f.scope, f.rule)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            allowed.append(f)
        elif key in allowlist:
            kept.append(dataclasses.replace(
                f, message=f.message + (
                    f" [exceeds allowlist budget of {allowlist[key]}]")))
        else:
            kept.append(f)
    return kept, allowed


def lint_module(path: str, source: str, hot_scopes: Set[str],
                deterministic: bool = True,
                allowlist: Optional[Allowlist] = None,
                ) -> Tuple[List[Finding], List[Finding]]:
    """Run all rules on one module. Returns ``(kept, allowed)`` after noqa
    and allowlist filtering. ``hot_scopes={"*"}`` marks every scope hot
    (used by fixture tests)."""
    ctx = parse_module(path, source)
    findings = (spl001(ctx, hot_scopes) + spl003(ctx, deterministic)
                + spl004(ctx))
    findings = _apply_noqa(findings, ctx.lines)
    return _apply_allowlist(findings, allowlist or {})


def _repo_files(root: Path) -> List[Path]:
    out: List[Path] = []
    for d in config.SCAN_DIRS:
        base = root / d
        if base.is_dir():
            out.extend(sorted(base.rglob("*.py")))
    return out


def _hot_scopes_by_path(root: Path, files: Iterable[Path],
                        trees: Dict[str, ast.Module]) -> Dict[str, Set[str]]:
    graph = CallGraph()
    for rel, tree in trees.items():
        graph.add_module(rel, tree)
    hot: Dict[str, Set[str]] = {}
    for path, qualname in graph.reachable(config.HOT_PATH_ROOTS):
        hot.setdefault(path, set()).add(qualname)
    return hot


@dataclasses.dataclass
class LintResult:
    new: List[Finding]
    baselined: List[Finding]
    allowed: List[Finding]
    stale: List[Key]
    hot_scopes: Dict[str, Set[str]]

    @property
    def rc(self) -> int:
        return 1 if (self.new or self.stale) else 0

    def render(self, verbose: bool = False) -> str:
        out: List[str] = []
        for f in self.new:
            out.append(f.render())
        for key in self.stale:
            rule, path, scope, snippet = key
            out.append(f"{path}: STALE baseline entry {rule} [{scope}] — "
                       f"finding no longer fires; remove it\n    {snippet}")
        if verbose:
            for f in self.allowed:
                out.append(f"allowed: {f.render()}")
            for f in self.baselined:
                out.append(f"baselined: {f.render()}")
        out.append(f"sproutlint: {len(self.new)} new, "
                   f"{len(self.baselined)} baselined, "
                   f"{len(self.allowed)} allowlisted, "
                   f"{len(self.stale)} stale baseline entries")
        return "\n".join(out)


def run_lint(root: Path, baseline_path: Optional[Path] = None,
             write_baseline: bool = False) -> LintResult:
    baseline_path = baseline_path or root / BASELINE_DEFAULT
    files = _repo_files(root)
    sources: Dict[str, str] = {}
    trees: Dict[str, ast.Module] = {}
    for p in files:
        rel = p.relative_to(root).as_posix()
        text = p.read_text()
        try:
            trees[rel] = ast.parse(text, filename=rel)
        except SyntaxError:
            continue   # not this gate's job; ruff/ast_lint own syntax
        sources[rel] = text
    hot = _hot_scopes_by_path(root, files, trees)

    findings: List[Finding] = []
    allowed: List[Finding] = []
    for rel, text in sources.items():
        deterministic = any(rel.startswith(prefix)
                            for prefix in config.DETERMINISTIC_PATHS)
        module_allow = {(p, s, r): n for (p, s, r), n
                        in config.ALLOWLIST.items() if p == rel}
        kept, ok = lint_module(rel, text, hot.get(rel, set()),
                               deterministic, module_allow)
        findings.extend(kept)
        allowed.extend(ok)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))

    if write_baseline:
        save_baseline(baseline_path, findings)
        return LintResult([], findings, allowed, [], hot)

    new, baselined, stale = apply_baseline(
        findings, load_baseline(baseline_path))
    return LintResult(new, baselined, allowed, stale, hot)
