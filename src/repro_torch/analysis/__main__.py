"""CLI: ``python -m repro_torch.analysis {lint,audit,all}``.

``lint`` runs the AST layer over ``src/repro_torch``; ``audit`` drives an
engine per variant on ``--device`` (default ``cuda``; ``cpu`` here) and
audits every entry it built; ``all`` runs both and fails if either fails.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _cmd_lint(args: argparse.Namespace) -> int:
    from repro_torch.analysis.sproutlint import run_lint
    result = run_lint(Path(args.root), Path(args.baseline) if args.baseline
                      else None, write_baseline=args.write_baseline)
    print(result.render(verbose=args.verbose))
    if args.write_baseline:
        print(f"baseline written ({len(result.baselined)} findings)")
        return 0
    return result.rc


def _cmd_audit(args: argparse.Namespace) -> int:
    from repro_torch.analysis.graph_audit import run_audit
    report = run_audit(device=args.device,
                       write_inventory=args.write_inventory)
    print(report.render(verbose=args.verbose))
    return report.rc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's lint (AST) + graph audit of its entry points")
    parser.add_argument("command", choices=("lint", "audit", "all"))
    parser.add_argument("--root", default=".",
                        help="repo root (default: cwd)")
    parser.add_argument("--baseline", default=None,
                        help="baseline JSON path (default: "
                             "<root>/src/repro_torch/analysis/baseline.json)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="regenerate the baseline from current findings")
    parser.add_argument("--write-inventory", action="store_true",
                        help="regenerate the committed entry-point inventory")
    parser.add_argument("--device", default="cuda",
                        help="where the audit builds its engines "
                             "(default: cuda)")
    parser.add_argument("--verbose", "-v", action="store_true")
    args = parser.parse_args(argv)

    if args.command == "lint":
        return _cmd_lint(args)
    if args.command == "audit":
        return _cmd_audit(args)
    rc = _cmd_lint(args)
    rc_audit = _cmd_audit(args)
    return rc or rc_audit


if __name__ == "__main__":
    sys.exit(main())
