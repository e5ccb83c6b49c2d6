"""CLI for the port's trusscheck pass: ``python -m repro_torch.analysis
[paths...]`` (default ``src/repro_torch``).

Exit status: 0 when no active (non-allowlisted) error findings, 1 when
there are, 2 on usage errors.  ``--json`` writes the machine report
(``-`` for stdout); human output always goes to stdout.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

from repro_torch.analysis import build_rules, check_paths, fixes
from repro_torch.analysis import framework as fw


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="trusscheck",
        description=("repo-native static analysis of the PyTorch/CUDA "
                     "port: codified bug classes of the truss stack"))
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files or directories to check "
                             "(default: src/repro_torch)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--json", dest="json_path", default=None,
                        metavar="FILE",
                        help="write the JSON report to FILE ('-' = stdout)")
    parser.add_argument("--fix", action="store_true",
                        help="apply mechanical fixes for TRK102/TRK103, "
                             "then re-check")
    parser.add_argument("--show-allowlisted", action="store_true",
                        help="also print allowlisted findings")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in build_rules():
            print(f"{rule.rule_id}  [{rule.severity:7s}]  {rule.summary}")
        return 0

    only = args.rules.split(",") if args.rules else None
    try:
        report = check_paths(args.paths, only=only)
    except ValueError as exc:
        print(f"trusscheck: {exc}", file=sys.stderr)
        return 2

    if args.fix:
        fixed = 0
        for path in sorted({f.path for f in report.active}):
            fixed += fixes.apply_fixes(path, report.active)
        if fixed:
            print(f"trusscheck: applied {fixed} mechanical fix(es); "
                  f"re-checking")
            report = check_paths(args.paths, only=only)

    shown = report.findings if args.show_allowlisted else report.active
    for finding in shown:
        print(finding.render())

    if args.json_path == "-":
        print(report.as_json())
    elif args.json_path:
        fw.Path(args.json_path).write_text(report.as_json() + "\n",
                                           encoding="utf-8")

    n_allow = sum(1 for f in report.findings if f.allowlisted)
    verdict = "clean" if not report.errors else "FAILED"
    print(f"trusscheck: {report.files_checked} files, "
          f"{len(report.errors)} error(s), {n_allow} allowlisted — "
          f"{verdict}")
    return 1 if report.errors else 0


if __name__ == "__main__":
    sys.exit(main())
