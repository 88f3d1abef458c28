"""CLI: ``python -m repro_torch.analysis src/repro_torch tests/``.

Exit code 1 when any error-severity finding survives suppression (or any
warning under ``--strict``); 0 on a clean tree; 2 for an unknown rule id
in ``--select``.  ``--json`` emits the machine-readable report (schema:
version/paths/files_checked/counts/findings) for CI artifacts.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.engine import (DEFAULT_EXCLUDED_DIRS, RULES,
                                         lint_paths, render_human,
                                         render_json)
import repro_torch.analysis.rules  # noqa: F401  — registers the rule set

DEFAULT_PATHS = ["src/repro_torch"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis of the PyTorch port: host syncs, rng "
                    "and dtype discipline, kernel-wrapper checks, rebuilds "
                    "and re-run side effects")
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                    help="files or directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--json", action="store_true",
                    help="emit the JSON report instead of human output")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail the run")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--no-default-excludes", action="store_true",
                    help="also lint fixtures/ and cache directories")
    ns = ap.parse_args(argv)

    if ns.list_rules:
        for rid, r in sorted(RULES.items()):
            print(f"{rid} [{r.severity}] — {r.summary}")
        return 0

    select = {s.strip() for s in ns.select.split(",")} if ns.select else None
    if select is not None:
        unknown = select - set(RULES)
        if unknown:
            print(f"unknown rule id(s): {sorted(unknown)}", file=sys.stderr)
            return 2
    excluded = frozenset() if ns.no_default_excludes \
        else DEFAULT_EXCLUDED_DIRS
    report = lint_paths(ns.paths or DEFAULT_PATHS, select=select,
                        excluded_dirs=excluded)
    print(render_json(report) if ns.json else render_human(report))
    failed = report["counts"]["error"] > 0 or (
        ns.strict and report["counts"]["warning"] > 0)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
