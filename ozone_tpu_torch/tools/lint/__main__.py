"""CLI: ``python -m ozone_tpu_torch.tools.lint [paths...] [--check]``.

Exit status 0 = zero unsuppressed findings, 1 = findings, 2 = usage or
analysis error. Import-light (no torch, nothing of `ozone_tpu`): the
tier-1 gate runs it as a subprocess.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ozone_tpu_torch.tools.lint import (
    LintError,
    RULES,
    format_findings,
    lint_paths,
    rewrite_legacy_suppressions,
)


def _default_target() -> list[str]:
    here = Path.cwd() / "ozone_tpu_torch"
    if here.is_dir():
        return [str(here)]
    pkg = Path(__file__).resolve().parents[2]  # .../ozone_tpu_torch
    return [str(pkg)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ozone_tpu_torch.tools.lint",
        description="ozlint: AST-based invariant analyzer")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: ozone_tpu_torch/)")
    ap.add_argument("--check", action="store_true",
                    help="CI mode: identical analysis, exit status is "
                         "the only contract (still prints findings)")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print rule ids with their invariants")
    ap.add_argument("--fix-suppressions", action="store_true",
                    help="rewrite legacy `# resilience-lint: allow` "
                         "markers to `# ozlint: allow[...] -- reason` "
                         "in place")
    args = ap.parse_args(argv)

    # force rule registration for --list-rules
    from ozone_tpu_torch.tools.lint import rules as _rules  # noqa: F401

    if args.list_rules:
        for rid, rule in sorted(RULES.items()):
            print(f"{rid}: {rule.summary}")
        return 0

    paths = args.paths or _default_target()
    if args.fix_suppressions:
        for p in rewrite_legacy_suppressions(paths):
            print(f"rewrote legacy suppression markers in {p}")
        return 0

    rule_ids = [r.strip() for r in args.rules.split(",") if r.strip()] \
        or None
    try:
        findings = lint_paths(paths, rules=rule_ids, root=str(Path.cwd()))
    except LintError as e:
        print(f"ozlint: error: {e}", file=sys.stderr)
        return 2
    print(format_findings(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
