"""CLI: ``python -m stellar_tpu_torch.analysis [paths...]`` / ``stellar-tpu-torch-analyze``.

Exit codes: 0 clean, 1 unsuppressed violations, 2 parse errors (a module
the analyzer could not read must never let the tree report clean — the
parse error wins even when every parsed file passed).
"""

from __future__ import annotations

import argparse
import os
import sys

from .core import analyze_paths
from .report import render_human, render_json, render_rules


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="stellar-tpu-torch-analyze",
        description="project-contract static analyzer for stellar_tpu_torch",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help="files/directories to audit (default: the installed"
        " stellar_tpu_torch package)",
    )
    ap.add_argument("--json", action="store_true", help="machine-readable report")
    ap.add_argument(
        "--rules", action="store_true", help="list active rules and exit"
    )
    ap.add_argument(
        "--suppressions",
        action="store_true",
        help="also print the suppression inventory (human mode)",
    )
    args = ap.parse_args(argv)

    if args.rules:
        print(render_rules())
        return 0

    paths = args.paths
    if not paths:
        paths = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    report = analyze_paths(paths)
    print(render_json(report) if args.json else render_human(report, args.suppressions))
    return report.exit_code()


if __name__ == "__main__":
    sys.exit(main())
