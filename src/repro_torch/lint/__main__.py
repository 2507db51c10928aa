"""CLI entry point: ``python -m repro_torch.lint [--json] [--rules a,b] paths...``

Exit codes: 0 clean, 1 findings, 2 usage/parse error.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.lint.engine import (
    LintEngine,
    iter_python_files,
    parse_file_info,
    render_human,
    render_json,
)
from repro_torch.lint.rules import ALL_RULES


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="PyTorch/CUDA correctness linter for the repro_torch codebase",
    )
    parser.add_argument(
        "paths", nargs="*", help="files or directories to lint"
    )
    parser.add_argument(
        "--json", action="store_true", help="emit machine-readable JSON"
    )
    parser.add_argument(
        "--rules",
        default=None,
        help="comma-separated rule names to run (default: all)",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalog and exit",
    )
    try:
        args = parser.parse_args(argv)
    except SystemExit as exc:
        # argparse exits 2 on usage errors already; --help exits 0
        return int(exc.code or 0)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name:26s} {rule.description}")
        return 0
    if not args.paths:
        print("error: no paths given (see --help)", file=sys.stderr)
        return 2

    enabled = None
    if args.rules is not None:
        enabled = {r.strip() for r in args.rules.split(",") if r.strip()}
        known = {r.name for r in ALL_RULES}
        unknown = enabled - known
        if unknown:
            print(
                f"error: unknown rule(s): {', '.join(sorted(unknown))}",
                file=sys.stderr,
            )
            return 2

    engine = LintEngine(ALL_RULES)
    files = []
    any_path = False
    for path in iter_python_files(args.paths):
        any_path = True
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
            files.append(parse_file_info(path, source))
        except (OSError, SyntaxError, ValueError) as exc:
            print(f"error: {path}: {exc}", file=sys.stderr)
            return 2
    if not any_path:
        print("error: no python files found", file=sys.stderr)
        return 2

    findings = engine.run(files, enabled=enabled)
    print(render_json(findings) if args.json else render_human(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
