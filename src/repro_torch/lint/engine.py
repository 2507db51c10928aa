"""Rule engine of :mod:`repro_torch.lint`.

Plain-stdlib AST analysis: no third-party linter frameworks, and no
``torch``, so CI's lint job runs it with nothing installed.  The rules
encode repo-specific invariants (step reachability, the packed-key bit
budget, the ``valid=`` sentinel convention) that generic tools cannot.

The engine runs two passes:

1. **Project pass** — every file is parsed once and a
   :class:`ProjectContext` is built (the step call graph of
   :mod:`repro_torch.lint.callgraph`, the deprecated-shim name set, the
   memoizing functions).  Rules that need cross-file facts read them from
   the context.
2. **Rule pass** — each rule visits each file's AST and yields
   :class:`Finding` objects; findings suppressed by a pragma on any line
   the flagged node spans are dropped.

Pragma syntax (checked verbatim by tests)::

    expr  # lint: disable=rule-name            one line, one or more rules
    expr  # lint: disable=rule-a,rule-b        comma-separated
    expr  # lint: disable=rule-name -- why     a trailing justification
    # lint: disable-file=rule-name             whole file

Exit-code contract of ``python -m repro_torch.lint``: 0 clean, 1 findings,
2 usage/parse error.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

__all__ = [
    "Finding",
    "FileInfo",
    "LintEngine",
    "ProjectContext",
    "Rule",
    "lint_paths",
    "lint_source",
]

# the rule list ends at the first word that does not follow a comma, so a
# trailing justification (``-- why``) is not read as part of a rule name
_PRAGMA_RE = re.compile(
    r"#\s*lint:\s*(disable|disable-file)\s*=\s*"
    r"([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Rule:
    """Base class for lint rules.

    Subclasses set ``name`` (the pragma handle, kebab-case) and
    ``description``, and implement :meth:`check` yielding findings.  A rule
    never sees suppressed findings being dropped — suppression is the
    engine's job, so rules stay pure detectors.
    """

    name: str = ""
    description: str = ""

    def check(
        self, info: "FileInfo", project: "ProjectContext"
    ) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(
        self, info: "FileInfo", node: ast.AST, message: str
    ) -> Finding:
        return Finding(
            rule=self.name,
            path=info.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
        )


@dataclasses.dataclass
class FileInfo:
    """One parsed source file plus its pragma map."""

    path: str
    source: str
    tree: ast.Module
    # line -> set of rule names disabled on that line
    line_pragmas: Dict[int, Set[str]]
    # rule names disabled for the whole file
    file_pragmas: Set[str]

    def suppressed(self, finding: Finding, node_lines: Sequence[int]) -> bool:
        if finding.rule in self.file_pragmas or "all" in self.file_pragmas:
            return True
        for ln in node_lines:
            rules = self.line_pragmas.get(ln)
            if rules and (finding.rule in rules or "all" in rules):
                return True
        return False


@dataclasses.dataclass
class ProjectContext:
    """Cross-file facts shared by all rules."""

    files: List[FileInfo]
    # simple function names reachable from a step root (see callgraph)
    step_reachable: Set[str]
    # function simple names that are deprecation shims (call _warn_shim)
    shim_names: Set[str]
    # function simple names whose every definition memoizes its result
    # (see callgraph.cached_names)
    cached_names: Set[str]


def _parse_pragmas(source: str):
    line_pragmas: Dict[int, Set[str]] = {}
    file_pragmas: Set[str] = set()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if not m:
                continue
            rules = {
                r.strip() for r in m.group(2).split(",") if r.strip()
            }
            if m.group(1) == "disable-file":
                file_pragmas |= rules
            else:
                line_pragmas.setdefault(tok.start[0], set()).update(rules)
    except tokenize.TokenError:
        pass  # the ast parse will report the real error
    return line_pragmas, file_pragmas


def parse_file_info(path: str, source: str) -> FileInfo:
    tree = ast.parse(source, filename=path)
    line_pragmas, file_pragmas = _parse_pragmas(source)
    return FileInfo(
        path=path,
        source=source,
        tree=tree,
        line_pragmas=line_pragmas,
        file_pragmas=file_pragmas,
    )


def _node_lines(node: ast.AST) -> Sequence[int]:
    lo = getattr(node, "lineno", None)
    if lo is None:
        return ()
    hi = getattr(node, "end_lineno", None) or lo
    return range(lo, hi + 1)


class LintEngine:
    """Run a rule set over a set of parsed files."""

    def __init__(self, rules: Sequence[Rule]):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.rules = list(rules)

    def build_context(self, files: List[FileInfo]) -> ProjectContext:
        from repro_torch.lint import callgraph

        trees = [f.tree for f in files]
        step_reachable = callgraph.step_reachable_names(trees)
        shim_names: Set[str] = set()
        for f in files:
            for node in ast.walk(f.tree):
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    for sub in ast.walk(node):
                        if (
                            isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Name)
                            and sub.func.id == "_warn_shim"
                        ):
                            shim_names.add(node.name)
                            break
        return ProjectContext(
            files=files,
            step_reachable=step_reachable,
            shim_names=shim_names,
            cached_names=callgraph.cached_names(trees),
        )

    def run(
        self,
        files: List[FileInfo],
        enabled: Optional[Set[str]] = None,
    ) -> List[Finding]:
        project = self.build_context(files)
        findings: List[Finding] = []
        for rule in self.rules:
            if enabled is not None and rule.name not in enabled:
                continue
            for info in files:
                for item in rule.check(info, project):
                    finding, node = (
                        item if isinstance(item, tuple) else (item, None)
                    )
                    # a pragma on ANY line the flagged node spans counts
                    # (so a comment on either line of a wrapped call works)
                    lines = {finding.line}
                    if node is not None:
                        lines.update(_node_lines(node))
                    if not info.suppressed(finding, sorted(lines)):
                        findings.append(finding)
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return findings


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs
                if d not in ("__pycache__", ".git", ".hypothesis")
            )
            for name in sorted(names):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def lint_source(
    source: str,
    path: str = "<string>",
    rules: Optional[Sequence[Rule]] = None,
) -> List[Finding]:
    """Lint one source string (the unit-test entry point)."""
    from repro_torch.lint.rules import ALL_RULES

    engine = LintEngine(list(rules) if rules is not None else ALL_RULES)
    return engine.run([parse_file_info(path, source)])


def lint_paths(
    paths: Sequence[str],
    rules: Optional[Sequence[Rule]] = None,
) -> List[Finding]:
    """Lint files/directories as ONE project (shared call graph)."""
    from repro_torch.lint.rules import ALL_RULES

    engine = LintEngine(list(rules) if rules is not None else ALL_RULES)
    files = []
    for path in iter_python_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            files.append(parse_file_info(path, fh.read()))
    return engine.run(files)


def render_human(findings: List[Finding]) -> str:
    lines = [f.format() for f in findings]
    lines.append(
        f"{len(findings)} finding(s)" if findings else "clean: 0 findings"
    )
    return "\n".join(lines)


def render_json(findings: List[Finding]) -> str:
    return json.dumps(
        {
            "version": 1,
            "findings": [f.to_json() for f in findings],
            "count": len(findings),
        },
        indent=2,
    )
