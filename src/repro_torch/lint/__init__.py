"""repro_torch.lint — a PyTorch/CUDA correctness linter for the port.

The counterpart of :mod:`repro.lint` for ``src/repro_torch``: a small
AST-based static-analysis framework for the invariants the port's steps
depend on: no host synchronisation and no data-dependent shape inside a
step (a warm sample, a kernel wrapper, a train / prefill / decode step),
disciplined PRNG key use, no kernel rebuilds or reloads per call, no
bit-budget overflow in the packed dedup keys, no deprecated shims inside
``src/``, the ``valid=`` sentinel remap before packing, and locked
shared-state mutation in the serving worker.  The rule catalog, and why
the reference's ``tracer-leak`` has no counterpart, is in
:mod:`repro_torch.lint.rules`.  Standard library only: it imports neither
``torch`` nor ``jax``.

Usage::

    python -m repro_torch.lint src/repro_torch          # exit 1 on findings
    python -m repro_torch.lint --json src/repro_torch   # machine output

Suppression::

    n = int(count)  # lint: disable=host-sync-in-step -- why it is inherent
"""

from repro_torch.lint.engine import (
    Finding,
    LintEngine,
    Rule,
    lint_paths,
    lint_source,
)
from repro_torch.lint.rules import ALL_RULES

__all__ = [
    "ALL_RULES",
    "Finding",
    "LintEngine",
    "Rule",
    "lint_paths",
    "lint_source",
]
