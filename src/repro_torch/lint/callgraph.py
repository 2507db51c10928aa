"""Lightweight step call graph for :mod:`repro_torch.lint`.

The host-sync and dynamic-shape rules need to know which functions run
inside a *step*: the work a warm session or a training / serving loop
repeats per call, which should enqueue device work and never wait on it.
The reference finds its steps as ``jax.jit`` roots; eager PyTorch has no
such marker, so the port declares its roots in :data:`STEP_ROOTS`.  Full
name resolution is out of scope for a linter; as in the reference, the
graph is built over *simple* function names (the last component of a
dotted call), which is exact enough for this codebase's flat
``module.function`` style:

- **Roots** are the functions of :data:`STEP_ROOTS`, by simple name,
  wherever they are defined (nested closures included).
- **Edges** go from a function to every known function name it calls.

``step_reachable_names`` returns the transitive closure from the roots.
A name shared by a step function and a host one is treated as reachable
(conservative: rules may flag the host twin, which a pragma can silence —
missing a real host sync is the worse failure).

``cached_names`` gives the functions that memoize their result (an
``lru_cache`` / ``cache`` decorator, or a write into module-level state,
the ``_build._LIBS`` idiom), for the rebuild-hazard rule.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set

__all__ = ["STEP_ROOTS", "cached_names", "step_reachable_names"]

# The port's counterparts of what the reference compiles (a step may do
# host work between device launches, but never wait on the device):
STEP_ROOTS = (
    # the reference's jax.jit roots that the port defines by name
    # (repro.lint.callgraph over src/repro): the engines' rounds ...
    "_round_body",
    "_bd_round_body",
    "_split_heavy_body",
    "_many_round",
    "_plan_constants",
    # ... MAGFIT's E/M steps, the naive tile, the KPGM edge batch ...
    "_elbo_logits",
    "estep",
    "mstep",
    "sample_tile",
    "sample_edge_batch",
    # ... and the six kernel wrappers
    "quilt_prng_descent_lookup",
    "quadrant_descent_prng",
    "quadrant_descent",
    "quilt_descent_lookup",
    "magm_logprob",
    "bernoulli_tile",
    # the step closures the reference jits at launch (launch/train.py,
    # launch/serve.py); the port's are train/steps.py's
    "train_step",
    "prefill_step",
    "decode_step",
)


def _dotted_last(node: ast.AST):
    """Simple name of a call target: f() -> f, mod.f() -> f."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _function_defs(trees: Iterable[ast.Module]):
    for tree in trees:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node


def step_reachable_names(trees: List[ast.Module]) -> Set[str]:
    """Simple names of all functions reachable from a step root."""
    defs: Dict[str, List[ast.FunctionDef]] = {}
    for fn in _function_defs(trees):
        defs.setdefault(fn.name, []).append(fn)

    roots = set(STEP_ROOTS) & set(defs)

    # edges: function name -> called known-function names
    calls: Dict[str, Set[str]] = {}
    for name, fn_list in defs.items():
        out: Set[str] = set()
        for fn in fn_list:
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    callee = _dotted_last(node.func)
                    if callee in defs and callee != name:
                        out.add(callee)
        calls[name] = out

    reachable: Set[str] = set()
    stack = sorted(roots)
    while stack:
        name = stack.pop()
        if name in reachable:
            continue
        reachable.add(name)
        stack.extend(sorted(calls.get(name, ()) - reachable))
    return reachable


def _memoizes(fn: ast.FunctionDef, module_names: Set[str]) -> bool:
    """An ``lru_cache`` / ``cache`` decorator, or a memo in module-level
    state that the function both reads and stores into: ``global X; if X
    is None: X = ...`` or ``X.get(k)`` ... ``X[k] = ...`` (``_build.load``'s
    ``_LIBS``)."""
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if _dotted_last(target) in ("lru_cache", "cache"):
            return True
    # a store X[k] = v loads the name X: that load is not a read of the memo
    stored = {
        id(n.value)
        for n in ast.walk(fn)
        if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
    }
    declared: Set[str] = set()
    read: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            declared.update(node.names)
        elif (
            isinstance(node, ast.Name)
            and isinstance(node.ctx, ast.Load)
            and id(node) not in stored
        ):
            read.add(node.id)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id in declared & read:
                return True
            if (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name)
                and t.value.id in (module_names - declared) & read
            ):
                return True
    return False


def cached_names(trees: List[ast.Module]) -> Set[str]:
    """Simple names all of whose definitions memoize (see ``_memoizes``)."""
    verdict: Dict[str, bool] = {}
    for tree in trees:
        module_names: Set[str] = set()
        for stmt in tree.body:
            targets = (
                stmt.targets
                if isinstance(stmt, ast.Assign)
                else [stmt.target]
                if isinstance(stmt, ast.AnnAssign)
                else []
            )
            module_names |= {t.id for t in targets if isinstance(t, ast.Name)}
        for fn in _function_defs([tree]):
            ok = _memoizes(fn, module_names)
            verdict[fn.name] = verdict.get(fn.name, True) and ok
    return {name for name, ok in verdict.items() if ok}
