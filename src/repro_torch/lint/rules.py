"""The rule catalog of :mod:`repro_torch.lint`: the reference linter's
rules (``repro.lint``) read for PyTorch code on a CUDA device.

=========================  ==================================================
host-sync-in-step          .item()/.tolist()/.cpu()/.numpy(), int()/float()/
                           bool()/np.* of tensor params, synchronize(),
                           .to("cpu"), host -> device copies in
                           step-reachable functions
dynamic-shape-in-step      nonzero/argwhere/unique/masked_select, one-arg
                           torch.where, repeat_interleave without
                           output_size=, boolean-mask indexing in
                           step-reachable functions
prng-key-discipline        key reuse across prng draws, hard-coded
                           PRNGKey/manual_seed, raw keys bypassing
                           rng_from_key
rebuild-hazard             kernel builds/loads, torch.compile, CUDAGraph()
                           per call (in loops / uncached functions)
packed-bits-overflow       shift-or key packing that can exceed the target
                           dtype width (node_bits+1 sentinel convention)
deprecated-shim            src/ code calling the deprecation shims it ships
missing-valid-mask         -1 sentinel producers feeding
                           segmented_unique_mask without a valid= remap
unlocked-shared-mutation   worker-class shared state mutated outside the
                           lock
=========================  ==================================================

How each reference rule maps: ``host-sync-in-jit`` splits into
``host-sync-in-step`` (what waits on the device) and
``dynamic-shape-in-step`` (what under ``jit`` fails at trace time; on CUDA
each reads a size back and none can be captured in a CUDA graph);
``recompile-hazard`` becomes ``rebuild-hazard``;
``prng-key-discipline``, ``packed-bits-overflow``, ``deprecated-shim``,
``missing-valid-mask`` and ``unlocked-shared-mutation`` port as they are.
``tracer-leak`` has no counterpart: an eager tensor stored on ``self`` or a
global is an ordinary value that outlives no trace.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.lint.engine import FileInfo, ProjectContext, Rule

__all__ = ["ALL_RULES"]

# attribute reads and calls that read a tensor's metadata, never its data
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "size", "numel"}

# prng draws that CONSUME a key (split/fold_in derive, not consume)
_KEY_CONSUMERS = {
    "uniform", "normal", "randint", "bits", "bernoulli", "permutation",
    "choice", "categorical", "gumbel", "exponential", "truncated_normal",
    "gamma", "beta", "poisson", "laplace", "cauchy", "dirichlet",
    "loggamma", "rademacher", "maxwell",
}

# counter-PRNG derivations that consume a key the same way a draw does:
# counter_seed(key) pins the ENTIRE counter stream of that key (every
# (graph, slot, channel) uniform), so feeding the same key to another
# consumer afterwards overlays two streams on one key.  Matched by simple
# name regardless of root — the idiom appears as ops.counter_seed and the
# kernels module itself.
_COUNTER_CONSUMERS = {"counter_seed"}

_INT_WIDTHS = {
    "int64": 63, "uint64": 64, "int32": 31, "uint32": 32,
    "int16": 15, "uint16": 16, "int8": 7, "uint8": 8,
}

# tensor -> host reads: each waits for the device
_HOST_READS = {"item", "tolist", "cpu", "numpy"}

# ops whose output shape depends on the data
_DYNAMIC_SHAPE_OPS = {
    "nonzero", "argwhere", "masked_select", "unique", "unique_consecutive",
}

# elementwise predicates whose result is a boolean mask
_MASK_CALLS = {
    "isnan", "isinf", "isfinite", "isneginf", "isposinf", "logical_and",
    "logical_or", "logical_not", "logical_xor", "eq", "ne", "lt", "le",
    "gt", "ge", "isin",
}


def _last(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    """Leftmost name of a dotted expression: np.random.seed -> np."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _functions(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _own_nodes(fn: ast.FunctionDef):
    """The nodes of ``fn``'s body, not descending into nested functions
    or classes (each nested function is judged as its own name)."""
    stack: List[ast.AST] = list(reversed(fn.body))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            continue
        stack.extend(reversed(list(ast.iter_child_nodes(node))))


# annotations of host values: Python scalars, and numpy arrays (the host
# plans a step's per-graph asks and targets)
_HOST_ANNOTATIONS = {"int", "float", "bool", "str", "bytes", "ndarray"}


def _tensor_params(fn: ast.FunctionDef) -> Set[str]:
    """Params that can hold device tensors in a step.

    Excludes, per this repo's conventions: ``self`` / ``cls``; keyword-only
    params (plan configuration: Python scalars and shapes); params
    annotated with a Python scalar type or ``np.ndarray`` (host values by
    contract).
    """
    a = fn.args
    params: Set[str] = set()
    for p in a.posonlyargs + a.args:
        ann = p.annotation
        if ann is not None and _last(ann) in _HOST_ANNOTATIONS:
            continue
        params.add(p.arg)
    return params - {"self", "cls"}


def _references(node: ast.AST, names: Set[str]) -> bool:
    """Does ``node`` reference any of ``names`` other than through a
    metadata read (.shape/.ndim/.dtype/.device/.size()/.numel())?"""
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return False
    if isinstance(node, ast.Name):
        return node.id in names
    return any(
        _references(c, names) for c in ast.iter_child_nodes(node)
    )


def _has_cache_decorator(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if _last(target) in ("lru_cache", "cache"):
            return True
    return False


def _names_cpu(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Constant)
        and isinstance(n.value, str)
        and n.value.split(":")[0] == "cpu"
        for n in ast.walk(node)
    )


def _is_device_arg(node: ast.AST) -> bool:
    """A positional ``.to()`` argument that names a device: a string, or a
    name like ``dev`` / ``device`` / ``plan.device``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    name = _last(node)
    return name is not None and "dev" in name.lower()


def _host_made(node: ast.AST) -> bool:
    """A tensor built on the host: ``torch.from_numpy`` / ``torch.tensor``
    / ``torch.as_tensor`` without a device."""
    return (
        isinstance(node, ast.Call)
        and _last(node.func) in ("from_numpy", "tensor", "as_tensor")
        and not any(k.arg == "device" for k in node.keywords)
    )


class HostSyncInStep(Rule):
    """R1 — host synchronisation inside step-reachable code.

    A step (a warm sample, a train or decode step) should enqueue device
    work and return; each of these waits for the device instead:
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``; ``int()``,
    ``float()``, ``bool()`` and ``np.*`` of a tensor parameter;
    ``synchronize()``; ``.to("cpu")``; and a host value moved to the
    device, a copy from pageable memory that waits on the host and the
    transfer the reference's transfer guard polices:
    ``torch.tensor(..., device=)`` / ``torch.as_tensor(..., device=)``,
    ``.cuda()``, and ``.to(<device>)`` of a tensor parameter or of a
    tensor built on the host (``torch.from_numpy(a).to(dev)``).  Uses only
    through ``.shape``/``.ndim``/``.dtype``/``.device``/``.size()``/
    ``.numel()`` are metadata; keyword-only parameters and parameters
    annotated as scalars or numpy arrays are host values by convention.
    """

    name = "host-sync-in-step"
    description = ".item()/.cpu()/int()/np.*/synchronize()/H2D copies in steps"

    def check(self, info: FileInfo, project: ProjectContext):
        for fn in _functions(info.tree):
            if fn.name not in project.step_reachable:
                continue
            params = _tensor_params(fn)
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                message = self._sync(node, params)
                if message:
                    yield self.finding(
                        info, node,
                        f"{message} in step-reachable `{fn.name}` waits "
                        "for the device",
                    ), node

    def _sync(self, node: ast.Call, params: Set[str]) -> Optional[str]:
        callee = node.func
        args = list(node.args) + [k.value for k in node.keywords]
        if isinstance(callee, ast.Attribute):
            if callee.attr in _HOST_READS and not (
                callee.attr == "item" and (node.args or node.keywords)
            ):
                return f"`.{callee.attr}()`"
            if callee.attr == "synchronize":
                return "`synchronize()`"
            if callee.attr == "to" and any(_names_cpu(a) for a in args):
                return "`.to(cpu)`"
            if callee.attr == "cuda" or (
                callee.attr == "to"
                and (
                    any(_is_device_arg(a) for a in node.args)
                    or any(
                        k.arg == "device"
                        and not (
                            isinstance(k.value, ast.Constant)
                            and k.value.value is None
                        )
                        for k in node.keywords
                    )
                )
                and (
                    _host_made(callee.value)
                    or _references(callee.value, params)
                )
            ):
                return f"`.{callee.attr}(<device>)` (a host value copied to the device)"
            if _root_name(callee) in ("np", "numpy") and any(
                _references(a, params) for a in args
            ):
                return (
                    f"numpy call `np.{callee.attr}` on a tensor argument"
                )
            if (
                callee.attr in ("tensor", "as_tensor")
                and _root_name(callee) == "torch"
                and any(
                    k.arg == "device"
                    and not (
                        isinstance(k.value, ast.Constant)
                        and k.value.value is None
                    )
                    for k in node.keywords
                )
            ):
                return (
                    f"`torch.{callee.attr}(..., device=)` (a host value "
                    "copied to the device)"
                )
        if (
            isinstance(callee, ast.Name)
            and callee.id in ("int", "float", "bool")
            and node.args
            and _references(node.args[0], params)
        ):
            return f"`{callee.id}()` of a tensor argument"
        return None


class DynamicShapeInStep(Rule):
    """R2 — data-dependent output shapes inside step-reachable code.

    Under ``jit`` the reference cannot trace these at all; on CUDA each
    reads a count back from the device (a sync) and none can be captured
    in a CUDA graph: ``nonzero``, ``argwhere``, ``unique`` /
    ``unique_consecutive``, ``masked_select``, a one-argument
    ``torch.where(cond)``, ``repeat_interleave`` with tensor repeats and
    no ``output_size=``, and boolean-mask indexing ``x[cmp]`` (or ``x[m]``
    where ``m`` was bound to a mask in the same function).
    """

    name = "dynamic-shape-in-step"
    description = "nonzero/unique/mask indexing/repeat_interleave in steps"

    def _is_mask(self, node: ast.AST, masks: Set[str]) -> bool:
        if isinstance(node, ast.Compare):
            return True
        if isinstance(node, ast.Name):
            return node.id in masks
        if isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.Invert, ast.Not)
        ):
            return self._is_mask(node.operand, masks)
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)
        ):
            return self._is_mask(node.left, masks) or self._is_mask(
                node.right, masks
            )
        if isinstance(node, ast.Call):
            return _last(node.func) in _MASK_CALLS
        return False

    def _masks(self, fn: ast.FunctionDef) -> Set[str]:
        """Names bound to a mask expression in ``fn`` (to a fixed point,
        so ``ok = m & (x > 0)`` after ``m = y < 1`` counts)."""
        masks: Set[str] = set()
        while True:
            found = set(masks)
            for node in _own_nodes(fn):
                if isinstance(node, ast.Assign) and self._is_mask(
                    node.value, masks
                ):
                    found |= {
                        t.id for t in node.targets if isinstance(t, ast.Name)
                    }
            if found == masks:
                return masks
            masks = found

    def _call(self, node: ast.Call) -> Optional[str]:
        name = _last(node.func)
        root = _root_name(node.func)
        if root in ("np", "numpy"):
            return None
        if name in _DYNAMIC_SHAPE_OPS:
            return f"`{name}`"
        if (
            name == "where"
            and root == "torch"
            and len(node.args) == 1
            and not node.keywords
        ):
            return "one-argument `torch.where`"
        if name == "repeat_interleave" and not any(
            k.arg == "output_size" for k in node.keywords
        ):
            kw = [k.value for k in node.keywords if k.arg == "repeats"]
            pos = 1 if root == "torch" and len(node.args) > 1 else 0
            repeats = kw[0] if kw else (
                node.args[pos] if len(node.args) > pos else None
            )
            if not (
                isinstance(repeats, ast.Constant)
                and isinstance(repeats.value, int)
            ):
                return "`repeat_interleave` without `output_size=`"
        return None

    def check(self, info: FileInfo, project: ProjectContext):
        for fn in _functions(info.tree):
            if fn.name not in project.step_reachable:
                continue
            masks = self._masks(fn)
            for node in _own_nodes(fn):
                what = None
                if isinstance(node, ast.Call):
                    what = self._call(node)
                elif isinstance(node, ast.Subscript) and isinstance(
                    node.ctx, ast.Load
                ):
                    index = node.slice
                    parts = (
                        index.elts if isinstance(index, ast.Tuple) else [index]
                    )
                    if any(self._is_mask(p, masks) for p in parts):
                        what = "boolean-mask indexing"
                if what:
                    yield self.finding(
                        info, node,
                        f"{what} in step-reachable `{fn.name}`: the output "
                        "shape depends on the data (a count read back from "
                        "the device; not capturable in a CUDA graph)",
                    ), node


class PrngKeyDiscipline(Rule):
    """R3 — PRNG key hygiene on the port's ``core/prng.py``.

    (a) the same key variable consumed by two ``prng`` draws in one
    straight-line block without an interleaving ``split``/``fold_in``
    reuses the stream (identical or correlated variates) —
    ``counter_seed(key)`` counts as a draw here, since it pins the key's
    whole counter-PRNG stream; (b) ``PRNGKey(<constant>)``,
    ``torch.manual_seed(<constant>)`` or ``Generator().manual_seed(
    <constant>)`` inside library code hard-wires determinism callers
    cannot see; (c) keys fed raw into numpy RNG constructors bypass
    ``rng_from_key``'s canonicalization (uint32 words of a key are NOT a
    well-mixed numpy seed).
    """

    name = "prng-key-discipline"
    description = "key reuse / hard-coded seeds / raw keys around rng_from_key"

    def _none_default_exempt(self, fn: ast.FunctionDef) -> Set[int]:
        """ids of PRNGKey calls inside the ``x if x is not None else
        PRNGKey(0)`` / ``if key is None: ...`` default idiom — a
        caller-overridable documented default, not a buried seed."""
        exempt: Set[int] = set()

        def none_test(test: ast.expr) -> bool:
            return (
                isinstance(test, ast.Compare)
                and len(test.ops) == 1
                and isinstance(test.ops[0], (ast.Is, ast.IsNot))
                and isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value is None
            )

        for node in ast.walk(fn):
            if isinstance(node, ast.IfExp) and none_test(node.test):
                scope: List[ast.AST] = [node.body, node.orelse]
            elif isinstance(node, ast.If) and none_test(node.test):
                scope = list(node.body)
            else:
                continue
            for sub_root in scope:
                for sub in ast.walk(sub_root):
                    if (
                        isinstance(sub, ast.Call)
                        and _last(sub.func) == "PRNGKey"
                    ):
                        exempt.add(id(sub))
        return exempt

    def check(self, info: FileInfo, project: ProjectContext):
        for fn in _functions(info.tree):
            yield from self._check_reuse(info, fn.body)
            if fn.name == "rng_from_key":
                continue  # the canonical router is allowed raw access
            exempt = self._none_default_exempt(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                seeded = _last(node.func) in (
                    "PRNGKey", "manual_seed", "manual_seed_all"
                )
                if (
                    seeded
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and id(node) not in exempt
                ):
                    yield self.finding(
                        info, node,
                        f"hard-coded `{_last(node.func)}("
                        f"{node.args[0].value!r})` in library code: thread "
                        "a caller key (or pragma if the fixed default is "
                        "the documented contract)",
                    ), node
                if _root_name(node.func) in ("np", "numpy") and _last(
                    node.func
                ) in ("default_rng", "RandomState", "seed", "Generator"):
                    arg_names = {
                        n.id
                        for a in list(node.args)
                        + [k.value for k in node.keywords]
                        for n in ast.walk(a)
                        if isinstance(n, ast.Name)
                    }
                    if any("key" in n.lower() for n in arg_names):
                        yield self.finding(
                            info, node,
                            "raw key material fed to numpy RNG: route "
                            "through quilt.rng_from_key (canonical uint32 "
                            "entropy extraction)",
                        ), node

    def _assigned_names(self, stmt: ast.stmt) -> Set[str]:
        out: Set[str] = set()
        targets: List[ast.expr] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    out.add(n.id)
        return out

    def _check_reuse(self, info: FileInfo, body: List[ast.stmt]):
        consumed: Dict[str, ast.AST] = {}
        for stmt in body:
            # nested blocks restart the analysis (loop bodies re-derive
            # keys per iteration; branches are alternatives, not sequences)
            draws: List[Tuple[str, ast.Call]] = []
            for node in ast.walk(stmt):
                if not (
                    isinstance(node, ast.Call)
                    and node.args
                    and isinstance(node.args[0], ast.Name)
                ):
                    continue
                name = _last(node.func)
                is_draw = (
                    name in _KEY_CONSUMERS
                    and _root_name(node.func) == "prng"
                )
                if is_draw or name in _COUNTER_CONSUMERS:
                    draws.append((node.args[0].id, node))
            draws.sort(key=lambda kn: (kn[1].lineno, kn[1].col_offset))
            for key_name, node in draws:
                prev = consumed.get(key_name)
                if prev is not None:
                    yield self.finding(
                        info, node,
                        f"key `{key_name}` already consumed by a draw at "
                        f"line {prev.lineno}: split/fold_in before drawing "
                        "again (identical streams otherwise)",
                    ), node
                consumed[key_name] = node
            for name in self._assigned_names(stmt):
                consumed.pop(name, None)
            for sub_body in (
                getattr(stmt, "body", None),
                getattr(stmt, "orelse", None),
                getattr(stmt, "finalbody", None),
            ):
                if sub_body:
                    yield from self._check_reuse(info, sub_body)


class RebuildHazard(Rule):
    """R4 — kernel builds, library loads and compiled wrappers per call.

    ``_build.build`` / ``build_all`` / ``load``, ``ctypes.CDLL``,
    ``torch.compile`` and ``torch.cuda.CUDAGraph()`` evaluated inside a
    loop, or in a plain (uncached) function, redo per call what should
    happen once: re-hashing or recompiling the CUDA sources, reloading a
    library, recompiling or re-capturing a graph.  The blessed patterns:
    a call to a function that memoizes (``_build.load``'s ``_LIBS`` dict,
    a kernel module's ``global _LIB`` library), or construction inside an
    ``functools.lru_cache`` / ``functools.cache`` function.
    """

    name = "rebuild-hazard"
    description = "kernel build/load, torch.compile, CUDAGraph per call"

    def _builder(self, node: ast.Call) -> Optional[str]:
        callee = node.func
        name = _last(callee)
        root = _root_name(callee)
        if (
            name in ("build", "build_all", "load")
            and isinstance(callee, ast.Attribute)
            and root == "_build"
        ):
            return f"_build.{name}"
        if name == "CDLL":
            return "ctypes.CDLL"
        if name == "compile" and root == "torch":
            return "torch.compile"
        if name == "CUDAGraph":
            return "torch.cuda.CUDAGraph"
        return None

    def check(self, info: FileInfo, project: ProjectContext):
        for fn in _functions(info.tree):
            if _has_cache_decorator(fn) or fn.name in project.cached_names:
                continue
            in_loop: Set[int] = set()
            for node in _own_nodes(fn):
                if isinstance(node, (ast.For, ast.While)):
                    in_loop.update(id(n) for n in ast.walk(node))
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                what = self._builder(node)
                if what is None or _last(node.func) in project.cached_names:
                    continue
                where = (
                    "inside a loop in" if id(node) in in_loop else "in uncached"
                )
                yield self.finding(
                    info, node,
                    f"`{what}` {where} `{fn.name}`: redone on every call — "
                    "hoist it, memoize it, or call a memoizing loader",
                ), node


class PackedBitsOverflow(Rule):
    """R5 — shift/or key packing past the target dtype width.

    The segmented dedup packs (graph, src, dst, arrival) into one int64
    sort key; ``core/dedup._packed_bits`` budgets
    ``glog + 2*(node_bits[+1]) + abits <= 63`` (the +1 is the ``valid=``
    sentinel bit).  This rule checks every ``(a << s1) | (b << s2) | ...``
    chain with two or more shifted terms: constant shifts are summed
    against the inferred target width (``astype``/cast in the chain, else
    the 63-bit signed int64 default); symbolic shifts must appear in a
    function that consults ``_packed_bits`` (or its ``fits`` flag) — the
    repo's guard convention.
    """

    name = "packed-bits-overflow"
    description = "bit packing can exceed target dtype (node_bits+1 budget)"

    def _flatten_or(self, node: ast.BinOp) -> List[ast.expr]:
        terms: List[ast.expr] = []
        stack: List[ast.expr] = [node]
        while stack:
            cur = stack.pop()
            if isinstance(cur, ast.BinOp) and isinstance(cur.op, ast.BitOr):
                stack.extend([cur.left, cur.right])
            else:
                terms.append(cur)
        return terms

    def _shift_terms(self, terms: List[ast.expr]):
        return [
            t for t in terms
            if isinstance(t, ast.BinOp) and isinstance(t.op, ast.LShift)
        ]

    def _chain_width(self, chain: ast.AST) -> int:
        """Target width inferred from casts inside the chain; 63 (signed
        int64, the packing convention) when unannotated."""
        for node in ast.walk(chain):
            name = None
            if isinstance(node, ast.Call):
                if _last(node.func) == "astype" and node.args:
                    name = _last(node.args[0])
                elif _last(node.func) in _INT_WIDTHS:
                    name = _last(node.func)
            if name in _INT_WIDTHS:
                return _INT_WIDTHS[name]
        return 63

    def _payload_bound(self, node: ast.expr) -> Optional[int]:
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return max(node.value.bit_length(), 1)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitAnd):
            for side in (node.left, node.right):
                if isinstance(side, ast.Constant) and isinstance(
                    side.value, int
                ):
                    return max(side.value.bit_length(), 1)
        return None

    def check(self, info: FileInfo, project: ProjectContext):
        for fn in _functions(info.tree):
            guarded = any(
                isinstance(n, ast.Name) and n.id in ("_packed_bits", "fits")
                for n in ast.walk(fn)
            )
            seen: Set[int] = set()
            for node in ast.walk(fn):
                if not (
                    isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.BitOr)
                ) or id(node) in seen:
                    continue
                terms = self._flatten_or(node)
                for t in terms:
                    for sub in ast.walk(t):
                        seen.add(id(sub))
                shifts = self._shift_terms(terms)
                if len(shifts) < 2:
                    continue
                amounts = [s.right for s in shifts]
                if all(
                    isinstance(a, ast.Constant) and isinstance(a.value, int)
                    for a in amounts
                ):
                    width = self._chain_width(node)
                    top = max(
                        shifts, key=lambda s: s.right.value  # type: ignore
                    )
                    payload = self._payload_bound(top.left) or 1
                    if top.right.value + payload > width:  # type: ignore
                        yield self.finding(
                            info, node,
                            f"packed key needs >= {top.right.value + payload}"
                            f" bits but the target dtype holds {width}: "
                            "widen the dtype or re-budget the fields "
                            "(_packed_bits convention: node ids cost "
                            "node_bits+1 with a valid= sentinel)",
                        ), node
                elif not guarded:
                    yield self.finding(
                        info, node,
                        "symbolic shift packing without a _packed_bits "
                        "guard: bound the field widths (node_bits+1 per "
                        "sentinel-remapped id) before packing",
                    ), node


class DeprecatedShim(Rule):
    """R6 — src/ calling its own deprecation shims.

    Functions that call ``_warn_shim`` are the deprecated free-function
    surface kept for external callers; internal code invoking them takes
    the DeprecationWarning AND the per-call plan-cache digest cost the
    session API exists to avoid.
    """

    name = "deprecated-shim"
    description = "internal call to a _warn_shim-wrapped deprecated function"

    def check(self, info: FileInfo, project: ProjectContext):
        if not project.shim_names:
            return
        for fn in _functions(info.tree):
            if fn.name in project.shim_names:
                continue  # shims may delegate among themselves
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Call)
                    and _last(node.func) in project.shim_names
                ):
                    yield self.finding(
                        info, node,
                        f"call to deprecated shim `{_last(node.func)}` "
                        "inside src/: use the session API "
                        "(repro_torch.api.MAGMSampler / KPGMSampler)",
                    ), node


class MissingValidMask(Rule):
    """R7 — sentinel producers feeding the dedup without ``valid=``.

    ``segmented_unique_mask`` packs src/dst into the sort key; -1
    sentinel rows (lookup misses) MUST be remapped through the ``valid=``
    mask (which re-budgets node_bits+1 and excludes them from ranking) —
    packed raw, -1 aliases a real edge key and both the dedup and the
    per-graph counts corrupt silently.
    """

    name = "missing-valid-mask"
    description = "-1 sentinels reach segmented_unique_mask without valid="

    def _produces_sentinel(self, fn: ast.FunctionDef, names: Set[str]):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets = {
                    t.id for t in node.targets if isinstance(t, ast.Name)
                }
                if not (targets & names):
                    continue
                for sub in ast.walk(node.value):
                    if (
                        isinstance(sub, ast.Constant)
                        and sub.value == -1
                    ) or (
                        isinstance(sub, ast.UnaryOp)
                        and isinstance(sub.op, ast.USub)
                        and isinstance(sub.operand, ast.Constant)
                        and sub.operand.value == 1
                    ):
                        return True
        return False

    def check(self, info: FileInfo, project: ProjectContext):
        for fn in _functions(info.tree):
            for node in ast.walk(fn):
                if not (
                    isinstance(node, ast.Call)
                    and _last(node.func) == "segmented_unique_mask"
                ):
                    continue
                if any(k.arg == "valid" for k in node.keywords):
                    continue
                pair_names = {
                    a.id
                    for a in node.args[1:3]
                    if isinstance(a, ast.Name)
                }
                if pair_names and self._produces_sentinel(fn, pair_names):
                    yield self.finding(
                        info, node,
                        "src/dst carry -1 sentinels but "
                        "segmented_unique_mask is called without valid=: "
                        "misses will alias real packed keys",
                    ), node


class UnlockedSharedMutation(Rule):
    """R8 — worker-class shared state mutated outside the lock.

    In a class that owns both a ``threading.Lock`` and a worker
    ``threading.Thread`` (the GraphServer shape), every ``self.*``
    mutation outside ``__init__`` races the worker unless it holds the
    lock — including the close() flag and the stats counters.
    """

    name = "unlocked-shared-mutation"
    description = "self.* mutated outside `with self._lock` in worker classes"

    def _lock_names(self, cls: ast.ClassDef) -> Tuple[Set[str], bool]:
        locks: Set[str] = set()
        has_thread = False
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                callee = _last(node.value.func)
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        if callee in ("Lock", "RLock"):
                            locks.add(t.attr)
                        if callee == "Thread":
                            has_thread = True
        return locks, has_thread

    def _is_lock_with(self, node: ast.With, locks: Set[str]) -> bool:
        for item in node.items:
            ctx = item.context_expr
            if (
                isinstance(ctx, ast.Attribute)
                and isinstance(ctx.value, ast.Name)
                and ctx.value.id == "self"
                and ctx.attr in locks
            ):
                return True
        return False

    def _walk_method(
        self, info, method: str, body, locks: Set[str], locked: bool
    ):
        for stmt in body:
            if isinstance(stmt, ast.With):
                inner = locked or self._is_lock_with(stmt, locks)
                yield from self._walk_method(
                    info, method, stmt.body, locks, inner
                )
                continue
            if not locked and isinstance(stmt, (ast.Assign, ast.AugAssign)):
                targets = (
                    stmt.targets
                    if isinstance(stmt, ast.Assign)
                    else [stmt.target]
                )
                for t in targets:
                    base = t
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    if (
                        isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id == "self"
                        and base.attr not in locks
                    ):
                        yield self.finding(
                            info, stmt,
                            f"`self.{base.attr}` mutated in `{method}` "
                            "without holding the lock: races the worker "
                            "thread (wrap in `with self._lock:`)",
                        ), stmt
            for sub_body in (
                getattr(stmt, "body", None),
                getattr(stmt, "orelse", None),
                getattr(stmt, "finalbody", None),
            ):
                if sub_body:
                    yield from self._walk_method(
                        info, method, sub_body, locks, locked
                    )
            for handler in getattr(stmt, "handlers", ()):
                yield from self._walk_method(
                    info, method, handler.body, locks, locked
                )

    def check(self, info: FileInfo, project: ProjectContext):
        for cls in ast.walk(info.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks, has_thread = self._lock_names(cls)
            if not locks or not has_thread:
                continue
            for fn in cls.body:
                if not isinstance(
                    fn, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if fn.name in ("__init__", "__del__"):
                    continue
                yield from self._walk_method(
                    info, fn.name, fn.body, locks, locked=False
                )


ALL_RULES = [
    HostSyncInStep(),
    DynamicShapeInStep(),
    PrngKeyDiscipline(),
    RebuildHazard(),
    PackedBitsOverflow(),
    DeprecatedShim(),
    MissingValidMask(),
    UnlockedSharedMutation(),
]
