"""repro_torch.lint: per-rule true-positive/true-negative fixtures,
calibrated on the port's own code, and the engine contracts (pragmas,
exit codes, JSON schema, call-graph reachability); then, under the ``ref``
fixture, the port held against the reference linter (``repro.lint``): the
rules that port as they are and the engine's pragma handling give the same
``(rule, line, col)``, and ``STEP_ROOTS`` is the reference's jit roots that
the port defines, plus the three steps the reference jits at launch.

Pure AST: this file imports no torch (the linter does not either).
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch.lint import ALL_RULES, lint_paths, lint_source
from repro_torch.lint import rules as port_rules
from repro_torch.lint.__main__ import main as lint_main
from repro_torch.lint.callgraph import STEP_ROOTS, cached_names, step_reachable_names
from repro_torch.lint.engine import iter_python_files, parse_file_info, render_human, render_json

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")


def _rules(src):
    return [f.rule for f in lint_source(textwrap.dedent(src))]


def _count(src, rule):
    return _rules(src).count(rule)


def _port_file(*parts):
    with open(os.path.join(PORT, *parts), encoding="utf-8") as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# host-sync-in-step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("body, what", [
    ("return logits.item()", ".item()"),
    ("return logits.tolist()", ".tolist()"),
    ("return logits.cpu()", ".cpu()"),
    ("return logits.detach().numpy()", ".numpy()"),
    ("return int(cache_len) + 1", "int()"),
    ("return float(logits.sum())", "float()"),
    ("return bool(logits.any())", "bool()"),
    ("return np.asarray(logits)", "np.asarray"),
    ("torch.cuda.synchronize()\n        return logits", "synchronize()"),
    ("return logits.to('cpu')", ".to(cpu)"),
    ("return logits.to(device='cpu')", ".to(cpu)"),
    ("return logits + torch.tensor(2.0, dtype=torch.float32, device=logits.device)", "torch.tensor"),
    ("return torch.as_tensor([1, 2], device=dev)", "torch.as_tensor"),
    ("return torch.from_numpy(np.cumsum(asks)).to(dev)", "from_numpy"),
    ("return cache_len.to(dev)", "param to device"),
    ("return logits.cuda()", ".cuda()"),
])
def test_host_sync_positive(body, what):
    src = f"""
    import numpy as np
    import torch

    def decode_step(logits, cache_len, dev, asks: np.ndarray):
        {body}
    """
    assert _count(src, "host-sync-in-step") == 1, what


def test_host_sync_positive_transitive_callee():
    # the root is train_step; the sync sits in a helper reached by name,
    # the shape of train/steps.py's grad_fn -> loss_fn closures
    src = """
    def make_train_step(model):
        def train_step(params, opt_state, batch):
            return grad_fn(params, batch)
        return train_step

    def make_grad_fn(model):
        def grad_fn(params, batch):
            return loss_fn(params, batch)
        return grad_fn

    def loss_fn(params, batch):
        return batch["tokens"].sum().item()
    """
    assert "host-sync-in-step" in _rules(src)


def test_host_sync_negative_unreached():
    # the session reads its round back outside the steps (quilt_run)
    src = """
    def quilt_run(key, plan):
        counts = plan.counts.cpu().numpy()
        return int(counts.sum())
    """
    assert "host-sync-in-step" not in _rules(src)


def test_host_sync_negative_metadata_and_host_params():
    # shapes, devices, keyword-only plan constants, scalar and numpy
    # annotations, fills on the device and dtype casts wait for nothing
    src = """
    import numpy as np
    import torch

    def _round_body(rkey, gids, targets, plan, *, a_tot, budget):
        gc = int(gids.numel())
        b = int(gids.shape[0]) + int(gids.size(0)) + gids.ndim
        dev = gids.device
        g = torch.full((), float(budget), dtype=torch.float32, device=dev)
        local = torch.arange(gc * a_tot, device=dev).to(torch.int64)
        return local, g, b, float(a_tot)

    def _many_round(key, cum, asks: np.ndarray, n: int):
        return np.cumsum(asks), int(n), cum.to(torch.float32)
    """
    assert "host-sync-in-step" not in _rules(src)


def test_host_sync_on_port_code():
    """Calibration on the port: quilt.py's round and acceptance helpers
    reach no sync but the pragma'd salt read, and the (non-step) engine
    driver reads its counts back."""
    src = _port_file("core", "quilt.py")
    assert [f for f in lint_source(src, path="quilt.py") if f.rule == "host-sync-in-step"] == []
    reach = step_reachable_names([ast.parse(src)])
    assert "_round_body" in reach and "quilt_run" not in reach and ".cpu()" in src
    info = parse_file_info("quilt.py", src)
    salt = [ln for ln, rules in info.line_pragmas.items() if "host-sync-in-step" in rules]
    assert salt, "accept_salt's read of the host key carries its pragma"


# ---------------------------------------------------------------------------
# dynamic-shape-in-step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("body", [
    "return torch.nonzero(keep)",
    "return keep.nonzero()",
    "return torch.argwhere(keep)",
    "return torch.unique(x)",
    "return x.unique_consecutive()",
    "return torch.masked_select(x, keep)",
    "return torch.where(keep)",
    "return torch.repeat_interleave(torch.arange(4), asks)",
    "return x[x > 0]",
    "return x[:, keep & (x < 1)]",
    "m = x >= 0\n        return x[m]",
    "m = x >= 0\n        ok = m & keep\n        return x[~ok]",
    "return x[torch.isfinite(x)]",
])
def test_dynamic_shape_positive(body):
    src = f"""
    import torch

    def _bd_round_body(x, keep, asks):
        {body}
    """
    assert _count(src, "dynamic-shape-in-step") == 1, body


def test_dynamic_shape_negative():
    # the fixed-shape idioms the rounds use: masks kept as masks, a
    # three-argument where, int repeats with output_size (flash's GQA),
    # integer gathers, and host numpy
    src = """
    import numpy as np
    import torch

    def _round_body(x, keep, idx, rep: int, h: int, host: np.ndarray):
        valid = (x >= 0) & keep
        y = torch.where(valid, x, -1)
        k = x.repeat_interleave(rep, dim=2, output_size=h)
        k2 = x.repeat_interleave(2, dim=0)
        z = x[idx] + x[:, 0]
        u = np.unique(host)
        return valid, y, k, k2, z, u
    """
    assert "dynamic-shape-in-step" not in _rules(src)


def test_dynamic_shape_negative_unreached():
    # QuiltRun's edge split reads its kept rows back on the host
    src = """
    import torch

    def edges_per_sample(keep):
        return torch.nonzero(keep).reshape(-1).cpu().numpy()
    """
    assert "dynamic-shape-in-step" not in _rules(src)


# ---------------------------------------------------------------------------
# prng-key-discipline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src", [
    """
    def f(key, shape):
        a = prng.uniform(key, shape)
        b = prng.normal(key, shape)
        return a + b
    """,
    """
    def f(shape):
        key = prng.PRNGKey(42)
        return prng.uniform(key, shape)
    """,
    """
    import torch

    def f():
        torch.manual_seed(0)
    """,
    """
    import torch

    def f():
        return torch.Generator().manual_seed(1234)
    """,
    """
    import numpy as np

    def f(key):
        return np.random.default_rng(int(key[0]))
    """,
    """
    def f(key, shape):
        seed = ops.counter_seed(key)
        u = prng.uniform(key, shape)
        return seed, u
    """,
])
def test_prng_positive(src):
    assert "prng-key-discipline" in _rules(src)


def test_prng_negative():
    # the port's idioms: split / fold_in before the next draw, the
    # caller-overridable default (init_model's meta-device key among
    # them), rng_from_key's canonical fold, seeds threaded from callers
    src = """
    import numpy as np
    import torch

    def f(key, shape):
        k1, k2 = prng.split(key)
        a = prng.uniform(k1, shape)
        b = prng.normal(k2, shape)
        key = prng.fold_in(key, 1)
        c = prng.uniform(key, shape)
        return a + b + c

    def init_model(key, cfg, *, device=None):
        if device == "meta":
            key = prng.PRNGKey(0) if key is None else key
        return prng.split(key, 8)

    def g(shape, key=None):
        if key is None:
            key = prng.PRNGKey(0)
        return prng.uniform(key, shape)

    def rng_from_key(key):
        words = prng.fold_in(key, 0x5EED).reshape(-1).tolist()
        return np.random.default_rng([int(x) & 0xFFFFFFFF for x in words])

    def h(seed):
        torch.manual_seed(seed)
        return np.random.default_rng(seed)
    """
    assert "prng-key-discipline" not in _rules(src)


# ---------------------------------------------------------------------------
# rebuild-hazard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src", [
    """
    def launch_all(names):
        return [_build.load(name) for name in names]
    """,
    """
    def run(xs):
        out = []
        for x in xs:
            out.append(_build.build("bernoulli_tile"))
        return out
    """,
    """
    import ctypes

    def library(path):
        return ctypes.CDLL(path)
    """,
    """
    import torch

    def step(fn, x):
        return torch.compile(fn)(x)
    """,
    """
    import torch

    def capture(fn, xs):
        for x in xs:
            g = torch.cuda.CUDAGraph()
        return g
    """,
])
def test_rebuild_positive(src):
    assert "rebuild-hazard" in _rules(src)


def test_rebuild_negative():
    # a memoizing loader (the _LIBS dict; a module's global _LIB), an
    # lru_cache factory, and compile() of another module
    src = """
    import ctypes
    import functools
    import re
    import torch

    _LIBS = {}
    _LIB = None

    def load(name):
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(name)
            _LIBS[name] = lib
        return lib

    def _library():
        global _LIB
        if _LIB is None:
            _LIB = _build.load("bernoulli_tile")
        return _LIB

    def _uniforms_library(name):
        return _build.load(name)

    @functools.lru_cache(maxsize=8)
    def compiled(fn):
        return torch.compile(fn)

    def pattern():
        return re.compile("x")
    """
    assert "rebuild-hazard" not in _rules(src)


def test_rebuild_on_port_code(tmp_path):
    """quadrant_descent.py's ``_uniforms_library`` calls ``_build.load`` on
    every launch: clean beside ``_build.py`` (whose ``load`` memoizes in
    ``_LIBS``), flagged without it."""
    qd = os.path.join(PORT, "kernels", "quadrant_descent.py")
    build = os.path.join(PORT, "kernels", "_build.py")
    alone = [f for f in lint_paths([qd]) if f.rule == "rebuild-hazard"]
    assert [f.line for f in alone] and all("_build.load" in f.message for f in alone)
    assert [f for f in lint_paths([qd, build]) if f.rule == "rebuild-hazard"] == []


def test_cached_names_on_port_code():
    trees = [ast.parse(_port_file("kernels", name)) for name in ("_build.py", "quadrant_descent.py")]
    cached = cached_names(trees)
    assert {"load", "_library", "_descent_library"} <= cached
    assert not {"build", "build_all", "_uniforms_library"} & cached


# ---------------------------------------------------------------------------
# the four rules that port as they are: fixtures of the reference's tests
# ---------------------------------------------------------------------------

_AS_IS = {
    "packed-bits-overflow": (
        """
        def pack(g, s, d):
            return ((g & 0xFF) << 60) | (s << 30) | d

        def pack_sym(g, s, d, node_bits, abits):
            return (g << (2 * node_bits + abits)) | (s << abits) | d
        """,
        """
        def pack(g, s, d):
            return ((g & 0x3) << 50) | (s << 25) | d

        def pack_guarded(g, s, d, node_bits, abits, num_graphs, n):
            glog, abits, fits = _packed_bits(node_bits, num_graphs, n)
            return (g << (2 * node_bits + abits)) | (s << abits) | d

        def index(kb, scfg, d):
            return (kb << d) | scfg

        def wide(g, s, d):
            return (g.astype(np.uint64) << 60) | (s << 30) | d
        """,
    ),
    "deprecated-shim": (
        """
        def _warn_shim(name, alt):
            pass

        def old_api(x):
            _warn_shim("old_api", "Sampler")
            return x + 1

        def internal(x):
            return old_api(x)
        """,
        """
        def _warn_shim(name, alt):
            pass

        def old_api(x):
            _warn_shim("old_api", "Sampler")
            return x + 1

        def old_api_fast(x):
            _warn_shim("old_api_fast", "Sampler")
            return old_api(x)
        """,
    ),
    "missing-valid-mask": (
        """
        import torch

        def f(gid, src, dst, cum, targets, ok):
            src = torch.where(ok, src, -1)
            dst = torch.where(ok, dst, -1)
            return segmented_unique_mask(
                gid, src, dst, cum, targets, node_bits=8
            )
        """,
        """
        import torch

        def f(gid, src, dst, cum, targets, ok):
            src = torch.where(ok, src, -1)
            dst = torch.where(ok, dst, -1)
            valid = (src >= 0) & (dst >= 0)
            return segmented_unique_mask(
                gid, src, dst, cum, targets, node_bits=8, valid=valid
            )

        def g(gid, src, dst, cum, targets):
            return segmented_unique_mask(gid, src, dst, cum, targets, node_bits=8)
        """,
    ),
    "unlocked-shared-mutation": (
        """
        import threading

        class Server:
            def __init__(self):
                self._lock = threading.Lock()
                self._closed = False
                self._worker = threading.Thread(target=self._drain)

            def close(self):
                self._closed = True
        """,
        """
        import threading

        class Server:
            def __init__(self):
                self._lock = threading.Lock()
                self._closed = False
                self.stats = {"served": 0}
                self._worker = threading.Thread(target=self._drain)

            def close(self):
                with self._lock:
                    if self._closed:
                        return
                    self._closed = True

            def _bump(self, by):
                with self._lock:
                    self.stats["served"] += by

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def set(self, n):
                self.n = n
        """,
    ),
}


@pytest.mark.parametrize("rule", sorted(_AS_IS))
def test_as_is_rules_positive_and_negative(rule):
    positive, negative = _AS_IS[rule]
    assert rule in _rules(positive)
    assert rule not in _rules(negative)


@pytest.mark.parametrize("parts, rule", [
    (("core", "dedup.py"), "packed-bits-overflow"),
    (("core", "dedup.py"), "missing-valid-mask"),
    (("core", "quilt.py"), "deprecated-shim"),
    (("launch", "serve.py"), "unlocked-shared-mutation"),
])
def test_as_is_rules_on_their_port_targets(parts, rule):
    """Each rule's target in the port lints clean: ``dedup._packed_bits``
    and ``segmented_unique_mask``, ``quilt._warn_shim``'s shims, the
    ``GraphServer``; the calibration is not vacuous: each source holds what
    its rule looks at."""
    src = _port_file(*parts)
    anchor = {"packed-bits-overflow": "_packed_bits", "missing-valid-mask": "segmented_unique_mask",
              "deprecated-shim": "_warn_shim", "unlocked-shared-mutation": "threading.Thread"}[rule]
    assert anchor in src
    assert rule not in [f.rule for f in lint_source(src, path=parts[-1])]


# ---------------------------------------------------------------------------
# engine: pragmas, suppression spans
# ---------------------------------------------------------------------------

_POSITIVE = """
import torch


def decode_step(x):
    return int(x) + 1
"""


def test_pragma_line_suppression():
    src = _POSITIVE.replace("return int(x) + 1", "return int(x) + 1  # lint: disable=host-sync-in-step")
    assert "host-sync-in-step" not in _rules(src)


def test_pragma_trailing_justification():
    src = _POSITIVE.replace(
        "return int(x) + 1",
        "return int(x) + 1  # lint: disable=host-sync-in-step -- the loop's host int, as the reference's",
    )
    assert "host-sync-in-step" not in _rules(src)


def test_pragma_file_suppression():
    assert "host-sync-in-step" not in _rules("# lint: disable-file=host-sync-in-step\n" + _POSITIVE)


def test_pragma_other_rule_does_not_suppress():
    src = _POSITIVE.replace("return int(x) + 1", "return int(x) + 1  # lint: disable=rebuild-hazard")
    assert "host-sync-in-step" in _rules(src)


def test_pragma_multi_rule_and_all():
    src = _POSITIVE.replace(
        "return int(x) + 1", "return int(x) + 1  # lint: disable=rebuild-hazard,host-sync-in-step"
    )
    assert "host-sync-in-step" not in _rules(src)
    src_all = _POSITIVE.replace("return int(x) + 1", "return int(x) + 1  # lint: disable=all")
    assert _rules(src_all) == []


def test_pragma_on_any_spanned_line():
    src = """
    import numpy as np

    def decode_step(x):
        return np.asarray(
            x
        )  # lint: disable=host-sync-in-step
    """
    assert "host-sync-in-step" not in _rules(src)


def test_parse_file_info_tracks_pragmas():
    info = parse_file_info(
        "p.py",
        "# lint: disable-file=rebuild-hazard\nx = 1  # lint: disable=a, b -- why\n",
    )
    assert info.file_pragmas == {"rebuild-hazard"}
    assert info.line_pragmas[2] == {"a", "b"}


# ---------------------------------------------------------------------------
# callgraph
# ---------------------------------------------------------------------------


def test_callgraph_roots_and_closure():
    src = textwrap.dedent(
        """
        def make_decode_step(model):
            def decode_step(params, batch):
                return helper(batch)
            return decode_step

        def helper(x):
            return inner(x)

        def inner(x):
            return x * 2

        def untouched(x):
            return x
        """
    )
    reach = step_reachable_names([ast.parse(src)])
    assert {"decode_step", "helper", "inner"} <= reach
    assert not {"untouched", "make_decode_step"} & reach


def test_step_roots_reach_the_port():
    """Every root is defined in the port, and the closure holds the paths
    the card's runtime check walks (the session's round, the kernel
    wrappers, the LM steps) but not the sessions' own drivers."""
    trees = [ast.parse(open(p, encoding="utf-8").read()) for p in iter_python_files([PORT])]
    defined = {n.name for t in trees for n in ast.walk(t) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    assert set(STEP_ROOTS) <= defined
    reach = step_reachable_names(trees)
    assert {"_round_body", "accept_salt", "segmented_unique_mask", "quilt_prng_descent_lookup",
            "forward", "decode", "update"} <= reach
    assert not {"quilt_run", "balldrop_run", "sample_stream", "serve_lm"} & reach


# ---------------------------------------------------------------------------
# CLI: exit codes, JSON, rule selection
# ---------------------------------------------------------------------------


@pytest.fixture()
def dirty_file(tmp_path):
    p = tmp_path / "dirty.py"
    p.write_text(_POSITIVE)
    return str(p)


@pytest.fixture()
def clean_file(tmp_path):
    p = tmp_path / "clean.py"
    p.write_text("import torch\n\n\ndef f(x):\n    return x\n")
    return str(p)


def test_cli_exit_codes(dirty_file, clean_file, tmp_path, capsys):
    assert lint_main([clean_file]) == 0
    assert lint_main([dirty_file]) == 1
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    assert lint_main([str(bad)]) == 2
    assert lint_main([]) == 2
    assert lint_main(["--rules", "no-such-rule", clean_file]) == 2
    assert lint_main([str(tmp_path / "empty_dir_missing")]) == 2
    capsys.readouterr()


def test_cli_json_schema(dirty_file, capsys):
    assert lint_main(["--json", dirty_file]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["version"] == 1
    assert out["count"] == len(out["findings"]) == 1
    f = out["findings"][0]
    assert f["rule"] == "host-sync-in-step"
    assert f["path"] == dirty_file
    assert f["line"] == 6 and f["col"] >= 1
    assert "int()" in f["message"]


def test_cli_rule_selection(dirty_file, capsys):
    assert lint_main(["--rules", "rebuild-hazard", dirty_file]) == 0
    assert lint_main(["--rules", "host-sync-in-step", dirty_file]) == 1
    assert lint_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rule in ALL_RULES:
        assert rule.name in listed


def test_render_human_format():
    text = render_human(lint_source(_POSITIVE, path="x.py"))
    assert "x.py:6:12: host-sync-in-step:" in text
    assert "1 finding(s)" in text
    assert render_human([]) == "clean: 0 findings"
    assert json.loads(render_json([])) == {"version": 1, "findings": [], "count": 0}


def test_rule_catalog_unique_and_described():
    names = [r.name for r in ALL_RULES]
    assert len(names) == len(set(names)) == 8
    assert all(r.description for r in ALL_RULES)
    for name in names:
        assert name in port_rules.__doc__


def test_src_tree_is_clean():
    """The shipped port must lint clean: CI's lint job."""
    assert lint_main([PORT]) == 0


_IMPORT_CHECK = """
import sys
import repro_torch.lint, repro_torch.lint.__main__
from repro_torch.lint import lint_paths
assert lint_paths([sys.argv[1]]) == []
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro', 'numpy'))
assert not bad, bad
print('clean')
"""


def test_lint_imports_stdlib_only():
    """``import repro_torch.lint`` (and a whole run over the port) loads
    neither torch nor jax nor the reference: CI's lint job installs none."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK, PORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
    cli = subprocess.run([sys.executable, "-m", "repro_torch.lint", "--json", PORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert cli.returncode == 0, cli.stdout + cli.stderr
    assert json.loads(cli.stdout)["count"] == 0


# ---------------------------------------------------------------------------
# the port against the reference linter
# ---------------------------------------------------------------------------

_PARITY_RULES = ("packed-bits-overflow", "deprecated-shim", "missing-valid-mask", "unlocked-shared-mutation")

# each fixture with and without pragmas (no trailing justification: the
# reference reads one as part of the rule name, see below)
_PARITY_SOURCES = [textwrap.dedent(src) for pair in _AS_IS.values() for src in pair] + [
    textwrap.dedent(_AS_IS["packed-bits-overflow"][0]).replace(
        "(s << 30) | d", "(s << 30) | d  # lint: disable=packed-bits-overflow"),
    "# lint: disable-file=deprecated-shim\n" + textwrap.dedent(_AS_IS["deprecated-shim"][0]),
    textwrap.dedent(_AS_IS["missing-valid-mask"][0]).replace(
        "gid, src, dst, cum, targets, node_bits=8\n",
        "gid, src, dst, cum, targets, node_bits=8  # lint: disable=all\n"),
    textwrap.dedent(_AS_IS["unlocked-shared-mutation"][0]).replace(
        "self._closed = True", "self._closed = True  # lint: disable=missing-valid-mask, unlocked-shared-mutation"),
]


def _triples(findings):
    return [(f.rule, f.line, f.col) for f in findings if f.rule in _PARITY_RULES]


@pytest.mark.parametrize("i", range(len(_PARITY_SOURCES)))
def test_as_is_rules_match_the_reference(ref, i):
    import repro.lint as ref_lint

    src = _PARITY_SOURCES[i]
    want = _triples(ref_lint.lint_source(src))
    assert _triples(lint_source(src)) == want


@pytest.mark.parametrize("parts", [("core", "dedup.py"), ("core", "quilt.py"), ("launch", "serve.py")])
def test_as_is_rules_match_the_reference_on_the_trees(ref, parts):
    """The reference's module and the port's, each through both linters."""
    import repro.lint as ref_lint

    for tree in ("repro", "repro_torch"):
        with open(os.path.join(SRC, tree, *parts), encoding="utf-8") as fh:
            src = fh.read()
        assert _triples(lint_source(src)) == _triples(ref_lint.lint_source(src))


def test_pragma_parsing_matches_the_reference(ref):
    from repro.lint import engine as ref_engine

    for src in _PARITY_SOURCES + ["x = 1  # lint: disable=a, b\n", "# lint: disable-file=x,y\n"]:
        a, b = parse_file_info("p.py", src), ref_engine.parse_file_info("p.py", src)
        assert (a.line_pragmas, a.file_pragmas) == (b.line_pragmas, b.file_pragmas)
    # the one intended difference: the reference's documented trailing
    # justification becomes part of its rule name, which then matches none
    why = "x = 1  # lint: disable=packed-bits-overflow -- why\n"
    assert parse_file_info("p.py", why).line_pragmas == {1: {"packed-bits-overflow"}}
    assert ref_engine.parse_file_info("p.py", why).line_pragmas == {1: {"packed-bits-overflow -- why"}}


# the reference's jit roots with no function of that name in the port
ABSENT_ROOTS = {
    "_fold_key_data": "the reference jits rng_from_key's fold-in to keep its constant on the device; "
                      "the port's rng_from_key folds the key where it lives",
    "_segmented_unique_jit": "the jitted core of the reference's dedup.segmented_unique; the port's "
                             "segmented_unique runs eagerly",
    "boot_theta": "a closure the reference jits inside bootstrap_theta_se; the port computes the "
                  "bootstrap statistic inline",
    "sample_edges_sharded": "core/distributed.py's sharded sampler: meshes wait for more than one card "
                            "(ROADMAP item 7b)",
}
LAUNCH_STEPS = {"train_step", "prefill_step", "decode_step"}  # jitted by launch/train.py and launch/serve.py


def test_step_roots_match_the_reference_jit_roots(ref):
    from repro.lint import callgraph as ref_callgraph

    def defs(tree_dir):
        trees = [ast.parse(open(p, encoding="utf-8").read()) for p in iter_python_files([tree_dir])]
        return trees, {n.name for t in trees for n in ast.walk(t)
                       if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    ref_trees, ref_defs = defs(os.path.join(SRC, "repro"))
    _, port_defs = defs(PORT)
    roots = set()
    for tree in ref_trees:
        roots |= ref_callgraph._scope_jit_roots(tree) & ref_defs
    roots |= {fn.name for fn in ref_callgraph._function_defs(ref_trees) if ref_callgraph._decorator_roots(fn)}
    assert len(roots) == 20
    assert roots - port_defs == set(ABSENT_ROOTS)
    assert set(STEP_ROOTS) == (roots & port_defs) | LAUNCH_STEPS
    assert len(STEP_ROOTS) == len(set(STEP_ROOTS)) == 19
