"""Scoped import of the JAX reference package for the port's parity tests.

The reference needs ``jax.experimental.enable_x64``, which jax 0.9 moved
to ``jax.enable_x64``, and calls ``jax.shard_map(..., check_rep=)``, which
jax 0.9 renamed ``check_vma=``.  :func:`reference_package` installs both
aliases only while a test module holds the ``ref`` fixture, imports
``repro``, and on teardown restores ``jax`` and ``jax.experimental`` and
drops every ``repro`` module it imported — so the JAX package's own test files see the same interpreter
state whether or not these tests ran in their worker.  Nothing is installed
at import or collection time.

Also: the checks that the port imports without JAX, and that the card
marker's fixture decides at run time.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import types

import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

_REF_MODULES = {
    "api": "repro.api",
    "session": "repro.api.session",
    "quilt": "repro.core.quilt",
    "dedup": "repro.core.dedup",
    "kpgm": "repro.core.kpgm",
    "magm": "repro.core.magm",
    "partition": "repro.core.partition",
    "qd": "repro.kernels.quadrant_descent",
    "kref": "repro.kernels.ref",
    "ml": "repro.kernels.magm_logprob",
    "bt": "repro.kernels.bernoulli_tile",
    "ops": "repro.kernels.ops",
    "naive": "repro.core.naive",
    "magfit": "repro.fit.magfit",
    "ingest": "repro.fit.ingest",
    "recover": "repro.fit.recover",
    "optimizer": "repro.train.optimizer",
    "pipeline": "repro.data.pipeline",
    "paper": "repro.configs.magm_paper",
    "chaos": "repro.dist.chaos",
    "ckpt": "repro.dist.checkpoint",
    "stream": "repro.api.stream",
    "serve": "repro.launch.serve",
    "hints": "repro.dist.hints",
    "sharding": "repro.dist.sharding",
    "collectives": "repro.dist.collectives",
    "hlo_cost": "repro.analysis.hlo_cost",
    "roofline": "repro.analysis.roofline",
    "transformer": "repro.models.transformer",
    "lm": "repro.models.model",
    "lm_configs": "repro.configs",
}


def _is_ref(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


@contextlib.contextmanager
def reference_package():
    """Yield a namespace of the reference's modules, imported under the
    ``enable_x64`` and ``check_rep`` aliases; undo the aliases and the
    imports on exit."""
    import functools
    import importlib

    import jax
    import jax.experimental

    missing = object()
    saved = jax.experimental.__dict__.get("enable_x64", missing)
    saved_shard_map = jax.shard_map
    before = set(sys.modules)
    jax.experimental.enable_x64 = lambda new_val=True: jax.enable_x64(new_val)

    @functools.wraps(saved_shard_map)
    def shard_map(*args, check_rep=None, **kwargs):
        if check_rep is not None:
            kwargs["check_vma"] = check_rep
        return saved_shard_map(*args, **kwargs)

    jax.shard_map = shard_map
    try:
        yield types.SimpleNamespace(
            **{k: importlib.import_module(v) for k, v in _REF_MODULES.items()}
        )
    finally:
        jax.shard_map = saved_shard_map
        if saved is missing:
            del jax.experimental.enable_x64
        else:
            jax.experimental.enable_x64 = saved
        added = [m for m in set(sys.modules) - before if _is_ref(m)]
        for name in sorted(added, key=len, reverse=True):
            mod = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if parent in sys.modules and getattr(sys.modules[parent], child, None) is mod:
                delattr(sys.modules[parent], child)


@pytest.fixture(scope="module")
def ref():
    """The reference package for one test module (see reference_package)."""
    import jax

    assert jax.config.jax_threefry_partitionable, (
        "parity fixtures assume jax_threefry_partitionable=True"
    )
    with reference_package() as r:
        yield r


@pytest.fixture
def cuda_device():
    """A CUDA device for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_reference_scope_is_undone():
    import jax.experimental

    had_alias = hasattr(jax.experimental, "enable_x64")
    before = {m for m in sys.modules if _is_ref(m)}
    with reference_package() as r:
        assert r.quilt.DISPATCH_COUNTERS["exact_fallbacks"] >= 0
        assert hasattr(jax.experimental, "enable_x64")
    assert hasattr(jax.experimental, "enable_x64") == had_alias
    assert {m for m in sys.modules if _is_ref(m)} == before


_IMPORT_CHECK = """
import sys
import repro_torch, repro_torch.api, repro_torch.interop
import repro_torch.core.quilt, repro_torch.kernels.ops, repro_torch.configs.magm_paper
import repro_torch.core.naive, repro_torch.fit.magfit
import repro_torch.core.balldrop, repro_torch.core.stats, repro_torch.analysis.validate
import repro_torch.dist.chaos, repro_torch.dist.checkpoint, repro_torch.api.stream
import repro_torch.launch.serve
import repro_torch.train.optimizer, repro_torch.data.pipeline
import repro_torch.fit, repro_torch.fit.ingest, repro_torch.fit.recover
import repro_torch.configs, repro_torch.models.model, repro_torch.train.steps, repro_torch.analysis.roofline
import repro_torch.models.ssm
import repro_torch.dist.fault, repro_torch.launch.train
import repro_torch.dist.sharding, repro_torch.dist.collectives, repro_torch.launch.dryrun
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))
assert not bad, bad
print('clean')
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHECK],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
for name in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):
    sys.modules[name] = None  # any import of them raises ImportError
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]
for m in mods:
    importlib.import_module(m)
print(" ".join(mods))
"""


def test_whole_port_imports_with_jax_blocked():
    """Every module of the port imports with ``jax``, ``repro`` and
    ``ml_dtypes`` made unimportable."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    for m in ("repro_torch.core.quilt", "repro_torch.dist.chaos", "repro_torch.dist.checkpoint",
              "repro_torch.api.stream", "repro_torch.launch.serve", "repro_torch.kernels._build",
              "repro_torch.train.optimizer", "repro_torch.data.pipeline", "repro_torch.fit.ingest",
              "repro_torch.fit.recover", "repro_torch.models.model", "repro_torch.configs.base",
              "repro_torch.analysis.roofline", "repro_torch.dist.fault", "repro_torch.launch.train",
              "repro_torch.dist.hints", "repro_torch.dist.sharding", "repro_torch.dist.collectives",
              "repro_torch.launch.mesh", "repro_torch.launch.dryrun", "repro_torch.analysis.op_cost"):
        assert m in mods, m


def test_port_sources_name_no_jax():
    root = os.path.join(SRC, "repro_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]
    files.append(os.path.join(SRC, "..", "chip_smoke.py"))
    for path in files:
        with open(path) as fh:
            for line in fh:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0]
                    assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), (path, line)


def test_threefry_partitionable_flag():
    import jax

    assert jax.config.jax_threefry_partitionable


def test_cuda_fixture_decides_at_run_time(request):
    if torch.cuda.is_available():
        assert request.getfixturevalue("cuda_device").type == "cuda"
    else:
        with pytest.raises(pytest.skip.Exception):
            request.getfixturevalue("cuda_device")
