"""Step checkpoints in the port (``repro_torch.dist.checkpoint``) against
the reference's ``repro.dist.checkpoint``: the same tree saved by either
package gives byte-equal files (``NNNNN.bin`` leaves and ``meta.json``)
and restores through the other's ``restore``; a crash at
``checkpoint.write``, at ``checkpoint.rename`` or between the two renames
leaves a restorable step in both; mismatched targets raise ValueError;
``prune`` keeps the newest steps.  Equality is exact.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch.dist import chaos
from repro_torch.dist import checkpoint as ckpt


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several worker processes share one host: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class Pair(NamedTuple):
    lo: np.ndarray
    hi: np.ndarray


def _tree(scale: int = 1):
    """Nested dicts (keys out of order), a list, a tuple, a named tuple and
    a None, over float32/int32/uint8/int64/float64 leaves."""
    return {
        "z": np.arange(6, dtype=np.float32).reshape(2, 3) * scale,
        "b": [np.int32(5 * scale), (np.arange(4, dtype=np.uint8) * scale, None)],
        "a": {"y": np.asarray(-3 * scale, dtype=np.int64), "x": Pair(np.ones(2) * scale, np.zeros((1, 2), np.int32))},
    }


def _leaves(tree):
    return [np.asarray(x) for x in ckpt._flatten(tree)[0]]


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_flatten_order_is_jax_tree_order(ref):
    import jax

    t = _tree()
    ours = _leaves(t)
    theirs = [np.asarray(x) for x in jax.tree.leaves(t)]
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_leaf_files_are_byte_equal(ref, tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path / "port"), 4, t)
    ref.ckpt.save(str(tmp_path / "ref"), 4, t)
    got, want = _files(tmp_path / "port" / "step_4"), _files(tmp_path / "ref" / "step_4")
    assert sorted(got) == [f"{i:05d}.bin" for i in range(6)] + ["meta.json"]
    assert got == want


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_saved_tree_restores_in_the_other_package(ref, tmp_path, direction):
    src, dst = (ckpt, ref.ckpt) if direction == "port-to-ref" else (ref.ckpt, ckpt)
    t = _tree(3)
    src.save(str(tmp_path), 9, t)
    assert dst.latest_step(str(tmp_path)) == 9
    back, meta = dst.restore(str(tmp_path), 9, _tree())
    assert meta["step"] == 9
    for a, b in zip(_leaves(back), _leaves(t)):
        assert np.array_equal(a, b)  # the reference's restore may narrow int64 without x64
    if dst is ckpt:
        assert isinstance(back["a"]["x"], Pair) and back["b"][1][1] is None
        assert all(a.dtype == b.dtype for a, b in zip(_leaves(back), _leaves(t)))


def _crash(package, faults, site, directory, step, tree, monkeypatch):
    """One save of ``tree`` killed at ``site``: a chaos site, or
    ``between-renames`` (after ``final -> final.old``, before
    ``tmp -> final``)."""
    if site == "between-renames":
        real = os.rename

        def rename(a, b):
            if str(a).endswith(".tmp"):
                raise OSError("killed between the renames")
            real(a, b)

        monkeypatch.setattr(os, "rename", rename)
        with pytest.raises(OSError):
            package.save(directory, step, tree)
        monkeypatch.setattr(os, "rename", real)
        return
    with faults.active(faults.FaultSchedule([faults.FaultSpec(site, (0,))])):
        with pytest.raises(faults.InjectedFault):
            package.save(directory, step, tree)


@pytest.mark.parametrize("package", ["port", "ref"])
@pytest.mark.parametrize("site", ["checkpoint.write", "checkpoint.rename", "between-renames"])
def test_crash_inside_a_save_leaves_a_restorable_step(ref, tmp_path, monkeypatch, package, site):
    pkg, faults = (ckpt, chaos) if package == "port" else (ref.ckpt, ref.chaos)
    d = str(tmp_path)
    old, new = _tree(1), _tree(2)
    pkg.save(d, 1, old)
    # the crashed save rewrites step 1 itself between the renames, else step 2
    step = 1 if site == "between-renames" else 2
    _crash(pkg, faults, site, d, step, new, monkeypatch)
    assert pkg.latest_step(d) == 1
    back, _ = pkg.restore(d, 1, _tree())
    # between the renames the complete new copy is promoted; otherwise the
    # previous checkpoint is untouched
    want = new if site == "between-renames" else old
    for a, b in zip(_leaves(back), _leaves(want)):
        assert np.array_equal(a, b)
    assert pkg.available_steps(d) == [1]


@pytest.mark.parametrize(
    "target, match",
    [
        ({"a": np.zeros(3, np.float32)}, "shape"),
        ({"a": np.zeros((2, 2), np.float64)}, "dtype"),
        ({"a": np.zeros((2, 2), np.float32), "b": np.zeros(1)}, "leaves"),
    ],
    ids=["shape", "dtype", "count"],
)
def test_restore_rejects_a_mismatched_target(tmp_path, target, match):
    ckpt.save(str(tmp_path), 1, {"a": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match=match):
        ckpt.restore(str(tmp_path), 1, target)


def test_restore_of_a_missing_step_and_shardings(tmp_path):
    with pytest.raises(ValueError, match="no checkpoint at step 3"):
        ckpt.restore(str(tmp_path), 3, {})
    with pytest.raises(NotImplementedError, match="item 7b"):
        ckpt.restore(str(tmp_path), 3, {}, shardings={})
    assert ckpt.available_steps(str(tmp_path / "absent")) == [] and ckpt.latest_step(str(tmp_path)) is None


def test_prune_keeps_the_newest(tmp_path):
    for s in (1, 5, 3, 8):
        ckpt.save(str(tmp_path), s, {"s": np.asarray(s)})
    ckpt.prune(str(tmp_path), keep=2)
    assert ckpt.available_steps(str(tmp_path)) == [5, 8]
    ckpt.prune(str(tmp_path), keep=0)
    assert ckpt.available_steps(str(tmp_path)) == [5, 8]
