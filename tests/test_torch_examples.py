"""The port's examples (``examples/torch_*.py``), each run once on the CPU
as a user runs it (``--device cpu``, sizes cut by their own flags): the
quickstart's split session, the distributed sampler on 4 gloo ranks (its
own asserts hold the mesh edges and the streamed chunks to the unsharded
run), LM serving and LM training on a MAGM walk corpus."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from test_torch_reference import SRC

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples")
RUNS = {
    "torch_quickstart": (["--log2-n", "10"], "warm resample"),
    "torch_distributed_sampling": (["--log2-n", "10", "--chunk-edges", "1024"],
                                   "single-device == 4-rank edge set: exact"),
    "torch_serve_lm": ([], "[serve] OK"),
    "torch_train_lm_on_graph": (["--steps", "16", "--batch", "2", "--seq", "32", "--graph-nodes", "512"],
                                "[train] OK"),
}


@pytest.mark.parametrize("name", RUNS)
def test_example_runs_on_the_cpu(name, tmp_path):
    argv, expect = RUNS[name]
    if name == "torch_train_lm_on_graph":
        argv = argv + ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(EXAMPLES, name + ".py"), "--device", "cpu", *argv],
                          env=env, capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert expect in proc.stdout, proc.stdout[-2000:]
