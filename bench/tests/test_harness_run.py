"""A run of the harness at a tiny size on the CPU (the look for a card
skipped): the result line's schema, ``correct`` false under each fault
the cells can have, the refusal without a card, the modules a run loads,
and the frozen roofline count against the program's."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from bench.harness import measure, roofline, spec
from bench.tests.conftest import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny_cell(name):
    c = spec.cell(BENCH, name, ROOT)
    return c._replace(config=tiny(c.config), traffic=dict(c.traffic, warmup_seconds=0))


def run_tiny(name, traced=False, seconds=0.3):
    return measure.run(tiny_cell(name), 2**31 + 99, seconds, traced, "cpu", time.perf_counter())


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_schema(cell, traced):
    line = run_tiny(cell, traced)
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = spec.cell(BENCH, cell, ROOT).per_layer if traced else spec.cell(BENCH, cell, ROOT).end_to_end
    names = {m.name for m in want}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"]) and line["device"]["window_s"] > 0
        bd = line["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"} and len(bd["idle_gaps"]) <= 10
        if "rounds_per_call" in names:
            assert line["metrics"]["rounds_per_call"]["value"] == 1.0
    else:
        assert names - {"peak_mem_gib"} <= set(line["metrics"])
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line)


def _stale(fn):
    """A call that returns its first answer again: its state never moves."""
    first = []

    def wrapped(*a, **k):
        out = fn(*a, **k)
        if not first:
            first.append(out)
        return first[0]

    return wrapped


def _half(fn):
    """Half of the batch (half of a single graph's edges) left out."""

    def wrapped(*a, **k):
        out = fn(*a, **k)
        if isinstance(out, list):
            return out[: len(out) // 2]
        return out._replace(edges=out.edges[: out.edges.shape[0] // 2])

    return wrapped


def _altered(fn):
    """One answer altered where it is produced: an edge's target moved."""

    def wrapped(*a, **k):
        out = fn(*a, **k)
        g = out[-1] if isinstance(out, list) else out
        e = g.edges.copy()
        e[-1, 1] = (e[-1, 1] + 1) % g.n
        g = g._replace(edges=e)
        return out[:-1] + [g] if isinstance(out, list) else g

    return wrapped


@pytest.mark.parametrize("fault", [_stale, _half, _altered], ids=["state-unchanged", "half-batch", "answer-altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    from repro_torch.api import session

    c = tiny_cell(cell)
    cls = session.MAGMSampler if c.config["model"] == "magm" else session.KPGMSampler
    method = "sample_batch" if c.traffic["call"] == "sample_batch" else "sample"
    monkeypatch.setattr(cls, method, fault(getattr(cls, method)))
    line = measure.run(c, 2**31 + 5, 0.4, False, "cpu", time.perf_counter())
    assert line["correct"] is False and line["failed"] >= 1
    assert line["compared"]["rows_differing"]["value"] > line["compared"]["rows_differing"]["limit"]


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


LOADS = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(body):
    code = LOADS.format(root=str(ROOT), src=str(ROOT / "src"), body=body)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    body = (
        "from bench.harness import measure, spec\n"
        "import bench.control, bench.reference.sampler\n"
        "from bench.tests.conftest import tiny\n"
        f"c = spec.cell(spec.load(), {CELLS[0]!r})\n"
        "measure.run(c._replace(config=tiny(c.config)), 3, 0.2, True, 'cpu', time.perf_counter())\n"
        "assert not measure.loaded_forbidden()\n"
    )
    mods = _top_level_modules(body)
    assert "repro_torch" in mods  # the program ran
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    body = (
        "from bench.harness import spec\n"
        "from bench.tests.conftest import THETA_1\n"
        "cfg = dict(engine='quilt', model='magm', theta=THETA_1, mu=0.5, d=6, num_nodes=64, attribute_seed=0,"
        " oversample=1.05)\n"
        "ref = spec.reference(cfg, {'call': 'sample'}, 1, 'cpu')\n"
        "ref.compare([(0, ref.outputs(0))])\n"
    )
    mods = _top_level_modules(body)
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_loaded_forbidden_compares_whole_top_level_names():
    assert measure.loaded_forbidden(["repro_torch", "repro_torch.core.quilt", "jaxtyping", "numpy"]) == []
    assert measure.loaded_forbidden(["repro_torch", "repro.core"]) == ["repro"]
    assert measure.loaded_forbidden(["jaxlib.xla_client", "flax", "jax"]) == ["flax", "jax", "jaxlib"]


# (rows, d, B, L) of one call's launch: the exact round (49 graphs x
# 528,283), the KPGM d = 19 round (18,874,368 rows over the 2^19 table),
# the fused batch (196 graphs x 589,824); and smaller shapes beside them
SHAPES = [(49 * 528_283, 15, 7, 20_704), (18_874_368, 19, 1, 1 << 19), (196 * 589_824, 15, 7, 20_704),
          (1_000, 8, 3, 64), (25, 4, 2, 8)]


def test_the_cells_work_shapes():
    for cell in CELLS:
        c = spec.cell(BENCH, cell, ROOT)
        w = spec.reference(c.config, c.traffic, 1, "cpu").work()
        assert (w["rows"], w["d"], w["table_rows"], w["table_width"]) in SHAPES[:3]


@pytest.mark.parametrize("rows, d, B, L", SHAPES)
def test_frozen_count_equals_the_programs(rows, d, B, L):
    import torch
    from types import SimpleNamespace

    from repro_torch.analysis import roofline as program

    plan = SimpleNamespace(table_cfg=torch.empty((B, L), dtype=torch.int32, device="meta"), d=d, num_graphs=B * B)
    want_ms, _ = program.kernel_bound_ms(plan, rows)
    assert roofline.lookup_bound_ms(rows, d, B, L, B * B) == pytest.approx(want_ms, rel=1e-12)
    assert roofline.HBM_BYTES_PER_S == program.HBM_BYTES_PER_S
    assert roofline.INT32_OPS_PER_S == program.INT32_OPS_PER_S


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, cuda_device):
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    assert all(np.isfinite(m["value"]) for m in line["metrics"].values())
