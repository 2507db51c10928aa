"""A cell whose engine, reference, loop, traffic and metrics are new files
runs through the harness with no edit to it: each part is found by its
name (``harness/spec.py``).  The files here are written into a scratch
tree beside a copy of ``BENCHMARK.json``'s format, and drive a made-up
engine that needs no program."""

import json
import textwrap
import time

import pytest

from bench.harness import measure, spec

ENGINE = '''
from bench.harness.workload import Work


def build(config, traffic, seed, device):
    return Work(lambda i: [[seed % 97, i]], len, lambda: None)
'''
REFERENCE = '''
class Reference:
    def __init__(self, config, traffic, seed, device, precision="float32"):
        self.seed = seed

    def compare(self, kept):
        bad = sum(out != [[self.seed % 97, i]] for i, out in kept)
        return {"calls_wrong": (bad, 0)}, bad
'''
PACED = '''
import time


def drive(call, seconds, traffic, seed, done):
    """One client issuing call i at its due time, start + i * period_s;
    latency from the due time."""
    period = float(traffic["period_s"])
    lat, start, i = [], time.perf_counter(), 0
    while True:
        due = start + i * period
        time.sleep(max(due - time.perf_counter(), 0.0))
        out = call(i)
        end = time.perf_counter()
        lat.append((end - due) * 1e3)
        done(i, out)
        i += 1
        if end - start >= seconds:
            return lat, end - start
'''
CODED_TRAFFIC = '''
from bench.harness.workload import Work

TRAFFIC = {"loop": "paced", "period_s": 0.01, "warmup_calls": 1, "check_calls": 2}


def build(config, traffic, seed, device):
    """A mix written in code takes the engine's place: here it answers
    every call wrong, which the engine's reference has to see."""
    return Work(lambda i: [[-1, i]], len, lambda: None)
'''
CALLS_PER_S = '''
UNIT = "calls/s"
SOURCE = "host_clock"


def read(r):
    return r.calls / r.window_s
'''
LATE_MS = '''
UNIT = "ms"
SOURCE = "host_clock"
LAYER = "loop"
MOVES = "calls_per_s"


def read(r):
    return max(r.call_ms)
'''


@pytest.fixture
def tree(tmp_path):
    """A scratch checkout holding a new engine, reference, loop, two mixes
    (one of parameters, one of code), a configuration and two metrics."""
    files = {
        "engines/echo.py": ENGINE,
        "reference/echo.py": REFERENCE,
        "loops/paced.py": PACED,
        "traffic/paced.json": json.dumps({"loop": "paced", "period_s": 0.01, "warmup_calls": 1, "check_calls": 2}),
        "traffic/coded.py": CODED_TRAFFIC,
        "configs/echo-small.json": json.dumps({"name": "echo-small", "engine": "echo"}),
        "metrics/calls_per_s.py": CALLS_PER_S,
        "metrics/late_ms.py": LATE_MS,
    }
    for rel, text in files.items():
        path = tmp_path / "bench" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    cells = [{"name": f"echo-small.{t}", "config": "echo-small", "traffic": t, "chips": 1, "why": "test"}
             for t in ("paced", "coded")]
    bench = {
        "configs": [{"name": "echo-small", "file": "bench/configs/echo-small.json"}],
        "workloads": cells,
        "end_to_end": [{"name": "calls_per_s", "unit": "calls/s"}],
        "per_layer": [{"name": "late_ms", "unit": "ms", "moves": "calls_per_s"}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("traffic, correct", [("paced", True), ("coded", False)])
def test_a_cell_of_new_files_runs(tree, traffic, correct, traced):
    cell = spec.cell(spec.load(tree), f"echo-small.{traffic}", tree)
    assert (cell.traffic_code is None) == (traffic == "paced")
    line = measure.run(cell, 12345, 0.15, traced, "cpu", time.perf_counter())
    assert line["correct"] is correct
    assert line["compared"]["calls_wrong"]["limit"] == 0
    assert (line["compared"]["calls_wrong"]["value"] == 0) is correct
    want = "late_ms" if traced else "calls_per_s"
    assert list(line["metrics"]) == [want]
    # the paced loop issues about one call every 10 ms over the 0.15 s
    assert 5 <= line["attempted"] <= 30


def test_a_mix_with_both_files_is_refused(tree):
    (tree / "bench" / "traffic" / "coded.json").write_text("{}")
    with pytest.raises(FileNotFoundError):
        spec.cell(spec.load(tree), "echo-small.coded", tree)


@pytest.mark.parametrize("kind, name", [("engines", "absent"), ("loops", "../engines/echo"), ("metrics", "a b")])
def test_a_missing_or_malformed_name_is_refused(tree, kind, name):
    with pytest.raises((FileNotFoundError, ValueError)):
        spec.plugin(kind, name, tree)
