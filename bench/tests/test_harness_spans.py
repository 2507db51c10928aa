"""The readers of the program's spans and counters (``repro_torch/obs.py``):
their arithmetic on made-up readings, nothing read where a key is missing
or zero (the program before it had spans, or a run with no card), and a
traced run at a tiny size on the CPU that reads the counters with the
engine's own list of patched functions emptied."""

import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench.harness import measure, spec
from bench.tests.conftest import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load(ROOT)
EXACT, BATCH = "magm-theta1-n2e15.exact", "magm-theta1-n2e15.batch4"

# each per-call reader and the total it reads
PER_CALL = {
    "alpha_stream_ms_per_call": "span.engine.alpha.stream_ms",
    "dedup_stream_ms_per_call": "span.engine.dedup.stream_ms",
    "result_host_ms_per_call": "span.result.edges.self_host_ms",
}
READINGS = {
    "span.engine.alpha.stream_ms": 46_000.0,
    "span.engine.dedup.stream_ms": 2_000.0,
    "span.result.edges.self_host_ms": 3_000.0,
    "candidates": 200 * 49 * 528_283,
    "edges_out": 200 * 516_018,
}
CALLS = 200


def _r(counters, calls=CALLS):
    return SimpleNamespace(calls=calls, counters=counters)


@pytest.mark.parametrize("name", sorted(PER_CALL))
def test_per_call_readers(name):
    reader = spec.reader(name, ROOT)
    assert reader.read(_r(READINGS)) == pytest.approx(READINGS[PER_CALL[name]] / CALLS)
    assert reader.SOURCE == "program_span" and reader.UNIT == "ms"


def test_kept_per_candidate_pct():
    reader = spec.reader("kept_per_candidate_pct", ROOT)
    assert reader.read(_r(READINGS)) == pytest.approx(100 * 516_018 / (49 * 528_283))
    assert reader.SOURCE == "program_counter" and reader.UNIT == "%"


@pytest.mark.parametrize("name", sorted(PER_CALL) + ["kept_per_candidate_pct"])
@pytest.mark.parametrize("missing", ["all", "key", "zero", "none"])
def test_nothing_to_read(name, missing):
    """A parent without spans, a CPU run (no stream times), a zero total."""
    keys = [PER_CALL[name]] if name in PER_CALL else ["candidates", "edges_out"]
    counters = dict(READINGS)
    if missing == "all":
        counters = {}
    elif missing == "key":
        for k in keys:
            counters.pop(k)
    elif missing == "zero":
        counters.update(dict.fromkeys(keys, 0))
    else:
        counters = None
    assert spec.reader(name, ROOT).read(_r(counters)) is None


@pytest.mark.parametrize("name", ["dedup_stream_ms_per_call", "result_host_ms_per_call", "kept_per_candidate_pct"])
def test_batch_twins_read_alike(name):
    base, twin = spec.reader(name, ROOT), spec.reader(name + ".batch", ROOT)
    assert twin.read is base.read and twin.MOVES == "peak_mem_gib" and base.MOVES == "edges_per_s"
    assert (twin.UNIT, twin.SOURCE, twin.LAYER) == (base.UNIT, base.SOURCE, base.LAYER)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name + ".batch")
    assert entry["workloads"] == [BATCH]


@pytest.mark.parametrize("cell", [EXACT, BATCH])
def test_a_traced_run_reads_the_programs_spans_without_the_patch_list(cell, monkeypatch):
    """The engine's patched functions emptied: the counters and the host
    spans come from the program itself.  No stream time on the CPU."""
    engine = spec.plugin("engines", "quilt", ROOT)
    monkeypatch.setattr(engine, "SPANS", ())
    c = spec.cell(BENCH, cell, ROOT)
    c = c._replace(config=tiny(c.config), traffic=dict(c.traffic, warmup_seconds=0))
    line = measure.run(c, 2**31 + 77, 0.3, True, "cpu", time.perf_counter())
    assert line["correct"] is True
    suffix = ".batch" if cell == BATCH else ""
    got = line["metrics"]
    assert 0 < got["kept_per_candidate_pct" + suffix]["value"] < 100
    assert got["result_host_ms_per_call" + suffix]["value"] > 0
    assert "dedup_stream_ms_per_call" + suffix not in got and "alpha_stream_ms_per_call" not in got
