"""Every cell of BENCHMARK.json resolves its configuration, traffic and
metric files by name, and the file keeps the benchmark's format."""

import json
import re
from pathlib import Path

import pytest

from bench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its time: 2 + 14 x 24 runs, 180 s of compiling a cell, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files(cell):
    c = spec.cell(BENCH, cell, ROOT)
    assert c.chips == 1
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert c.traffic["loop"] == "closed" and c.traffic["clients"] == 1
    assert {m.name for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(m.reader.read)
    assert callable(spec.builder(c)) and callable(spec.loop(c).drive)
    assert callable(spec.plugin("reference", c.config["engine"], ROOT).Reference)


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_file_matches_its_entry(metric):
    mod = spec.reader(metric["name"], ROOT)
    assert mod.UNIT == metric["unit"]
    assert mod.SOURCE == metric["source"]
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "layer" in metric:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert mod.LAYER == metric["layer"] and mod.MOVES == metric["moves"]
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    else:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("entry", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config_entry_and_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("bench/configs/") and (ROOT / entry["file"]).is_file()
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"]
    assert "assumed" in config and config["precision"] == "float32"
    for text in (entry["source"], entry["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_are_unique_and_each_config_used():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_each_per_layer_metric_moves_a_metric_its_cell_reports(cell):
    c = spec.cell(BENCH, cell, ROOT)
    reported = {m.name for m in c.end_to_end}
    for m in c.per_layer:
        assert m.entry["moves"] in reported


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such-cell", ROOT)
