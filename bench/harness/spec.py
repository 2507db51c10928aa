"""Resolution of a cell of ``BENCHMARK.json`` to its files, by name.

Each part of a cell sits in a file of its own, found by the name that
``BENCHMARK.json`` or the configuration gives it:

- the configuration: the entry's ``file``;
- the traffic mix: ``bench/traffic/<traffic>.json`` (parameters), or
  ``bench/traffic/<traffic>.py`` where the mix needs code: it defines
  ``TRAFFIC`` (the same parameters) and may define ``build``, which then
  takes the engine's place;
- the engine, the system under test: ``bench/engines/<engine>.py``, with
  ``build(config, traffic, seed, device)`` returning a
  ``harness.workload.Work``; ``<engine>`` is the configuration's ``engine``;
- the plain reference: ``bench/reference/<engine>.py``, with
  ``Reference(config, traffic, seed, device, precision)``;
- the loop that offers the load: ``bench/loops/<loop>.py``, with ``drive``;
  ``<loop>`` is the mix's ``loop``;
- each metric's reader: ``bench/metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import List, NamedTuple, Optional

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
_LOADED: dict = {}


class Metric(NamedTuple):
    name: str
    unit: str
    entry: dict  # the metric's entry in BENCHMARK.json
    reader: object  # the module of bench/metrics/<name>.py


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict  # the mix's parameters
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path = ROOT
    traffic_code: Optional[object] = None  # the module of a mix written in code


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def plugin(kind: str, name: str, root: Path = ROOT):
    """The module of ``bench/<kind>/<name>.py``, loaded once per file."""
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is no benchmark name")
    path = (root / "bench" / kind / f"{name}.py").resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {name!r} at {path}")
        safe = re.sub(r"[^A-Za-z0-9_]", "_", f"bench_{kind}_{name}")
        spec = importlib.util.spec_from_file_location(safe, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def reader(name: str, root: Path = ROOT):
    """The module of ``bench/metrics/<name>.py``."""
    return plugin("metrics", name, root)


def builder(cell: Cell):
    """The ``build`` of the cell's mix where it has one, else its engine's."""
    own = getattr(cell.traffic_code, "build", None)
    return own if own is not None else plugin("engines", cell.config["engine"], cell.root).build


def reference(config: dict, traffic: dict, seed: int, device: str, precision: str = "float32", root: Path = ROOT):
    """The plain reference of the configuration's engine."""
    return plugin("reference", config["engine"], root).Reference(config, traffic, seed, device, precision)


def loop(cell: Cell):
    return plugin("loops", cell.traffic.get("loop", "closed"), cell.root)


def _metrics(entries, cell: str, root: Path) -> List[Metric]:
    return [
        Metric(m["name"], m["unit"], m, reader(m["name"], root))
        for m in entries
        if "workloads" not in m or cell in m["workloads"]
    ]


def _traffic(name: str, root: Path):
    """``(parameters, module or None)`` of the mix ``name``."""
    data, code = root / "bench" / "traffic" / f"{name}.json", root / "bench" / "traffic" / f"{name}.py"
    if data.is_file() == code.is_file():
        raise FileNotFoundError(f"traffic {name!r} needs exactly one of {data.name} and {code.name}")
    if data.is_file():
        with open(data) as f:
            return json.load(f), None
    module = plugin("traffic", name, root)
    return dict(module.TRAFFIC), module


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has {len(found)} workloads named {name!r}")
    w = found[0]
    cfgs = [c for c in bench["configs"] if c["name"] == w["config"]]
    if len(cfgs) != 1:
        raise KeyError(f"BENCHMARK.json has {len(cfgs)} configs named {w['config']!r}")
    with open(root / cfgs[0]["file"]) as f:
        config = json.load(f)
    traffic, code = _traffic(w["traffic"], root)
    return Cell(name, int(w["chips"]), config, traffic,
                _metrics(bench["end_to_end"], name, root), _metrics(bench["per_layer"], name, root), root, code)
