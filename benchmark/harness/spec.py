"""Finding a cell's pieces by name.

``BENCHMARK.json`` names the cell; the cell names a configuration and a
traffic mix; the configuration names its entry.  Each piece is a file of
its own under ``benchmark/``, found by that name, so a new cell, mix,
configuration or per-layer metric is new files plus an entry in
``BENCHMARK.json``:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  deployment's sizes, precision and ``entry``;
* ``traffic/<traffic>.json``: the mix's parameters, read by the entry's
  generator;
* ``entries/<entry>.py``: the job driver of one kind of entry point;
* ``limits/<cell>.json``: each compared number's limit and the readings it
  was set from;
* ``metrics/<metric>.py``: a metric's reader (``UNIT`` and ``read(run)``,
  which returns None where it finds nothing to read).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent.parent   # benchmark/
ROOT = HERE.parent                              # the checkout


class SpecError(Exception):
    """A cell, configuration, mix, limit or metric that cannot be found
    or read."""


def _json(path: Path) -> Dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"missing {path.relative_to(ROOT)}") from None
    except json.JSONDecodeError as e:
        raise SpecError(f"{path.relative_to(ROOT)}: {e}") from None


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file by path under a private module name (metric and entry
    names may hold dots)."""
    if not path.is_file():
        raise SpecError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Metric:
    name: str
    unit: str
    reader: ModuleType = None


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    entry: ModuleType
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _applies(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _metric(entry: Dict) -> Metric:
    """A metric of ``BENCHMARK.json`` with its reader."""
    reader = load_module(HERE / "metrics" / f"{entry['name']}.py",
                         f"benchmark_metric_{entry['name'].replace('.', '_')}")
    if reader.UNIT != entry["unit"]:
        raise SpecError(f"metric {entry['name']}: reader unit {reader.UNIT!r}, "
                        f"BENCHMARK.json {entry['unit']!r}")
    return Metric(entry["name"], entry["unit"], reader)


def load_cell(name: str, traffic: Dict = None) -> Cell:
    """Every piece of the cell ``name``, from ``BENCHMARK.json``;
    ``traffic`` replaces the mix's parameters (the tests' small sizes)."""
    bench = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name}: no config {w['config']!r}")
    config = _json(ROOT / configs[w["config"]]["file"])
    if traffic is None:
        traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = _json(HERE / "limits" / f"{name}.json")
    entry = load_module(HERE / "entries" / f"{config['entry']}.py",
                        f"benchmark_entry_{config['entry']}")
    e2e = [_metric(m) for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m.name for m in e2e}
    per_layer = [_metric(m) for m in bench["per_layer"]
                 if _applies(m, name) and m["moves"] in reported]
    return Cell(name, int(w["chips"]), config, traffic, limits, entry, e2e, per_layer)
