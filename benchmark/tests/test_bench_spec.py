"""Every cell, configuration, mix, limit and metric loads by name, and
BENCHMARK.json keeps to the shape its contract asks for."""

import json
import re

import pytest

from benchmark.harness import cell as harness
from benchmark.harness.spec import HERE, ROOT, SpecError, load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = load_cell(name)
    assert cell.entry.CHECKS and set(cell.entry.CHECKS) <= set(cell.limits)
    assert {m.name for m in cell.end_to_end} >= {"gflops", "setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer + cell.end_to_end:
        assert m.reader.UNIT == m.unit
    for m in cell.per_layer + [m for m in cell.end_to_end if m.name == "gflops"]:
        assert m.reader.read(harness.Run()) is None, f"{m.name} read an empty run"


def test_unknown_cell_is_a_spec_error():
    with pytest.raises(SpecError):
        load_cell("no_such.cell")


def test_names_units_and_bounds():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def test_a_full_check_fits_at_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["parsec_tpu_torch", "parsec_tpu_torch.ops", "jaxtyping", "numpy",
             "parsec_tpu", "parsec_tpu.core", "jax.numpy", "jaxlib", "flax.linen"]
    assert harness.forbidden_modules(names) == ["flax.linen", "jax.numpy", "jaxlib",
                                                "parsec_tpu", "parsec_tpu.core"]


def test_every_cache_lives_inside_the_checkout(monkeypatch):
    for var in harness.CACHES:
        monkeypatch.delenv(var, raising=False)
    harness.set_cache_env()
    import os
    for var in harness.CACHES:
        path = os.environ[var]
        assert path.startswith(str(HERE / ".cache")), path
