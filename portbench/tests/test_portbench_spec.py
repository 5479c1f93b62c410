"""The harness finds every configuration, traffic mix, limits file and
per-layer metric reader by the name ``BENCHMARK.json`` gives it, and the
file keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec
from portbench.tests.common import BENCHMARK, ROOT

BENCH = json.loads(BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_by_name(cell):
    c = spec.load_cell(cell, BENCHMARK)
    assert c.chips == 1
    assert c.traffic["loop"] in ("em", "align")
    assert (ROOT / "portbench" / "families" / f"{c.config['model']}.py").exists()
    assert c.limits["compared"]
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][1].startswith("portbench/")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"]}) == len(
        BENCH["end_to_end"]) + len(BENCH["per_layer"])
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert len(json.dumps(BENCH)) < 64 * 1024
