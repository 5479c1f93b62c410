"""Find a cell's configuration, traffic mix, limits and per-layer metric
readers by the names ``BENCHMARK.json`` gives them."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, benchmark: pathlib.Path) -> Cell:
    """The cell ``name`` of the benchmark file at ``benchmark``."""
    bench = load_json(benchmark)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload named {name!r} in {benchmark}")
    w = found[0]
    config = load_json(HERE / "configs" / f"{w['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``, or, where there
    is none, of the file named by the part before the first dot: the cells'
    copies of one quantity (``idle_share.gauss``, ``idle_share.align``)
    share a reader."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
