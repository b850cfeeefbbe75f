"""Cells, configurations, traffic mixes, per-layer metrics and kernel work
formulas, each found by its name in ``BENCHMARK.json``:

    mapbench/configs/<config>.json     a configuration (a deployment)
    mapbench/traffic/<traffic>.json    a traffic mix (the read pool)
    mapbench/metrics/<metric>.py       a per-layer metric's reader
    mapbench/work/<kernel>.py          a kernel's operations and bytes

A new cell, mix or metric is a new file and a new entry; no file of the
harness changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def config_file(name: str) -> str:
    return os.path.join(HERE, "configs", name + ".json")


def traffic_file(name: str) -> str:
    return os.path.join(HERE, "traffic", name + ".json")


def cell(name: str, bench: dict = None) -> CellSpec:
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return CellSpec(name, int(w["chips"]),
                    load_json(config_file(w["config"])),
                    load_json(traffic_file(w["traffic"])),
                    [m for m in bench["end_to_end"] if _applies(m, name)],
                    [m for m in bench["per_layer"] if _applies(m, name)])


def _module(kind: str, name: str):
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"mapbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str):
    """The reader of per-layer metric ``name``: NAME, UNIT, LAYER, MOVES,
    BETTER, optionally KERNEL, and ``read(records) -> float | None``."""
    return _module("metrics", name)


def work_module(kernel: str):
    """A kernel's SYMBOL (a part of its name in a trace) and
    ``needs(batches, ctx) -> (operations, bytes)``."""
    return _module("work", kernel)
