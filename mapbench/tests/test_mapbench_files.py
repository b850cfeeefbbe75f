"""BENCHMARK.json against the contract's shape, and the harness finding
configurations, mixes and metrics by name, dropped-in files included."""

import json
import os
import re
import shutil

import pytest

from mapbench import cell as cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cells.benchmark()


def test_benchmark_json_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["mapbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("mapbench/")
        assert os.path.exists(os.path.join(cells.ROOT, c["file"]))
        held = cells.load_json(os.path.join(cells.ROOT, c["file"]))
        assert held["reduced"] == c["reduced"]
        assert held["source"] == c["source"]
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert w["config"] in names and len(w["why"]) <= 200
        assert os.path.exists(cells.traffic_file(w["traffic"]))
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        layers.setdefault(m["layer"], set()).add(m["name"])


@pytest.mark.parametrize("name", [m for m in
                                  json.load(open(os.path.join(
                                      cells.ROOT, "BENCHMARK.json")))[
                                      "per_layer"]],
                         ids=lambda m: m["name"])
def test_metric_modules_match_their_entries(name):
    m = name
    mod = cells.metric_module(m["name"])
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES, mod.BETTER) == (
        m["name"], m["unit"], m["layer"], m["moves"], m["better"])
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"
    if getattr(mod, "KERNEL", None):
        assert cells.work_module(mod.KERNEL).SYMBOL


@pytest.mark.parametrize("workload", [
    w["name"] for w in json.load(open(os.path.join(
        cells.ROOT, "BENCHMARK.json")))["workloads"]])
def test_cells_load_by_name(workload, bench):
    spec = cells.cell(workload, bench)
    assert spec.config["mapper"]["batch_size"] == 4096
    assert spec.mix["pool_reads"] == 1 << 20
    assert {m["name"] for m in spec.end_to_end} == {
        "reads_per_s", "batch_p95_ms", "peak_dev_mem_gib", "setup_s"}
    assert len(spec.per_layer) == len(bench["per_layer"])


def test_dropped_in_files_are_found(tmp_path, monkeypatch, bench):
    for d in ("configs", "traffic", "metrics", "work"):
        shutil.copytree(os.path.join(cells.HERE, d), tmp_path / d)
    cfg = cells.load_json(cells.config_file("ecoli-k12-100bp"))
    (tmp_path / "configs" / "ecoli-new.json").write_text(json.dumps(
        dict(cfg, genome_len=1000)))
    mix = cells.load_json(cells.traffic_file("sam-unique"))
    (tmp_path / "traffic" / "short-mix.json").write_text(json.dumps(
        dict(mix, read_len=36)))
    (tmp_path / "metrics" / "io.new_ms.py").write_text(
        "NAME = 'io.new_ms'\nUNIT = 'ms'\nLAYER = 'io'\n"
        "MOVES = 'reads_per_s'\nBETTER = 'lower'\n"
        "def read(records):\n    return 1.5\n")
    monkeypatch.setattr(cells, "HERE", str(tmp_path))
    b = dict(bench)
    b["workloads"] = bench["workloads"] + [dict(
        name="ecoli-new.short-mix", config="ecoli-new", traffic="short-mix",
        chips=1, why="test")]
    b["configs"] = bench["configs"] + [dict(
        name="ecoli-new", source="x", file="mapbench/configs/ecoli-new.json",
        reduced=[], why="test")]
    b["per_layer"] = bench["per_layer"] + [dict(
        name="io.new_ms", unit="ms", better="lower", source="host_clock",
        layer="io", moves="reads_per_s", workloads=["ecoli-new.short-mix"])]
    spec = cells.cell("ecoli-new.short-mix", b)
    assert spec.config["genome_len"] == 1000
    assert spec.mix["read_len"] == 36
    assert [m["name"] for m in spec.per_layer] == ["io.new_ms"]
    assert cells.metric_module("io.new_ms").read(None) == 1.5
    with pytest.raises(KeyError):
        cells.cell("nope.nope", b)
