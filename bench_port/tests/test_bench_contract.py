"""``BENCHMARK.json`` against the rules the benchmark keeps: names and
units of the allowed characters, every file it names present, each
per-layer metric's own file agreeing with its entry and reported only in
cells that report what it moves, the bounds within their range, and a
full check of 24 cells fitting its time."""
import importlib.util
import json
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
B = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def cells_reporting(metric):
    names = [w["name"] for w in B["workloads"]]
    return metric.get("workloads", names)


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["bench_port"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) <= 64 * 1024


@pytest.mark.parametrize("key", sorted(KEYS))
def test_entries(key):
    seen = set()
    for e in B[key]:
        extra = {"workloads"} if key in ("end_to_end", "per_layer") else set()
        assert KEYS[key] <= set(e) <= KEYS[key] | extra, e
        assert NAME.match(e["name"]) and e["name"] not in seen
        seen.add(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]


def test_files_exist_and_cells_name_their_driver():
    bench = os.path.join(REPO, "bench_port")
    for c in B["configs"]:
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
    for w in B["workloads"]:
        cell = json.load(open(os.path.join(bench, "workloads",
                                           f"{w['name']}.json")))
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert cell["why"] == w["why"] and w["chips"] == 1
        assert os.path.exists(os.path.join(bench, "drivers",
                                           f"{cell['driver']}.py"))


def test_bounds():
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in B["end_to_end"])


def test_every_cell_reports_enough():
    for w in B["workloads"]:
        e2e = [m["name"] for m in B["end_to_end"]
               if w["name"] in cells_reporting(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in cells_reporting(m) for m in B["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_metric_file_agrees(metric):
    m = next(x for x in B["per_layer"] if x["name"] == metric)
    path = os.path.join(REPO, "bench_port", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("metric", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.MOVES, mod.SOURCE) == (
        m["layer"], m["unit"], m["better"], m["moves"], m["source"])
    moves = next(x for x in B["end_to_end"] if x["name"] == m["moves"])
    assert set(cells_reporting(m)) <= set(cells_reporting(moves))


def test_a_full_check_fits():
    runs = 2 + 14 * 24
    total = runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
