"""The harness is driven by data: a configuration, a cell and a per-layer
metric added as new files and entries, with no existing file edited, are
found by their names, listed and run to a printed result line, at a tiny
size on the CPU with the program's plain versions."""
import hashlib
import json
import os

from bench_port.tests import tiny_tree

NEW_METRIC = '''"""Units in the traced slice (a metric a test adds)."""
LAYER = "device"
UNIT = "units"
BETTER = "higher"
MOVES = "request_s"
SOURCE = "host_clock"


def read(record):
    return float(record["units"])
'''


def digests(folder):
    out = {}
    for base, _, files in os.walk(folder):
        for f in files:
            if "__pycache__" not in base:
                p = os.path.join(base, f)
                out[os.path.relpath(p, folder)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_found_and_run(tmp_path):
    bench = tiny_tree.make(str(tmp_path))
    before = digests(bench)
    cfg = tiny_tree.read(os.path.join(bench, "configs",
                                      "videogpt-phi3mini.json"))
    cfg["name"] = "videogpt-narrow"
    cfg["model"].update(hidden_size=96, num_attention_heads=6,
                        num_key_value_heads=6)
    tiny_tree.write(os.path.join(bench, "configs", "videogpt-narrow.json"),
                    cfg)
    cell = tiny_tree.read(os.path.join(bench, "workloads",
                                       "videogpt.serve_clip.json"))
    cell.update(config="videogpt-narrow", why="a cell a test adds")
    cell["traffic"].update(steps=1, guidance=1.0)
    tiny_tree.write(os.path.join(bench, "workloads",
                                 "narrow.serve_once.json"), cell)
    with open(os.path.join(bench, "metrics", "traced_units.serve.py"),
              "w") as f:
        f.write(NEW_METRIC)
    path = os.path.join(str(tmp_path), "BENCHMARK.json")
    b = tiny_tree.read(path)
    b["configs"].append({"name": "videogpt-narrow", "source": "a test",
                         "file": "bench_port/configs/videogpt-narrow.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "narrow.serve_once",
                           "config": "videogpt-narrow",
                           "traffic": "serve_once", "chips": 1,
                           "why": "a test"})
    for m in b["end_to_end"]:
        if "workloads" in m and "videogpt.serve_clip" in m["workloads"]:
            m["workloads"].append("narrow.serve_once")
    b["per_layer"].append({"name": "traced_units.serve", "unit": "units",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "request_s",
                           "workloads": ["narrow.serve_once"]})
    tiny_tree.write(path, b)

    plain = tiny_tree.run_cell(bench, "narrow.serve_once", trace=0)
    assert plain["correct"], plain["check"]
    assert set(plain["metrics"]) == {"request_s", "serve_frames_per_s",
                                     "peak_mem_gib", "setup_s"}
    traced = tiny_tree.run_cell(bench, "narrow.serve_once", trace=1)
    assert traced["metrics"]["traced_units.serve"]["value"] == float(
        cell["trace_units"])
    assert "traced_units.serve" not in json.dumps(
        tiny_tree.run_cell(bench, "videogpt.serve_clip", trace=1)["metrics"])
    after = digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "configs/videogpt-narrow.json", "workloads/narrow.serve_once.json",
        "metrics/traced_units.serve.py"}
