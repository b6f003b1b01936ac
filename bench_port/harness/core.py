"""One run of one cell: find its files by name, set it up, measure the
window, trace a slice, judge the outputs, print the result line.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric sits in a file of its own under the benchmark's folder,
found by the name ``BENCHMARK.json`` and the cell's file give it:

- ``configs/<config>.json``: the sizes as run (``model``, ``vae``), the
  source, ``reduced`` and ``assumed``, the deployment;
- ``workloads/<cell>.json``: the configuration's and the driver's names,
  the traffic, ``chips``, ``why``, the units traced and the limits of the
  comparison;
- ``drivers/<driver>.py``: ``build(ctx)`` returns the cell: the program
  built on weights drawn from the seed, warmed up on the cell's own
  shapes; ``unit(i)`` runs one whole request or step;
- ``metrics/<metric>.py``: ``read(record)``, the metric from the traced
  slice's record, or None where there is nothing to read.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "video_gpt_tpu")
GIB = 2 ** 30


class RunError(Exception):
    """A run that prints no result line."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``video_gpt_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def guard_imports(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise RunError(f"{when}: the run holds the modules {found}; the "
                       f"benchmark measures the PyTorch port alone")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise RunError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    if not os.path.exists(path):
        raise RunError(f"no file {path}")
    with open(path) as f:
        return json.load(f)


class Context:
    """What a driver is given: the run's arguments, its cell and
    configuration, the device, and where the benchmark's files are."""

    def __init__(self, bench_dir: str, workload: str, seed: int,
                 seconds: float, trace: bool, device):
        self.bench_dir = bench_dir
        self.name = workload
        self.cell = read_json(os.path.join(bench_dir, "workloads",
                                           f"{workload}.json"))
        self.config = read_json(os.path.join(bench_dir, "configs",
                                             f"{self.cell['config']}.json"))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.traffic = self.cell["traffic"]
        self.check = self.cell["check"]
        self.t_start = time.time()

    def log(self, msg: str) -> None:
        print(f"[{self.name}] {msg}", file=sys.stderr, flush=True)

    def mark(self, what: str) -> None:
        """Log the seconds since the process started, at a set-up step."""
        self.log(f"{what} at {time.time() - self.t_start:.1f} s")


def _metric_entries(benchmark: dict, key: str, workload: str) -> List[dict]:
    return [m for m in benchmark[key]
            if "workloads" not in m or workload in m["workloads"]]


def run(argv: List[str], bench_dir: str, t_start: float,
        require_cuda: bool = True) -> Dict[str, object]:
    """The result of one run; raises :class:`RunError` where a run must
    print no result. ``require_cuda`` False lets a test drive a run on the
    CPU with the program's plain versions."""
    ap = argparse.ArgumentParser(prog="bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    guard_imports("at start")
    root = os.path.dirname(os.path.abspath(bench_dir))
    benchmark = read_json(os.path.join(root, "BENCHMARK.json"))
    if not any(w["name"] == args.workload for w in benchmark["workloads"]):
        raise RunError(f"BENCHMARK.json names no cell {args.workload!r}")
    entry = next(w for w in benchmark["workloads"]
                 if w["name"] == args.workload)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    cache = os.path.join(root, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    import torch
    if require_cuda:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device is available")
        if torch.cuda.device_count() < entry["chips"]:
            raise RunError(f"the cell needs {entry['chips']} cards, "
                           f"{torch.cuda.device_count()} are present")
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    # the reference's fp32 products stay fp32 (no TF32), as the program's
    # own entry points set it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if root not in sys.path:
        sys.path.insert(0, root)
    ctx = Context(bench_dir, args.workload, args.seed, args.seconds,
                  args.trace, device)
    ctx.t_start = t_start
    ctx.mark("torch and the device ready")
    driver = load_module(os.path.join(bench_dir, "drivers",
                                      f"{ctx.cell['driver']}.py"),
                         f"bench_driver_{ctx.cell['driver']}")
    cell = driver.build(ctx)
    ctx.mark("set-up done")

    # ---- the measured window -------------------------------------------------
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    attempted = failed = 0
    while True:
        failed += 0 if cell.unit(attempted) else 1
        attempted += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    guard_imports("after the window")
    window_units = attempted

    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": entry["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if not args.trace:
        values = cell.end_to_end(window_units, wall)
        values["peak_mem_gib"] = peak / GIB
        values["setup_s"] = setup_s
        for m in _metric_entries(benchmark, "end_to_end", args.workload):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        from . import trace as tr
        n = int(ctx.cell.get("trace_units", 1))
        box = [attempted]

        def one():
            ok = cell.unit(box[0])
            box[0] += 1
            if not ok:
                box.append(False)

        prof, slice_wall = tr.profile_units(one, n, device.type == "cuda")
        attempted, failed = box[0], failed + (len(box) - 1)
        rec = tr.reduce(prof, n, slice_wall)
        del prof
        ctx.log(f"traced slice {slice_wall / n:.4f} s a unit against "
                f"{wall / window_units:.4f} s untraced")
        rec["wall_s_per_unit"] = wall / window_units
        rec["busy_s_per_unit"] = rec["busy_s"] / n
        rec["unit"] = cell.unit_info()
        device_info["busy_s"] = rec["busy_s"]
        device_info["window_s"] = slice_wall
        breakdown = rec["breakdown"]
        for m in _metric_entries(benchmark, "per_layer", args.workload):
            reader = load_module(os.path.join(bench_dir, "metrics",
                                              f"{m['name']}.py"),
                                 f"bench_metric_{m['name'].replace('.', '_')}")
            value = reader.read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        guard_imports("after the traced slice")

    # ---- the comparison that decides `correct` --------------------------------
    cell.release()
    t_check = time.perf_counter()
    readings = cell.check()
    ctx.log(f"window {wall:.1f} s, {window_units} units; comparison "
            f"{time.perf_counter() - t_check:.1f} s")
    correct = failed == 0 and all(
        math.isfinite(r["value"]) and r["value"] <= r["limit"]
        for r in readings.values())
    for name, r in readings.items():
        print(f"check {name}: {r['value']!r} (limit {r['limit']!r})",
              file=sys.stderr, flush=True)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = readings
    guard_imports("before the result")
    return result


def main(bench_dir: str, t_start: float) -> int:
    try:
        result = run(sys.argv[1:], bench_dir, t_start)
    except RunError as e:
        print(f"bench_port: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0
