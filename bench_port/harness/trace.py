"""The traced slice: whole units under ``torch.profiler``, reduced to a
record that the per-layer metrics read.

Device events are the profiler's kernel, copy and set activities; a range
(a ``record_function`` such as the optimizer's "AdamW.step") is not work
and counts nothing itself, but each kernel that starts inside its device
span is filed under it. Busy time is the union of the device intervals.
An idle gap is named by the innermost host event that was running when it
began.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

UNIT_RANGE = "bench.unit"
TOP = 10


def profile_units(run_unit: Callable[[], None], n: int, device_trace: bool):
    """(profiler, wall seconds) of ``n`` units traced with host and, on a
    card, device activities."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device_trace:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            with record_function(UNIT_RANGE):
                run_unit()
        wall = time.perf_counter() - t0
    return prof, wall


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(prof, units: int, wall_s: float) -> Dict[str, object]:
    """The traced slice as a record: per-kernel device seconds (with the
    range each kernel ran in), busy seconds, the slice's wall seconds, the
    largest device operations and the longest idle gaps."""
    from torch.autograd import DeviceType
    host, device, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        iv = (name, s, s + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            (spans if e.is_user_annotation() else device).append(iv)
        elif e.device_type() == DeviceType.CPU:
            host.append(iv)
    ranged = [sp for sp in spans if sp[0] != UNIT_RANGE]
    kernels: Dict[Tuple[str, str], float] = {}
    for name, a, b in device:
        rng = next((n for n, x, y in ranged if x <= a < y), "")
        key = (name, rng)
        kernels[key] = kernels.get(key, 0.0) + (b - a) * 1e-9
    busy = _union([(a, b) for _, a, b in device])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1])
                   for i in range(len(busy) - 1)), reverse=True)[:TOP]
    idle = []
    for length, at in gaps:
        covering = [(a, n) for n, a, b in host if a <= at < b]
        idle.append([max(covering)[1] if covering else "(host idle)",
                     length * 1e-9])
    by_name: Dict[str, float] = {}
    for (name, _), sec in kernels.items():
        by_name[name] = by_name.get(name, 0.0) + sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"units": units, "wall_s": wall_s, "busy_s": busy_s,
            "kernels": [[n, r, s] for (n, r), s in kernels.items()],
            "breakdown": {"device_ops": [[n[:120], s] for n, s in top],
                          "idle_gaps": idle}}
