"""The traced slice filed by the program's spans.

The program's spans are ``video_gpt_tpu_torch.utils.profiling.annotate``
ranges, recorded only inside ``profiling.spans()``. The traced slice does
not switch them on, and nothing in the harness calls this module yet. To
read them, ``trace.profile_units`` enters :func:`program_spans` beside the
profile and ``trace.reduce`` returns :func:`record` of :func:`events`; a
per-layer metric then reads ``record["span_kernels"]`` through
:func:`span_device_s`.

Device events are the profiler's kernel, copy and set activities. Two
attributions file them, each kernel exactly once:

- by range (``kernels``, as ``trace.reduce`` files them today): a range (a
  ``record_function`` such as the optimizer's "AdamW.step") is not work
  and counts nothing itself, but each kernel that starts inside its device
  span is filed under the first such range. The harness's own
  ``bench.unit`` and the program's ``vgt.*`` spans take no part, so this
  attribution reads the same whether the program's spans are on or not;
- by span (``span_kernels``, ``spans``): each kernel is filed under the
  innermost program span (a ``vgt.*`` span or "AdamW.step") that was open
  on the host when the kernel was launched. The launch is the runtime call
  with the kernel's correlation id, on whatever thread made it, so the
  kernels that autograd's thread launches land in the span the main thread
  holds open around ``backward()``. A span's path names the program spans
  that enclose it, outermost first: ``vgt.generate/vgt.sampler.step``.

Busy time is the union of the device intervals. An idle gap is named
``<innermost program span> / <innermost host event>`` as they were when it
began; ``(outside the program)`` where no program span was open.

The attribution is plain functions over ``(name, start_ns, end_ns, ...)``
tuples (:func:`record`), so that a test drives it without a card.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

from bench_port.harness.readers import matches
from bench_port.harness.trace import TOP, UNIT_RANGE, _union

PROGRAM_PREFIX = "vgt."
OPTIMIZER_SPAN = "AdamW.step"
OUTSIDE = "(outside the program)"

Host = Tuple[str, int, int]            # a host event: name, start, end
Device = Tuple[str, int, int, int]     # a device event and its correlation
Span = Tuple[str, int, int]            # a program span: path, start, end


def program_spans():
    """The program's ``spans()`` context, which switches its spans on; a
    no-op context for a program without it. Imported here, when called,
    so that the harness loads without the program."""
    try:
        from video_gpt_tpu_torch.utils.profiling import spans
    except ImportError:
        return contextlib.nullcontext()
    return spans()


def is_program_span(name: str) -> bool:
    return name.startswith(PROGRAM_PREFIX) or name == OPTIMIZER_SPAN


def leaf(path: str) -> str:
    """The innermost span's name of a span path."""
    return path.rsplit("/", 1)[-1]


def kernels_by_range(device: List[Device], ranges: List[Host]
                     ) -> Dict[Tuple[str, str], float]:
    """Device seconds by (kernel name, range): the first range, other than
    the harness's and the program's spans, whose device span holds the
    kernel's start; "" where none does."""
    ranged = [r for r in ranges if r[0] != UNIT_RANGE
              and not r[0].startswith(PROGRAM_PREFIX)]
    kernels: Dict[Tuple[str, str], float] = {}
    for name, a, b, _ in device:
        rng = next((n for n, x, y in ranged if x <= a < y), "")
        key = (name, rng)
        kernels[key] = kernels.get(key, 0.0) + (b - a) * 1e-9
    return kernels


def span_paths(host: List[Host]) -> List[Span]:
    """The program spans among the host events, each with its path."""
    spans = sorted((e for e in host if is_program_span(e[0])),
                   key=lambda e: (e[1], -e[2]))
    out: List[Span] = []
    stack: List[Span] = []
    for name, a, b in spans:
        while stack and stack[-1][2] <= a:
            stack.pop()
        path = f"{stack[-1][0]}/{name}" if stack else name
        out.append((path, a, b))
        stack.append((path, a, b))
    return out


class SpanIndex:
    """The innermost program span open at a host time: the one that
    started last of those that hold it."""

    def __init__(self, spans: List[Span]):
        self.points = sorted({t for _, a, b in spans for t in (a, b)})
        self.paths = []
        for t in self.points:
            open_ = [s for s in spans if s[1] <= t < s[2]]
            self.paths.append(max(open_, key=lambda s: (s[1], len(s[0])))[0]
                              if open_ else OUTSIDE)

    def at(self, t: int) -> str:
        i = bisect.bisect_right(self.points, t) - 1
        return self.paths[i] if i >= 0 else OUTSIDE


def kernels_by_span(device: List[Device], launches: Dict[int, int],
                    index: SpanIndex) -> Tuple[Dict[Tuple[str, str], int],
                                               int]:
    """Device ns by (kernel name, span path) of the span open at each
    kernel's launch, and how many kernels had no launch in the trace
    (filed by their own start instead)."""
    out: Dict[Tuple[str, str], int] = {}
    unlinked = 0
    for name, a, b, corr in device:
        t = launches.get(corr)
        if t is None:
            unlinked += 1
            t = a
        key = (name, index.at(t))
        out[key] = out.get(key, 0) + (b - a)
    return out, unlinked


def idle_gaps(busy: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """(length, start) of each gap between the busy intervals."""
    return [(busy[i + 1][0] - busy[i][1], busy[i][1])
            for i in range(len(busy) - 1)]


def gap_name(at: int, host: List[Host], index: SpanIndex) -> str:
    covering = [(a, n) for n, a, b in host
                if a <= at < b and not is_program_span(n)]
    event = max(covering)[1] if covering else "(host idle)"
    return f"{leaf(index.at(at))} / {event}"


def record(host: List[Host], device: List[Device], ranges: List[Host],
           launches: Dict[int, int], units: int, wall_s: float
           ) -> Dict[str, object]:
    """The traced slice as a record: per-kernel device seconds with the
    range each ran in (``kernels``), busy and wall seconds, the largest
    device operations and the longest idle gaps (``breakdown``); and by
    program span: ``span_kernels`` ([kernel, span path, seconds] over the
    slice), ``spans`` ({path: host seconds, calls and device seconds of
    the kernels filed under it as the innermost span, a unit}) and
    ``span_idle`` ({path: device-idle seconds a unit of the gaps that
    began in it}). ``host``: every host event, the program's spans among
    them; ``device``: kernels, copies and sets with their correlation ids;
    ``ranges``: the device spans of the ranges; ``launches``: the host
    start of each runtime call by correlation id."""
    kernels = kernels_by_range(device, ranges)
    spans = span_paths(host)
    index = SpanIndex(spans)
    by_span, unlinked = kernels_by_span(device, launches, index)
    busy = _union([(a, b) for _, a, b, _ in device])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps = idle_gaps(busy)
    span_idle: Dict[str, float] = {}
    for length, at in gaps:
        path = index.at(at)
        span_idle[path] = span_idle.get(path, 0.0) + length * 1e-9 / units
    idle = [[gap_name(at, host, index), length * 1e-9]
            for length, at in sorted(gaps, reverse=True)[:TOP]]
    device_ns: Dict[str, int] = {}
    for (_, path), ns in by_span.items():
        device_ns[path] = device_ns.get(path, 0) + ns
    per_span: Dict[str, Dict[str, float]] = {}
    for path, a, b in spans:
        s = per_span.setdefault(path, {
            "host_s": 0.0, "calls": 0.0,
            "device_s": device_ns.get(path, 0) * 1e-9 / units})
        s["host_s"] += (b - a) * 1e-9 / units
        s["calls"] += 1.0 / units
    by_name: Dict[str, float] = {}
    for (name, _), sec in kernels.items():
        by_name[name] = by_name.get(name, 0.0) + sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"units": units, "wall_s": wall_s, "busy_s": busy_s,
            "kernels": [[n, r, s] for (n, r), s in kernels.items()],
            "span_kernels": [[n, p, ns * 1e-9]
                             for (n, p), ns in by_span.items()],
            "spans": per_span, "span_idle": span_idle,
            "unlinked_kernels": unlinked,
            "breakdown": {"device_ops": [[n[:120], s] for n, s in top],
                          "idle_gaps": idle}}


def span_lines(rec: Dict[str, object]) -> List[str]:
    """The record's spans a unit, the most device time first: calls, host
    ms, device ms of the kernels filed under each, and device-idle ms of
    the gaps that began in each."""
    idle = rec["span_idle"]
    rows = [(s["device_s"], path, s) for path, s in rec["spans"].items()]
    out = [f"{path}: {s['calls']:g} calls, host {s['host_s'] * 1e3:.3f} ms, "
           f"device {dev * 1e3:.3f} ms, idle {idle.get(path, 0.0) * 1e3:.3f}"
           f" ms" for dev, path, s in sorted(rows, reverse=True)]
    outside = sum(sec for _, path, sec in rec["span_kernels"]
                  if path == OUTSIDE) / rec["units"]
    filed = sum(s["device_s"] for s in rec["spans"].values())
    total = sum(sec for _, _, sec in rec["kernels"]) / rec["units"]
    out.append(f"{OUTSIDE}: device {outside * 1e3:.3f} ms, idle "
               f"{idle.get(OUTSIDE, 0.0) * 1e3:.3f} ms; under spans "
               f"{filed * 1e3:.6f} + outside {outside * 1e3:.6f} of "
               f"{total * 1e3:.6f} ms; kernels with no launch in the "
               f"trace: {rec['unlinked_kernels']}")
    return out


def events(prof) -> Tuple[List[Host], List[Device], List[Host],
                          Dict[int, int]]:
    """(host events, device events, device spans of the ranges, launches)
    of a finished profile, as :func:`record` takes them."""
    from torch.autograd import DeviceType
    host: List[Host] = []
    device: List[Device] = []
    ranges: List[Host] = []
    launches: Dict[int, int] = {}
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        iv = (name, s, s + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                ranges.append(iv)
            else:
                device.append(iv + (e.correlation_id(),))
        elif e.device_type() == DeviceType.CPU:
            host.append(iv)
            # CUDA API calls (cudaLaunchKernel, cuLaunchKernel,
            # cudaMemcpyAsync, ...) carry the correlation id of the work
            # they queue; the framework's own ops number theirs apart
            if name.startswith("cu") and e.correlation_id():
                c = e.correlation_id()
                launches[c] = min(launches.get(c, s), s)
    return host, device, ranges, launches


def span_device_s(record: dict, spans: Iterable[str],
                  include: Iterable[str] = (), exclude: Iterable[str] = ()
                  ) -> Optional[float]:
    """Device seconds a unit of the kernels filed under one of the program
    spans ``spans`` (the span itself or one it encloses) whose names hold
    one of ``include`` (every kernel if empty) and none of ``exclude``;
    None where none of those spans was open in the slice (a program
    without them)."""
    spans, include, exclude = set(spans), tuple(include), tuple(exclude)
    if not any(spans & set(path.split("/")) for path in record["spans"]):
        return None
    total = 0.0
    for name, path, sec in record["span_kernels"]:
        if not spans & set(path.split("/")):
            continue
        if include and not matches(name, include):
            continue
        if matches(name, exclude):
            continue
        total += sec
    return total / record["units"]
