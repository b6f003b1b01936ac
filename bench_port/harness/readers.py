"""What the per-layer metrics' readers share: device seconds of the traced
slice by kernel-name patterns, per unit."""
from __future__ import annotations

from typing import Iterable, Optional

from bench_port.flops import PEAK_BF16_FLOPS


def matches(name: str, patterns: Iterable[str]) -> bool:
    return any(p in name for p in patterns)


def device_s(record: dict, include: Iterable[str] = (),
             exclude: Iterable[str] = (), in_range: Optional[str] = None
             ) -> float:
    """Device seconds a unit of the kernels whose names hold one of
    ``include`` (every kernel if empty) and none of ``exclude``; with
    ``in_range``, only those that ran inside that range, else only those
    outside every range."""
    include, exclude = tuple(include), tuple(exclude)
    total = 0.0
    for name, rng, sec in record["kernels"]:
        if (rng != in_range) if in_range is not None else rng:
            continue
        if include and not matches(name, include):
            continue
        if matches(name, exclude):
            continue
        total += sec
    return total / record["units"]


def roofline(record: dict, family: str, patterns: Iterable[str]):
    """The family's summed bound over its kernels' device time, in %; None
    where no such kernel ran."""
    bound_ms = record["unit"]["bounds_ms"].get(family)
    ms = device_s(record, patterns) * 1e3
    if not bound_ms or ms <= 0:
        return None
    return 100.0 * bound_ms / ms


def idle_share(record: dict):
    """1 - device busy seconds a unit of the traced slice over the wall
    seconds a unit of the untraced window, in %, so that the tracer's own
    host time stays out of it; None where the trace holds no device work.
    Unclamped: where the device is busy all through, one traced unit can
    run a little longer than the window's mean unit and read below 0."""
    if record["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s_per_unit"]
                    / record["wall_s_per_unit"])


def mfu(record: dict) -> float:
    """Model FLOPs a unit over the untraced wall a unit, as a share of the
    card's dense bf16 peak, in %."""
    return 100.0 * record["unit"]["model_flops"] / record[
        "wall_s_per_unit"] / PEAK_BF16_FLOPS
