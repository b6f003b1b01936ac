"""File + stdout logger and phase timing.

Port of ``video_gpt_tpu/utils/logging.py`` (the reference's
``LVM/utils.py`` logger): :func:`create_logger` writes each record to
stdout and, given a directory, to its ``log.txt``, in the same format;
:class:`PhaseTimer` accumulates wall-clock time per named phase and
prints the same summary. Host clock only: time of device work needs a
``torch.cuda.synchronize()`` inside the phase.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional


def create_logger(logging_dir: Optional[str] = None,
                  name: str = "video_gpt_tpu_torch") -> logging.Logger:
    """The logger ``name`` (made once: a second call returns it as it
    is), INFO and above to stdout and to ``logging_dir/log.txt``."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[\033[34m%(asctime)s\033[0m] %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if logging_dir is not None:
        os.makedirs(logging_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(logging_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class PhaseTimer:
    """Accumulating wall-clock timers for named phases:
    ``with timer.phase("encode"): ...``, then :meth:`summary`."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def phase(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                dt = time.perf_counter() - self.t0
                timer.totals[name] = timer.totals.get(name, 0.0) + dt
                timer.counts[name] = timer.counts.get(name, 0) + 1
                return False

        return _Ctx()

    def summary(self) -> str:
        """One line per phase, the longest first: total seconds, count and
        mean milliseconds."""
        lines = []
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            mean_ms = self.totals[k] / self.counts[k] * 1e3
            lines.append(f"{k}: {self.totals[k]:.3f}s "
                         f"({self.counts[k]}x, {mean_ms:.1f} ms avg)")
        return "\n".join(lines)
