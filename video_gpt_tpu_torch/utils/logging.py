"""File + stdout logger.

Port of ``video_gpt_tpu/utils/logging.py`` (the reference's
``LVM/utils.py`` logger): :func:`create_logger` writes each record to
stdout and, given a directory, to its ``log.txt``, in the same format.
Time by phase is the profiler's: ``utils.profiling.trace`` records the
program's spans beside the card's kernels.
"""
from __future__ import annotations

import logging
import os
from typing import Optional


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
