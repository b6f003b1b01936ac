"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Builds happen at
first use, all sources in parallel, into ``_build/`` beside the package; a
library is named by the hash of its sources and flags, so a changed source
rebuilds and an unchanged one is reused. Processes that build at once (the
ranks of a mesh on a fresh tree) take turns under a file lock in the build
directory, so one builds and the others load. Nothing here runs at import
time.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("rank_attention.cu", "bias_attention.cu",
           "bias_attention_bwd.cu", "inline_attention.cu",
           "inline_attention_bwd.cu", "fp32_attention.cu",
           "fp32_attention_bwd.cu", "overlap_probe.cu")
HEADERS = ("attention_args.cuh", "attention_common.cuh", "fp32_split.cuh",
           "inline_mask.cuh", "tile_map.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                           "CUDA kernels build on a machine with the CUDA "
                           "toolkit")
    return path


def _target(src: str, csrc: str = CSRC, build_dir: str = BUILD_DIR) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + (src,):
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(build_dir, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build(csrc: str = CSRC, build_dir: str = BUILD_DIR
          ) -> Dict[str, ctypes.CDLL]:
    """{source stem: loaded library} of the sources in ``csrc``, building
    what is missing into ``build_dir`` (one nvcc process per source, all
    started together)."""
    os.makedirs(build_dir, exist_ok=True)
    # one process builds at a time, so the ranks of a fresh multi-process
    # launch run nvcc once, not once each (each library is installed
    # whole, by os.replace, either way); the lock goes with its file's
    # close (or the process), so a build that was cut off leaves none
    with open(os.path.join(build_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build(csrc, build_dir)


def _build(csrc: str, build_dir: str) -> Dict[str, ctypes.CDLL]:
    targets = {src: _target(src, csrc, build_dir) for src in SOURCES}
    procs = {}
    for src, so in targets.items():
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        log = open(so[:-3] + ".log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(csrc, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT), log, tmp)
    failed = []
    for src, (proc, log, tmp) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(src)
        else:
            os.replace(tmp, targets[src])
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + build_log(csrc, build_dir))
    return {os.path.splitext(src)[0]: ctypes.CDLL(so)
            for src, so in targets.items()}


@functools.lru_cache(maxsize=None)
def libraries() -> Dict[str, ctypes.CDLL]:
    """The package's own kernels (``csrc/``), built at first use."""
    return build()


def build_log(csrc: str = CSRC, build_dir: str = BUILD_DIR) -> str:
    """The compiler output of the current sources (``-Xptxas -v``: each
    kernel's registers, shared memory and spills)."""
    out = []
    for src in SOURCES:
        path = _target(src, csrc, build_dir)[:-3] + ".log"
        if os.path.exists(path):
            with open(path) as f:
                out.append(f"== {src}\n{f.read()}")
    return "\n".join(out)


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{rc}")
