"""Side-by-side readings of the overlap probe P1 on the card.

Run from the root of the tree to measure (its package is imported from the
current directory), with one CUDA device:

    python <repo>/tools/overlap_ab.py rows LABEL
    python <repo>/tools/overlap_ab.py consumers N [N ...]

``rows``: the tree's own probe kernels. ``consumers``: the probe built
from a copy of ``csrc/`` whose ``kProbeConsumers`` (consumer warpgroups of
64 query rows a block; the shipped source has 2) is each N. With one
consumer a block holds one warpgroup of products, so nothing beside a
warpgroup's own order hides its exp2 pass; every block reads its problem's
K/V, so a problem's K/V is read 256 / (64 N) times (from L2 after the
first). Each reading checks every body against the plain version at G 2
(max abs error), then times the serial body and every pipelined ``nsub``
at G 1 and G 132: the median of 20 samples, each the mean of 10 launches
back to back between two CUDA events (the same timer in every tree, so
that trees whose wrappers cost the host more or less compare alike). One
JSON line per (tree or N, G).

To compare two trees on one card, run ``rows`` in each tree's root within
one call, in the order parent, change, change, parent.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, ".")
import torch  # noqa: E402

from video_gpt_tpu_torch.ops import _cuda  # noqa: E402
from video_gpt_tpu_torch.probes import overlap_probe  # noqa: E402

LINE = re.compile(r"constexpr int kProbeConsumers = \d+;")
SAMPLES, BURST = 20, 10


def median_ms(fn) -> float:
    fn()
    times = []
    for _ in range(SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BURST):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BURST)
    return float(np.median(times))


def libraries(consumers: int, root: str):
    """The kernels built from a copy of csrc/ at ``consumers``, and the
    probe's ptxas lines."""
    csrc = os.path.join(root, f"csrc{consumers}")
    shutil.copytree(_cuda.CSRC, csrc)
    path = os.path.join(csrc, "overlap_probe.cu")
    with open(path) as f:
        text = f.read()
    if len(LINE.findall(text)) != 1:
        raise SystemExit("overlap_probe.cu: kProbeConsumers not found once")
    with open(path, "w") as f:
        f.write(LINE.sub(f"constexpr int kProbeConsumers = {consumers};",
                         text))
    build = os.path.join(root, f"build{consumers}")
    libs = _cuda.build(csrc, build)
    log = _cuda.build_log(csrc, build).split("== overlap_probe.cu", 1)[1]
    regs = [ln.strip() for ln in log.split("\n== ", 1)[0].splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    return libs, regs


def bodies(q, k, v):
    """(name, launch) of the serial body and every pipelined nsub."""
    return [("serial", lambda: overlap_probe.overlap_serial(q, k, v))] + [
        (f"nsub{n}", lambda n=n: overlap_probe.overlap_pipelined(q, k, v, n))
        for n in overlap_probe.NSUBS]


def reading(dev, **tags) -> None:
    q, k, v = overlap_probe.probe_inputs(2, dev)
    want = overlap_probe.overlap_reference(q.float(), k.float(), v.float())
    errs = {name: float((fn().float() - want).abs().max())
            for name, fn in bodies(q, k, v)}
    del q, k, v, want
    for problems in (1, 132):
        q, k, v = overlap_probe.probe_inputs(problems, dev)
        ms = {name: median_ms(fn) for name, fn in bodies(q, k, v)}
        print(json.dumps(dict(tags, problems=problems, ms=ms, speedup={
            name: ms["serial"] / t for name, t in ms.items()},
            max_abs_err_g2=errs)), flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("overlap_ab: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    if argv[:1] == ["rows"] and len(argv) == 2:
        _cuda.libraries()
        reading(dev, tree=argv[1], device=smi)
        return 0
    if argv[:1] != ["consumers"] or len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = tempfile.mkdtemp(prefix="overlap_ab_")
    try:
        for consumers in map(int, argv[1:]):
            libs, regs = libraries(consumers, root)
            _cuda.libraries = lambda libs=libs: libs
            reading(dev, consumers=consumers, device=smi, ptxas=regs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
