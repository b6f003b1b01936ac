"""The control of a cell's comparison, read on the card at the cell's own
size:

    python3 bench_port/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed the reference is run as the check runs it, and again one
precision below the configuration's (fp8 operands for bf16) in the
program's place; a training cell also plants the faults it can have (part
of the batch left out; a step that leaves the state unchanged). Each
variant's compared numbers are printed as one JSON line a seed. These
readings set the upper end of each limit (``PERF.md``); the benchmark's own
runs never run this.
"""
import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))

from bench_port.harness.core import Context, load_module  # noqa


def control(bench_dir: str, workload: str, seeds, device) -> list:
    """One dict a seed: {variant: {number: reading}}."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for seed in seeds:
        ctx = Context(bench_dir, workload, seed, 0, False, device)
        driver = load_module(os.path.join(bench_dir, "drivers",
                                          f"{ctx.cell['driver']}.py"),
                             f"bench_driver_{ctx.cell['driver']}")
        t0 = time.perf_counter()
        got = driver.build(ctx, with_program=False).control()
        out.append({"workload": workload, "seed": seed, "readings": got,
                    "seconds": time.perf_counter() - t0})
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for line in control(BENCH_DIR, args.workload, args.seeds,
                        torch.device("cuda", 0)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
