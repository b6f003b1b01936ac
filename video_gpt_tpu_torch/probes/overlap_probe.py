"""Does the card run the tensor cores under the exp2 pass when a
warpgroup's key loop is software-pipelined?

Port of ``scripts/overlap_probe.py`` (P1): one unmasked unshifted-exp2
attention of [256, 128] queries over 8192 keys of D 128, scale 1, computed
by two hand-written kernels of ``csrc/overlap_probe.cu`` that share one
block shape (a TMA producer warpgroup, two consumer warpgroups of 64 query
rows on wgmma) and one ring of K/V stages, and differ only in the order of
issue and wait inside a consumer warpgroup:

- :func:`overlap_serial`: per 64-key subtile, S = Q.K^T and wait, the exp2
  pass, P.V and wait;
- :func:`overlap_pipelined`: subtile j+1's S issued before subtile j's exp2
  pass and left to run under it, P.V of j after it; ``nsub`` in (2, 4, 8,
  16) splits each 256-key span into subtiles of 256 / nsub keys (nsub 4:
  the serial body's tile).

Equal math, FLOPs and bytes. ``problems`` (G) independent copies of the
probe run in one launch: G = 1 is the TPU probe (2 blocks of 128 rows),
G = 132 gives every SM two blocks in turn. Runs on CUDA only:

    python -m video_gpt_tpu_torch.probes.overlap_probe

prints, per G, each variant's time (``median_ms``: the median of 20
samples of 10 launches back to back), max|A - B| between the variants and
against the plain version, and the speedup of each ``nsub`` over the
serial body, then one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops.flash_attention import _launch

BQ, LK, D = 256, 8192, 128
NSUBS = (2, 4, 8, 16)
REPS = 20
BURST = 10  # launches a timed sample
SPAN = 256  # keys split into nsub subtiles (csrc kSpan)


class _ProbeArgs(ctypes.Structure):
    """Mirror of ``ProbeArgs`` in csrc/overlap_probe.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in ("q", "k", "v", "out")] \
        + [(name, ctypes.c_int) for name in (
            "problems", "bq", "lk", "head_dim", "nsub")]


def overlap_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> torch.Tensor:
    """Plain P1: q [G, BQ, D], k/v [G, LK, D] -> [G, BQ, D] in q's dtype,
    out = bf16(p).v / max(sum p, 1e-30) with p = exp2(clamp(q.k, +-100));
    the probabilities are cast to v's dtype before P.V, as the kernels
    do."""
    s = q.float() @ k.float().transpose(-1, -2)
    p = torch.exp2(s.clamp(-100.0, 100.0))
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    return ((p.to(v.dtype).float() @ v.float()) / l).to(q.dtype)


def _run(fn: str, q, k, v, nsub: int = 0) -> torch.Tensor:
    g, bq, d = q.shape
    lk = k.shape[1]
    for name, x, shape in (("q", q, (g, bq, d)), ("k", k, (g, lk, d)),
                           ("v", v, (g, lk, d))):
        if x.device != q.device or x.dtype != torch.bfloat16 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous bf16 {shape} on "
                             f"{q.device}; got {x.dtype} {tuple(x.shape)}")
    if d != D or bq % 64 or lk % SPAN:
        raise ValueError(f"the probe kernels take D {D}, BQ a multiple of 64 "
                         f"and LK a multiple of {SPAN}; got {d}, {bq}, {lk}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the probe kernels read q, k, v by TMA: each must "
                         "start on a 16-byte boundary")
    out = torch.empty_like(q)
    a = _ProbeArgs(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                   out=out.data_ptr(), problems=g, bq=bq, lk=lk, head_dim=d,
                   nsub=nsub)
    _launch("overlap_probe", fn, a, q.device)
    return out


def overlap_serial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """The serial body; the plain version for CPU tensors."""
    if not q.is_cuda:
        return overlap_reference(q, k, v)
    out = _run("vgt_overlap_serial", q, k, v)
    overlap_serial.launches += 1
    return out


overlap_serial.launches = 0


def overlap_pipelined(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      nsub: int) -> torch.Tensor:
    """The software-pipelined body with ``nsub`` subtiles per 256 keys; the
    plain version for CPU tensors."""
    if nsub not in NSUBS:
        raise ValueError(f"nsub must be one of {NSUBS}, got {nsub}")
    if not q.is_cuda:
        return overlap_reference(q, k, v)
    out = _run("vgt_overlap_pipelined", q, k, v, nsub)
    overlap_pipelined.launches += 1
    return out


overlap_pipelined.launches = 0


def probe_inputs(problems: int, device, bq: int = BQ, lk: int = LK,
                 seed: int = 0):
    """q, k ~ 0.1 N(0, 1) and v ~ N(0, 1) in bf16, as the TPU probe draws
    them (so s = q.k stays near 0 and exp2 near 1), from a numpy seed."""
    rng = np.random.default_rng(seed)

    def draw(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(x).to(device, torch.bfloat16)

    return (draw((problems, bq, D), 0.1), draw((problems, lk, D), 0.1),
            draw((problems, lk, D), 1.0))


def median_ms(fn, reps: int = REPS) -> float:
    """Median device time of one launch of ``fn`` over ``reps`` samples,
    after one warm-up launch. A sample is the mean of ``BURST`` launches
    back to back between two CUDA events, so that the host's work between
    launches (the wrapper, the tensor maps: ~30 us, a quarter of a G 1
    launch) overlaps the device's instead of adding to it."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BURST):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BURST)
    return float(np.median(times))


def run(problems: int, device, reps: int = REPS) -> dict:
    """Both bodies at G = ``problems``: median times, max|A - B| between
    each pipelined variant and the serial body, and each against the plain
    version (fp32, unrounded probabilities)."""
    q, k, v = probe_inputs(problems, device)
    plain = overlap_reference(q.float(), k.float(), v.float())
    serial = overlap_serial(q, k, v)
    serial_ms = median_ms(lambda: overlap_serial(q, k, v), reps)

    def err(x, y):
        return float((x.float() - y.float()).abs().max())

    res = dict(problems=problems, bq=BQ, lk=LK, d=D, reps=reps,
               serial_ms=serial_ms, serial_vs_plain=err(serial, plain),
               pipelined=[])
    for nsub in NSUBS:
        out = overlap_pipelined(q, k, v, nsub)
        ms = median_ms(lambda: overlap_pipelined(q, k, v, nsub), reps)
        res["pipelined"].append(dict(
            nsub=nsub, subtile_keys=SPAN // nsub, ms=ms,
            speedup=serial_ms / ms, vs_serial=err(out, serial),
            vs_plain=err(out, plain)))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("overlap_probe: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    dev = torch.device("cuda")
    results = []
    for problems in (1, 132):
        r = run(problems, dev)
        results.append(r)
        print(f"G {problems}: A serial            {r['serial_ms']:8.4f} ms"
              f"   (max|A-plain| {r['serial_vs_plain']:.2e})")
        for p in r["pipelined"]:
            print(f"G {problems}: B pipelined nsub={p['nsub']:<2}  "
                  f"{p['ms']:8.4f} ms   (max|A-B| {p['vs_serial']:.2e}, "
                  f"max|B-plain| {p['vs_plain']:.2e})   speedup "
                  f"{p['speedup']:5.3f}x", flush=True)
    print(json.dumps({"overlap_probe": results, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
