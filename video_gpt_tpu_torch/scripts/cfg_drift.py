"""Quality drift of serving schedules against the reference trajectory.

Port of ``scripts/cfg_drift.py``. It compares the final denoised latents
of a candidate serving schedule, any combination of

- ``cfg_interval`` (the uncond forward skipped outside the sigma
  interval, ``SchedulerConfig.cfg_interval``, arXiv:2404.07724),
- ``uncond_refresh=k`` (the last uncond prediction reused between every
  k-th guided step, ``SchedulerConfig.uncond_refresh``, DeepCache-style
  arXiv:2312.00858),
- fewer denoise steps and shifted sigma grids (``steps``, ``shift``),

against the reference schedule: ``BENCH_STEPS`` steps, guidance at every
step, at the flagship geometry (8 conditioning frames, a 16-frame clip,
176x320, guidance 1.5, bf16) with random weights and a re-rolled head (a
zero head predicts 0 for any context and would make every schedule look
drift-free). No trained weights are in the repository, so it bounds the
divergence the schedule itself introduces through a real network, not
perceptual quality.

One JSON line per schedule: the relative final-latent MSE
``mean((z_sched - z_ref)^2) / mean(z_ref^2)``, the step plan, and the
cost relative to the reference in forward units, ``(num_steps + r *
uncond_evals) / (BENCH_STEPS (1 + r))``. ``r`` is the uncond forward's
time over the cond decode's, measured in the run on its device (the
medians of a few timed calls) and printed first on a line of its own
beside the card's name and power limit.

    python -m video_gpt_tpu_torch.scripts.cfg_drift [--device cpu]

Env:
  NUM_LAYERS    default 8 (full depth is not needed for the dynamics)
  BENCH_STEPS   the reference's step count (default 10)
  SCHEDULES     ';'-separated specs, each ','-separated key=val with keys
                steps, shift, ival (lo:hi or none), k, e.g.
                "ival=0.15:0.7,k=2;steps=8,shift=1.0,ival=0.15:0.7"
                (missing keys: steps=BENCH_STEPS, shift=1, no interval,
                k=1). Default: :data:`DEFAULT_SWEEP`.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from ..config import ModelConfig, SchedulerConfig
from ..layout import decode_rank, frame_block_inference_layout, \
    tokens_per_frame
from ..models.video_gpt import Batch, VideoGPT, decode_mask
from ..sampling.pipeline import resolve_device
from ..sampling.scheduler import sample_separate_cfg, step_kinds

N_CLEAN, N_GEN, H, W = 8, 16, 176, 320
CFG_SCALE = 1.5
STEPS = int(os.environ.get("BENCH_STEPS", 10))
NUM_LAYERS = int(os.environ.get("NUM_LAYERS", 8))
DEFAULT_SWEEP = (
    # interval-only rows
    "ival=0.15:0.7;ival=0.0:0.75;ival=0.2:0.6;"
    # uncond-refresh on top of the serving interval
    "ival=0.15:0.7,k=2;ival=0.15:0.7,k=3;k=2;k=3;"
    # fewer-step schedules
    "steps=8;steps=8,ival=0.15:0.7;steps=8,ival=0.15:0.7,k=2;"
    "steps=6;steps=6,ival=0.15:0.7;steps=6,shift=1.5,ival=0.15:0.7;"
    "steps=5,ival=0.15:0.7;steps=5,shift=1.5,ival=0.15:0.7;"
    # fewer steps with uncond refresh (no interval)
    "steps=8,k=2;steps=8,k=3;steps=6,k=2;steps=6,k=3;steps=6,shift=1.5,k=2;"
    "steps=5,k=2;steps=5,k=3"
)
SCHEDULES = os.environ.get("SCHEDULES", DEFAULT_SWEEP)
# timed calls of each forward for the uncond / cond ratio (after a warm-up)
RATIO_CALLS = 5
KIND_CHARS = {"cfg": "G", "cfg_reuse": "r", "cond": "."}


def parse_schedule(spec: str) -> SchedulerConfig:
    steps, shift, ival, k = STEPS, 1.0, None, 1
    for part in spec.split(","):
        key, _, val = part.strip().partition("=")
        if key == "steps":
            steps = int(val)
        elif key == "shift":
            shift = float(val)
        elif key == "ival":
            ival = (None if val in ("none", "") else
                    tuple(float(x) for x in val.split(":")))
        elif key == "k":
            k = int(val)
        elif key:
            raise ValueError(f"unknown schedule key {key!r} in {spec!r}")
    return SchedulerConfig(num_steps=steps, time_shifting_factor=shift,
                           prediction_type="x1", cfg_interval=ival,
                           uncond_refresh=k)


def drift_model(cfg: ModelConfig, device, dtype: torch.dtype,
                seed: int = 2) -> VideoGPT:
    """Random weights from ``seed``, the head (``final_layer``) re-rolled
    at N(0, 0.05) as the JAX script re-rolls it."""
    model = VideoGPT(cfg, device="meta", dtype=dtype).to_empty(device=device)
    gen = torch.Generator(device).manual_seed(seed)
    model.init_random_(gen)
    with torch.no_grad():
        for p in model.final_layer.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    return model.eval()


class Clip(NamedTuple):
    """The flagship clip's two contexts: the cond row over its cached
    clean prefix, the uncond row over the noisy tail alone."""

    batch_c: Batch
    batch_u: Batch
    tail: int
    prefix: int
    size: tuple  # (h, w) of a frame

    @classmethod
    def build(cls, n_clean: int, n_gen: int, h: int, w: int,
              device) -> "Clip":
        n = tokens_per_frame(h, w)
        lay_c = frame_block_inference_layout(n_clean, n_gen, n,
                                             use_cfg=False)
        lay_u = frame_block_inference_layout(0, n_gen, n, use_cfg=False)
        tail = lay_c.noisy_tail_len()
        if decode_rank(lay_c, tail) is None:
            raise ValueError("the cond row's layout has no columnar mask")
        return cls(Batch.from_layout(lay_c, device),
                   Batch.from_layout(lay_u, device), tail,
                   lay_c.length - tail, (h, w))


def denoisers(model: VideoGPT, clip: Clip, clean: torch.Tensor):
    """(cond, uncond) forwards of ``clip``: the cond decode over the
    prefill's cache, the uncond row over its own tokens."""
    cache = model.prefill(clip.batch_c, clean, clip.prefix)
    bias_c = decode_mask(clip.batch_c.meta.tail(clip.tail), clip.batch_c.meta)
    bias_u = decode_mask(clip.batch_u.meta, clip.batch_u.meta)

    def cond(z, t):
        return model.decode(clip.batch_c, z, t, cache, clip.tail, bias=bias_c)

    def uncond(z, t):
        return model(clip.batch_u, z, t, bias=bias_u)

    return cond, uncond


@torch.no_grad()
def final_latents(model: VideoGPT, clip: Clip, clean: torch.Tensor,
                  z0: torch.Tensor, sched: SchedulerConfig,
                  cfg_scale: float = CFG_SCALE) -> torch.Tensor:
    """The clip's final latents under ``sched``, fp32 on the host."""
    cond, uncond = denoisers(model, clip, clean)
    z = sample_separate_cfg(z0, lambda z, t: (cond(z, t), uncond(z, t)),
                            sched, cfg_scale, denoise_cond_fn=cond)
    return z.float().cpu()


def _median_ms(fn: Callable[[], object], device: torch.device) -> float:
    fn()
    times = []
    for _ in range(RATIO_CALLS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@torch.no_grad()
def uncond_over_cond(model: VideoGPT, clip: Clip, clean: torch.Tensor,
                     z0: torch.Tensor) -> Dict[str, float]:
    """The medians of a timed uncond forward and a timed cond decode on
    the model's device, and their ratio (the uncond forward's share of
    a guided step's cost, in cond-decode units)."""
    cond, uncond = denoisers(model, clip, clean)
    t = torch.full((z0.shape[0],), 0.5, device=z0.device, dtype=z0.dtype)
    device = z0.device
    cond_ms = _median_ms(lambda: cond(z0, t), device)
    uncond_ms = _median_ms(lambda: uncond(z0, t), device)
    return dict(uncond_ms=uncond_ms, cond_ms=cond_ms,
                uncond_over_cond=uncond_ms / cond_ms)


def drift_record(spec: str, sched: SchedulerConfig, out: torch.Tensor,
                 ref: torch.Tensor, ratio: float,
                 ref_steps: int = STEPS) -> dict:
    """One schedule's line, unrounded."""
    kinds = step_kinds(sched)
    n_uncond = sum(k == "cfg" for k in kinds)
    mse = float(((out - ref) ** 2).mean())
    return {
        "schedule": spec.strip(),
        "num_steps": sched.num_steps,
        "time_shift": sched.time_shifting_factor,
        "cfg_interval": sched.cfg_interval,
        "uncond_refresh": sched.uncond_refresh,
        "steps_guided": int(sum(k != "cond" for k in kinds)),
        "uncond_evals": int(n_uncond),
        "rel_cost": (sched.num_steps + ratio * n_uncond)
        / (ref_steps * (1.0 + ratio)),
        "rel_final_latent_mse": mse / float((ref ** 2).mean()),
        "kinds": "".join(KIND_CHARS[k] for k in kinds),
    }


def sweep(model: VideoGPT, clip: Clip, clean: torch.Tensor,
          z0: torch.Tensor, specs: List[str], ratio: float,
          ref_steps: int = STEPS) -> List[dict]:
    """Every schedule of ``specs`` against the reference schedule
    (``ref_steps`` steps, guidance at each)."""
    ref = final_latents(model, clip, clean, z0,
                        SchedulerConfig(num_steps=ref_steps,
                                        prediction_type="x1"))
    out = []
    for spec in specs:
        if spec.strip():
            sched = parse_schedule(spec)
            out.append(drift_record(spec, sched, final_latents(
                model, clip, clean, z0, sched), ref, ratio, ref_steps))
    return out


def printed(rec: dict) -> dict:
    """A record as the JAX script prints it (cost to 4 places, MSE to
    6)."""
    return dict(rec, rel_cost=round(rec["rel_cost"], 4),
                rel_final_latent_mse=round(rec["rel_final_latent_mse"], 6))


def card_name(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def inputs(cfg: ModelConfig, clip: Clip, dtype: torch.dtype,
           seed: int = 0):
    """(clean latents, z0) drawn on the host from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    n_gen, n_clean = clip.batch_c.noisy_gather.shape[0], \
        clip.batch_c.clean_gather.shape[0]
    h, w = clip.size
    hl, wl, c = h // 8, w // 8, cfg.in_channels
    z0 = torch.randn((n_gen, hl, wl, c), generator=gen)
    clean = torch.randn((n_clean, hl, wl, c), generator=gen)
    device = clip.batch_c.input_ids.device
    return clean.to(device, dtype), z0.to(device, dtype)


def run(device="cuda", num_layers: int = NUM_LAYERS,
        schedules: str = SCHEDULES,
        log: Optional[Callable[[str], None]] = print) -> dict:
    """The whole measurement in bf16: the ratio line, then a line per
    schedule. Returns {"ratio": ..., "records": [...]} (unrounded)."""
    device = resolve_device(device)
    cfg = ModelConfig(num_layers=num_layers)
    model = drift_model(cfg, device, torch.bfloat16)
    clip = Clip.build(N_CLEAN, N_GEN, H, W, device)
    clean, z0 = inputs(cfg, clip, torch.bfloat16)
    ratio = dict(uncond_over_cond(model, clip, clean, z0),
                 num_layers=num_layers, device=card_name(device))
    log(json.dumps({"uncond_over_cond": ratio}))
    records = sweep(model, clip, clean, z0, schedules.split(";"),
                    ratio["uncond_over_cond"])
    for rec in records:
        log(json.dumps(printed(rec)))
    return {"ratio": ratio, "records": records}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    run(args.device)


if __name__ == "__main__":
    main()
