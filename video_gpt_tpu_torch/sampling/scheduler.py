"""Flow-matching Euler sampler.

Port of ``video_gpt_tpu/sampling/scheduler.py``; its ``lax.scan`` over the
sigma grid is a Python loop here. Semantics:

- time-shifted grid  sigma = t / (t + s - s*t)  over linspace(0, 1, steps+1)
- x1-prediction -> velocity  (pred - z) / (1 - sigma)
- CFG: uncond + scale * (cond - uncond)
- Euler update  z += (sigma_next - sigma) * v, integrated in fp32

``add_noise_x1`` is the training loss's interpolation. Each denoise step
is the span ``vgt.sampler.step`` (``utils.profiling.annotate``): the model
calls nest in it, and its own kernels are the guidance mix and the Euler
update.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SchedulerConfig
from ..utils.profiling import annotate

STEP_SPAN = "vgt.sampler.step"


def sigma_schedule(num_steps: int, time_shifting_factor: float = 1.0,
                   begin_time: Optional[float] = None) -> np.ndarray:
    """[num_steps + 1] float32 sigma grid."""
    t = np.linspace(0.0 if begin_time is None else begin_time, 1.0,
                    num_steps + 1, dtype=np.float64)
    s = time_shifting_factor
    t = t / (t + s - s * t)
    return t.astype(np.float32)


def cfg_mix(pred: torch.Tensor, scale: float) -> torch.Tensor:
    """First half = cond, second half = uncond (frame-major). Returns the
    guided prediction broadcast back to both halves."""
    cond, uncond = pred.chunk(2, dim=0)
    guided = uncond + scale * (cond - uncond)
    return torch.cat([guided, guided], dim=0)


def cfg_step_flags(cfg: SchedulerConfig) -> Tuple[bool, ...]:
    """Per-step guidance flags: guided where sigma is in
    ``cfg.cfg_interval``; every step when it is None."""
    if cfg.cfg_interval is None:
        return (True,) * cfg.num_steps
    lo, hi = cfg.cfg_interval
    grid = sigma_schedule(cfg.num_steps, cfg.time_shifting_factor,
                          cfg.begin_time)
    return tuple(bool(lo <= s < hi) for s in grid[:cfg.num_steps])


def step_kinds(cfg: SchedulerConfig) -> Tuple[str, ...]:
    """Per-step evaluation plan of the separate-CFG sampler: ``'cond'``
    (outside the guidance interval: conditional context only), ``'cfg'``
    (both contexts) or ``'cfg_reuse'`` (conditional context, guided by the
    last unconditional prediction; ``uncond_refresh > 1``)."""
    return _kinds_from_flags(cfg_step_flags(cfg), cfg.uncond_refresh)


def _kinds_from_flags(guided: Tuple[bool, ...], k: int) -> Tuple[str, ...]:
    k = max(int(k or 1), 1)
    kinds = []
    since_eval = None  # guided steps since the last uncond evaluation
    for g in guided:
        if not g:
            kinds.append("cond")
            # re-entering guidance must evaluate fresh, never reuse an
            # uncond prediction cached many sigmas earlier
            since_eval = None
        elif since_eval is None or since_eval >= k:
            kinds.append("cfg")
            since_eval = 1
        else:
            kinds.append("cfg_reuse")
            since_eval += 1
    return tuple(kinds)


def _euler(cfg: SchedulerConfig, sigmas: np.ndarray, z: torch.Tensor,
           i: int, pred: torch.Tensor) -> torch.Tensor:
    """One Euler step with the fp32 prediction ``pred``; z keeps its dtype.
    The sigma arithmetic is float32, as on the TPU."""
    zf = z.float()
    v = (pred - zf) / float(np.float32(1.0) - sigmas[i]) \
        if cfg.prediction_type == "x1" else pred
    return (zf + float(sigmas[i + 1] - sigmas[i]) * v).to(z.dtype)


def add_noise_x1(x1: torch.Tensor, x0: torch.Tensor, t: torch.Tensor
                 ) -> torch.Tensor:
    """Rectified-flow interpolation x_t = t*x1 + (1-t)*x0 with one t per
    leading index; t == 1 is clean."""
    t = t.reshape((-1,) + (1,) * (x1.dim() - 1)).to(x1.dtype)
    return t * x1 + (1.0 - t) * x0


def _timesteps(z: torch.Tensor, sigma: np.float32) -> torch.Tensor:
    return torch.full((z.shape[0],), float(sigma), dtype=z.dtype,
                      device=z.device)


def sample(z0: torch.Tensor,
           denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
           cfg: SchedulerConfig, use_cfg: bool = False,
           cfg_scale: float = 1.0,
           guidance_fn: Optional[Callable[[torch.Tensor], torch.Tensor]]
           = None) -> torch.Tensor:
    """Run the Euler ODE from noise to clip latents. ``denoise_fn(z, t)``
    returns the model prediction (t is [N]); with ``use_cfg`` the first half
    of z is the conditional copy and must equal the second half, and the
    guidance mixes the halves (``guidance_fn``, default :func:`cfg_mix` at
    ``cfg_scale``: any row split, such as the image path's 3-way one)."""
    sigmas = sigma_schedule(cfg.num_steps, cfg.time_shifting_factor,
                            cfg.begin_time)
    guide = guidance_fn if guidance_fn is not None else (
        lambda v: cfg_mix(v, cfg_scale))
    z = z0
    for i in range(cfg.num_steps):
        with annotate(STEP_SPAN):
            pred = denoise_fn(z, _timesteps(z, sigmas[i])).float()
            if cfg.prediction_type == "x1":
                v = (pred - z.float()) / float(np.float32(1.0) - sigmas[i])
                if use_cfg:
                    v = guide(v)
            else:
                v = guide(pred) if use_cfg else pred
            z = (z.float() + float(sigmas[i + 1] - sigmas[i]) * v).to(
                z.dtype)
    return z


def sample_separate_cfg(
    z0: torch.Tensor,
    denoise_pair_fn: Callable[[torch.Tensor, torch.Tensor],
                              Tuple[torch.Tensor, torch.Tensor]],
    cfg: SchedulerConfig,
    cfg_scale: float,
    denoise_cond_fn: Optional[Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor]] = None,
) -> torch.Tensor:
    """Euler ODE with separate-CFG evaluation: ``denoise_pair_fn(z, t) ->
    (cond, uncond)`` runs the two contexts at their natural lengths.
    ``cfg.cfg_interval`` and ``cfg.uncond_refresh`` select per step what is
    evaluated (:func:`step_kinds`); ``denoise_cond_fn`` evaluates the
    conditional context alone (default: the pair's first half).
    z0: [N, hl, wl, C], one copy."""
    sigmas = sigma_schedule(cfg.num_steps, cfg.time_shifting_factor,
                            cfg.begin_time)

    def eval_cond(z, t):
        if denoise_cond_fn is not None:
            return denoise_cond_fn(z, t)
        return denoise_pair_fn(z, t)[0]

    z = z0
    u_cache = torch.zeros_like(z0)
    for i, kind in enumerate(step_kinds(cfg)):
        with annotate(STEP_SPAN):
            t = _timesteps(z, sigmas[i])
            if kind == "cfg":
                cond, uncond = denoise_pair_fn(z, t)
                u_cache = uncond.to(z0.dtype)
            else:
                cond = eval_cond(z, t)
                uncond = u_cache
            if kind == "cond":
                pred = cond.float()
            else:
                pred = uncond.float() + cfg_scale * (cond.float()
                                                     - uncond.float())
            z = _euler(cfg, sigmas, z, i, pred)
    return z


def sample_separate_multi(
    z0: torch.Tensor,
    denoise_fns: Sequence[Callable[[torch.Tensor, torch.Tensor],
                                   torch.Tensor]],
    combine: Callable[[Sequence[torch.Tensor]], torch.Tensor],
    cfg: SchedulerConfig,
) -> torch.Tensor:
    """Euler ODE where each guidance context evaluates separately at its
    natural length and ``combine(preds) -> pred`` mixes their fp32
    predictions, given in ``denoise_fns`` order with the conditional
    context first (the image path's 2- and 3-way CFG). Per
    :func:`step_kinds`: ``'cond'`` steps evaluate the conditional context
    alone and use its prediction raw; ``'cfg_reuse'`` steps evaluate it
    alone and combine it with the other contexts' last predictions (kept in
    z0's dtype). z0: [N, hl, wl, C], one copy."""
    sigmas = sigma_schedule(cfg.num_steps, cfg.time_shifting_factor,
                            cfg.begin_time)
    z = z0
    cache = [torch.zeros_like(z0) for _ in denoise_fns[1:]]
    for i, kind in enumerate(step_kinds(cfg)):
        with annotate(STEP_SPAN):
            t = _timesteps(z, sigmas[i])
            if kind == "cfg":
                preds = [fn(z, t).float() for fn in denoise_fns]
                cache = [p.to(z0.dtype) for p in preds[1:]]
                pred = combine(preds)
            else:
                cond = denoise_fns[0](z, t).float()
                pred = cond if kind == "cond" else combine(
                    [cond] + [c.float() for c in cache])
            z = _euler(cfg, sigmas, z, i, pred)
    return z
