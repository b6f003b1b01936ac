"""Plain reference of the flow-matching training step and AdamW.

The loss of the published recipes: rectified-flow interpolation x_t = t x1
+ (1 - t) x0 with one t per frame block (shared by the block's frames), the
conditioning frames lightly noised at t_in = a + (1 - a) u, and the mean
over the noisy frames of the per-frame mean squared error against the
target (x1 for Video-GPT, the velocity x1 - x0 for OmniGen). The update is
a global-norm clip followed by AdamW (bias-corrected moments, decoupled
weight decay on every parameter), written out one tensor at a time; the
moments may rest in host memory, where they do not fit beside the fp32
weights, their gradients and the activations on one card.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from .model import Precision, forward


class StepData(NamedTuple):
    """One step's inputs, as the reference works them out."""

    layout: object                  # the reference's own layout
    x1: torch.Tensor                # [Nn, h, w, C] target latents
    clean: Tuple[torch.Tensor, ...]  # clean groups, real frames only
    x0: torch.Tensor                # [Nn, h, w, C] standard normal
    t: torch.Tensor                 # [Nn] the noisy frames' timesteps
    x0c: Tuple[torch.Tensor, ...]   # per clean group, standard normal
    t_in: Tuple[torch.Tensor, ...]  # per clean group, uniform draws
    frame_row: torch.Tensor         # [Nn] the batch row of each frame


class OptConfig(NamedTuple):
    lr: float
    beta1: float
    beta2: float
    eps: float
    weight_decay: float
    max_grad_norm: float
    input_noise: float
    target: str  # 'x1' | 'velocity'


def step_loss(P: dict, arch: dict, prec: Precision, d: StepData,
              opt: OptConfig, rows_kept: int = 0) -> torch.Tensor:
    """The scalar loss of one step. ``rows_kept`` > 0 keeps the frames of
    the first ``rows_kept`` batch rows alone (a fault to plant: part of the
    batch left out, the mean taken over the rest)."""
    t = d.t.float()
    shape = (-1,) + (1,) * (d.x1.dim() - 1)
    xt = t.reshape(shape) * d.x1 + (1.0 - t.reshape(shape)) * d.x0
    clean = []
    for g, x0c, u in zip(d.clean, d.x0c, d.t_in):
        tin = (opt.input_noise + (1.0 - opt.input_noise) * u).reshape(shape)
        clean.append(tin * g + (1.0 - tin) * x0c)
    pred = forward(P, arch, prec, d.layout, xt, t, tuple(clean),
                   recompute=True)
    target = d.x1 if opt.target == "x1" else d.x1 - d.x0
    per_frame = ((target - pred) ** 2).flatten(1).mean(-1)
    if rows_kept:
        per_frame = per_frame[d.frame_row < rows_kept]
    return per_frame.mean()


def train_steps(P: dict, names: Sequence[str], arch: dict, prec: Precision,
                data: Sequence[StepData], opt: OptConfig,
                rows_kept: int = 0, moments: str = "host"
                ) -> Tuple[List[float], Dict[str, float]]:
    """Run the steps of ``data`` on the parameters ``names`` of ``P`` (fp32,
    updated in place). Between steps the moments rest in host memory or,
    with ``moments`` "device", beside the parameters. Returns (each step's
    loss, the first step's clipped gradient norm of each parameter)."""
    params = [P[n].requires_grad_(True) for n in names]
    mu: List = [None] * len(params)
    nu: List = [None] * len(params)
    losses: List[float] = []
    first: Dict[str, float] = {}
    for count, d in enumerate(data, start=1):
        loss = step_loss(P, arch, prec, d, opt, rows_kept)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        norm = float(torch.sqrt(sum(g.double().pow(2).sum() for g in grads)))
        clip = 1.0 if norm < opt.max_grad_norm else opt.max_grad_norm / norm
        if count == 1:
            first = {n: float(torch.linalg.vector_norm(g.double())) * clip
                     for n, g in zip(names, grads)}
        bc1 = 1.0 - opt.beta1 ** count
        bc2 = 1.0 - opt.beta2 ** count
        keep = count < len(data)
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                g = g * clip
                m = (torch.zeros_like(p) if mu[i] is None
                     else mu[i].to(p.device))
                v = (torch.zeros_like(p) if nu[i] is None
                     else nu[i].to(p.device))
                m.mul_(opt.beta1).add_(g, alpha=1.0 - opt.beta1)
                v.mul_(opt.beta2).addcmul_(g, g, value=1.0 - opt.beta2)
                upd = (m / bc1) / ((v / bc2).sqrt() + opt.eps)
                p.sub_(opt.lr * (upd + opt.weight_decay * p))
                if keep:
                    host = moments == "host"
                    mu[i] = m.cpu() if host else m
                    nu[i] = v.cpu() if host else v
        del grads
        if math.isnan(losses[-1]):
            break
    for p in params:
        p.requires_grad_(False)
    return losses, first
