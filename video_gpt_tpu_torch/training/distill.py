"""Progressive step- and guidance distillation of the flow-matching sampler.

Port of ``video_gpt_tpu/training/distill.py``. One round trains a student
to serve at ``S`` Euler steps from a frozen teacher evaluated on the
``S * m``-step grid (Salimans & Ho 2022, adapted to x1-prediction):

- draw a student grid index per (row, frame-block), shared by the block's
  frames, and form ``x_t = sigma_i x1 + (1 - sigma_i) x0``;
- roll the teacher ``m`` Euler substeps from ``sigma_i`` to
  ``sigma_{i+1}`` (fp32, no gradient);
- invert one student Euler step, so that predicting the target lands the
  student where the teacher landed:
  ``target = x_t + (z' - x_t) (1 - s) / (s_next - s)``;
- regress the student's prediction at ``(x_t, sigma_i)`` onto it (per-frame
  MSE in fp32, ``uniform`` or ``endpoint`` weights).

With ``cfg_scale`` w (guidance distillation, Meng et al. 2023) the
teacher's prediction is ``uncond + w (cond - uncond)``, its unconditional
call on ``inputs.batch_uncond`` with no clean latents; the student keeps
its conditional input and serves with no uncond row.

Each layout's attention bias is paid once per step: the conditional
batch's (one ``BiasMap``) feeds the teacher's conditional calls and the
student's forward, recompute and backward; the unconditional batch's feeds
the teacher's unconditional calls.

The JAX package draws x0, the grid-index table, x0c and t_clean from one
PRNG key; the port takes them as a :class:`DistillDraws`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..config import TrainConfig
from ..models.video_gpt import maybe_bias
from ..sampling.scheduler import add_noise_x1, sigma_schedule
from .loss import DrawPart, LossInputs, take_part, whole_part
from .train_state import TrainState, loss_step


class DistillDraws(NamedTuple):
    """The distillation loss's random numbers, on the inputs' device."""

    x0: torch.Tensor       # [Nn, hl, wl, C] fp32 standard normal
    index: torch.Tensor    # [rows, max_blocks] int64 grid index in [0, S)
    x0c: torch.Tensor      # [Nc, hl, wl, C] fp32 standard normal
    t_clean: torch.Tensor  # [Nc] fp32 uniform


def draw_distill_noise(generator: torch.Generator, inputs: LossInputs,
                       max_blocks: int, student_steps: int,
                       part: Optional[DrawPart] = None) -> DistillDraws:
    """Draw :class:`DistillDraws` from ``generator`` (on the inputs'
    device); with ``part``, a data rank's: the global batch's draws, of
    which it keeps its noisy and clean slots and its rows
    (``loss.take_part``), so every data rank draws the numbers one rank
    draws for the global batch."""
    dev = inputs.x1.device
    g = part or whole_part(inputs)
    draws = DistillDraws(
        x0=torch.randn((g.noisy[1],) + inputs.x1.shape[1:],
                       generator=generator, device=dev),
        index=torch.randint(0, student_steps, (g.rows[1], max_blocks),
                            generator=generator, device=dev),
        x0c=torch.randn((g.clean[1],) + inputs.clean_latents.shape[1:],
                        generator=generator, device=dev),
        t_clean=torch.rand((g.clean[1],), generator=generator, device=dev))
    return take_part(draws, part, inputs)


def _per_frame_sigma(sig: torch.Tensor, idx: torch.Tensor, x: torch.Tensor
                     ) -> torch.Tensor:
    """Grid values per frame, shaped to broadcast against ``x``."""
    return sig[idx].float().reshape((-1,) + (1,) * (x.dim() - 1))


@torch.no_grad()
def teacher_rollout(call: Callable, zt: torch.Tensor, clean_in: torch.Tensor,
                    sig_teacher: torch.Tensor, start: torch.Tensor,
                    substeps: int) -> torch.Tensor:
    """``substeps`` Euler steps of the frozen teacher along its sigma grid.

    ``call(z, t, clean)`` is the teacher's prediction; zt [Nn, hl, wl, C]
    are the noisy latents at ``sig_teacher[start]`` (``start`` per frame).
    Integrates in fp32; the x1 -> velocity conversion and the Euler update
    are the sampler's."""
    z = zt.float()
    for j in range(substeps):
        s = _per_frame_sigma(sig_teacher, start + j, z)
        s_next = _per_frame_sigma(sig_teacher, start + j + 1, z)
        t = sig_teacher[start + j].to(zt.dtype)
        pred = call(z.to(zt.dtype), t, clean_in).float()
        v = (pred - z) / (1.0 - s)
        z = z + (s_next - s) * v
    return z


def _forward(module, batch, z, t, clean, bias=None):
    return module(batch, z, t, clean, bias=bias)


def distillation_loss(model, teacher, inputs: LossInputs,
                      draws: DistillDraws, student_steps: int,
                      substeps: int = 2, time_shift: float = 1.0,
                      input_noise: float = 1.0, loss_weight: str = "uniform",
                      cfg_scale: Optional[float] = None,
                      apply_fn: Optional[Callable] = None):
    """(scalar loss, aux with the per-frame losses) of one distillation
    regression step of ``model`` (the student) onto ``teacher`` with the
    random numbers ``draws``. The forwards run under the caller's
    autocast; the targets and the loss are fp32. ``apply_fn(module,
    batch, z, t, clean, bias=)`` replaces the forward of the teacher and
    the student alike (``parallel.pipeline.pp_apply`` on a pipe mesh, each
    model over its own stage's layers). On a mesh the two models are built
    on the same one, and every teacher forward is a sequence of
    collectives that each rank issues in the same order: the rollout's
    substeps, each the conditional then the unconditional call."""
    x1, clean = inputs.x1, inputs.clean_latents
    m = int(substeps)
    sig_t = torch.from_numpy(sigma_schedule(student_steps * m,
                                            time_shift)).to(x1.device)

    # per-(row, block) student grid point, gathered per frame
    i = draws.index[inputs.noisy_frame_row.long(),
                    inputs.noisy_frame_block.long()]
    start = i * m  # teacher grid index of sigma_i
    sigma = sig_t[start]

    xt = add_noise_x1(x1.float(), draws.x0, sigma).to(x1.dtype)

    # conditioning frames: clean at serving unless a robustness noise floor
    # is asked for (pretraining uses U[0.9, 1])
    if clean.shape[0] > 0 and input_noise < 1.0:
        t_in = input_noise + (1.0 - input_noise) * draws.t_clean
        clean_in = add_noise_x1(clean, draws.x0c.to(clean.dtype), t_in)
    else:
        clean_in = clean

    call = apply_fn or _forward
    mesh = model.llm.mesh
    batch = inputs.batch
    bias = maybe_bias(model.cfg, batch.meta, batch.meta, mesh)
    if cfg_scale is not None:
        if inputs.batch_uncond is None:
            raise ValueError("guidance distillation (cfg_scale set) needs "
                             "inputs.batch_uncond: collate with "
                             "uncond=True (training/data.py)")
        batch_u = inputs.batch_uncond
        bias_u = maybe_bias(model.cfg, batch_u.meta, batch_u.meta, mesh)
        empty_clean = clean_in[:0]

        def teacher_call(z, t, cl):
            cond = call(teacher, batch, z, t, cl, bias=bias).float()
            unc = call(teacher, batch_u, z, t, empty_clean,
                       bias=bias_u).float()
            return unc + cfg_scale * (cond - unc)
    else:
        def teacher_call(z, t, cl):
            return call(teacher, batch, z, t, cl, bias=bias)
    z_prime = teacher_rollout(teacher_call, xt, clean_in, sig_t, start, m)

    # invert one student Euler step: predicting `target` at sigma_i lands
    # the student exactly at the teacher's z'
    s = _per_frame_sigma(sig_t, start, xt)
    s_next = _per_frame_sigma(sig_t, start + m, xt)
    xt32 = xt.float()
    target = xt32 + (z_prime - xt32) * (1.0 - s) / (s_next - s)

    pred = call(model, batch, xt, sigma.to(xt.dtype), clean_in,
                bias=bias).float()

    diff = target - pred
    per_frame = (diff ** 2).reshape(diff.shape[0], -1).mean(-1)
    if loss_weight == "endpoint":
        # ((s_next - s) / (1 - s))^2: the MSE between the student's landed
        # one-Euler-step endpoint and the teacher's z'
        w = ((s_next - s) / (1.0 - s)) ** 2
        per_frame = per_frame * w.reshape(-1)
    elif loss_weight != "uniform":
        raise ValueError(f"distill_loss_weight={loss_weight!r} "
                         "(expected 'uniform' or 'endpoint')")
    if inputs.frame_weights is not None:
        per_frame = per_frame * inputs.frame_weights
    return per_frame.mean(), {"per_frame_loss": per_frame}


def distill_optimizer_config(cfg: TrainConfig) -> TrainConfig:
    """The config of the distillation optimizer: ``lr`` is ``distill_lr``
    unless that is None. The student starts near the teacher, and Adam's
    first step moves every parameter by about the learning rate whatever
    the gap, so distillation runs far below the pretraining rate."""
    if cfg.distill_lr is None:
        return cfg
    return dataclasses.replace(cfg, lr=cfg.distill_lr)


def make_distill_train_step(model, teacher, cfg: TrainConfig,
                            apply_fn: Optional[Callable] = None
                            ) -> Callable:
    """``step(state, inputs, draws) -> metrics``: the distillation loss of
    the student ``model`` (``state``'s model, its optimizer built from
    :func:`distill_optimizer_config`) onto the frozen ``teacher``,
    backward, clip, AdamW and the gated EMA of the student, in place
    (``config.check_train_config`` refuses the recipes it does not
    take). ``apply_fn``: :func:`distillation_loss`'s."""

    def step(state: TrainState, inputs: LossInputs, draws: DistillDraws):
        return loss_step(state, lambda: distillation_loss(
            model, teacher, inputs, draws,
            student_steps=cfg.distill_student_steps,
            substeps=cfg.distill_substeps,
            time_shift=cfg.distill_time_shift,
            input_noise=cfg.distill_input_noise,
            loss_weight=cfg.distill_loss_weight,
            cfg_scale=cfg.distill_guidance, apply_fn=apply_fn), cfg,
            inputs.x1.device)

    return step
