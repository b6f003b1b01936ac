"""Flow-matching training loss (x1-prediction with noisy conditioning).

Port of ``video_gpt_tpu/training/loss.py``:

- rectified-flow interpolation x_t = t*x1 + (1-t)*x0 with target x1
  (t == 1 is clean);
- one timestep per frame-block, shared by the block's frames (the stage-1
  interleaved recipe is the case of blocks of one frame);
- conditioning frames get low noise: t_input ~ U[input_noise, 1];
- optional first-frame weighting (``frame_weights``) and the higher-order
  loss rescale (``order != 2``);
- ``prediction_target='velocity'`` (the image family's target x1 - x0);
- ``input_output_return``: the aux input-reconstruction loss over the
  clean frames, averaged with the per-frame losses over every frame;
  ``clean_weights`` drops the clean slots that only pad a shape.

The JAX package draws x0, the timestep table, x0c and t_input from one
PRNG key. The port takes them as a :class:`LossDraws`, drawn from a
``torch.Generator`` by :func:`draw_loss_noise` or built by a caller (a test
hands both sides the same numbers). A data rank of a mesh draws the global
batch's numbers and keeps its part (:class:`DrawPart`), so its step
computes what one rank computes on the global batch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.video_gpt import Batch
from ..sampling.scheduler import add_noise_x1


class LossInputs(NamedTuple):
    """One training example of static shape (built by training/data.py from
    a layout and the VAE-encoded frames)."""

    batch: Batch
    x1: torch.Tensor                 # [Nn, hl, wl, C] target latents
    clean_latents: torch.Tensor      # [Nc, hl, wl, C]
    noisy_frame_row: torch.Tensor    # [Nn] int32
    noisy_frame_block: torch.Tensor  # [Nn] int32
    frame_weights: Optional[torch.Tensor] = None  # [Nn] loss weights
    # [Nc] 1.0 for real clean frames, 0.0 for shape-padding slots
    clean_weights: Optional[torch.Tensor] = None
    # the unconditional branch of guidance distillation ('uncond' scheme:
    # same rows and blocks, noisy frames only, the same noisy order)
    batch_uncond: Optional[Batch] = None


class LossDraws(NamedTuple):
    """The loss's random numbers, all fp32 on the inputs' device."""

    x0: torch.Tensor       # [Nn, hl, wl, C] standard normal
    t_table: torch.Tensor  # [rows, max_blocks] uniform
    x0c: torch.Tensor      # [Nc, hl, wl, C] standard normal
    t_clean: torch.Tensor  # [Nc] uniform


class DrawPart(NamedTuple):
    """Where a data rank's batch sits in the global batch: the (first,
    global count) of its noisy frames, of its rows and of its clean slots
    (row-major in both, as ``collate`` lays them out)."""

    noisy: Tuple[int, int]
    rows: Tuple[int, int]
    clean: Tuple[int, int]


def whole_part(inputs: LossInputs) -> DrawPart:
    """The :class:`DrawPart` of a batch that is the whole global batch."""
    return DrawPart((0, inputs.x1.shape[0]),
                    (0, inputs.batch.input_ids.shape[0]),
                    (0, inputs.clean_latents.shape[0]))


def draw_loss_noise(generator: torch.Generator, inputs: LossInputs,
                    max_blocks: int, part: Optional[DrawPart] = None
                    ) -> LossDraws:
    """Draw :class:`LossDraws` from ``generator`` (on the inputs' device);
    with ``part``, the global batch's draws, and keep this rank's
    (:func:`take_part`)."""
    dev = inputs.x1.device
    g = part or whole_part(inputs)
    draws = LossDraws(
        x0=torch.randn((g.noisy[1],) + inputs.x1.shape[1:],
                       generator=generator, device=dev),
        t_table=torch.rand((g.rows[1], max_blocks), generator=generator,
                           device=dev),
        x0c=torch.randn((g.clean[1],) + inputs.clean_latents.shape[1:],
                        generator=generator, device=dev),
        t_clean=torch.rand((g.clean[1],), generator=generator, device=dev))
    return take_part(draws, part, inputs)


def take_part(draws, part: Optional[DrawPart], inputs: LossInputs):
    """This data rank's part (``part``; None: all) of the global batch's
    ``draws``, for its batch ``inputs``: a :class:`LossDraws`, or any
    draws of its layout (per noisy frame, per row, per clean slot twice;
    ``distill.DistillDraws``)."""
    if part is None:
        return draws
    nn_, nc = inputs.x1.shape[0], inputs.clean_latents.shape[0]
    rows = inputs.batch.input_ids.shape[0]
    (n0, _), (r0, _), (c0, _) = part
    x0, per_row, x0c, t_clean = draws
    return type(draws)(x0[n0:n0 + nn_], per_row[r0:r0 + rows],
                       x0c[c0:c0 + nc], t_clean[c0:c0 + nc])


def sample_block_timesteps(t_table: torch.Tensor, frame_row: torch.Tensor,
                           frame_block: torch.Tensor) -> torch.Tensor:
    """One t per (row, block) from the drawn table, gathered per frame:
    frames of the same block share their timestep."""
    return t_table[frame_row.long(), frame_block.long()]


def training_loss(model, inputs: LossInputs, draws: LossDraws,
                  input_noise: float = 0.9, order: int = 2,
                  prediction_target: str = "x1",
                  input_output_return: bool = False,
                  denominator: Optional[torch.Tensor] = None,
                  apply_fn=None):
    """(scalar loss, aux dict with the per-frame losses) of ``model`` on
    ``inputs`` with the random numbers ``draws``. The forward runs under
    the caller's autocast; the loss is taken in fp32.
    ``prediction_target`` is ``'x1'`` (the video path) or ``'velocity'``
    (the image family: x1 - x0). ``input_output_return`` adds the aux
    head's reconstruction loss of the clean frames (the model must carry
    ``input_head``): loss = (sum per_frame + sum per_clean) / (Nn +
    n_clean), with n_clean the real clean frames of ``clean_weights``.
    ``apply_fn`` replaces ``model``'s forward, with its signature (the
    GPipe trunk, ``parallel.pipeline.pp_apply``)."""
    x1, clean = inputs.x1, inputs.clean_latents
    x0 = draws.x0.to(x1.dtype)
    t = sample_block_timesteps(draws.t_table, inputs.noisy_frame_row,
                               inputs.noisy_frame_block)
    xt = add_noise_x1(x1, x0, t)
    if clean.shape[0] > 0:
        t_in = input_noise + (1.0 - input_noise) * draws.t_clean
        clean_in = add_noise_x1(clean, draws.x0c.to(clean.dtype), t_in)
    else:
        clean_in = clean

    call = model if apply_fn is None else apply_fn
    if input_output_return:
        pred, clean_pred = call(inputs.batch, xt, t, clean_in,
                                input_output_return=True)
    else:
        pred = call(inputs.batch, xt, t, clean_in)

    target = x1 if prediction_target == "x1" else x1 - x0
    diff = target.float() - pred.float()
    err = (diff ** order).reshape(diff.shape[0], -1)
    per_frame = err.mean(-1)  # [Nn]
    if order != 2:
        # rescale each frame's higher-order loss to the squared loss's
        # magnitude, the scale detached: mean(err2_i) / mean(err_order_i)
        per_frame2 = (diff ** 2).reshape(diff.shape[0], -1).mean(-1)
        scale = (per_frame2 / torch.where(per_frame == 0.0,
                                          torch.ones_like(per_frame),
                                          per_frame)).detach()
        per_frame = scale * per_frame
    if inputs.frame_weights is not None:
        per_frame = per_frame * inputs.frame_weights
    aux = {"per_frame_loss": per_frame}
    if not input_output_return:
        return per_frame.mean(), aux
    cerr = (clean.float() - clean_pred.float()) ** 2
    per_clean = cerr.reshape(cerr.shape[0], -1).mean(-1)
    if inputs.clean_weights is not None:
        w = inputs.clean_weights.float()
        per_clean = per_clean * w
        n_clean = torch.clamp(w.sum(), min=1.0)
    else:
        n_clean = per_clean.shape[0]
    aux["input_loss"] = per_clean
    if denominator is None:
        denominator = per_frame.shape[0] + n_clean
    return (per_frame.sum() + per_clean.sum()) / denominator, aux
