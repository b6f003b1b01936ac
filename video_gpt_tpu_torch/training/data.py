"""Collation: clip samples -> fixed-shape training batches.

Port of ``video_gpt_tpu/training/data.py``. Every batch of one (rows,
frames, resolution) signature has the same shapes: the sequence is padded
to the worst-case frame-block layout and the clean-frame side to its
largest count. The JAX package needs that for one compile; the port keeps
it so a run's memory does not vary from step to step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..layout import RowSpec, build_layout
from ..models.video_gpt import Batch
from .loss import LossInputs


def to_device(batch, device):
    """A batch (nested NamedTuples of tensors) with every tensor moved to
    ``device``."""
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    if isinstance(batch, tuple):
        return type(batch)(*(to_device(x, device) for x in batch))
    return batch


class TrainBatch(NamedTuple):
    inputs: LossInputs           # x1 / clean_latents None until encoded
    pixels: torch.Tensor         # [B*F, H, W, 3] in [-1, 1]
    noisy_sel: torch.Tensor      # [Nn] -> row-major frame index into pixels
    clean_sel: torch.Tensor      # [Nc_max] (padded entries point at frame 0)
    clean_valid: torch.Tensor    # [Nc_max] 1.0 for real clean frames

    def to(self, device) -> "TrainBatch":
        """Every tensor of the batch moved to ``device``."""
        return to_device(self, device)


def _round_up(n: int, multiple: int) -> int:
    return n + -n % multiple


def collate(samples: Sequence, n_img: int, sp_multiple: int = 1,
            cls_weight: Optional[float] = None,
            uncond: bool = False) -> TrainBatch:
    """``samples``: ClipSamples sharing frame count and resolution. The
    batch is made on the host (:meth:`TrainBatch.to` moves it).
    ``sp_multiple`` (the mesh's seq axis) pads every token layout to a
    multiple of it.

    ``uncond=True`` also builds the unconditional branch of guidance
    distillation (``inputs.batch_uncond``): the 'uncond' layout scheme,
    same rows and blocks, noisy frames only in the same order, padded to
    F (n_img + 2) whatever the block partition."""
    F = samples[0].pixels.shape[0]
    B = len(samples)
    seg = n_img + 2
    # worst case: all but the last block doubled
    pad_to = _round_up(2 * F * seg, sp_multiple)
    layout = build_layout([RowSpec(tuple(s.frame_blocks), "training")
                           for s in samples], n_img,
                          pad_to_multiple=sp_multiple, pad_to=pad_to)
    batch_uncond = None
    if uncond:
        layout_u = build_layout([RowSpec(tuple(s.frame_blocks), "uncond")
                                 for s in samples], n_img,
                                pad_to_multiple=sp_multiple,
                                pad_to=_round_up(F * seg, sp_multiple))
        if layout_u.num_noisy_frames != layout.num_noisy_frames:
            raise ValueError("the uncond layout's noisy frames differ")
        batch_uncond = Batch.from_layout(layout_u, "cpu")
    nn_ = layout.num_noisy_frames
    if nn_ != B * F:
        raise ValueError(f"{nn_} noisy frames for {B} rows of {F}")
    nc_max = max(B * (F - 1), 1)
    nc = layout.num_clean_frames

    noisy_sel = layout.noisy_frame_row * F + layout.noisy_video_frame
    clean_sel = np.zeros((nc_max,), np.int32)
    clean_valid = np.zeros((nc_max,), np.float32)
    clean_sel[:nc] = layout.clean_frame_row * F + layout.clean_video_frame
    clean_valid[:nc] = 1.0
    clean_gather = np.zeros((nc_max, n_img), np.int32)
    clean_gather[:nc] = layout.clean_gather
    layout.clean_gather = clean_gather  # fixed-shape view

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    frame_weights = None
    if cls_weight is not None:
        # up-weight the first frame of each clip
        frame_weights = t(np.where(layout.noisy_video_frame == 0, cls_weight,
                                   1.0).astype(np.float32))
    inputs = LossInputs(
        batch=Batch.from_layout(layout, "cpu"),
        x1=None, clean_latents=None,
        noisy_frame_row=t(layout.noisy_frame_row),
        noisy_frame_block=t(layout.noisy_frame_block),
        frame_weights=frame_weights, clean_weights=t(clean_valid),
        batch_uncond=batch_uncond)
    pixels = np.concatenate([s.pixels for s in samples], axis=0)
    return TrainBatch(inputs=inputs, pixels=t(pixels),
                      noisy_sel=t(noisy_sel.astype(np.int32)),
                      clean_sel=t(clean_sel), clean_valid=t(clean_valid))
