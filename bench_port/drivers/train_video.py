"""Video-GPT pretraining: ``Trainer.train_step`` on one stage's clips.

Traffic (the cell's ``traffic``): ``stage`` (the program's curriculum
recipe), ``frames``, ``frame_blocks`` (the block partition of every row,
fixed for the cell so that every run does the same work), ``rows``,
``height`` / ``width`` and ``optimizer``. Each step's clip pixels are new,
made on the device from (seed, step). One step is one unit.
"""
from __future__ import annotations

import numpy as np
import torch

from bench_port import flops
from bench_port.harness import program
from bench_port.harness.training import TrainCell, frame_pixels
from bench_port.reference.layout import RowSpec, build_layout
from bench_port.reference.model import vae_encode
from bench_port.reference.train import StepData


class VideoTrainCell(TrainCell):
    target = "x1"

    def setup_traffic(self):
        t = self.ctx.traffic
        self.frames, self.rows = t["frames"], t["rows"]
        self.hw = (t["height"], t["width"])
        self.blocks = tuple(t["frame_blocks"])
        self.n_img = (self.hw[0] // 16) * (self.hw[1] // 16)
        self.layout = build_layout(
            [RowSpec(self.blocks, "training")] * self.rows, self.n_img,
            pad_to=2 * self.frames * (self.n_img + 2))
        self.work = flops.train_step(
            self.arch, self.layout, self.n_img, self.layout.num_clean_frames,
            self.arch["precompute_bias_limit"])
        self.tokens = self.work["tokens"]

    def make_trainer(self, sd, vsd):
        from video_gpt_tpu_torch.config import stage_config
        from video_gpt_tpu_torch.data.video import ClipSample
        from video_gpt_tpu_torch.training.data import collate
        from video_gpt_tpu_torch.training.trainer import Trainer
        t = self.ctx.traffic
        o = t["optimizer"]
        tcfg = stage_config(
            t["stage"], frame_num=self.frames, batch_size_per_device=self.rows,
            lr=o["lr"], lr_scheduler="constant", adam_beta1=o["beta1"],
            adam_beta2=o["beta2"], adam_epsilon=o["eps"],
            adam_weight_decay=o["weight_decay"],
            max_grad_norm=o["max_grad_norm"], input_noise=o["input_noise"],
            mixed_precision=t["mixed_precision"])
        trainer = Trainer(program.model_config(self.ctx.config), tcfg, None,
                          program.vae_config(self.ctx.config),
                          vae_state_dict=vsd, init_state_dict=sd,
                          target_resolution=self.hw, device=self.device,
                          seed=self.ctx.seed)
        # the program's collate of the cell's fixed layout; each step
        # brings new pixels
        dummy = np.zeros((self.frames, 1, 1, 3), np.float32)
        self.template = collate([ClipSample(dummy, self.blocks)] * self.rows,
                                self.n_img).to(self.device)
        return trainer

    def pixels(self, step: int) -> torch.Tensor:
        return frame_pixels(self.ctx.seed, f"clip{step}",
                            self.rows * self.frames, *self.hw, self.device)

    def batch(self, step: int):
        return self.template._replace(pixels=self.pixels(step))

    def reference_step(self, step: int, V: dict, prec) -> StepData:
        lay, F = self.layout, self.frames
        gen = torch.Generator(self.device).manual_seed(
            program.step_generator_seed(self.ctx.seed, step))
        pix = self.pixels(step)
        hl, wl, c = self.hw[0] // 8, self.hw[1] // 8, self.arch["in_channels"]
        # the trainer's draws, in its order and dtypes: the posterior in
        # the compute dtype, then the loss's fp32 draws
        enc = torch.randn((pix.shape[0], hl, wl, c), generator=gen,
                          device=self.device, dtype=self.compute_dtype)
        with torch.no_grad():
            lat = vae_encode(V, self.vae, prec, pix, enc)
        nn_ = lay.num_noisy_frames
        slots = max(self.rows * (F - 1), 1)
        x0 = torch.randn((nn_, hl, wl, c), generator=gen, device=self.device)
        t_table = torch.rand((self.rows, F), generator=gen,
                             device=self.device)
        x0c = torch.randn((slots, hl, wl, c), generator=gen,
                          device=self.device)
        t_clean = torch.rand((slots,), generator=gen, device=self.device)

        def idx(x):
            return torch.as_tensor(np.asarray(x), device=self.device).long()

        row, blk = idx(lay.noisy_frame_row), idx(lay.noisy_frame_block)
        nsel = row * F + idx(lay.noisy_video_frame)
        nc = lay.num_clean_frames
        csel = idx(lay.clean_frame_row) * F + idx(lay.clean_video_frame)
        return StepData(layout=lay, x1=lat[nsel], clean=(lat[csel],),
                        x0=x0, t=t_table[row, blk], x0c=(x0c[:nc],),
                        t_in=(t_clean[:nc],), frame_row=row)


def build(ctx, with_program: bool = True):
    return VideoTrainCell(ctx, with_program)
