"""OmniGen fine-tuning: ``ImageGenTrainer.train_step`` on text + image ->
image rows.

Traffic (the cell's ``traffic``): ``rows`` (the batch), ``output_size`` and
``input_size``, ``max_input_images`` (the collate's clean slots a row),
``pad_to`` (the collate's token length),
``prompts`` (each row's prompt: the text tokens before and after its one
input image, fixed for the cell so that every run does the same work),
``mixed_precision`` and ``optimizer``. Each step's token ids and pixels are
new, made from (seed, step). One step is one unit.
"""
from __future__ import annotations

import numpy as np
import torch

from bench_port import flops
from bench_port.harness import program, weights
from bench_port.harness.training import TrainCell, frame_pixels
from bench_port.reference.image_layout import TextRow, single_shot_layout
from bench_port.reference.model import vae_encode
from bench_port.reference.tokens import DEFAULT_TOKEN_IDS
from bench_port.reference.train import StepData

TEXT_IDS = (100, 32000)  # drawn text ids: ordinary vocabulary entries


class ImageTrainCell(TrainCell):
    target = "velocity"

    def setup_traffic(self):
        t = self.ctx.traffic
        self.rows = t["rows"]
        self.out_hw = tuple(t["output_size"])
        self.in_hw = tuple(t["input_size"])
        self.max_in = t["max_input_images"]
        self.pad_to = t["pad_to"]
        self.n_out = (self.out_hw[0] // 16) * (self.out_hw[1] // 16)
        self.n_region = (self.in_hw[0] // 16) * (self.in_hw[1] // 16)
        self.prompts = [tuple(p) for p in t["prompts"]]
        self.work = flops.train_step(
            self.arch, self.layout_of(0), self.n_out, self.rows,
            self.arch["precompute_bias_limit"])
        self.tokens = self.work["tokens"]

    def make_trainer(self, sd, vsd):
        from video_gpt_tpu_torch.config import TrainConfig
        from video_gpt_tpu_torch.training.image_trainer import ImageGenTrainer
        t = self.ctx.traffic
        o = t["optimizer"]
        tcfg = TrainConfig(
            batch_size_per_device=self.rows, lr=o["lr"],
            lr_scheduler="constant", adam_beta1=o["beta1"],
            adam_beta2=o["beta2"], adam_epsilon=o["eps"],
            adam_weight_decay=o["weight_decay"],
            max_grad_norm=o["max_grad_norm"], input_noise=o["input_noise"],
            mixed_precision=t["mixed_precision"])
        return ImageGenTrainer(
            program.model_config(self.ctx.config), tcfg, None, None, None,
            output_size=self.out_hw, input_size=self.in_hw,
            max_input_images=self.max_in, pad_to=self.pad_to,
            vae_cfg=program.vae_config(self.ctx.config), vae_state_dict=vsd,
            init_state_dict=sd, device=self.device, seed=self.ctx.seed)

    # -- traffic -------------------------------------------------------------------

    def text_rows(self, step: int):
        rng = np.random.default_rng(weights.seed_of(self.ctx.seed,
                                                    f"text{step}"))
        slot = DEFAULT_TOKEN_IDS.slot
        rows = []
        for before, after in self.prompts[:self.rows]:
            ids = rng.integers(*TEXT_IDS, size=before + after).tolist()
            rows.append(TextRow(ids[:before] + [slot] * self.n_region
                                + ids[before:],
                                [(before, before + self.n_region)]))
        return rows

    def layout_of(self, step: int):
        return single_shot_layout(self.text_rows(step), self.n_out,
                                  self.n_region, pad_to=self.pad_to)

    def pixels(self, step: int):
        """(output images [B, h, w, 3], the clean slots [B · max_in, h', w',
        3]: each row's input image, then the zero padding slots)."""
        out = frame_pixels(self.ctx.seed, f"out{step}", self.rows,
                           *self.out_hw, self.device)
        inp = frame_pixels(self.ctx.seed, f"in{step}", self.rows,
                           *self.in_hw, self.device)
        slots = torch.zeros((self.rows * self.max_in,) + inp.shape[1:],
                            device=self.device)
        slots[:self.rows] = inp
        return out, slots

    def batch(self, step: int):
        from video_gpt_tpu_torch.data.image_text import (ImageGenSample,
                                                         collate_image_gen)
        blank_out = np.broadcast_to(np.float32(0), self.out_hw + (3,))
        blank_in = np.broadcast_to(np.float32(0), self.in_hw + (3,))
        samples = [ImageGenSample(r, [blank_in], blank_out)
                   for r in self.text_rows(step)]
        tb = collate_image_gen(samples, self.pad_to, self.max_in)
        out, slots = self.pixels(step)
        return tb._replace(out_pixels=out, in_pixels=slots).to(self.device)

    def reference_step(self, step: int, V: dict, prec) -> StepData:
        lay = self.layout_of(step)
        gen = torch.Generator(self.device).manual_seed(
            program.step_generator_seed(self.ctx.seed, step))
        out, slots = self.pixels(step)
        c = self.arch["in_channels"]

        def posterior(px):
            shape = (px.shape[0], px.shape[1] // 8, px.shape[2] // 8, c)
            noise = torch.randn(shape, generator=gen, device=self.device,
                                dtype=self.compute_dtype)
            with torch.no_grad():
                return vae_encode(V, self.vae, prec, px, noise)

        # the trainer's draws, in its order: the output images' posterior,
        # the input slots', then the loss's
        x1, clean = posterior(out), posterior(slots)
        x0 = torch.randn(x1.shape, generator=gen, device=self.device)
        t_table = torch.rand((self.rows, 1), generator=gen,
                             device=self.device)
        x0c = torch.randn(clean.shape, generator=gen, device=self.device)
        t_clean = torch.rand((clean.shape[0],), generator=gen,
                             device=self.device)
        row = torch.as_tensor(lay.noisy_frame_row, device=self.device).long()
        nc = lay.num_clean_frames
        return StepData(layout=lay, x1=x1, clean=(clean[:nc],), x0=x0,
                        t=t_table[row, 0], x0c=(x0c[:nc],),
                        t_in=(t_clean[:nc],), frame_row=row)


def build(ctx, with_program: bool = True):
    return ImageTrainCell(ctx, with_program)
