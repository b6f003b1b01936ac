"""Training loop of the image-generation (OmniGen ancestor) family.

Port of ``video_gpt_tpu/training/image_trainer.py``. One step
(:meth:`ImageGenTrainer.train_step`): the VAE encodes the output and the
input images under ``no_grad`` with posterior draws, then
the flow-matching loss on the velocity target (x1 - x0, one block per
row), the backward with per-layer recompute, global-norm clip, AdamW and
the gated EMA of ``training.train_state`` (with ``offload_optimizer``,
the host-offloaded AdamW of ``training.offload`` on one device). Every
random number of step ``i`` comes from one ``torch.Generator`` seeded from
(seed, i). The token
stream of every batch is padded to one length, ``pad_to`` (default
``min(max_input_length_limit, 512 + max_input_images * n_region + 1 +
n_out)``, rounded down to the seq multiple on a mesh, then up to it). Runs
on CUDA unless the caller asks for the CPU. ``mesh_cfg`` trains over data
x seq x tensor ranks as the video ``Trainer`` does (its module docstring;
the ring under ``sp_attention='ring'`` too); a pipe axis is refused, as
the JAX package refuses it.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import MeshConfig, ModelConfig, TrainConfig, check_train_config
from ..data.image_text import (ImageGenTrainBatch, ImageTextDataset,
                               collate_image_gen)
from ..data.prefetch import Prefetcher
from ..image_gen import ImageGenProcessor
from ..models.vae import AutoencoderKL, VAEConfig
from ..models.video_gpt import VideoGPT
from ..parallel.distributed import GracefulShutdown
from ..parallel.mesh import DATA_AXIS, SEQ_AXIS, axis_size, batch_rows, \
    make_mesh
from ..sampling.pipeline import resolve_device
from ..utils import checkpoint as ckpt
from .loss import draw_loss_noise
from .offload import init_offload_training
from .train_state import (TrainState, autocast, init_train_state,
                          make_train_step)
from .trainer import (checkpoint_writer, draw_part, init_model_, new_model,
                      shard_state_dict, write_train_args)


class ImageGenTrainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        json_file: Optional[str],
        image_root: Optional[str],
        tokenizer,
        output_size: Tuple[int, int] = (512, 512),
        input_size: Optional[Tuple[int, int]] = None,
        condition_dropout_prob: float = 0.1,
        max_input_images: int = 3,
        pad_to: Optional[int] = None,
        vae_cfg: VAEConfig = VAEConfig(),
        vae_state_dict: Optional[dict] = None,
        init_state_dict: Optional[dict] = None,
        device="cuda",
        seed: int = 0,
        mesh_cfg: Optional[MeshConfig] = None,
    ):
        """``json_file`` None builds no dataset, for a caller that feeds
        :meth:`train_step` its own batches. Without state dicts the weights
        are random from ``seed`` (the head and the noisy-patch embedder
        zero, as a fresh training model's)."""
        check_train_config(train_cfg)
        self.mesh = None
        if mesh_cfg is not None and mesh_cfg.num_devices > 1:
            if train_cfg.offload_optimizer:
                raise ValueError("offload_optimizer is the single-chip "
                                 "full-depth path; it does not compose "
                                 "with a mesh")
            if mesh_cfg.pipe > 1:
                raise ValueError("pipeline parallelism is wired for the "
                                 "video Trainer; use dp/sp/tensor here")
            self.mesh = make_mesh(mesh_cfg)
        sp = axis_size(self.mesh, SEQ_AXIS)
        if sp > 1:
            model_cfg = dataclasses.replace(
                model_cfg, sp_attention=train_cfg.sp_attention)
        if train_cfg.gradient_checkpointing and not model_cfg.remat:
            model_cfg = dataclasses.replace(model_cfg, remat=True)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.vae_cfg = vae_cfg
        self.device = resolve_device(device)
        self.seed = seed
        self.processor = ImageGenProcessor(tokenizer,
                                           token_ids=model_cfg.token_ids)
        self.output_size = tuple(output_size)
        self.input_size = tuple(input_size or output_size)
        self.max_input_images = max_input_images
        self.dataset = None
        if json_file is not None:
            self.dataset = ImageTextDataset(
                json_file, image_root, self.processor,
                output_size=self.output_size, input_size=self.input_size,
                condition_dropout_prob=condition_dropout_prob,
                max_input_length_limit=train_cfg.max_input_length_limit,
                seed=seed)
        # one token budget: a text allowance, the worst case of image
        # regions, TIME and the output tokens
        n_out = (self.output_size[0] // 16) * (self.output_size[1] // 16)
        n_region = (self.input_size[0] // 16) * (self.input_size[1] // 16)
        limit = train_cfg.max_input_length_limit
        limit -= limit % sp  # Ulysses needs L divisible by the seq axis
        self.pad_to = pad_to if pad_to is not None else min(
            limit, 512 + max_input_images * n_region + 1 + n_out)
        self.pad_to += -self.pad_to % sp
        self._vae_state_dict = vae_state_dict
        self._init_state_dict = init_state_dict
        self.model: Optional[VideoGPT] = None
        self.vae: Optional[AutoencoderKL] = None
        self._step_fn = None

    @property
    def _batch_rows(self) -> int:
        """Global batch rows: rows per rank x the data axis."""
        return self.cfg.batch_size_per_device * axis_size(self.mesh,
                                                          DATA_AXIS)

    @property
    def is_main(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def make_batch(self, index: int) -> ImageGenTrainBatch:
        """This rank's rows of batch ``index`` of the data order, on the
        host; a record's epoch is its visit count, which re-rolls its
        condition dropout."""
        b = self._batch_rows
        n = len(self.dataset)
        samples = [self.dataset.sample((index * b + i) % n,
                                       (index * b + i) // n)
                   for i in range(b)[batch_rows(self.mesh, b)]]
        return collate_image_gen(samples, self.pad_to, self.max_input_images,
                                 token_ids=self.model_cfg.token_ids)

    def build(self) -> TrainState:
        """Model, VAE and optimizer on the device; the train state."""
        dev = self.device
        model = new_model(self.model_cfg, torch.float32, dev, self.mesh,
                          self.cfg.input_output_return)
        if self._init_state_dict is None:
            init_model_(model, self.mesh,
                        torch.Generator(dev).manual_seed(self.seed + 3))
        else:
            model.load_state_dict(shard_state_dict(
                self._init_state_dict, model, self.mesh), strict=True)
        vae = AutoencoderKL(self.vae_cfg, device="meta",
                            dtype=torch.float32).to_empty(device=dev)
        if self._vae_state_dict is not None:
            vae.load_state_dict(self._vae_state_dict, strict=True)
        else:
            vae.init_random_(torch.Generator(dev).manual_seed(self.seed + 1))
        self.model, self.vae = model.train(), vae.eval().requires_grad_(False)
        if self.cfg.offload_optimizer:
            state, self._step_fn = init_offload_training(
                model, self.cfg, prediction_target="velocity")
            return state
        self._step_fn = make_train_step(model, self.cfg,
                                        prediction_target="velocity")
        return init_train_state(model, self.cfg, self.mesh)

    def step_generator(self, step_idx: int) -> torch.Generator:
        """The generator of step ``step_idx``'s random numbers."""
        seed = int(np.random.SeedSequence([self.seed, step_idx])
                   .generate_state(1)[0])
        return torch.Generator(self.device).manual_seed(seed)

    def train_step(self, state: TrainState, tb: ImageGenTrainBatch,
                   step_idx: int):
        """One full step on a batch already on the device: the output and
        the input images VAE-encoded under no_grad (posterior draws), then
        the velocity loss, backward, clip, AdamW and the gated EMA. Returns
        the step's metrics (device tensors)."""
        gen = self.step_generator(step_idx)
        part, denominator = draw_part(self.mesh, tb.inputs,
                                      tb.inputs.clean_weights,
                                      self.cfg.input_output_return)
        with torch.no_grad(), autocast(self.cfg, self.device):
            x1 = self.vae.encode(tb.out_pixels, noise=gen, noise_rows=(
                part and part.rows))
            clean = self.vae.encode(tb.in_pixels, noise=gen, noise_rows=(
                part and part.clean))
        inputs = tb.inputs._replace(x1=x1, clean_latents=clean)
        draws = draw_loss_noise(gen, inputs, max_blocks=1, part=part)
        return self._step_fn(state, inputs, draws, denominator=denominator)

    # ---- loop --------------------------------------------------------------

    def run(self, max_steps: int, log_writer=None) -> TrainState:
        if self.dataset is None:
            raise ValueError("ImageGenTrainer.run needs a json_file")
        if self.cfg.max_steps is None:
            # the cosine schedule decays over the run's step budget
            self.cfg = dataclasses.replace(self.cfg, max_steps=max_steps)
        cfg = self.cfg
        write_train_args(cfg, self.model_cfg, self.mesh)
        ckpt_dir = os.path.join(cfg.results_dir, "checkpoints")
        state = self.build()
        start_step = 0
        if cfg.auto_resume and ckpt.latest_step(ckpt_dir) is not None:
            state, start_step = ckpt.restore_checkpoint(ckpt_dir, state,
                                                        mesh=self.mesh)
            self.log(f"resumed from step {start_step}")
        prefetcher = Prefetcher(self.make_batch, depth=cfg.prefetch_depth,
                                workers=cfg.num_workers, start=start_step)
        writer = checkpoint_writer(ckpt_dir, self.mesh, state)
        # SIGTERM / SIGINT: a checkpoint at the current step, then return
        shutdown = GracefulShutdown()
        t0, running = time.time(), []
        try:
            for step_idx in range(start_step, max_steps):
                if shutdown.agreed(self.device):
                    writer.save_durable(step_idx, state)
                    self.log(f"shutdown requested: checkpoint-{step_idx} "
                             "durable")
                    break
                tb = prefetcher.get().to(self.device)
                metrics = self.train_step(state, tb, step_idx)
                running.append(metrics["loss"])
                if (step_idx + 1) % cfg.log_every == 0 \
                        or step_idx == start_step:
                    sps = len(running) / max(time.time() - t0, 1e-9)
                    mean_loss = float(torch.stack(running).mean())
                    grad_norm = float(metrics["grad_norm"])
                    self.log(f"step {step_idx + 1}: loss={mean_loss:.4f} "
                             f"grad_norm={grad_norm:.3f} "
                             f"steps/sec={sps:.3f}")
                    if log_writer is not None and self.is_main:
                        log_writer.add_scalar("train/loss", mean_loss,
                                              step_idx + 1)
                        log_writer.add_scalar("train/grad_norm", grad_norm,
                                              step_idx + 1)
                        log_writer.add_scalar("train/steps_per_sec", sps,
                                              step_idx + 1)
                    running, t0 = [], time.time()
                if (step_idx + 1) % cfg.ckpt_every == 0:
                    writer.save(step_idx + 1, state)
        finally:
            shutdown.restore()
            prefetcher.close()
            writer.close()  # the last save is on disk before returning
        return state

    def log(self, msg: str) -> None:
        if self.is_main:
            print(msg, flush=True)
