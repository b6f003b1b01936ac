"""Training loop: dataset -> VAE encode -> flow-matching step -> checkpoints.

Port of ``video_gpt_tpu/training/trainer.py`` for one device and no mesh.
One step (:meth:`Trainer.train_step`): the VAE encodes the clip's frames
under ``no_grad`` with a posterior draw, then the loss, the backward through
the trunk with per-layer recompute, global-norm clip, AdamW and the gated
EMA. Mixed precision is the JAX package's: fp32 parameters and optimizer
state, bf16 compute. Every random number of step ``i`` comes from one
``torch.Generator`` seeded from (seed, i), so a resumed run continues the
noise stream instead of replaying it. Runs on CUDA unless the caller asks
for the CPU.

With ``input_output_return`` the model carries the aux input head and the
loss adds its reconstruction of the clean frames. Two recipes change what
:meth:`Trainer.build` makes (the JAX ``_build``'s branches):

- ``use_lora``: the model carries rank-``lora_rank`` adapters on
  ``qkv_proj`` / ``o_proj``, the base (the warm start) is frozen, and AdamW,
  the EMA and the checkpoints hold the adapters alone;
- ``distill``: the student is a copy of the warm start, and the teacher a
  frozen second model with the same weights (held in bf16 under
  ``mixed_precision='bf16'``: autocast casts every weight use to bf16, so it
  computes what the fp32 weights would); AdamW runs at ``distill_lr``, and
  with ``distill_guidance`` the batches carry the 'uncond' layout.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig, check_train_config
from ..data.prefetch import Prefetcher
from ..data.video import VideoClipDataset
from ..layout import tokens_per_frame
from ..models.vae import AutoencoderKL, VAEConfig
from ..models.video_gpt import VideoGPT
from ..parallel.distributed import GracefulShutdown
from ..sampling.pipeline import resolve_device
from ..utils import checkpoint as ckpt
from .data import TrainBatch, collate
from .distill import (distill_optimizer_config, draw_distill_noise,
                      make_distill_train_step)
from .lora import freeze_base_, init_lora_, is_adapter
from .loss import draw_loss_noise
from .train_state import (TrainState, autocast, init_lora_train_state,
                          init_train_state, make_lora_train_step,
                          make_train_step)


class Trainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        video_source: Optional[str],
        vae_cfg: VAEConfig = VAEConfig(),
        vae_state_dict: Optional[dict] = None,
        init_state_dict: Optional[dict] = None,
        target_resolution=(176, 320),
        device="cuda",
        seed: int = 0,
    ):
        """``video_source``: a directory of videos or a ``.txt`` manifest;
        None builds no dataset, for a caller that feeds
        :meth:`train_step` its own batches. Without state dicts the
        weights are random from ``seed`` (the model's head and noisy-patch
        embedder zero, as a fresh training model's)."""
        check_train_config(train_cfg)
        if train_cfg.gradient_checkpointing and not model_cfg.remat:
            model_cfg = dataclasses.replace(model_cfg, remat=True)
        if train_cfg.use_lora and not model_cfg.lora_rank:
            model_cfg = dataclasses.replace(model_cfg,
                                            lora_rank=train_cfg.lora_rank)
        est_tokens = 2 * train_cfg.frame_num * (
            tokens_per_frame(*target_resolution) + 2)
        if est_tokens > train_cfg.max_input_length_limit:
            raise ValueError(
                f"sequence of ~{est_tokens} tokens exceeds "
                f"max_input_length_limit={train_cfg.max_input_length_limit}; "
                "lower frame_num/resolution or raise the limit")
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.vae_cfg = vae_cfg
        self.device = resolve_device(device)
        self.target_resolution = tuple(target_resolution)
        self.seed = seed
        self.dataset = None
        if video_source is not None:
            self.dataset = VideoClipDataset(
                video_source, frame_num=train_cfg.frame_num,
                frame_interval=train_cfg.frame_interval,
                flexible_interval=train_cfg.flexible_interval,
                interval_bound=train_cfg.interval_bound,
                target_resolution=self.target_resolution,
                scheme=train_cfg.frame_block_scheme, seed=seed)
        self._vae_state_dict = vae_state_dict
        self._init_state_dict = init_state_dict
        self.model: Optional[VideoGPT] = None
        self.teacher: Optional[VideoGPT] = None  # distillation only
        self.vae: Optional[AutoencoderKL] = None
        self._step_fn = None

    @property
    def n_img(self) -> int:
        return tokens_per_frame(*self.target_resolution)

    def make_batch(self, index: int) -> TrainBatch:
        """Batch ``index`` of the data order, on the host."""
        rows = self.cfg.batch_size_per_device
        # the raw index: each wraparound of the dataset re-rolls the clips
        samples = [self.dataset.sample(index * rows + i) for i in range(rows)]
        return collate(samples, self.n_img, cls_weight=self.cfg.cls_weight,
                       uncond=self.cfg.distill_guidance is not None)

    def _new_model(self, dtype: torch.dtype) -> VideoGPT:
        """A training model (with the aux input head under
        ``input_output_return``), its memory uninitialised."""
        return VideoGPT(self.model_cfg, device="meta", dtype=dtype,
                        train_init=True,
                        input_head=self.cfg.input_output_return).to_empty(
                            device=self.device)

    def _load_init(self, model: VideoGPT) -> None:
        """The warm start into ``model``: every entry (the base's alone
        under LoRA, whose adapters it does not hold), or random weights."""
        sd = self._init_state_dict
        if sd is None:
            model.init_random_(
                torch.Generator(self.device).manual_seed(self.seed + 3))
        elif self.cfg.use_lora:
            missing, unexpected = model.load_state_dict(sd, strict=False)
            base = [n for n in missing if not is_adapter(n)]
            if unexpected or base:
                raise ValueError(
                    f"the LoRA warm start must hold the base model: "
                    f"{len(base)} base entries missing (e.g. {base[:3]}), "
                    f"unexpected {unexpected[:3]}")
        else:
            model.load_state_dict(sd, strict=True)

    def build(self) -> TrainState:
        """Model (and teacher), VAE and optimizer on the device; the train
        state."""
        dev = self.device
        cfg = self.cfg
        model = self._new_model(torch.float32)
        self._load_init(model)
        vae = AutoencoderKL(self.vae_cfg, device="meta",
                            dtype=torch.float32).to_empty(device=dev)
        if self._vae_state_dict is not None:
            vae.load_state_dict(self._vae_state_dict, strict=True)
        else:
            vae.init_random_(torch.Generator(dev).manual_seed(self.seed + 1))
        self.model, self.vae = model.train(), vae.eval().requires_grad_(False)
        if cfg.distill:
            if self._init_state_dict is None:
                # distilling a random teacher is almost surely a mistake,
                # but a smoke run on fresh weights must stay possible
                print("WARNING: --distill with no --model_ckpt/"
                      "--init_checkpoint_dir — the frozen teacher is a "
                      "RANDOMLY INITIALIZED model. Distillation regresses "
                      "the student onto this teacher's rollouts; if you "
                      "meant to distill trained weights, pass them.",
                      flush=True)
            teacher = self._new_model(torch.bfloat16
                                      if cfg.mixed_precision == "bf16"
                                      else torch.float32)
            teacher.load_state_dict(model.state_dict(), strict=True)
            self.teacher = teacher.eval().requires_grad_(False)
            self._step_fn = make_distill_train_step(model, self.teacher, cfg)
            return init_train_state(model, distill_optimizer_config(cfg))
        if cfg.use_lora:
            init_lora_(model, torch.Generator(dev).manual_seed(self.seed + 4))
            freeze_base_(model)
            self._step_fn = make_lora_train_step(model, cfg)
            return init_lora_train_state(model, cfg)
        self._step_fn = make_train_step(model, cfg)
        return init_train_state(model, cfg)

    def step_generator(self, step_idx: int) -> torch.Generator:
        """The generator of step ``step_idx``'s random numbers."""
        seed = int(np.random.SeedSequence([self.seed, step_idx])
                   .generate_state(1)[0])
        return torch.Generator(self.device).manual_seed(seed)

    def train_step(self, state: TrainState, tb: TrainBatch, step_idx: int):
        """One full step on a batch already on the device: VAE encode under
        no_grad with a posterior draw, then the recipe's loss (training or
        distillation), backward, clip, AdamW and the gated EMA. Returns the
        step's metrics (device tensors)."""
        cfg = self.cfg
        gen = self.step_generator(step_idx)
        with torch.no_grad(), autocast(cfg, self.device):
            latents = self.vae.encode(tb.pixels, noise=gen)
        inputs = tb.inputs._replace(
            x1=latents[tb.noisy_sel.long()],
            clean_latents=latents[tb.clean_sel.long()])
        if cfg.distill:
            draws = draw_distill_noise(gen, inputs, cfg.frame_num,
                                       cfg.distill_student_steps)
        else:
            draws = draw_loss_noise(gen, inputs, max_blocks=cfg.frame_num)
        return self._step_fn(state, inputs, draws)

    # ---- loop --------------------------------------------------------------

    def run(self, max_steps: int, log_writer=None) -> TrainState:
        if self.dataset is None:
            raise ValueError("Trainer.run needs a video_source")
        if self.cfg.max_steps is None:
            # bind the run's step budget before the optimizer is built: the
            # cosine schedule decays over exactly this horizon
            self.cfg = dataclasses.replace(self.cfg, max_steps=max_steps)
        cfg = self.cfg
        os.makedirs(cfg.results_dir, exist_ok=True)
        with open(os.path.join(cfg.results_dir, "train_args.json"), "w") as f:
            json.dump({"train": dataclasses.asdict(cfg),
                       "model": {k: str(v) for k, v in
                                 dataclasses.asdict(self.model_cfg).items()}},
                      f, indent=2, default=str)
        ckpt_dir = os.path.join(cfg.results_dir, "checkpoints")
        state = self.build()
        start_step = 0
        if cfg.auto_resume and ckpt.latest_step(ckpt_dir) is not None:
            state, start_step = ckpt.restore_checkpoint(ckpt_dir, state)
            print(f"resumed from step {start_step}", flush=True)
        prefetcher = Prefetcher(self.make_batch, depth=cfg.prefetch_depth,
                                workers=cfg.num_workers, start=start_step)
        writer = ckpt.CheckpointWriter(ckpt_dir)
        # SIGTERM / SIGINT: a checkpoint at the current step, then return
        shutdown = GracefulShutdown()
        try:
            return self._loop(start_step, max_steps, state, prefetcher,
                              writer, log_writer, shutdown)
        finally:
            shutdown.restore()
            prefetcher.close()
            writer.close()  # the last save is on disk before returning

    def _loop(self, start_step, max_steps, state, prefetcher, writer,
              log_writer, shutdown):
        cfg = self.cfg
        t0 = time.time()
        running = []
        for step_idx in range(start_step, max_steps):
            if shutdown.requested.is_set():
                writer.save_durable(step_idx, state)
                print(f"shutdown requested: checkpoint-{step_idx} durable",
                      flush=True)
                break
            tb = prefetcher.get().to(self.device)
            metrics = self.train_step(state, tb, step_idx)
            # keep the device scalar: reading it here would wait for the
            # device every step
            running.append(metrics["loss"])
            if (step_idx + 1) % cfg.log_every == 0 or step_idx == start_step:
                dt = time.time() - t0
                sps = len(running) / max(dt, 1e-9)
                mean_loss = float(torch.stack(running).mean())
                grad_norm = float(metrics["grad_norm"])
                print(f"step {step_idx + 1}: loss={mean_loss:.4f} "
                      f"grad_norm={grad_norm:.3f} steps/sec={sps:.3f}",
                      flush=True)
                if log_writer is not None:
                    log_writer.add_scalar("train/loss", mean_loss,
                                          step_idx + 1)
                    log_writer.add_scalar("train/grad_norm", grad_norm,
                                          step_idx + 1)
                    log_writer.add_scalar("train/steps_per_sec", sps,
                                          step_idx + 1)
                running, t0 = [], time.time()
            if (step_idx + 1) % cfg.ckpt_every == 0:
                writer.save(step_idx + 1, state)
                print(f"saving checkpoint-{step_idx + 1} (async)", flush=True)
        return state
