"""Training loop: dataset -> VAE encode -> flow-matching step -> checkpoints.

Port of ``video_gpt_tpu/training/trainer.py``. One step
(:meth:`Trainer.train_step`): the VAE encodes the clip's frames under
``no_grad`` with a posterior draw, then the loss, the backward through
the trunk with per-layer recompute, global-norm clip, AdamW and the gated
EMA. Mixed precision is the JAX package's: fp32 parameters and optimizer
state, bf16 compute; with ``offload_optimizer`` bf16 parameters on the
device and the fp32 master, mu and nu in host memory, updated on the host
(``training/offload.py``; one device only). Every random number of step
``i`` comes from one ``torch.Generator`` seeded from (seed, i), so a
resumed run continues the
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

``mesh_cfg`` (one process per rank, ``parallel/mesh.py``) trains over
data x seq x tensor x pipe ranks: the global batch is
``batch_size_per_device x data`` rows, of which each data rank loads and
collates its own (the
dataset is not split by process: every rank reads the same global clip
indices, as the single-host JAX run does); the sequence is padded to the
seq multiple, and the attention over seq is ``TrainConfig.sp_attention``'s
(Ulysses or the ring); the random numbers of step i are drawn for the
global batch and sliced to the rank's rows, so a mesh step computes what
one rank computes on the global batch. The model is built for the mesh
(its tensor part, its ZeRO-3 parts, its pipe stage's layers; random
weights are the one-rank model's), the loss runs the trunk as a GPipe
pipeline of ``pp_microbatches`` microbatches on a pipe mesh
(``parallel.pipeline.pp_apply``), AdamW's state is ZeRO-sharded
(``train_state``), each rank checkpoints its part, and rank 0 alone logs.
A pipe axis composes with data only. Both recipes run on a mesh as the
JAX Trainer runs them: LoRA's frozen base is placed as the trainable
parameters are (its tensor part, under ZeRO-3 its data part, gathered per
layer), the adapters follow their projections' tensor parts and take
their own ZeRO dimension, and every rank starts from the one-rank
adapters; LoRA refuses a pipe axis with the JAX message. Distillation's
teacher is built for the mesh like the student (its tensor part, ZeRO-3
parts and pipe stage) and runs through the student's attention routing
and, on a pipe mesh, the GPipe trunk; its draws are made for the global
batch and sliced to the rank, as the loss's are.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import MeshConfig, ModelConfig, TrainConfig, check_train_config
from ..data.prefetch import Prefetcher
from ..data.video import VideoClipDataset
from ..layout import tokens_per_frame
from ..models.afmoe import expert_loads
from ..models.vae import AutoencoderKL, VAEConfig
from ..models.video_gpt import VideoGPT
from ..parallel.distributed import GracefulShutdown
from ..parallel.mesh import (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS,
                             axis_size, batch_rows, make_mesh, shard_params_,
                             zero_shard)
from ..parallel.pipeline import pp_apply
from ..sampling.pipeline import resolve_device
from ..utils import checkpoint as ckpt
from ..utils.profiling import annotate
from ..utils.weights import (tp_shard, tp_shard_state_dict,
                             zero_shard_state_dict)
from .data import TrainBatch, collate
from .distill import (distill_optimizer_config, draw_distill_noise,
                      make_distill_train_step)
from .lora import freeze_base_, init_lora_, is_adapter
from .loss import DrawPart, draw_loss_noise
from .offload import init_offload_training
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
        mesh_cfg: Optional[MeshConfig] = None,
    ):
        """``video_source``: a directory of videos or a ``.txt`` manifest;
        None builds no dataset, for a caller that feeds
        :meth:`train_step` its own batches. Without state dicts the
        weights are random from ``seed`` (the model's head and noisy-patch
        embedder zero, as a fresh training model's). ``mesh_cfg``: the
        mesh of a launch of one process per rank (its world size must be
        the mesh's)."""
        check_train_config(train_cfg)
        self.mesh = None
        if mesh_cfg is not None and mesh_cfg.num_devices > 1:
            if model_cfg.trunk == "afmoe":
                raise ValueError("the AFMoE trunk trains on one device: no "
                                 "mesh (no expert parallelism yet)")
            if train_cfg.offload_optimizer:
                raise ValueError("offload_optimizer is the single-chip "
                                 "full-depth path; use ZeRO over the mesh "
                                 "(--mesh_data/--zero3) instead")
            check_pipe(mesh_cfg, model_cfg, train_cfg)
            self.mesh = make_mesh(mesh_cfg)
            if mesh_cfg.seq > 1:
                model_cfg = dataclasses.replace(
                    model_cfg, sp_attention=train_cfg.sp_attention)
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

    @property
    def _batch_rows(self) -> int:
        """Global batch rows: rows per rank x the data axis."""
        return self.cfg.batch_size_per_device * axis_size(self.mesh,
                                                          DATA_AXIS)

    @property
    def is_main(self) -> bool:
        """Rank 0 (or no mesh): the rank that logs."""
        return self.mesh is None or self.mesh.rank == 0

    def make_batch(self, index: int) -> TrainBatch:
        """This rank's rows of batch ``index`` of the data order, on the
        host."""
        rows = self._batch_rows
        # the raw index: each wraparound of the dataset re-rolls the clips
        samples = [self.dataset.sample(index * rows + i)
                   for i in range(rows)[batch_rows(self.mesh, rows)]]
        return collate(samples, self.n_img,
                       sp_multiple=axis_size(self.mesh, SEQ_AXIS),
                       cls_weight=self.cfg.cls_weight,
                       uncond=self.cfg.distill_guidance is not None)

    def _new_model(self, dtype: torch.dtype) -> VideoGPT:
        """A training model (with the aux input head under
        ``input_output_return``) built for the mesh, its memory
        uninitialised."""
        return new_model(self.model_cfg, dtype, self.device, self.mesh,
                         self.cfg.input_output_return)

    def _load_init(self, model: VideoGPT) -> None:
        """The warm start into ``model``: every entry (the base's alone
        under LoRA, whose adapters it does not hold), or random weights;
        on a mesh, this rank's part of them."""
        sd = self._init_state_dict
        if sd is None:
            init_model_(model, self.mesh, torch.Generator(
                self.device).manual_seed(self.seed + 3))
            return
        sd = shard_state_dict(sd, model, self.mesh)
        if self.cfg.use_lora:
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
        if cfg.offload_optimizer:
            state, self._step_fn = init_offload_training(model, cfg)
            return state
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
            self._step_fn = make_distill_train_step(
                model, self.teacher, cfg, apply_fn=self._pipe_fn())
            return init_train_state(model, distill_optimizer_config(cfg),
                                    self.mesh)
        if cfg.use_lora:
            gen = torch.Generator(dev).manual_seed(self.seed + 4)
            if self.mesh is None:
                init_lora_(model, gen)
            else:
                init_lora_(model, gen, whole=whole_model(model),
                           part=functools.partial(part_of, model=model,
                                                  mesh=self.mesh))
            freeze_base_(model)
            self._step_fn = make_lora_train_step(model, cfg)
            return init_lora_train_state(model, cfg, self.mesh)
        pipe_fn = self._pipe_fn()
        self._step_fn = make_train_step(
            model, cfg, apply_fn=None if pipe_fn is None
            else functools.partial(pipe_fn, model))
        return init_train_state(model, cfg, self.mesh)

    def _pipe_fn(self):
        """On a pipe mesh, the GPipe trunk's forward of a model (its
        stage's layers over the pipe axis, ``pp_apply`` at the recipe's
        microbatches); else None."""
        if axis_size(self.mesh, PIPE_AXIS) == 1:
            return None
        return functools.partial(pp_apply,
                                 num_micro=num_micro(self.mesh.cfg, self.cfg))

    def step_generator(self, step_idx: int) -> torch.Generator:
        """The generator of step ``step_idx``'s random numbers."""
        seed = int(np.random.SeedSequence([self.seed, step_idx])
                   .generate_state(1)[0])
        return torch.Generator(self.device).manual_seed(seed)

    def train_step(self, state: TrainState, tb: TrainBatch, step_idx: int):
        """One full step on a batch already on the device: VAE encode under
        no_grad with a posterior draw, then the recipe's loss (training or
        distillation), backward, clip, AdamW and the gated EMA, in the span
        ``vgt.train.step``. Returns the step's metrics (device tensors)."""
        with annotate("vgt.train.step"):
            cfg = self.cfg
            gen = self.step_generator(step_idx)
            part, denominator = draw_part(self.mesh, tb.inputs,
                                          tb.clean_valid,
                                          cfg.input_output_return)
            f = tb.pixels.shape[0] // tb.inputs.batch.input_ids.shape[0]
            with torch.no_grad(), autocast(cfg, self.device):
                latents = self.vae.encode(
                    tb.pixels, noise=gen, noise_rows=(
                        None if part is None else (part.rows[0] * f,
                                                   part.rows[1] * f)))
            inputs = tb.inputs._replace(
                x1=latents[tb.noisy_sel.long()],
                clean_latents=latents[tb.clean_sel.long()])
            if cfg.distill:
                draws = draw_distill_noise(gen, inputs, cfg.frame_num,
                                           cfg.distill_student_steps,
                                           part=part)
                return self._step_fn(state, inputs, draws)
            draws = draw_loss_noise(gen, inputs, max_blocks=cfg.frame_num,
                                    part=part)
            return self._step_fn(state, inputs, draws,
                                 denominator=denominator)

    # ---- loop --------------------------------------------------------------

    def run(self, max_steps: int, log_writer=None) -> TrainState:
        if self.dataset is None:
            raise ValueError("Trainer.run needs a video_source")
        if self.cfg.max_steps is None:
            # bind the run's step budget before the optimizer is built: the
            # cosine schedule decays over exactly this horizon
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
            if shutdown.agreed(self.device):
                writer.save_durable(step_idx, state)
                self.log(f"shutdown requested: checkpoint-{step_idx} "
                         "durable")
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
                self.log(f"step {step_idx + 1}: loss={mean_loss:.4f} "
                         f"grad_norm={grad_norm:.3f} steps/sec={sps:.3f}")
                loads = expert_loads(self.model)
                if loads:
                    self.log("expert load max/mean by layer: " + " ".join(
                        f"{float(x):.2f}" for x in loads))
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
                self.log(f"saving checkpoint-{step_idx + 1} (async)")
        return state

    def log(self, msg: str) -> None:
        if self.is_main:
            print(msg, flush=True)


def num_micro(mesh_cfg: MeshConfig, cfg: TrainConfig) -> int:
    """GPipe's microbatches a step: ``pp_microbatches``, or one per
    stage."""
    return cfg.pp_microbatches or mesh_cfg.pipe


def check_pipe(mesh_cfg: MeshConfig, model_cfg: ModelConfig,
               cfg: TrainConfig) -> None:
    """Raise, with the JAX Trainer's messages, on a pipe mesh it refuses:
    pipe with seq or tensor, with LoRA, layers that the stages do not
    divide, rows per rank that the microbatches do not."""
    pp = mesh_cfg.pipe
    if pp == 1:
        return
    if mesh_cfg.seq > 1 or mesh_cfg.tensor > 1:
        raise ValueError(
            "pipeline parallelism composes with data parallelism "
            "only (the stage body is local math); use tp/sp "
            "without pp for those regimes")
    if cfg.use_lora:
        raise ValueError("LoRA fine-tuning does not route through "
                         "the pipeline trunk; use dp/ZeRO for LoRA")
    if model_cfg.num_layers % pp:
        raise ValueError(
            f"num_layers={model_cfg.num_layers} not divisible by "
            f"the pipe axis {pp}")
    nm = num_micro(mesh_cfg, cfg)
    if cfg.batch_size_per_device % nm:
        raise ValueError(
            f"batch_size_per_device={cfg.batch_size_per_device} not "
            f"divisible by pp_microbatches={nm}")


def new_model(cfg: ModelConfig, dtype: torch.dtype, device, mesh,
              input_head: bool) -> VideoGPT:
    """A training model built for ``mesh`` (its tensor part; under ZeRO-3
    its parameters this data rank's parts), memory uninitialised."""
    model = VideoGPT(cfg, device="meta", dtype=dtype, train_init=True,
                     input_head=input_head, mesh=mesh)
    if mesh is not None and mesh.cfg.zero_params:
        return shard_params_(model, mesh, device)
    return model.to_empty(device=device)


def part_of(name: str, w: torch.Tensor, model: VideoGPT, mesh
             ) -> torch.Tensor:
    """This rank's part of the whole (one-rank) parameter ``name``."""
    w = tp_shard(name, w, model.cfg, axis_size(mesh, TENSOR_AXIS),
                 0 if mesh is None else mesh.index(TENSOR_AXIS))
    if mesh is not None and mesh.cfg.zero_params:
        w = zero_shard(w, mesh)
    return w


def whole_model(model: VideoGPT) -> VideoGPT:
    """The one-rank (unsharded) model of ``model``, on the meta device."""
    return VideoGPT(model.cfg, device="meta", train_init=model.train_init,
                    input_head=hasattr(model, "input_final_layer"))


def init_model_(model: VideoGPT, mesh, gen: torch.Generator) -> None:
    """Random weights of the one-rank model of ``gen``: on a mesh each
    whole parameter is drawn in turn and this rank keeps its part."""
    if mesh is None:
        model.init_random_(gen)
        return
    model.init_random_(gen, whole=whole_model(model),
                       part=functools.partial(part_of, model=model,
                                              mesh=mesh))


def shard_state_dict(sd: dict, model: VideoGPT, mesh) -> dict:
    """This rank's part of a one-rank state dict: its pipe stage's entries,
    its tensor part, and under ZeRO-3 its data part of that (``sd`` itself
    without a mesh)."""
    if mesh is None:
        return sd
    if axis_size(mesh, PIPE_AXIS) > 1:
        mine = model.state_dict().keys()
        sd = {k: v for k, v in sd.items() if k in mine}
    sd = tp_shard_state_dict(sd, model.cfg, axis_size(mesh, TENSOR_AXIS),
                             mesh.index(TENSOR_AXIS))
    if mesh.cfg.zero_params:
        sd = zero_shard_state_dict(sd, axis_size(mesh, DATA_AXIS),
                                   mesh.index(DATA_AXIS))
    return sd


def draw_part(mesh, inputs, clean_valid: torch.Tensor, input_head: bool):
    """(:class:`DrawPart` of this data rank's batch, the loss denominator
    of the global batch over the data size under ``input_head``), or
    (None, None) without a data axis. The rows' real clean counts are
    all-gathered over data: the clean slots of the global batch are laid
    out row-major, so a rank's start is the count of the rows before it."""
    n = axis_size(mesh, DATA_AXIS)
    if n == 1:
        return None, None
    rows = inputs.batch.input_ids.shape[0]
    nn_ = inputs.noisy_frame_row.shape[0]
    i = mesh.index(DATA_AXIS)
    counts = mesh.all_gather(clean_valid.sum().reshape(1), DATA_AXIS, 0)
    counts = [int(c) for c in counts.tolist()]
    # every rank's clean slots are rows x a per-row maximum
    part = DrawPart(noisy=(i * nn_, n * nn_), rows=(i * rows, n * rows),
                    clean=(sum(counts[:i]), n * clean_valid.shape[0]))
    denominator = None
    if input_head:
        denominator = (n * nn_ + max(sum(counts), 1)) / n
    return part, denominator


def write_train_args(cfg: TrainConfig, model_cfg: ModelConfig, mesh) -> None:
    """``results_dir/train_args.json`` (rank 0): the recipe, the model and,
    as the JAX package records it, its tensor-parallel degree."""
    os.makedirs(cfg.results_dir, exist_ok=True)
    if mesh is not None and mesh.rank != 0:
        return
    model = {k: str(v) for k, v in dataclasses.asdict(model_cfg).items()}
    model["tensor_parallel"] = str(axis_size(mesh, TENSOR_AXIS))
    with open(os.path.join(cfg.results_dir, "train_args.json"), "w") as f:
        json.dump({"train": dataclasses.asdict(cfg), "model": model,
                   "mesh": (None if mesh is None
                            else dataclasses.asdict(mesh.cfg))},
                  f, indent=2, default=str)


def checkpoint_writer(ckpt_dir: str, mesh, state: TrainState
                      ) -> ckpt.CheckpointWriter:
    """The writer of ``state``'s checkpoints; on a mesh its record names
    the parameters the state writes (a LoRA run's adapters alone)."""
    return ckpt.CheckpointWriter(
        ckpt_dir, mesh=mesh,
        record=None if mesh is None else ckpt.mesh_record(
            mesh, state.model, only=list(state.state_dict()["model"])))
