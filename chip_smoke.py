"""Smoke run of the PyTorch/CUDA port (``video_gpt_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-margin SEED...   # a reading, see below

Phases, in order; any failure exits nonzero and none is caught:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``video_gpt_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the ptxas register / shared-memory lines;
3. kernels: each hand-written kernel at the shapes of its path against its
   plain PyTorch version computed in fp32 from the same bf16 inputs (bar
   per element: its bf16 rounding bound, see ``KERNEL_ATOL``), timed with
   CUDA events beside the plain version and ``scaled_dot_product_attention``
   as the library yardstick (as many launches as fit 2 s). K1-K3 at the
   serving flagship (176x320 frames, 8 clean + 16 generated, 32 heads of
   96); the TPU's k-tiled kernels past 8192 keys as the port runs them: K4
   as K1 at the long rollout's cond row (5,328 queries over 12,432 + 5,328
   keys), K5 as K2 at a 40-frame uncond row (8,880^2), K10 as K3 at the
   long rollout's prefill (12,432^2 with its bias); the overlap probe P1
   (serial and pipelined bodies, every nsub, 132 problems of 256 x 8192 x
   128) and its sweep at 1 problem; K3 again and K9 (its backward) at the
   stage-1 training shape (16 frames, L 7104); K6 and K7 (its backward) at
   the stage-4 shape (80 frames, L 35520), and K6's kernel at the stage-1
   shape as K8; then the rollouts' other shapes: K2 over the long
   rollout's uncond row (5,328^2), and the batched rollout's K1 (B 2, a
   heads-major cache), K2 (B 2) and its prefill through K6 (B 2 x
   12,432^2, the index a batch-stride-0 view); K3 at the image path's
   cached decode (the tail's 4,097 queries over the heads-major
   concatenation of a prompt's cache and the tail, with a rectangular
   bias: text -> image ~4.1k keys, editing ~8.2k keys) and K3 and K9 at
   the train-image shape (L 4,609); and at a mesh rank's shapes of the
   flagship: K1 and K2 at 8 heads, K6 at a seq-sharded prefill (8 heads),
   K3 at a tensor-only prefill (16 heads); and at a mesh training rank's:
   K3/K9 at 16 heads over the stage-1 layout (tensor 2), K6/K7 at 16
   heads over it (a seq-2 rank's Ulysses heads) and at 8 heads over the
   stage-4 layout ((seq 2, tensor 2)); and at part B's: K6/K7 on a ring
   hop of the (seq 2, tensor 2) stage-4 run (16 heads, q chunk 1 over k
   chunk 0 and q chunk 0 over k chunk 1, each 17,760 x 17,760; K7 and its
   plain version handed the global lse of the two-chunk merge), and at a
   GPipe microbatch (32 heads, L 7104, B 1). Every attention kernel
   computes only the tiles its tile map does not call empty: each map the
   kernels build is held equal to its plain classifier, and its share of
   tiles computed and the map's own time are printed beside the kernel's:
   K3 (flagship, stage 1, K10) and K9 read the bias's map, built once per
   bias (``fa.bias_map``, not in their times); K6, K8, the B 2 prefill and
   K7 (stage 4) build theirs in every launch (in their times); K1/K2 (and
   K4, K5 and the rollouts' rows) classify each key tile in their producer
   as they load its ranks (in their times; no map), and their records give
   the share of tiles computed and full from the plain classifier; then
   every other dtype and head width the forward wrappers take: K1, K2, K3
   and K6 in bf16 at head_dim 16, 64 and 128 (the flagship's width in
   heads of that size, at its lengths; K6 over the prefill's clean
   prefix), and the fp32 kernel (``csrc/fp32_attention.cu``) as K1, K2 and
   K3 at the flagship's shapes, as K3 at the text -> image decode and at
   the stage-1 training shape (L 7104) and as K6 at the batched rollout's
   prefill (B 2 x 12,432^2), each against its plain version in fp32 on
   the card (fp32 bar: |got - plain| <= 2e-5 + 2e-5 |plain|), timed
   beside the plain version and SDPA in fp32 with the same mask, bound by
   the split-precision tensor rate (the fp32 kernels compute each fp32
   product as six bf16 products: 989 / 6 = 164.8 TFLOP/s; the log gives
   the CUDA-core fp32 bound, 66.9 TFLOP/s, beside it); then
   the backward kernels at every other dtype and head width their
   wrappers take: K9 and K7 in bf16 at head_dim 16, 64 and 128 (192 / 48
   / 24 heads; Dp 32, 64 and 128, the last with two dK/dV warpgroups) and
   the fp32 backward (``csrc/fp32_attention_bwd.cu``) as K9 and K7 at 96,
   K9 at the stage-1 training shape, K7 at a seq-2 rank's (half those
   heads, L 7104) and, at head_dim 128 and fp32, at the ring hop q1/k0 of
   the stage-4 layout from the global lse, each against its plain version (fp32 backward bar:
   |got - plain| <= 2e-5 + 2e-5 |plain| + 2^-18 mass), SDPA's backward
   and its bound;
4. small-input serving reference: ``generate`` on a tiny model (head_dim
   96, GQA) on the card in bf16 against the same weights and noise on the
   CPU in fp32 (plain versions), two blocks so every serving kernel and the
   cache extend run (bar: final-latent relative MSE 1e-3); the same in
   fp32 on the card (the fp32 kernel only; bar 1e-6, or twice the floor:
   the CPU's fp32 clip rerun with its linears summed in two halves), once
   more at ``precompute_bias_limit`` 0 (its prefill through the fp32 K6),
   and ``--tiny_model``'s config (head_dim 16) in bf16 at 1e-3;
5. serving main path: ``VideoGPTPipeline.generate`` at full width
   (ModelConfig(), the SDXL-class VAE, random bf16 weights from a seed,
   head and adaLN random) on 8 synthetic frames, 16 frames in 10 steps with
   guidance 1.5 and a 24-frame window, so the context keeps all 8 frames:
   once to warm up (checking that no float op runs on the host), once
   timed; the launch counts must be exactly the path's (prefill 32, cond
   decode 320, uncond 320), with one build of the bias's tile map; its
   MFU on a line of its own (``utils.profiling.mfu`` of ``bench.py``'s
   model flops, against the card's bf16 dense peak);
6. extend path: a two-block rollout without re-noise, whose second block
   grows the KV cache through the split decode kernel;
7. serving profile: the main path once more under torch.profiler, tracing
   the device only (device time by kernel group and the largest kernels,
   the device's idle share in that run);
8. long rollout, the recipe of ``configs/inference.sh`` at full width: 56
   synthetic frames, two 24-frame clips in 50 steps, an 80-frame window
   (the second block slides and prefills again), guidance 1.5, no re-noise:
   a warm-up at 1 step (host-op check on), then timed, with exactly 64 K3,
   3,200 K1 and 3,200 K2 launches (of which the 64 K3 and 3,200 K1 pass
   8192 keys: K10's and K4's function) and 2 bias-map builds (one per
   prefill), 104 uint8 frames and finite
   latents; then its first block once more under the profiler, at
   ROLLOUT_PROFILE_STEPS (10) steps;
9. batched rollout: the same recipe for 2 videos through
   ``generate_batch`` at 10 steps: exactly 64 K6 (the B = 2 prefill is
   above the bias limit), 640 K1 (all past 8192 keys) and 640 K2
   launches, 2 x 104 frames; the serving objects are freed after it
   (less than 1 GiB may stay allocated);
9a. ``generate --dtype fp32`` at full width and depth: the main path's
   recipe with fp32 weights, after a 1-step warm-up: exactly 32 K3, 320
   K1 and 320 K2 of the fp32 kernel and no bf16 launch, one map build,
   uint8 frames and finite fp32 latents, the clip time and peak memory;
   then ``python -m video_gpt_tpu_torch.cli generate --tiny_model
   --device cuda`` in bf16 and in fp32 through the CLI's ``main`` (2 -> 4
   + 4 frames, 4 steps, guidance 1.5; synthetic frames in place of a
   decoded video, and numpy in place of PIL where PIL is not installed):
   each dtype's kernels and not the other's, 10 frames written; then
   ``cli train --tiny_model --device cuda`` one step in bf16 and one with
   ``--mixed_precision no``, and ``cli train-image --tiny_model
   --mixed_precision no`` one step (synthetic clips and images in place
   of decoded files): exactly 2 K3 and 1 K9 a layer of the bf16 kernels
   at Dp 32, or of the fp32 kernels and no bf16 launch, one map build,
   a finite logged loss;
9b. ``scripts/cfg_drift.py`` at its defaults (8 layers of the flagship's
   width, random bf16 weights with the head re-rolled, 10 steps,
   guidance 1.5) over its whole sweep and the reference schedule against
   itself: the uncond / cond ratio measured on the card (the medians of
   timed calls), then a JSON line per schedule; the reference drifts from
   itself by exactly 0, every drift is finite, every plan is
   ``step_kinds``', the launches are exactly K3 per prefill, K1 per cond
   and K2 per uncond evaluation;
10. small-input mesh reference: a tiny model (head_dim 96, GQA 8:4) over
   (seq 2), (tensor 2) and (seq 2, tensor 2) gloo ranks sharing the card
   (``spawn_ranks``: one spawned process per rank; NCCL refuses two ranks
   on one device), against the same model on one rank, all in bf16, two
   blocks over 48x80 frames whose odd tails the seq axis pads (bar:
   final-latent relative MSE 1e-3), each rank with its exact launches
   (K6 prefills on a seq mesh, K3 with its bias on a tensor-only one).
   These three meshes, 11a's collective probe and 11a's small-input
   reference run at once (none of them is timed; their ranks fork from
   one forkserver, at one intra-op thread each);
11. full-width mesh clips, after every reference, on one set of 4 spawned
   ranks that goes on to 11a's full-width training runs (the ranks'
   start-up paid once): the main path's widths at 2 of its 32 layers
   (MESH_CLIP_LAYERS, seed 0), frames, noise and recipe over (seq 2,
   tensor 2) and (seq 4) (the reference's SP=4) gloo ranks on the card:
   each rank exactly 2 K6, 20 K1 and 20 K2 at its 8 heads, the final
   latents bit-equal across the ranks (``shard_divergence`` 0) and within
   relative MSE 1e-3 of the same model's single-rank clip and within
   twice its floor (that clip rerun with its linears in another fp32
   summation order, ``fp32_linears``), with the clip's wall time, the
   bytes each rank's collectives took in and each rank's peak memory
   (gloo ranks sharing one card: not multi-GPU speed);
11a. mesh training, gloo ranks sharing the card: gloo's reduce_scatter,
   all_gather, all_to_all_single, all_reduce and the hop of the ring and
   of GPipe (all_to_all_single with the payload to one peer: a ring shift,
   and with nothing sent by the last rank and received by the first) on
   CUDA operands (small, and large ones a matmul has just written), on 2
   and 3 ranks, each against its expected result; a small-input
   reference (a tiny model, head_dim 96, 8 heads, 4 layers, 4-frame 48x64
   rows, two steps with injected posterior noise and loss draws) over
   (data 2), (seq 2), (tensor 2), (data 2, zero3) and (data 2, seq 2,
   tensor 2, zero3), the ring over (seq 2), (seq 4) and (data 2, seq 2,
   tensor 2, zero3), and GPipe over (pipe 2, 2 microbatches) and (data 2,
   pipe 2, 4 microbatches, 8 rows), LoRA (rank 8) over (data 2, seq 2,
   tensor 2, zero3) and the ring's (seq 2), guided distillation over (seq
   2, tensor 2) and distillation over (data 2, pipe 2, 2 microbatches, 4
   rows) (a student other than its teacher), against the one-rank step on
   the same rows on the CPU in fp32 (bars: the training reference's, per
   step; each rank its exact K3/K9 or K6/K7 launches; the replicated
   parameters bit-equal across the ranks; the LoRA base or the teacher
   bit-equal on every rank); then the recipes of
   ``configs/pretrain_multichip_examples.sh`` at full width through the
   Trainer's own step, a warm-up and a timed step each: dp_tp_zero3 as
   (data 2, tensor 2, zero3) at 2 of the 32 layers (stage 1, each rank
   4 K3 and 2 K9 at 16 heads), dp_sp as (data 2, seq 2) at 1 layer
   and dp_sp_tp's (seq 2, tensor 2) at stage 4 and 1 layer (a
   replicating axis holds 16 B a parameter on each of its ranks: full
   depth does not fit the card twice; the three were cut from 32, 8 and 8
   layers for the script's time), the ring on that (seq 2, tensor 2)
   stage-4 run (each rank 4 K6 and 2 K7 at 16 heads over 17,760-token
   chunks), and dp_pp
   without its data axis as (pipe 4), stage 1, 4 rows in 4 microbatches,
   4 layers (1 a stage, cut from 16: each rank 8 K6 and 4 K7 at 32
   heads); LoRA on dp_tp_zero3's (data 2, tensor 2, zero3) at stage 1
   and 2 layers (each rank 4 K3 and 2 K9, its adapters' tensor and ZeRO
   parts over a frozen base), and guided distillation on (seq 2, tensor
   2) at stage 1 and 2 layers (each rank 12 K6 and 2 K7: four teacher
   forwards, the
   student's forward and recompute); each with the slowest rank's step
   time, global tokens/s, each rank's collective bytes (forward; backward
   with the optimizer's; the hops' apart), peak memory, its trained and
   frozen parameters, a gradient into its first layer's attention and
   into the patch embedder (LoRA: into the first layer's lora_B; under
   pipe, after the input gradient's sum over the stages), moved
   parameters, the LoRA base or the teacher bit-equal and divergence 0
   (not multi-GPU speed);
12. small-input training reference, twice: one loss and backward of a tiny
   model (head_dim 96, GQA) on the card (bf16, kernels) against the CPU
   (fp32, plain versions) with the same weights and random numbers: loss
   and flattened-gradient relative errors, held to a bar of a few times
   the CPU's own bf16-vs-fp32 error (the loss: within 2^-8). First on the
   bias route (K3/K9), then with ``precompute_bias_limit=0`` on the inline
   route of stages 2-4 (K6/K7); then in fp32 (``--mixed_precision no``)
   on both routes, card fp32 (the fp32 kernels only) against the CPU's
   fp32 step (bar 1e-6, or twice the floor: the CPU's step rerun with its
   linears summed in two halves), and the tiny model (head_dim 16) in
   bf16 on the inline route at the bf16 bar;
13. stage-1 training path: the ``Trainer`` step at full width (ModelConfig()
   with fp32 parameters and AdamW state, bf16 compute, per-layer
   recompute; the SDXL-class VAE; B 1, 16 synthetic 176x320 frames, L
   7104): one warm-up step (host-op check on) and 3 timed steps, each with
   exactly 64 K3 and 32 K9 launches and no other, one build of the bias's
   tile map, finite loss and gradient
   norm, a nonzero gradient into layer 0's attention, and AdamW moving the
   parameters; its MFU on a line of its own (``bench_suite.py``'s 6PT
   and attention flops); then one more step under torch.profiler (device
   time by group, the optimizer's range apart);
14. stage-4 training path, the same at 80 frames in the frame blocks of one
   seeded ``random_block_partition`` draw (L 35520, all 32 layers), after
   the stage-1 trainer is freed (two 56 GiB states do not fit): one
   warm-up step and 1 timed step, with exactly 64 K6 and 32 K7
   launches and no other, its MFU line, then one profiled step;
14a. ``train --mixed_precision no`` at stage 1, full width (fp32 end to
   end: parameters, activations, the fp32 attention kernels, GEMMs
   without TF32), after the stage-4 trainer is freed: one warm-up and
   FP32_TRAIN_STEPS (1) timed step, exactly 64 fp32 K3 and 32 fp32 K9 and
   no bf16 launch, one map build, finite loss and gradient norm, a
   gradient into layer 0's attention, AdamW moving the parameters; s/step,
   tokens/s, peak memory;
15. LoRA path, after the stage-4 trainer is freed (less than 1 GiB may
   stay allocated between these phases): rank-8 adapters on every layer's
   qkv_proj and o_proj over a frozen stage-1 model at full width (random
   base, heads randomised), L 7104, through the Trainer's own step: one
   warm-up step and 2 timed steps, each with exactly 64 K3, 32 K9 and one
   bias-map build; the base stays bit-equal, every watched lora_B moves in
   step 1 while lora_A's gradient is exactly 0 (B = 0), lora_A's gradient
   is not 0 from step 2 on, layer 0's adapter gradient is finite and not
   0; s/step, tokens/s, peak memory and the adapter count (4.72M);
16. small-input distillation reference: one guided distillation loss and
   backward of a tiny model (a teacher other than the student) on the card
   (bf16, K3/K9) against the CPU (fp32, plain versions) with the same
   weights and random numbers, held to the training reference's bars;
17. guided distillation path, the first round of
   ``configs/distill_serving.sh`` (5 student steps, 2 substeps, guidance
   1.5, distill_lr 1e-4) at full width: a random teacher with randomised
   heads (bf16) and its fp32 copy as the student; one warm-up and 2 timed
   steps, each with exactly 192 K3 (two substeps of a cond and an uncond
   teacher forward, the student's forward and recompute, per layer), 32 K9
   and two bias-map builds (one per layout); the teacher stays bit-equal,
   the student moves;
18. serving the products: the student's weights (bf16) through
   ``generate`` at its serving line (16 frames, 5 steps,
   ``img_guidance_scale`` 1: no uncond row), with exactly 160 K1, 32 K3, no
   K2 and one map build; then the LoRA path's adapters (B redrawn at
   random) merged into those weights on the card, each merged weight held
   to W + (alpha/r) B A within its bf16 rounding, and a clip of the merged
   model;
19. small-input image reference: ``ImageGenPipeline`` on a tiny model
   (head_dim 96, GQA) on the card in bf16 against the CPU in fp32 with the
   same weights and noise, 2-way and 3-way guidance (bar: final-latent
   relative MSE 1e-3), each with exactly its K3 launches and map builds;
20. image serving at full width, stub tokenizer, each guidance context at
   its natural length: (a) text -> image at the CLI's defaults
   (1024x1024, 50 steps, guidance 3.0): exactly 2 (32 + 50 x 32) = 3,264
   K3 launches and 4 map builds (each context's prefill and its decode
   bias, built once before the loop), no K1, K2 or K6; (b) editing with
   one 1024x1024 input image, 3-way guidance at 10 steps (a cut in steps
   only): 3 (32 + 10 x 32) = 1,056 K3 and 6 builds; each one uint8
   1024x1024x3 image and finite latents, after a 1-step warm-up with the
   host-op check on;
20a. ``generate-image --dtype fp32``: text -> image at 1024x1024 with fp32
   weights at FP32_IMAGE_STEPS steps (a cut in steps only), exactly 2 (32
   + steps x 32) fp32 K3 and 4 map builds, no bf16 launch;
21. train-image at full width through the image trainer's own step (512 x
   512 output, one 512x512 input image, max_input_images 3: L 4,609):
   one warm-up and 2 timed steps, each with exactly 64 K3, 32 K9 and one
   map build, finite loss and gradient norm, a gradient into layer 0's
   attention, AdamW moving the parameters;
22. stage 1 with the aux input head (``input_output_return``): one
   warm-up and 2 timed steps with stage 1's launches; the head's weight is
   0 before the first step, gets a nonzero gradient in every step and
   moves;
22a. small-input offload reference: one offload step (``--offload_optimizer``:
   bf16 parameters on the card, fp32 master, mu and nu on the host, the
   update on the host CPU) of a tiny model (head_dim 96, GQA) on the card
   against the same step on the CPU in fp32 (plain versions) and in bf16,
   from the same bf16-valued weights and random numbers: the loss within
   2^-8, the gradient the host update received within 4x the CPU's own
   bf16 error, every parameter exactly bf16 of its master after it;
22b. the offload path: stage 1 (``configs/pretrain_stage1.sh`` with
   ``--offload_optimizer``) at full width and OFFLOAD_LAYERS (8) of the
   32 layers (cut for the script's time: the host update scales with the
   depth) through the Trainer's own step (a further cut only if the
   host's MemAvailable cannot hold the 14 B a parameter of host state
   with a 1.25x margin: printed and listed in the ``runtime_depth_cuts``
   line): a warm-up (no float op on the host but the shared AdamW
   arithmetic of the update), 2 timed steps at ``offload_grad_splits`` 1
   with exactly 2 K3 and 1 K9 a layer and one map
   build each, one step at 2 (two passes: two map builds, K3 and K9
   between one and two passes' counts); each step's split (forward +
   backward, D2H, host update, H2D, with rates), peak device memory per
   grad_splits, the host state's size, its MFU line; finite loss and
   gradient norm, a gradient into layer 0's attention, the watched
   masters moved within the stage-1 bound, the watched parameters bf16
   and exactly bf16(master) after every step; the host state and the
   pinned buffer are freed after it (these two run last, so that the
   host state is not held while the mesh ranks copy through host memory);
23. a line of kernel records (K1-K10, P1, the fp32 kernel as K1-fp32,
   K2-fp32, K3-fp32 and K6-fp32 and the fp32 backward as K9-fp32 and
   K7-fp32, each with its launches read from the
   counters; K3 and K9 also per LoRA, distillation, train-image,
   input-head and offload step, K3 per image, K1-K3 in the cfg_drift
   sweep), then the device line as the last line.

Items 13-22b run at full depth unless the mesh ends past LATE_AT_S (800)
seconds into the script: then at LATE_LAYERS (4) of the 32 layers, the
offload path at most that (printed and listed in the
``runtime_depth_cuts`` line), so that a slow host still ends within the
script's 1,200 s.

The training phases use the recipes of ``configs/pretrain_stage1.sh`` and
``configs/pretrain_stage4.sh`` (betas 0.9/0.95, weight decay 0.1, eps 1e-5,
clip 1.0) with a constant learning rate of 1e-4: the recipes' 320000-step
linear warmup gives a learning rate of 0 at step 0, which would leave the
parameters unmoved. The LoRA and distillation paths take stage 1's
recipe with their own flags; train-image, the input-head and the offload
paths take a constant learning rate too.

``--mesh-train`` builds the kernels and runs only the mesh training's
kernel records and phase 11a (a development reading; no device line).

``--mesh-margin SEED...`` builds the kernels and runs only
:func:`mesh_margin`: the full-width (seq 2, tensor 2) clip against the
single-rank clip at each weight-and-noise seed, beside the single-rank
clip's own sensitivity to another fp32 summation order. It is a reading,
not a check: it fails on no value, and prints no device line.

It needs a CUDA device and exits nonzero without one. It imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import random
import re
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from video_gpt_tpu_torch import cli
from video_gpt_tpu_torch.config import (MeshConfig, ModelConfig, TrainConfig,
                                        stage_config)
from video_gpt_tpu_torch.data.image_text import (ImageGenSample,
                                                 collate_image_gen,
                                                 resize_center_crop)
from video_gpt_tpu_torch.data.video import (ClipSample,
                                            preprocess_to_resolution,
                                            random_block_partition)
from video_gpt_tpu_torch.image_gen import (DEFAULT_NEGATIVE_PROMPT,
                                           ImageGenPipeline,
                                           ImageGenProcessor, StubTokenizer,
                                           single_shot_layout)
from video_gpt_tpu_torch.layout import (frame_block_inference_layout,
                                        tokens_per_frame)
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.models.video_gpt import decode_mask
from video_gpt_tpu_torch.ops import _cuda
from video_gpt_tpu_torch.ops import flash_attention as fa
from video_gpt_tpu_torch.ops.attention import AttnMeta
from video_gpt_tpu_torch.parallel.distributed import hop, spawn_ranks
from video_gpt_tpu_torch.parallel.mesh import make_mesh
from video_gpt_tpu_torch.probes import overlap_probe
from video_gpt_tpu_torch.sampling.pipeline import VideoGPTPipeline
from video_gpt_tpu_torch.models.video_gpt import VideoGPT
from video_gpt_tpu_torch.training.data import collate
from video_gpt_tpu_torch.training.image_trainer import ImageGenTrainer
from video_gpt_tpu_torch.training.distill import (DistillDraws,
                                                  distillation_loss)
from video_gpt_tpu_torch.training.lora import (is_adapter, lora_state_dict,
                                               merge_lora)
from video_gpt_tpu_torch.training.loss import LossDraws, training_loss
from video_gpt_tpu_torch.training.train_state import autocast
from video_gpt_tpu_torch.training.trainer import Trainer

H_PX, W_PX = 176, 320
N_CLEAN, N_GEN, STEPS, CFG_SCALE = 8, 16, 10, 1.5
# the long rollout of configs/inference.sh: 56 conditioning frames, two
# 24-frame clips, an 80-frame window, 50 steps, guidance 1.5, no re-noise
ROLLOUT_CLEAN, ROLLOUT_GEN, ROLLOUT_WINDOW, ROLLOUT_STEPS = 56, (24, 24), \
    80, 50
# the batched rollout: that recipe for 2 videos through generate_batch, at
# the flagship's 10 steps (a cut in steps only, for the script's time)
BATCH_VIDEOS, BATCH_STEPS = 2, 10
# the long rollout's first block once more under the profiler, at this many
# steps (cut from the rollout's 50 for the script's time: a traced step
# costs ~4x an untraced one)
ROLLOUT_PROFILE_STEPS = 10
# K5's shape: the uncond row of a 40-frame clip (Lq = Lk = 8880)
K5_FRAMES = 40
# the overlap probe's problems per launch: two blocks of 128 rows each,
# one block an SM, two waves over the 132 SMs
P1_PROBLEMS = 132
# kernel vs plain, per element (bf16 inputs; the plain version in fp32 from
# the same values):
#   |got - want| <= ATOL + RTOL |want| + BF16_U * mass,
# mass = sum_k p |v| / sum_k p, the plain version run on |V|. The kernels
# round to bf16 (unit roundoff BF16_U = 2^-8) the probabilities before P.V,
# which moves an output by at most BF16_U * mass, and the output, by at most
# BF16_U |want| (RTOL is 2.5x that); ATOL covers fp32 summation order. The
# bar is each element's own rounding bound: a kernel that normalises 5%
# off or drops a partial key tile fails it.
KERNEL_ATOL, KERNEL_RTOL, BF16_U = 1e-4, 1e-2, 2.0 ** -8
# the fp32 kernel against its plain version in fp32 on the card, per
# element: |got - want| <= FP32_ATOL + FP32_RTOL |want|, the tier-1
# plain-versus-Pallas bar at fp32 (both sum in another order; nothing is
# rounded to bf16)
FP32_ATOL = FP32_RTOL = 2e-5
# the fp32 backward (K9-fp32, K7-fp32) against its plain version in fp32
# on the card, per element: |got - want| <= FP32_ATOL + FP32_RTOL |want| +
# FP32_BWD_MASS * mass, with the bf16 bar's backward masses (|ds| |K|,
# |ds|^T |Q|, p^T |dO|). Nothing is rounded to bf16, but ds = p (dp - di)
# cancels where dp is near di: an element of dq, dk, dv then carries the
# fp32 summation error of its terms (their mass, not its value), and p
# that of the forward's lse (~1e-6 relative at the flagship's logits).
# 2^-18 is 64 fp32 ulps of the mass.
FP32_BWD_MASS = 2.0 ** -18
# small-input reference: bf16 activations against fp32 ones over the whole
# slice (trunk, Euler steps, VAE) stay some 20x below this bar (the script
# prints that rounding floor, measured with the plain versions on the CPU);
# hiding the clean cache from the decode step lands above it
REF_REL_MSE_BAR = 1e-3
# the fp32 small-input reference: card fp32 (the fp32 kernel, fp32 GEMMs and
# convolutions, no TF32) against the CPU in fp32, final-latent relative MSE
# at most this, or twice the floor (the CPU's own clip with its linears in
# another fp32 summation order) where that is above it
FP32_REF_BAR = 1e-6
# small-input training reference: the card's bf16 gradient may be off the
# CPU's fp32 one by at most this many times the CPU's own bf16 error (the
# same bf16 rounding, made at other places by other kernels). The loss, a
# mean over every latent element, is held to one bf16 rounding of itself
# (2^-8 relative): its CPU bf16 error is one draw of a quantity that
# averages out (1.4e-5 in one run), too small a sample to scale a bar by.
TRAIN_REF_FLOOR_FACTOR = 4.0
# the training paths (configs/pretrain_stage{1,4}.sh, learning rate
# constant): stage -> (frames, timed steps, launches of each kernel per
# layer and step, builds of the bias's tile map per step). Each layer runs
# the forward twice (per-layer recompute); every layer's K3 and K9 read the
# one map of the step's bias. Stage 4 times one step (8.5 s; two until
# the script's time was cut).
TRAIN_PATHS = {1: (16, 3, {"K3": 2, "K9": 1}, 1),
               4: (80, 1, {"K6": 2, "K7": 1}, 0)}
# stage 1 with --mixed_precision no (fp32 end to end): one timed step
# after the warm-up
FP32_TRAIN_STEPS = 1
TRAIN_LR = 1e-4
# the LoRA path: rank-8 adapters on qkv_proj / o_proj (the reference's
# peft recipe) over a frozen stage-1 model; per step and layer 2 K3 and 1
# K9, one bias-map build, as the stage-1 path
LORA_RANK, LORA_STEPS = 8, 2
# guided distillation, the first round of configs/distill_serving.sh: a
# 5-step student from 2 teacher substeps each, guidance 1.5 baked in; per
# step and layer 6 K3 (2 substeps x (cond, uncond) teacher forwards, the
# student's forward and recompute) and 1 K9, one map per layout (2)
DISTILL = dict(distill=True, distill_student_steps=5, distill_substeps=2,
               distill_guidance=1.5, distill_lr=1e-4)
DISTILL_STEPS = 2
# serving the guided student: one cond row, 5 steps (its serving line)
STUDENT_STEPS = 5
# the image family at the CLI's defaults: (a) text -> image, 1024x1024, 50
# steps, guidance 3.0 (the README's prompt and the default negative
# prompt); (b) editing with one 1024x1024 input image and 3-way guidance
# (img_guidance_scale 1.6) at 10 steps, a cut in steps only
IMAGE_PX, IMAGE_STEPS, EDIT_STEPS = 1024, 50, 10
IMAGE_CFG, IMAGE_IMG_CFG = 3.0, 1.6
IMAGE_PROMPT = "a red bird"
EDIT_PROMPT = "make it red <img><|image_1|></img>"
# train-image at its CLI defaults (512x512, max_input_images 3: L 4,609)
# with one input image, and stage 1 with the aux input head
TRAIN_IMAGE_PX, MAX_INPUT_IMAGES, TRAIN_IMAGE_STEPS = 512, 3, 2
INPUT_HEAD_STEPS = 2
# the offload optimizer at stage 1 (configs/pretrain_stage1.sh with
# --offload_optimizer, learning rate constant): a warm-up, OFFLOAD_STEPS
# timed steps at grad_splits 1, one at 2. Its host state takes
# OFFLOAD_HOST_BYTES a parameter (fp32 master, mu and nu; the bf16
# transfer buffer); the phase cuts the depth (printed, listed in CUTS)
# unless the host's MemAvailable holds it OFFLOAD_HOST_MARGIN times over.
# The host update touches OFFLOAD_UPDATE_BYTES a parameter at the least:
# the bf16 gradient read and the new bf16 parameter written, master, mu
# and nu read and written.
OFFLOAD_STEPS = 2
OFFLOAD_HOST_BYTES, OFFLOAD_HOST_MARGIN = 14, 1.25
# the offload path's depth, cut from 32 layers for the script's time: its
# host update (~19 s a step at 32 layers) scales with the depth, and so
# does its share of a slow or busy host's CPU
OFFLOAD_LAYERS = 8
OFFLOAD_UPDATE_BYTES = 28
# the paths after the mesh (items 13-22b) run at LATE_LAYERS of the 32
# layers when the mesh ends past LATE_AT_S seconds into the script (F26
# ended it at 581 s, F27 at 649 s; their paths after it took ~200 s at
# full depth): on a host that much slower the script would not end within
# its 1,200 s. PATH_LAYERS is that depth once cut (None: full depth)
LATE_AT_S, LATE_LAYERS = 800.0, 4
PATH_LAYERS = None
# the cuts in depth this run made beyond those of the constants above
CUTS = []
# the seed of the stage-4 batch's random_block_partition draw
PARTITION_SEED = 0
# a kernel's timing runs as many launches as fit this many ms (at most 20;
# the plain version at most 3, the library call at most 10)
TIME_BUDGET_MS = 2000.0
# H100 SXM data-sheet peaks (dense bf16 tensor rate, fp32 CUDA-core rate,
# HBM3 rate)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 66.9e12
# the fp32 kernels' rate: each fp32 product as six bf16 tensor-core
# products of the operands' bf16 pieces (csrc/fp32_split.cuh)
PEAK_SPLIT_FP32_FLOPS = PEAK_BF16_FLOPS / 6
PEAK_BYTES = 3.35e12
TPU_KERNELS = "video_gpt_tpu/ops/flash_attention.py"
# the script's start, for the phases' elapsed time
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn, max_reps: int, budget_ms: float = TIME_BUDGET_MS) -> float:
    """Mean device time of ``fn``: one launch warms up and sizes the run,
    then as many launches as fit ``budget_ms``, at most ``max_reps``."""
    first = time_ms(fn, reps=1, warmup=0)
    reps = int(max(1, min(max_reps, budget_ms // max(first, 1e-3))))
    return time_ms(fn, reps=reps, warmup=0)


def bound(nbytes: int, flops: int, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_source(bf16_source: str, dtype: torch.dtype) -> str:
    """The source of the kernel that operands of ``dtype`` run: the bf16
    kernel's, or the fp32 kernel's."""
    name = bf16_source if dtype == torch.bfloat16 else "fp32_attention.cu"
    return f"video_gpt_tpu_torch/csrc/{name}"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def rank_pairs(rank: torch.Tensor, q_off: torch.Tensor) -> int:
    """Visible (query, key) pairs of a columnar mask, over its batch rows."""
    return sum(int(torch.searchsorted(r.sort().values, o.contiguous(),
                                      right=True).sum())
               for r, o in zip(rank, q_off))


def rank_visibility(mask) -> torch.Tensor:
    """[B, 1, Lq, Lk] bool of a columnar mask: the library call's mask."""
    return (mask.q_off[:, :, None] >= mask.rank[:, None, :])[:, None]


class HostFloatOps(TorchDispatchMode):
    """Records every aten op that touches a floating-point tensor on the
    host, apart from 0-dim operands (Python scalars), empty tensors (the
    placeholder that activation checkpointing allocates), ops that compute
    nothing (views, reading a scalar out) and copies between the host and
    the card (inputs in, results out). A copy or cast from host to host is
    recorded."""

    NO_COMPUTE = {"aten::lift_fresh", "aten::detach", "aten::alias",
                  "aten::_local_scalar_dense"}
    COPIES = {"aten::to", "aten::_to_copy", "aten::copy_"}

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        tensors = [x for x in tree_leaves((args, kwargs, out))
                   if isinstance(x, torch.Tensor)]
        on_host = any(x.device.type == "cpu" and x.is_floating_point()
                      and x.dim() > 0 and x.numel() > 0 for x in tensors)
        crosses = name in self.COPIES and any(x.device.type != "cpu"
                                              for x in tensors)
        if on_host and name not in self.NO_COMPUTE and not crosses:
            self.ops.add(name)
        return out


def _bf16_maker(dev, seed: int, dtype=torch.bfloat16):
    """bf16 (or ``dtype``) standard-normal tensors on ``dev`` from a numpy
    seed."""
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dtype)

    return bf16


def f32(*ts):
    return [t.float() for t in ts]


def vals(*ts, absv):
    # V in fp32, or |V| for the rounding bound's mass
    return [t.float().abs() if absv else t.float() for t in ts]


def _heads(heads=None, head_dim=None):
    """(heads, kv heads, head_dim): the flagship's, or ``heads`` of each
    (the flagship has as many kv heads as heads); at ``head_dim``, the
    flagship's width (3072) in heads of that width."""
    cfg = ModelConfig()
    if head_dim is not None:
        h = cfg.hidden_size // head_dim
        return h, h, head_dim
    if heads is None:
        return cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return heads, heads, cfg.head_dim


def decode_split_record(dev, seed: int, meta: AttnMeta, tail: int,
                        replaces: int, heads: int = None,
                        head_dim: int = None,
                        dtype: torch.dtype = torch.bfloat16) -> dict:
    """K1 over a cond row: the noisy tail's queries against the cache
    (heads-major) and the tail's own K/V (views of tokens-major K/V, as
    Phi3Attention passes them), for the batch rows of ``meta``; at the
    flagship's 32 heads, or ``heads`` (a mesh rank's share), or the
    flagship's width in heads of ``head_dim``; bf16 or fp32 operands."""
    h, hkv, d = _heads(heads, head_dim)
    bf16 = _bf16_maker(dev, seed, dtype)
    b, lc = meta.index.shape[0], meta.index.shape[1] - tail
    q = bf16(b, tail, h, d)
    kc, vc = bf16(b, hkv, lc, d), bf16(b, hkv, lc, d)
    kt_tok, vt_tok = bf16(b, tail, hkv, d), bf16(b, tail, hkv, d)
    kt, vt = kt_tok.transpose(1, 2), vt_tok.transpose(1, 2)
    mask = decode_mask(meta.tail(tail), meta)
    rank_c, rank_t = mask.rank[:, :lc], mask.rank[:, lc:]

    def fn():
        return fa.flash_mha_decode_split(q, kc, vc, kt, vt, mask)

    def plain(absv=False):
        return fa.rank_attention_reference(
            *f32(q), f32(kc, kt), vals(vc, vt, absv=absv), (rank_c, rank_t),
            mask.q_off)

    kcat = torch.cat([kc, kt], 2)
    vcat = torch.cat([vc, vt], 2)
    vis = rank_visibility(mask)
    qh = q.transpose(1, 2).contiguous()

    def lib():
        return F.scaled_dot_product_attention(qh, kcat, vcat, attn_mask=vis)

    return dict(
        fn=fn, plain=plain, lib=lib, route="cuda",
        source=kernel_source("rank_attention.cu", dtype), dtype=dtype,
        replaces=f"{TPU_KERNELS}:{replaces}",
        shape=f"B {b}, Lq {tail} vs {lc} cached + {tail} new keys",
        bytes=nbytes(q, kc, vc, kt, vt, mask.rank, mask.q_off, q),
        flops=4 * h * d * rank_pairs(mask.rank, mask.q_off),
        tiles=lambda: fa.rank_tile_classes_reference((rank_c, rank_t),
                                                     mask.q_off))


def decode_record(dev, seed: int, meta: AttnMeta, replaces: int,
                  heads: int = None, head_dim: int = None,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """K2 over a tail-only row (the uncond row), tokens-major K/V of its
    own, for the batch rows of ``meta`` (heads, width and dtype as
    :func:`decode_split_record`)."""
    h, hkv, d = _heads(heads, head_dim)
    bf16 = _bf16_maker(dev, seed, dtype)
    b, L = meta.index.shape
    mask = decode_mask(meta, meta)
    q, k, v = bf16(b, L, h, d), bf16(b, L, hkv, d), bf16(b, L, hkv, d)

    def fn():
        return fa.flash_mha_decode(q, k, v, mask)

    def plain(absv=False):
        return fa.rank_attention_reference(
            *f32(q), f32(k.transpose(1, 2)),
            vals(v.transpose(1, 2), absv=absv), (mask.rank,), mask.q_off)

    vis = rank_visibility(mask)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def lib():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=vis)

    return dict(
        fn=fn, plain=plain, lib=lib, route="cuda",
        source=kernel_source("rank_attention.cu", dtype), dtype=dtype,
        replaces=f"{TPU_KERNELS}:{replaces}", shape=f"B {b}, Lq = Lk = {L}",
        bytes=nbytes(q, k, v, mask.rank, mask.q_off, q),
        flops=4 * h * d * rank_pairs(mask.rank, mask.q_off),
        tiles=lambda: fa.rank_tile_classes_reference((mask.rank,),
                                                     mask.q_off))


def bias_record(dev, seed: int, meta: AttnMeta, replaces: int,
                heads: int = None, head_dim: int = None,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """K3 over a prefill's clean prefix with its precomputed bias (heads,
    width and dtype as :func:`decode_split_record`; the bias is bf16 at
    every dtype, as the model builds it)."""
    h, hkv, d = _heads(heads, head_dim)
    bf16 = _bf16_maker(dev, seed, dtype)
    L = meta.index.shape[1]
    bias = fa.precompute_bias(meta, meta)
    # the map is built once per bias, as the prefill builds it for its 32
    # layers: the kernel's time is the attention alone
    bm = fa.bias_map(bias)
    q, k, v = bf16(1, L, h, d), bf16(1, L, hkv, d), bf16(1, L, hkv, d)

    def fn():
        return fa.flash_mha(q, k, v, bm)

    def plain(absv=False):
        return fa.bias_attention_reference(*f32(q, k), *vals(v, absv=absv),
                                           bias)

    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    # the library takes a float mask of the query's dtype
    bias4 = bias[:, None].to(dtype)

    def lib():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias4)

    return dict(
        fn=fn, plain=plain, lib=lib, route="cuda",
        source=kernel_source("bias_attention.cu", dtype), dtype=dtype,
        replaces=f"{TPU_KERNELS}:{replaces}",
        shape=f"B 1, Lq = Lk = {L}, bf16 bias",
        bytes=nbytes(q, k, v, bias, q),
        flops=4 * h * d * int((bias == 0).sum()),
        tile_map=bias_tile_map(bias))


def kernels_phase(dev):
    """Each kernel at the shapes of its paths vs its plain version; returns
    {name: record} without the launch counts."""
    n_img = tokens_per_frame(H_PX, W_PX)
    lay_c = frame_block_inference_layout(N_CLEAN, N_GEN, n_img, False)
    lay_u = frame_block_inference_layout(0, N_GEN, n_img, False)
    meta_c = AttnMeta.from_layout(lay_c, dev)
    tail = lay_c.noisy_tail_len()
    lc = lay_c.length - tail
    out = {}
    # the serving flagship: K1 in the cond-row decode, K2 in the uncond
    # row, K3 in the prefill
    for name, make in (
            ("K1", lambda: decode_split_record(dev, 0, meta_c, tail, 661)),
            ("K2", lambda: decode_record(
                dev, 1, AttnMeta.from_layout(lay_u, dev), 416)),
            ("K3", lambda: bias_record(dev, 2, meta_c.cols(slice(0, lc)),
                                       133))):
        out[name] = check_and_time(name, make())
    out["K1"]["host_us"] = launch_host_us(dev)
    out.update(long_kernels(dev))
    out.update(probe_kernels(dev))
    train = training_kernels(dev)
    out["K3"]["training_shape"] = train.pop("K3")
    out.update(train)
    torch.cuda.empty_cache()
    out.update(inline_kernels(dev))
    for name, key, rec in rollout_kernels(dev):
        out[name][key] = rec
    for name, key, rec in mesh_kernels(dev):
        out[name][key] = rec
    for name, key, rec in mesh_train_kernels(dev):
        out[name][key] = rec
    image = image_kernels(dev)
    for key in ("image_decode_2way", "image_decode_3way"):
        out["K3"][key] = image[key]
    for name, rec in image["train_image_shape"].items():
        out[name]["train_image_shape"] = rec
    # the bf16 kernels' other widths under their kernel; the fp32 kernel
    # under each mask a kernel of its own (K1-fp32 ...), its first row
    # the record and the others beside it
    for name, key, rec in (*width_kernels(dev), *width_bwd_kernels(dev)):
        if not key.startswith("fp32"):
            out[name][key] = rec
            continue
        fname = f"{name}-fp32"
        if fname in out:
            out[fname][key] = rec
        else:
            out[fname] = dict(rec, name=fname, shape_key=key)
    return out


def launch_host_us(dev, n: int = 500) -> dict:
    """Host time of one K1 call (``flash_mha_decode_split``: its checks,
    the tensor maps' encoding and the launch) in microseconds, at a tiny
    shape (B 1, 4 heads, 64 queries over 64 + 64 keys) whose device time
    is below it, so that the launch queue never fills; beside it one
    ``torch.add`` of two such tensors, a PyTorch launch's host cost."""
    bf16 = _bf16_maker(dev, 11)
    d = ModelConfig().head_dim
    q = bf16(1, 64, 4, d)
    kc, vc, kt, vt = (bf16(1, 2, 64, d) for _ in range(4))
    mask = fa.DecodeMask(torch.zeros(1, 128, dtype=torch.int32, device=dev),
                         torch.zeros(1, 64, dtype=torch.int32, device=dev))
    out = {}
    for name, fn in (
            ("K1", lambda: fa.flash_mha_decode_split(q, kc, vc, kt, vt,
                                                     mask)),
            ("torch.add", lambda: torch.add(q, q))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    log(f"host time per call: K1 {out['K1']:.2f} us, torch.add "
        f"{out['torch.add']:.2f} us")
    return out


def long_kernels(dev) -> dict:
    """The TPU's k-tiled kernels past 8192 keys, K4, K5 and K10, as the port
    runs them: K1, K2 and K3 (keys stream through shared memory with no
    length cap). K4 at the long rollout's cond row (5,328 queries against
    12,432 cached + 5,328 new keys), K5 at the uncond row of a 40-frame
    clip (Lq = Lk = 8,880; no path of this script makes such a clip), K10
    at the long rollout's prefill at B = 1 (12,432^2 with its 309 MB bias).
    The plain versions walk one kv head and 4096 query rows at a time."""
    n_img = tokens_per_frame(H_PX, W_PX)
    lay = frame_block_inference_layout(ROLLOUT_CLEAN, ROLLOUT_GEN[0], n_img,
                                       False)
    meta = AttnMeta.from_layout(lay, dev)
    tail = lay.noisy_tail_len()
    lay5 = frame_block_inference_layout(0, K5_FRAMES, n_img, False)
    out = {}
    for name, kernel, make in (
            ("K4", "K1", lambda: decode_split_record(dev, 3, meta, tail,
                                                     797)),
            ("K5", "K2", lambda: decode_record(
                dev, 4, AttnMeta.from_layout(lay5, dev), 551)),
            ("K10", "K3", lambda: bias_record(
                dev, 5, meta.cols(slice(0, lay.length - tail)), 929))):
        out[name] = check_and_time(name, make(), f" ({kernel}'s kernel)")
        out[name]["kernel"] = kernel
        torch.cuda.empty_cache()
    return out


def probe_kernels(dev) -> dict:
    """P1, the overlap probe's serial and pipelined bodies, at the probe's
    shapes (BQ 256 queries over LK 8192 keys of D 128) for G = P1_PROBLEMS
    problems in one launch (264 blocks, one an SM at a time), each against
    the plain version; the pipelined body for every nsub (with its speedup
    over the serial body), the record keeps nsub 4 (the serial body's
    64-key tile). The library yardstick is ``scaled_dot_product_attention``
    at scale ln 2: exp2(s) = exp(s ln 2), and no |s| here comes near the
    clamp at 100. Then the probe's own sweep at G 1 (``median_ms``), the
    TPU probe's occupancy."""
    q, k, v = overlap_probe.probe_inputs(P1_PROBLEMS, dev)

    def plain(absv=False):
        return overlap_probe.overlap_reference(
            q.float(), k.float(), v.float().abs() if absv else v.float())

    qh, kh, vh = q[:, None], k[:, None], v[:, None]

    def lib():
        return F.scaled_dot_product_attention(qh, kh, vh, scale=math.log(2))

    base = dict(plain=plain, lib=lib, route="cuda",
                source="video_gpt_tpu_torch/csrc/overlap_probe.cu",
                shape=f"G {P1_PROBLEMS} x (BQ {overlap_probe.BQ}, LK "
                      f"{overlap_probe.LK}, D {overlap_probe.D})",
                bytes=nbytes(q, k, v, q),
                flops=4 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2])
    out = {"P1-serial": check_and_time("P1-serial", dict(
        base, fn=lambda: overlap_probe.overlap_serial(q, k, v),
        replaces="scripts/overlap_probe.py:38"))}
    by_nsub = []
    for nsub in overlap_probe.NSUBS:
        r = check_and_time("P1-pipelined", dict(
            base, fn=lambda n=nsub: overlap_probe.overlap_pipelined(q, k, v,
                                                                    n),
            replaces="scripts/overlap_probe.py:49"), f" (nsub {nsub})")
        r["nsub"] = nsub
        by_nsub.append(r)
    serial_ms = out["P1-serial"]["ms"]
    out["P1-pipelined"] = dict(by_nsub[overlap_probe.NSUBS.index(4)],
                               by_nsub=[dict({k_: r[k_] for k_ in (
                                   "nsub", "ms", "max_abs_err",
                                   "err_over_bar")},
                                   speedup=serial_ms / r["ms"])
                                   for r in by_nsub])
    del q, k, v, qh, kh, vh
    sweep = overlap_probe.run(1, dev)
    log(json.dumps({"overlap_probe": sweep}))
    out["P1-pipelined"]["sweep_one_problem"] = sweep
    return out


def bias_tile_map(bias: torch.Tensor):
    """(build, plain) of the bias's tile map, which K3 and K9 read."""
    return (lambda: fa.bias_tile_classes(bias),
            lambda: fa.bias_tile_classes_reference(bias))


def tile_map_record(label: str, build, plain) -> dict:
    """A kernel's tile map (``build``: its classifier launches alone) held
    equal to the plain classifier (``plain``), then timed; the share of
    tiles the kernel computes (not empty) and skips the mask of (full)."""
    got = build()
    torch.cuda.synchronize()
    want = plain()
    if not torch.equal(got, want):
        fail(f"{label}: the kernel's tile map differs from the plain one in "
             f"{int((got != want).sum())} of {want.numel()} tiles")
    computed = float((want != fa.TILE_EMPTY).float().mean())
    full = float((want == fa.TILE_FULL).float().mean())
    ms = timed(build, max_reps=20)
    log(f"{label}: tile map {tuple(want.shape)} equal to the plain one; "
        f"tiles computed {computed:.4f} (full {full:.4f}, partial "
        f"{computed - full:.4f}); the map alone {ms:.4f} ms")
    return dict(shape=list(want.shape), equal=True, tiles_computed=computed,
                tiles_full=full, map_ms=ms)


def check_and_time(name: str, r: dict, label: str = "") -> dict:
    """One kernel against its plain version, then timed; ``fn`` and
    ``plain`` return a tensor or a tuple of tensors (``plain(absv=True)``:
    the rounding bound's mass of each). ``label`` names the shape in the
    log. With ``tile_map`` (build, plain), the kernel's tile map is held
    equal to the plain one and timed (tile_map_record); with ``tiles`` (the
    plain classes of a kernel that builds no map), their shares. A record
    with ``dtype`` fp32 is held to the fp32 bar (no rounding mass; with
    ``backward``, FP32_BWD_MASS of the backward's mass) and bound by the
    split-precision rate (PEAK_SPLIT_FP32_FLOPS; the log also gives the
    fp32 CUDA-core bound). ``budget_ms``: each timing's budget
    (TIME_BUDGET_MS by default)."""
    name_l = f"{name}{label}"
    fp32 = r.get("dtype") == torch.float32
    fp32_mass = FP32_BWD_MASS if fp32 and r.get("backward") else 0.0

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    got = tup(r["fn"]())
    torch.cuda.synchronize()
    want = tup(r["plain"]())
    mass = want if fp32 and not fp32_mass else tup(r["plain"](absv=True))
    err = ratio = 0.0
    finite = True
    for g, w, m in zip(got, want, mass):
        w = w.float()
        diff = (g.float() - w).abs()
        bar = (FP32_ATOL + FP32_RTOL * w.abs() + fp32_mass * m.float()
               if fp32 else
               KERNEL_ATOL + KERNEL_RTOL * w.abs() + BF16_U * m.float())
        # the worst element's error over its bar: the check passes at <= 1
        err = max(err, float(diff.max()))
        ratio = max(ratio, float((diff / bar).max()))
        finite = finite and bool(torch.isfinite(g).all())
        log(f"{name_l}: output {tuple(g.shape)}: max abs err "
            f"{float(diff.max()):.3e} vs plain, worst error / bar "
            f"{float((diff / bar).max()):.3f} (bar per element "
            f"{float(bar.min()):.2e} to {float(bar.max()):.2e}, median "
            f"{float(bar.median()):.2e}; |plain| median "
            f"{float(w.abs().median()):.2e}, max {float(w.abs().max()):.3f})")
        del diff, bar, w
    if not finite or not ratio <= 1.0:
        fail(f"{name_l} disagrees with its plain version: worst error / "
             f"bar {ratio}, finite={finite}")
    del got, want, mass
    torch.cuda.empty_cache()
    budget = r.get("budget_ms", TIME_BUDGET_MS)
    ms = timed(r["fn"], max_reps=20, budget_ms=budget)
    plain_ms = timed(r["plain"], max_reps=3, budget_ms=budget)
    lib_ms = timed(r["lib"], max_reps=10, budget_ms=budget)
    bound_ms, bound_by = bound(
        r["bytes"], r["flops"],
        PEAK_SPLIT_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
    ffma = (f", CUDA-core fp32 bound "
            f"{bound(r['bytes'], r['flops'], PEAK_FP32_FLOPS)[0]:.4f}"
            if fp32 else "")
    log(f"{name_l}: {ms:.4f} ms (plain {plain_ms:.4f}, sdpa {lib_ms:.4f}, "
        f"bound {bound_ms:.4f} by {bound_by}{ffma}; "
        f"{r['flops'] / ms / 1e9:.1f} TFLOP/s)")
    rec = dict(name=name, route=r["route"], source=r["source"],
               replaces=r["replaces"], max_abs_err=err, max_err=err,
               err_over_bar=ratio, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
               tflops_visible=r["flops"] / ms / 1e9,
               dtype="fp32" if fp32 else "bf16",
               **({"shape": r["shape"]} if "shape" in r else {}))
    if "tile_map" in r:
        rec["tile_map"] = tile_map_record(name_l, *r["tile_map"])
    if "tiles" in r:
        classes = r["tiles"]()
        rec["tiles"] = dict(
            computed=float((classes != fa.TILE_EMPTY).float().mean()),
            full=float((classes == fa.TILE_FULL).float().mean()))
        log(f"{name_l}: tiles computed {rec['tiles']['computed']:.4f} (full "
            f"{rec['tiles']['full']:.4f}; the plain classes)")
    return rec


def train_batch(stage: int, uncond: bool = False):
    """A training batch (B 1) of ``stage`` on the host: synthetic 176x320
    frames through the port's preprocessing, collated as the Trainer does
    (``uncond``: with guidance distillation's unconditional layout).
    Stage 1: 16 frames in interleaved blocks of one frame; stage 4: 80
    frames in the frame blocks of one seeded ``random_block_partition``
    draw."""
    n = TRAIN_PATHS[stage][0]
    blocks = ((1,) * n if stage == 1 else
              random_block_partition(n, random.Random(PARTITION_SEED)))
    pixels = preprocess_to_resolution(synthetic_frames(n), H_PX, W_PX)
    return collate([ClipSample(pixels, blocks)], tokens_per_frame(H_PX, W_PX),
                   uncond=uncond)


def visible_pairs(meta: AttnMeta, k_meta: AttnMeta = None) -> int:
    """The (query, key) pairs that the metadata rule makes visible (B 1)
    between the queries of ``meta`` and the keys of ``k_meta`` (``meta``'s
    own by default), counted in steps of rows as the plain inline versions
    walk them."""
    k_meta = meta if k_meta is None else k_meta
    L, lk = meta.index.shape[1], k_meta.index.shape[1]
    total = 0
    for r0 in range(0, L, fa.INLINE_ROWS):
        qm = meta.cols(slice(r0, min(r0 + fa.INLINE_ROWS, L)))
        total += int(fa._padded_visibility(qm, k_meta, qm.index.shape[1],
                                           lk).sum())
    return total


def training_kernels(dev) -> dict:
    """K3 and K9 at the stage-1 training shape: the bias of a real stage-1
    collate layout (L 7104)."""
    meta = train_batch(1).inputs.batch.meta
    return bias_train_records(dev, AttnMeta(*(x.to(dev) for x in meta)),
                              " (stage-1 training shape)")


def bias_train_records(dev, meta: AttnMeta, label: str,
                       heads: int = None) -> dict:
    """K3 and K9 over the bias of a training layout's ``meta``, 32 heads of
    96 (or ``heads``, a mesh rank's), random bf16 q/k/v and dO. K9's plain
    version computes the gradients in fp32 from the same bf16 values; the
    mass of each gradient element is the plain version's product over
    absolute values (K9 rounds p and ds to bf16 before its products)."""
    bias = fa.precompute_bias(meta, meta)
    h, hkv, d = _heads(heads)
    L = bias.shape[1]
    bf16 = _bf16_maker(dev, 5)
    # as the attention layer makes them: q, k new tensors (RoPE), v a view
    # of the fused projection
    q, k = bf16(1, L, h, d), bf16(1, L, hkv, d)
    v = bf16(1, L, h + 2 * hkv, d)[:, :, h + hkv:]
    do = bf16(1, L, h, d)
    # one map per bias, as a training step builds it for K3 and K9
    bm = fa.bias_map(bias)
    out, lse = fa._bias_forward(q, k, v, bm, with_lse=True)
    pairs = int((bias == 0).sum())
    log(f"attention{label}: L {L}, {pairs} visible pairs "
        f"({pairs / L ** 2:.3f} of L^2)")

    def k3_plain(absv=False):
        vf = v.float()
        return fa.bias_attention_reference(*f32(q, k),
                                           vf.abs() if absv else vf, bias)

    def k9():
        return fa.flash_mha_bwd(q, k, v, bm, out, do, lse)

    def k9_plain(absv=False):
        return fa.bias_attention_backward_reference(
            *f32(q, k, v), bias, *f32(out, do), magnitude=absv)

    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    mask = bias[:, None]

    def k3_lib():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    do_h = do.transpose(1, 2).contiguous()

    def k9_lib():  # the backward alone of the library's attention
        return torch.autograd.grad(lib_out, (qh, kh, vh), do_h,
                                   retain_graph=True)

    src = "video_gpt_tpu_torch/csrc/"
    recs = {
        "K3": dict(fn=lambda: fa.flash_mha(q, k, v, bm), plain=k3_plain,
                   lib=k3_lib, route="cuda", source=src + "bias_attention.cu",
                   replaces=f"{TPU_KERNELS}:133",
                   bytes=nbytes(q, k, v, bias, q),
                   flops=4 * h * d * pairs, tile_map=bias_tile_map(bias)),
        "K9": dict(fn=k9, plain=k9_plain, lib=k9_lib, route="cuda",
                   source=src + "bias_attention_bwd.cu",
                   replaces=f"{TPU_KERNELS}:192",
                   # read q, k, v, o, dO, the bias and lse; write dq, dk, dv
                   bytes=nbytes(q, k, v, out, do, bias, q, k, v)
                   + 4 * h * L,
                   # S, dP, dV, dQ, dK over the visible pairs
                   flops=5 * 2 * h * d * pairs)}
    res = {name: check_and_time(name, r, label) for name, r in recs.items()}
    # K9 reads the map that K3 read
    res["K9"]["tile_map"] = res["K3"]["tile_map"]
    return res


def inline_tile_map(label: str, meta: AttnMeta, q=None) -> dict:
    """K6's tile map of ``meta`` against itself (tile_map_record); with the
    launch's ``q``, also the query rows a block covers and the share of the
    K/V stages it loads on which every consumer warpgroup of the block
    computes (from the plain map: ``inline_groups_reference``)."""
    rec = tile_map_record(
        label, lambda: fa.inline_tile_classes(meta, meta),
        lambda: fa.inline_tile_classes_reference(meta, meta))
    if q is not None:
        b, L, h, d = q.shape
        rows = fa.inline_block_rows(b, L, h, d, q.device)
        groups = fa.inline_groups_reference(
            fa.inline_tile_classes_reference(meta, meta), rows // fa.TILE_Q)
        shared = float(groups.shared.sum() / groups.tiles.sum())
        log(f"{label}: {rows}-row blocks, {int(groups.tiles.sum())} K/V "
            f"stages loaded, every consumer computes on {shared:.4f}")
        rec.update(block_rows=rows, stages_loaded=int(groups.tiles.sum()),
                   stages_all_consumers=shared)
    return rec


def inline_kernels(dev) -> dict:
    """K6 and K7 at the stage-4 training shape (the metadata of a real
    stage-4 collate layout, L 35520, 32 heads of 96), and K6's kernel at
    the stage-1 shape (L 7104) under the name K8: the TPU's resident
    inline kernel computes the same function, and on the card K6 serves
    it. Random bf16 q/k/v and dO; the plain versions compute in fp32 from
    the same values, one kv head and 4096 query rows at a time. The bound
    counts the visible pairs from the metadata. The library yardstick is
    ``scaled_dot_product_attention`` with the equivalent boolean mask (for
    K7, its backward alone)."""
    bf16 = _bf16_maker(dev, 7)

    def operands(stage):
        return stage_operands(dev, bf16, stage)

    meta, q, k, v, pairs = operands(4)
    res = inline_train_records(bf16, meta, q, k, v, pairs,
                               " (stage-4 training shape)")
    res["K6"]["tile_map"] = inline_tile_map("K6 (stage-4 training shape)",
                                            meta, q)
    del q, k, v
    torch.cuda.empty_cache()

    meta, q, k, v, pairs = operands(1)
    res["K8"] = check_and_time("K8", inline_record(
        meta, q, k, v, pairs, lambda: fa.flash_mha_inline(q, k, v, meta, meta),
        149, with_lse=False), " (K6's kernel at the stage-1 shape)")
    res["K8"]["same_kernel_as"] = "K6"
    res["K8"]["tile_map"] = inline_tile_map(
        "K8 (K6's kernel at the stage-1 shape)", meta, q)
    return res


def stage_operands(dev, bf16, stage: int, heads: int = None):
    """(metadata of a stage's training layout, q, k, v at ``heads`` (the
    flagship's by default), its visible pairs)."""
    meta = AttnMeta(*(x.to(dev) for x in
                      train_batch(stage).inputs.batch.meta))
    q, k, v = inline_operands(bf16, meta, heads=heads)
    L = meta.index.shape[1]
    pairs = visible_pairs(meta)
    log(f"stage-{stage} attention: L {L}, {pairs} visible pairs "
        f"({pairs / L ** 2:.3f} of L^2)")
    return meta, q, k, v, pairs


def inline_train_records(bf16, meta: AttnMeta, q, k, v, pairs: int,
                         label: str) -> dict:
    """K6 (the training forward, with its logsumexp) and K7 on ``q``,
    ``k``, ``v`` over ``meta``, with a random bf16 dO."""
    src = "video_gpt_tpu_torch/csrc/"
    b, L, h, d = q.shape
    do = bf16(b, L, h, d)
    out, lse = fa._inline_forward(q, k, v, meta, meta, with_lse=True)
    qh, kh, vh, mask = inline_sdpa_operands(q, k, v, meta)

    def k7():
        return fa.flash_mha_inline_bwd(q, k, v, meta, meta, out, do, lse)

    def k7_plain(absv=False):
        return fa.inline_attention_backward_reference(
            *f32(q, k, v), meta, meta, *f32(out, do), magnitude=absv)

    lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    do_h = do.transpose(1, 2).contiguous()

    def k7_lib():  # the backward alone of the library's attention
        return torch.autograd.grad(lib_out, (qh, kh, vh), do_h,
                                   retain_graph=True)

    recs = {
        # the training forward, which keeps the logsumexp
        "K6": inline_record(meta, q, k, v, pairs, lambda: fa._inline_forward(
            q, k, v, meta, meta, with_lse=True)[0], 1071, with_lse=True),
        "K7": dict(fn=k7, plain=k7_plain, lib=k7_lib, route="cuda",
                   source=src + "inline_attention_bwd.cu",
                   replaces=f"{TPU_KERNELS}:1215,1249",
                   # read q, k, v, o, dO, lse and the metadata; write dq,
                   # dk, dv
                   bytes=nbytes(q, k, v, out, do, lse, q, k, v)
                   + meta_bytes(meta),
                   # S, dP, dV, dQ, dK over the visible pairs
                   flops=5 * 2 * h * d * pairs,
                   # K6's map, with the column counts, in each K7 launch
                   tile_map=(lambda: fa.inline_tile_classes(
                       meta, meta, backward=True),
                       lambda: fa.inline_tile_classes_reference(meta, meta)))}
    res = {name: check_and_time(name, r, label) for name, r in recs.items()}
    del recs, out, lse, do, lib_out, do_h, qh, kh, vh, mask
    torch.cuda.empty_cache()
    return res


def inline_operands(bf16, meta: AttnMeta, heads: int = None,
                    head_dim: int = None):
    """q, k, v for the batch rows of ``meta`` as the attention layer makes
    them: q, k new tensors (RoPE), v a view of the fused projection (heads
    and width as :func:`decode_split_record`)."""
    h, hkv, d = _heads(heads, head_dim)
    b, L = meta.index.shape
    v = bf16(b, L, h + 2 * hkv, d)[:, :, h + hkv:]
    return bf16(b, L, h, d), bf16(b, L, hkv, d), v


def inline_sdpa_operands(q, k, v, meta: AttnMeta):
    """The library call's operands: heads-major copies of q/k/v and the
    mask as bool."""
    L = meta.index.shape[1]
    mask = fa._padded_visibility(meta, meta, L, L)[:, None]
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    return qh, kh, vh, mask


def meta_bytes(meta: AttnMeta) -> int:
    """The metadata's int32 bytes, an expanded (batch-stride-0) vector
    counted once."""
    return sum(4 * x.shape[1] * (x.shape[0] if x.stride(0) else 1)
               for x in meta)


def inline_record(meta, q, k, v, pairs: int, fn, replaces: int,
                  with_lse: bool) -> dict:
    """K6 (forward) on the operands of :func:`inline_operands`: the plain
    version in fp32 from the same values, the library call with the
    equivalent bool mask, the bound over ``pairs`` visible pairs."""
    h, d = q.shape[2], q.shape[3]
    qh, kh, vh, mask = inline_sdpa_operands(q, k, v, meta)

    def plain(absv=False):
        vf = v.float()
        return fa.inline_attention_reference(
            *f32(q, k), vf.abs() if absv else vf, meta, meta)[0]

    def lib():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    # read q, k, v and the metadata; write out (and lse)
    out_bytes = nbytes(q) + (4 * h * q.shape[0] * q.shape[1] if with_lse
                             else 0)
    return dict(fn=fn, plain=plain, lib=lib, route="cuda",
                source=kernel_source("inline_attention.cu", q.dtype),
                dtype=q.dtype, replaces=f"{TPU_KERNELS}:{replaces}",
                bytes=nbytes(q, k, v) + out_bytes + meta_bytes(meta),
                flops=4 * h * d * pairs)


def rollout_kernels(dev):
    """The rollouts' kernels at the shapes the K4/K10 records leave out:
    K2 over the long rollout's own uncond row (B 1, 5,328^2); the batched
    rollout's K1 cond row (B 2, 5,328 queries against a heads-major cache
    of 12,432 + 5,328 new keys), its K2 uncond row (B 2, 5,328^2), and its
    prefill through K6 (B 2 x 12,432^2, above the bias limit), whose
    ``index`` is an expanded view with batch stride 0. Yields (kernel, key
    of its record, result)."""
    n_img = tokens_per_frame(H_PX, W_PX)
    gen = ROLLOUT_GEN[0]

    def metas(rows):
        lay = frame_block_inference_layout(ROLLOUT_CLEAN, gen, n_img, False,
                                           rows=rows)
        lay_u = frame_block_inference_layout(0, gen, n_img, False, rows=rows)
        return (lay, AttnMeta.from_layout(lay, dev),
                AttnMeta.from_layout(lay_u, dev))

    _, _, meta_u = metas(1)
    yield "K2", "long_rollout_shape", check_and_time(
        "K2", decode_record(dev, 8, meta_u, 416), " (long rollout, uncond)")
    torch.cuda.empty_cache()
    lay, meta, meta_u = metas(BATCH_VIDEOS)
    tail = lay.noisy_tail_len()
    for name, label, make in (
            ("K1", "cond", lambda: decode_split_record(dev, 9, meta, tail,
                                                       661)),
            ("K2", "uncond", lambda: decode_record(dev, 10, meta_u, 416))):
        yield name, "batched_rollout_shape", check_and_time(
            name, make(), f" (batched rollout, {label})")
        torch.cuda.empty_cache()
    mp = meta.cols(slice(0, lay.length - tail))
    if mp.index.stride(0) != 0:
        fail("the batched prefill's index is not a batch-stride-0 view")
    q, k, v = inline_operands(_bf16_maker(dev, 11), mp)
    pairs = visible_pairs(mp)
    log(f"batched prefill attention: B {BATCH_VIDEOS}, L {mp.index.shape[1]}"
        f", {pairs} visible pairs")

    def k6():
        with torch.no_grad():
            return fa.flash_mha_inline(q, k, v, mp, mp)

    rec = check_and_time(
        "K6", inline_record(mp, q, k, v, pairs, k6, 1071, with_lse=False),
        " (batched rollout prefill)")
    rec["tile_map"] = inline_tile_map("K6 (batched rollout prefill)", mp, q)
    yield "K6", "batched_rollout_shape", rec
    torch.cuda.empty_cache()


# ---- every dtype and head width of the forward kernels ----------------------

# the bf16 kernels' other head widths, each at the flagship's width (3072)
# in heads of that width, so that the work per launch stays the flagship's
WIDTHS = (16, 64, 128)


def width_kernels(dev):
    """The forward kernels at the other dtype and head widths their wrappers
    take: K1, K2, K3 and K6 in bf16 at head_dim 16, 64 and 128 over the
    flagship's lengths (K6 over the prefill's clean prefix and its
    metadata, as a seq mesh's prefill runs it); the fp32 kernel as K1, K2
    and K3 at the flagship's shapes, as K3 at the text -> image decode
    (4,097 queries over 14 cached + 4,097 keys) and at the stage-1 training
    shape (L 7104; 64 launches per fp32 stage-1 step) and as K6 at the
    batched rollout's prefill (B 2 x 12,432^2). Yields (kernel, key of its
    record, result); the bf16 rows are held to the bf16 bar, the fp32 rows
    to the fp32 bar (``FP32_ATOL`` + ``FP32_RTOL`` |plain|)."""
    n_img = tokens_per_frame(H_PX, W_PX)
    lay_c = frame_block_inference_layout(N_CLEAN, N_GEN, n_img, False)
    lay_u = frame_block_inference_layout(0, N_GEN, n_img, False)
    meta_c = AttnMeta.from_layout(lay_c, dev)
    meta_u = AttnMeta.from_layout(lay_u, dev)
    tail = lay_c.noisy_tail_len()
    mp = meta_c.cols(slice(0, lay_c.length - tail))
    f32t = torch.float32

    def k6_record(meta, seed, dtype, head_dim=None):
        q, k, v = inline_operands(_bf16_maker(dev, seed, dtype), meta,
                                  head_dim=head_dim)

        def k6():
            with torch.no_grad():
                return fa.flash_mha_inline(q, k, v, meta, meta)

        return inline_record(meta, q, k, v, visible_pairs(meta), k6, 1071,
                             with_lse=False)

    rows = []
    for d in WIDTHS:
        key = f"bf16_d{d}"
        rows += [
            ("K1", key, d, lambda d=d: decode_split_record(
                dev, 60, meta_c, tail, 661, head_dim=d)),
            ("K2", key, d, lambda d=d: decode_record(dev, 61, meta_u, 416,
                                                     head_dim=d)),
            ("K3", key, d, lambda d=d: bias_record(dev, 62, mp, 133,
                                                   head_dim=d)),
            ("K6", key, d, lambda d=d: k6_record(mp, 63, torch.bfloat16, d))]
    (row, *_), n_out = image_rows()["text"]
    d = ModelConfig().head_dim
    rows += [
        ("K1", "fp32_flagship", d, lambda: decode_split_record(
            dev, 64, meta_c, tail, 661, dtype=f32t)),
        ("K2", "fp32_flagship", d, lambda: decode_record(
            dev, 65, meta_u, 416, dtype=f32t)),
        ("K3", "fp32_flagship", d, lambda: bias_record(dev, 66, mp, 133,
                                                       dtype=f32t)),
        ("K3", "fp32_image_decode_2way", d, lambda: image_decode_record(
            dev, 67, row, n_out, f32t)),
        ("K3", "fp32_train", d, lambda: bias_record(
            dev, 69, AttnMeta(*(x.to(dev) for x in
                                train_batch(1).inputs.batch.meta)),
            133, dtype=f32t)),
        ("K6", "fp32_batched_rollout", d, lambda: k6_record(
            batched_prefill_meta(dev), 68, f32t))]
    for name, key, head_dim, make in rows:
        r = make()
        r.pop("tiles", None)
        r.pop("tile_map", None)
        rec = check_and_time(name, r, f" ({key})")
        rec["head_dim"] = head_dim
        yield name, key, rec
        del r
        torch.cuda.empty_cache()


def batched_prefill_meta(dev) -> AttnMeta:
    """The metadata of the batched rollout's prefill (B 2 x 12,432: the
    clean prefix of the long rollout's layout for 2 videos), whose
    ``index`` is an expanded view with batch stride 0."""
    lay = frame_block_inference_layout(
        ROLLOUT_CLEAN, ROLLOUT_GEN[0], tokens_per_frame(H_PX, W_PX), False,
        rows=BATCH_VIDEOS)
    meta = AttnMeta.from_layout(lay, dev)
    return meta.cols(slice(0, lay.length - lay.noisy_tail_len()))


# ---- every dtype and head width of the backward kernels --------------------

# the backward kernels' other widths (bf16) and dtype (fp32, at the
# flagship's 96): (key of the record, dtype, head_dim); each at the
# flagship's width in heads of that width
BWD_WIDTHS = tuple((f"bf16_d{d}", torch.bfloat16, d) for d in WIDTHS) + (
    ("fp32", torch.float32, 96),)
# K7 at the ring hop at these widths only: Dp 128's two dK/dV warpgroups
# and the fp32 backward (the bf16 hops at 16 and 64 were cut for the
# script's time: ~15 s, the plain K7 over 17,760^2 at 96 / 24 heads)
RING_HOP_WIDTHS = (128, 96)


def bwd_source(name: str, dtype: torch.dtype) -> str:
    """The source of the backward kernel that operands of ``dtype`` run."""
    if dtype == torch.float32:
        return "video_gpt_tpu_torch/csrc/fp32_attention_bwd.cu"
    return ("video_gpt_tpu_torch/csrc/"
            + {"K9": "bias_attention_bwd.cu",
               "K7": "inline_attention_bwd.cu"}[name])


def k9_width_record(dev, meta: AttnMeta, d: int, dtype, seed: int) -> dict:
    """K9 over the bias of ``meta`` (the stage-1 layout) at the flagship's
    width in heads of ``d``, operands of ``dtype``, after K3's forward
    (its lse); the plain backward in fp32 from the same values, SDPA's
    backward with the bias as a float mask as the library yardstick."""
    h, hkv, _ = _heads(head_dim=d)
    mk = _bf16_maker(dev, seed, dtype)
    bias = fa.precompute_bias(meta, meta)
    L = bias.shape[1]
    q, k = mk(1, L, h, d), mk(1, L, hkv, d)
    v = mk(1, L, h + 2 * hkv, d)[:, :, h + hkv:]
    do = mk(1, L, h, d)
    bm = fa.bias_map(bias)
    out, lse = fa._bias_forward(q, k, v, bm, with_lse=True)
    pairs = int((bias == 0).sum())
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh,
                                             attn_mask=bias[:, None].to(dtype))
    do_h = do.transpose(1, 2).contiguous()

    def lib():  # the backward alone of the library's attention
        return torch.autograd.grad(lib_out, (qh, kh, vh), do_h,
                                   retain_graph=True)

    return dict(
        fn=lambda: fa.flash_mha_bwd(q, k, v, bm, out, do, lse),
        plain=lambda absv=False: fa.bias_attention_backward_reference(
            *f32(q, k, v), bias, *f32(out, do), magnitude=absv),
        lib=lib, route="cuda", source=bwd_source("K9", dtype), dtype=dtype,
        backward=True, replaces=f"{TPU_KERNELS}:192",
        shape=f"B 1, L {L}, {h} heads of {d}",
        # read q, k, v, o, dO, the bias and lse; write dq, dk, dv
        bytes=nbytes(q, k, v, out, do, bias, q, k, v) + 4 * h * L,
        # S, dP, dV, dQ, dK over the visible pairs
        flops=5 * 2 * h * d * pairs)


def k7_width_record(q, k, v, qm: AttnMeta, km: AttnMeta, do, out, lse,
                    pairs: int) -> dict:
    """K7 of ``q`` over the keys ``k``/``v`` of ``km`` from ``lse`` (K6's,
    or a ring chunk's global one, handed to the plain version too), SDPA's
    backward with the bool mask as the library yardstick."""
    b, lq, h, d = q.shape
    mask = fa._padded_visibility(qm, km, lq, km.index.shape[1])[:, None]
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    do_h = do.transpose(1, 2).contiguous()

    def lib():  # the backward alone of the library's attention
        return torch.autograd.grad(lib_out, (qh, kh, vh), do_h,
                                   retain_graph=True)

    return dict(
        fn=lambda: fa.flash_mha_inline_bwd(q, k, v, qm, km, out, do, lse),
        plain=lambda absv=False: fa.inline_attention_backward_reference(
            *f32(q, k, v), qm, km, *f32(out, do), magnitude=absv, lse=lse),
        lib=lib, route="cuda", source=bwd_source("K7", q.dtype),
        dtype=q.dtype, backward=True, replaces=f"{TPU_KERNELS}:1215,1249",
        shape=f"B {b}, {lq} queries over {k.shape[1]} keys, {h} heads of {d}",
        # read q, k, v, o, dO, lse and the metadata; write dq, dk, dv
        bytes=nbytes(q, k, v, out, do, lse, q, k, v) + meta_bytes(qm)
        + meta_bytes(km),
        flops=5 * 2 * h * d * pairs)


def width_bwd_kernels(dev):
    """The backward kernels at the other dtype and head widths their
    wrappers take (BWD_WIDTHS): K9 at the stage-1 training shape (L 7104,
    the flagship's width in heads of D: 192 / 48 / 24 at D 16 / 64 / 128,
    32 of 96 at fp32); K7 at a seq-2 rank's shape (half those heads over
    the stage-1 layout) and at the ring hop q1/k0 of the stage-4 layout
    (half those heads, a 17,760-query chunk over a 17,760-key chunk) from
    the global lse of the two-chunk merge, at RING_HOP_WIDTHS. bf16 rows are held to the bf16
    bar, fp32 rows to the fp32 backward's bar (FP32_BWD_MASS). Yields
    (kernel, key of its record, result)."""
    from video_gpt_tpu_torch.parallel.ring import LSE_START, merge
    meta1 = AttnMeta(*(x.to(dev) for x in train_batch(1).inputs.batch.meta))
    meta4 = AttnMeta(*(x.to(dev) for x in train_batch(4).inputs.batch.meta))
    L1, L4 = meta1.index.shape[1], meta4.index.shape[1]
    pairs1 = visible_pairs(meta1)
    c = L4 // 2
    qm, km = meta4.cols(slice(c, L4)), meta4.cols(slice(0, c))
    pairs_hop = visible_pairs(qm, km)
    for i, (key, dtype, d) in enumerate(BWD_WIDTHS):
        h = ModelConfig().hidden_size // d
        rows = [("K9", key, lambda: k9_width_record(dev, meta1, d, dtype,
                                                    70 + i),
                 " (stage-1 training shape)")]
        mk = _bf16_maker(dev, 80 + i, dtype)

        def seq2(h=h // 2, d=d, mk=mk):
            q, k, v = (mk(1, L1, h, d), mk(1, L1, h, d),
                       mk(1, L1, 3 * h, d)[:, :, 2 * h:])
            out, lse = fa._inline_forward(q, k, v, meta1, meta1,
                                          with_lse=True)
            return k7_width_record(q, k, v, meta1, meta1, mk(1, L1, h, d),
                                   out, lse, pairs1)

        def hop(h=h // 2, d=d, mk=mk):
            # q chunk 1's global (out, lse): K6 over both key chunks, merged
            q = mk(1, c, h, d)
            kc = [mk(1, c, h, d) for _ in range(2)]
            vc = [mk(1, c, 3 * h, d)[:, :, 2 * h:] for _ in range(2)]
            o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
            lse = torch.full((1, h, c), LSE_START, dtype=torch.float32,
                             device=dev)
            for j in (1, 0):
                o, lse = merge(o, lse, *fa._inline_forward(
                    q, kc[j], vc[j], qm, meta4.cols(
                        slice(j * c, (j + 1) * c)), with_lse=True))
            rec = k7_width_record(q, kc[0], vc[0], qm, km, mk(1, c, h, d),
                                  o.to(dtype), lse, pairs_hop)
            return rec

        rows.append(("K7", key + ("_seq2_rank" if dtype == torch.bfloat16
                                  else ""), seq2,
                     f" (a seq-2 rank's Ulysses heads: {h // 2}, L {L1})"))
        if d in RING_HOP_WIDTHS:
            rows.append(("K7", key + "_ring_hop_q1_k0", hop,
                         f" (a ring hop q1/k0 of the stage-4 layout from the "
                         f"global lse: {h // 2} heads, {c} x {c})"))
        for name, rkey, make, label in rows:
            # half the time budget of a kernel's timing: these rows were
            # cut for the script's time
            r = dict(make(), budget_ms=TIME_BUDGET_MS / 2)
            rec = check_and_time(name, r, f" ({rkey}){label}")
            rec["head_dim"] = d
            if rkey.endswith("ring_hop_q1_k0"):
                rec["lse"] = ("global: the two-chunk merge's, given to the "
                              "plain K7 too")
            yield name, rkey, rec
            del r
            torch.cuda.empty_cache()


# ---- the mesh: sequence- and tensor-parallel serving ------------------------

# the full-width clips' meshes: (seq 2, tensor 2), and (seq 4), the
# reference's SP=4; each rank holds 32 / (S T) = 8 of the flagship's heads
MESH_CLIPS = ((2, 2), (4, 1))
# their depth: 2 of the 32 layers (cut to fit the mesh training phases in
# the script's time, to 4, then to 2 when the fp32 and head-width serving
# phases joined; the single-rank clip they are held to, and its floor, are
# made at the same depth)
MESH_CLIP_LAYERS = 2
# the small-input mesh reference's meshes, and its frames: 48x80 is 15
# tokens a frame, 17 with its markers, so the seq axis pads the tail and
# the extend
MESH_REF_MESHES = ((2, 1), (1, 2), (2, 2))
MESH_REF_PX = (48, 80)


def mesh_name(seq: int, tensor: int) -> str:
    return f"seq{seq}_tensor{tensor}" if tensor > 1 else f"seq{seq}"


def mesh_kernels(dev):
    """The kernels at a mesh rank's shapes of the flagship: K1 (the cond
    row over the cache and the tail) and K2 (the uncond row) at the 8 heads
    of a (seq 2, tensor 2) or (seq 4) rank, K6 at such a rank's
    seq-sharded prefill (8 heads; no bias under Ulysses), K3 at a
    (tensor 2) rank's prefill (16 heads, with its bias). The flagship's
    lengths (prefix 1,776, tail 3,552, uncond row 3,552) are multiples of
    4, so neither seq axis pads them (the CPU tests hold padded lengths).
    Yields (kernel, key of its record, result)."""
    n_img = tokens_per_frame(H_PX, W_PX)
    lay_c = frame_block_inference_layout(N_CLEAN, N_GEN, n_img, False)
    lay_u = frame_block_inference_layout(0, N_GEN, n_img, False)
    meta_c = AttnMeta.from_layout(lay_c, dev)
    tail = lay_c.noisy_tail_len()
    lc = lay_c.length - tail
    if any(n % 4 for n in (tail, lc, lay_u.length)):
        fail(f"the flagship's lengths {tail}, {lc}, {lay_u.length} need a "
             "pad on a seq-4 mesh: the records below would not be the "
             "ranks' shapes")
    heads = ModelConfig().num_heads // 4
    label = f" (a mesh rank: {heads} heads)"
    yield "K1", "mesh_rank_shape", check_and_time(
        "K1", decode_split_record(dev, 30, meta_c, tail, 661, heads=heads),
        label)
    torch.cuda.empty_cache()
    yield "K2", "mesh_rank_shape", check_and_time(
        "K2", decode_record(dev, 31, AttnMeta.from_layout(lay_u, dev), 416,
                            heads=heads), label)
    torch.cuda.empty_cache()
    mp = meta_c.cols(slice(0, lc))
    q, k, v = inline_operands(_bf16_maker(dev, 32), mp, heads=heads)

    def k6():
        with torch.no_grad():
            return fa.flash_mha_inline(q, k, v, mp, mp)

    rec = check_and_time("K6", inline_record(
        mp, q, k, v, visible_pairs(mp), k6, 1071, with_lse=False),
        f" (a seq-sharded prefill: {heads} heads)")
    rec["tile_map"] = inline_tile_map("K6 (a seq-sharded prefill)", mp, q)
    yield "K6", "mesh_prefill_shape", rec
    del q, k, v
    torch.cuda.empty_cache()
    yield "K3", "mesh_tensor_prefill_shape", check_and_time(
        "K3", bias_record(dev, 33, mp, 133, heads=2 * heads),
        f" (a tensor-2 prefill: {2 * heads} heads)")
    torch.cuda.empty_cache()


def mesh_reference_config() -> ModelConfig:
    """A tiny model the kernels take (head_dim 96), GQA 8:4, kv heads
    divisible by 4."""
    return ModelConfig.tiny(hidden_size=768, num_heads=8, num_kv_heads=4)


def mesh_reference_latents(mesh) -> tuple:
    """(final latents on the host, launch counts) of the small-input
    mesh reference's generate on the card in bf16 (``mesh`` None: one
    rank): two blocks without re-noise, so the prefill, both denoise rows
    and the extend run, over frames whose tails the seq axis pads."""
    pipe = VideoGPTPipeline.build(mesh_reference_config(), VAEConfig.tiny(),
                                  device="cuda", dtype=torch.bfloat16,
                                  seed=0, mesh=mesh)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, MESH_REF_PX + (3,), dtype=np.uint8)
              for _ in range(2)]
    reset_counts()
    _, lat = pipe.generate(
        frames, noise=SeededNoise(0, pipe.device), gen_nums=(1, 1),
        num_inference_steps=3, img_guidance_scale=CFG_SCALE,
        clean_image_noise_level=0.0, max_input_image_size=80,
        max_frame_window=8, return_latents=True)
    torch.cuda.synchronize()
    return torch.stack(lat).float().cpu(), counts()


def mesh_rank(seq: int, tensor: int, reference: bool, clip: bool,
              seed: int = 0) -> dict:
    """One gloo rank of a mesh on the card: the small-input reference
    (``reference``) and the full-width clip (``clip``: the main path's
    widths at MESH_CLIP_LAYERS layers, frames and recipe, weights and
    noise from ``seed`` (the main path's is 0), a warm-up at 1 step,
    then timed with its launch counts, the bytes its collectives took in,
    its peak memory and the final latents' divergence across the ranks)."""
    import torch.distributed as dist
    from video_gpt_tpu_torch.utils.parity import shard_divergence
    mesh = make_mesh(MeshConfig(seq=seq, tensor=tensor))
    out = {}
    if reference:
        out["reference"] = mesh_reference_latents(mesh)
    if not clip:
        return out
    pipe = VideoGPTPipeline.build(ModelConfig(num_layers=MESH_CLIP_LAYERS),
                                  VAEConfig(), device="cuda",
                                  dtype=torch.bfloat16, seed=seed, mesh=mesh)
    frames = synthetic_frames(N_CLEAN)
    kw = dict(gen_nums=(N_GEN,), img_guidance_scale=CFG_SCALE,
              max_frame_window=N_CLEAN + N_GEN, seed=seed,
              return_latents=True)
    pipe.generate(frames, num_inference_steps=1, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh.stats.moved = mesh.stats.calls = 0
    reset_counts()
    dist.barrier()
    t0 = time.perf_counter()
    frames_out, lat = pipe.generate(frames, num_inference_steps=STEPS, **kw)
    torch.cuda.synchronize()
    dist.barrier()
    wall_s = time.perf_counter() - t0
    launches = counts()
    lat = torch.stack(lat)
    out["clip"] = dict(
        wall_s=wall_s, launches=launches, collective_bytes=mesh.stats.moved,
        collective_calls=mesh.stats.calls,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        divergence=shard_divergence(lat),
        frames_ok=(len(frames_out) == N_CLEAN + N_GEN and all(
            f.dtype == np.uint8 and f.shape == (H_PX, W_PX, 3)
            for f in frames_out)),
        finite=bool(torch.isfinite(lat).all()), latents=lat.float().cpu())
    return out


def run_mesh(seq: int, tensor: int, reference: bool, clip: bool,
             seed: int = 0, **spawn) -> list:
    """:func:`mesh_rank` on S x T gloo ranks sharing the card (``spawn``:
    spawn_ranks' ``threads`` and ``start_method``); every rank must exit
    0."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        res = spawn_ranks(mesh_rank, (seq, tensor, reference, clip, seed),
                          seq * tensor, workdir, timeout=600, **spawn)
    log(f"mesh {mesh_name(seq, tensor)}: {seq * tensor} gloo ranks on the "
        f"card, {time.perf_counter() - t0:.1f} s with their start-up")
    return res


def rel_mse(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want) ** 2).mean() / (want ** 2).mean())


def mesh_reference_phase(want: torch.Tensor, want_launches) -> dict:
    """The small-input mesh reference: the tiny model over (seq 2),
    (tensor 2) and (seq 2, tensor 2) gloo ranks against the same model on
    one rank (``want``: its final latents), all on the card in bf16 (bar:
    final-latent relative MSE 1e-3); each rank's launches must equal
    ``want_launches(seq, tensor)``. Nothing here is timed: every mesh runs
    at once, its ranks forked from the forkserver at one intra-op thread
    each."""
    out = {}
    with concurrent.futures.ThreadPoolExecutor(len(MESH_REF_MESHES)) as pool:
        runs = dict(zip(MESH_REF_MESHES, pool.map(
            lambda m: run_mesh(*m, True, False, threads=1,
                               start_method="forkserver"),
            MESH_REF_MESHES)))
    for seq, tensor in MESH_REF_MESHES:
        name = mesh_name(seq, tensor)
        res = runs[(seq, tensor)]
        rels = [rel_mse(r["reference"][0], want) for r in res]
        ran = [r["reference"][1] for r in res]
        log(f"small-input mesh reference {name}: relative MSE vs one rank "
            f"per rank {rels} (bar {REF_REL_MSE_BAR}), launches {ran[0]}")
        exp = want_launches(seq, tensor)
        if any(c != exp for c in ran):
            fail(f"small-input mesh reference {name}: launches {ran} != "
                 f"{exp}")
        if not all(r <= REF_REL_MSE_BAR for r in rels):
            fail(f"small-input mesh reference {name} disagrees with one "
                 f"rank: {rels}")
        out[name] = dict(rel_mse=max(rels))
    return out


def mesh_clip_phase(seq: int, tensor: int, res: list, single: torch.Tensor,
                    floor: float, want: dict, smi: str) -> dict:
    """Checks and prints one full-width mesh clip: each rank's launches
    exactly ``want``, the final latents bit-equal across the ranks and
    within REF_REL_MSE_BAR of the single-rank clip's (``single``, on the
    host) and within twice ``floor`` (the single-rank clip's own
    relative MSE under :func:`fp32_linears`: one change of summation order
    for the floor, the mesh's split as another), uint8 frames of the
    flagship's shape."""
    name = f"mesh_clip_{mesh_name(seq, tensor)}"
    clips = [r["clip"] for r in res]
    for r, c in enumerate(clips):
        log(f"{name} rank {r}: launches {c['launches']} (expected {want})")
        if c["launches"] != want:
            fail(f"{name} rank {r} launch counts {c['launches']} != {want}")
        if not (c["frames_ok"] and c["finite"]):
            fail(f"{name} rank {r}: frames or latents malformed")
    divergence = max(c["divergence"] for c in clips)
    rel = max(rel_mse(c["latents"], single) for c in clips)
    rec = dict(ranks=seq * tensor, seq=seq, tensor=tensor, steps=STEPS,
               clip_s=max(c["wall_s"] for c in clips),
               shard_divergence=divergence, rel_mse_vs_one_rank=rel,
               floor_rel_mse=floor,
               collective_bytes_per_rank=[c["collective_bytes"]
                                          for c in clips],
               collective_calls_per_rank=[c["collective_calls"]
                                          for c in clips],
               peak_mem_gib_per_rank=[c["peak_mem_gib"] for c in clips],
               launches_per_rank=clips[0]["launches"], device=smi,
               note="gloo ranks sharing one card: not multi-GPU speed")
    log(f"{name}: {N_GEN}-frame clip {rec['clip_s']:.3f} s over "
        f"{seq * tensor} gloo ranks on {smi} (gloo ranks sharing one card: "
        f"not multi-GPU speed); shard divergence {divergence}, relative MSE "
        f"vs one rank {rel:.3e} (bar {REF_REL_MSE_BAR}; one rank's floor "
        f"{floor:.3e}, bar twice that)")
    log(json.dumps({name: rec}))
    if divergence != 0.0:
        fail(f"{name}: the ranks' final latents differ by {divergence}")
    if not rel <= REF_REL_MSE_BAR:
        fail(f"{name} disagrees with the single-rank clip: {rel}")
    if not rel <= 2 * floor:
        fail(f"{name} is farther from the single-rank clip ({rel}) than "
             f"twice its floor ({floor})")
    return rec


# ---- training on the mesh: gloo ranks sharing the card -------------------
class MeshRun(NamedTuple):
    """A mesh of the mesh training phases: its config, the attention over
    seq, GPipe's microbatches (0: one per stage), the global batch's rows,
    (full width) the stage and the layers, and the recipe: "train",
    "lora" (rank-8 adapters over a frozen base), "distill" or
    "distill_guided" (a frozen teacher, guidance 1.5)."""

    cfg: MeshConfig
    sp: str = "ulysses"
    nm: int = 0
    rows: int = 2
    stage: int = 1
    layers: int = 4
    recipe: str = "train"


# the small-input mesh training reference: the data, seq and tensor
# meshes, the ring's (seq 2), (seq 4) and (data 2, seq 2, tensor 2,
# zero3), GPipe's (pipe 2, nm 2) and (data 2, pipe 2, nm 4) (4 rows a data
# rank); LoRA on (data 2, seq 2, tensor 2, zero3) and on the ring's (seq
# 2), guided distillation on (seq 2, tensor 2) and distillation on (data
# 2, pipe 2, nm 2)
MESH_TRAIN_REF = (
    MeshRun(MeshConfig(2)), MeshRun(MeshConfig(1, 2)),
    MeshRun(MeshConfig(1, 1, 2)), MeshRun(MeshConfig(2, zero_params=True)),
    MeshRun(MeshConfig(2, 2, 2, True)), MeshRun(MeshConfig(1, 2), "ring"),
    MeshRun(MeshConfig(1, 4), "ring"),
    MeshRun(MeshConfig(2, 2, 2, True), "ring"),
    MeshRun(MeshConfig(pipe=2), nm=2),
    MeshRun(MeshConfig(2, pipe=2), nm=4, rows=8),
    MeshRun(MeshConfig(2, 2, 2, True), recipe="lora"),
    MeshRun(MeshConfig(1, 2), "ring", recipe="lora"),
    MeshRun(MeshConfig(1, 2, 2), recipe="distill_guided"),
    MeshRun(MeshConfig(2, pipe=2), nm=2, rows=4, recipe="distill"))
# its tiny model's layers, frames (stage 1's interleaved blocks) and steps
MESH_TRAIN_PX, MESH_TRAIN_FRAMES = (48, 64), 4
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 4, 2
# full width, the recipes of configs/pretrain_multichip_examples.sh at the
# card's sizes, one row a data rank but GPipe's four. The ring runs
# dp_sp_tp's (seq 2, tensor 2) at stage 4 beside Ulysses there; GPipe
# runs dp_pp without its data axis, (pipe 4) at 4 microbatches; LoRA runs
# on dp_tp_zero3's mesh and guided distillation on (seq 2, tensor 2), both
# at stage 1. A replicating axis holds 16 B a parameter on each of its
# ranks: full depth does not fit one card twice. Cut in depth for the
# script's time: when the ring and GPipe joined, dp_tp_zero3 (which fits
# full depth: every axis shards its state) from 32 layers to 8 and dp_sp
# from 8 to 2; when LoRA and distillation joined, those two from 8 layers
# to 4, then dp_tp_zero3 from 8 to 4, the stage-4 (seq 2, tensor 2) runs
# (Ulysses and the ring) from 8 to 2 and GPipe from 16 to 8 (2 a stage);
# when the fp32 and head-width serving phases joined, dp_tp_zero3, LoRA
# and distillation from 4 to 2, dp_sp and both stage-4 runs from 2 to 1,
# GPipe from 8 to 4 (1 a stage)
MESH_TRAIN_FULL = (
    MeshRun(MeshConfig(2, 1, 2, True), layers=2),
    MeshRun(MeshConfig(2, 2, 1), layers=1),
    MeshRun(MeshConfig(1, 2, 2), rows=1, stage=4, layers=1),
    MeshRun(MeshConfig(1, 2, 2), "ring", rows=1, stage=4, layers=1),
    MeshRun(MeshConfig(pipe=4), nm=4, rows=4, layers=4),
    MeshRun(MeshConfig(2, 1, 2, True), layers=2, recipe="lora"),
    MeshRun(MeshConfig(1, 2, 2), rows=1, layers=2,
            recipe="distill_guided"))
# the device of the mesh training ranks
MESH_TRAIN_DEVICE = "cuda"


def train_mesh_name(run: MeshRun) -> str:
    c = run.cfg
    name = "_".join(f"{a}{n}" for a, n in (
        ("data", c.data), ("seq", c.seq), ("tensor", c.tensor),
        ("pipe", c.pipe)) if n > 1)
    return (name + ("_zero3" if c.zero_params else "")
            + ("_ring" if run.sp == "ring" and c.seq > 1 else "")
            + (f"_nm{run.nm or c.pipe}" if c.pipe > 1 else "")
            + ("" if run.recipe == "train" else f"_{run.recipe}"))


def mesh_train_launches(run: MeshRun, layers: int) -> dict:
    """One step's launches on a rank: the forward and the recompute of
    each layer, one backward; distillation adds the teacher's forwards (2
    substeps, each a conditional and, guided, an unconditional one). The
    ring runs K6/K7 once per chunk, S of them; a pipe stage its layers
    once per microbatch; Ulysses K6/K7 once a layer; without a seq or
    pipe axis K3/K9 with one build of the bias's map per layout."""
    c = run.cfg
    guided = run.recipe == "distill_guided"
    teacher = (0 if not run.recipe.startswith("distill")
               else 2 * (2 if guided else 1))
    fwd = 2 + teacher
    if c.pipe > 1:
        n = (run.nm or c.pipe) * layers // c.pipe
        return expect(K6=fwd * n, K7=n)
    if c.seq > 1:
        s = c.seq if run.sp == "ring" else 1
        return expect(K6=fwd * s * layers, K7=s * layers)
    return expect(K3=fwd * layers, K9=layers,
                  bias_map_builds=2 if guided else 1)


def probe_rank(hops_only: bool = False) -> dict:
    """gloo's collectives on CUDA operands (ranks sharing the card), each
    against its expected result: reduce_scatter (ZeRO's gradient shard),
    all_gather, all_to_all_single, all_reduce, and the hop of the ring and
    of GPipe (``distributed.hop``: all_to_all_single with the payload to
    one peer, in a ring shift, and with nothing sent on the last rank and
    nothing received on the first), or with ``hops_only`` the hop alone
    (the others split their operand into as many chunks as ranks); each on
    a small vector and on a large matrix that a matmul queued on the
    current stream has just written (the collective must wait for it)."""
    import torch.distributed as dist
    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda")

    def operands(size):
        """Each rank's input (rank i's from seed i), made on the card."""
        if size == "small":
            return [torch.arange(8, device=dev, dtype=torch.float32) + 10 * i
                    for i in range(n)]
        out = []
        for i in range(n):
            gen = torch.Generator(dev).manual_seed(100 + i)
            a = torch.randn((2048, 2048), device=dev, generator=gen)
            out.append(a @ a)
        return out

    out = {}
    for size in ("small", "large"):
        xs = operands(size)
        torch.cuda.synchronize()
        want_all = [x.cpu() for x in xs]
        total = sum(want_all)
        ops = {
            "reduce_scatter": (lambda x: _probe_reduce_scatter(x, n),
                               total.chunk(n)[r]),
            "all_gather": (lambda x: _probe_all_gather(x, n),
                           torch.cat(want_all)),
            "all_to_all_single": (lambda x: _probe_all_to_all(x),
                                  torch.cat([w.chunk(n)[r]
                                             for w in want_all])),
            "all_reduce": (lambda x: _probe_all_reduce(x), total),
            "hop_shift": (lambda x: hop(x, None, (r + 1) % n, (r - 1) % n),
                          want_all[(r - 1) % n]),
            # the last rank sends nothing, the first receives nothing (its
            # result is checked as its own input, untouched)
            "hop_ends": (lambda x: hop(x, None, r + 1 if r < n - 1 else None,
                                       r - 1 if r > 0 else None)
                         if r > 0 else (hop(x, None, r + 1, None), x)[1],
                         want_all[r - 1] if r > 0 else want_all[0])}
        if hops_only:
            ops = {k: v for k, v in ops.items() if k.startswith("hop")}
        for name, (fn, want) in ops.items():
            x = operands(size)[r]  # just queued, not synchronised
            try:
                got = fn(x).cpu()
                err = float((got - want).abs().max())
                out[f"{name}_{size}"] = err <= 1e-3 * float(
                    want.abs().max()) or err
            except Exception as e:  # the probe reports what gloo refuses
                out[f"{name}_{size}"] = f"{type(e).__name__}: {e}"
    return out


def _probe_reduce_scatter(x, n):
    import torch.distributed as dist
    o = torch.empty_like(x.chunk(n)[0])
    dist.reduce_scatter(o, [c.contiguous() for c in x.chunk(n)])
    return o


def _probe_all_gather(x, n):
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def _probe_all_to_all(x):
    import torch.distributed as dist
    o = torch.empty_like(x)
    dist.all_to_all_single(o, x)
    return o


def _probe_all_reduce(x):
    import torch.distributed as dist
    y = x.clone()
    dist.all_reduce(y)
    return y


def collective_probe(strict: bool = True) -> dict:
    def probe(n):
        with tempfile.TemporaryDirectory() as workdir:
            return spawn_ranks(probe_rank, (n == 3,), n, workdir,
                               timeout=300, threads=1,
                               start_method="forkserver")

    res = []
    # every collective on 2 ranks, the hop on 3 too, both at once
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for r in pool.map(probe, (2, 3)):
            res += r
    log(f"gloo collectives and the hop on CUDA operands, 2 and 3 ranks "
        f"sharing the card: {res}")
    if strict and any(v is not True for r in res for v in r.values()):
        fail(f"a collective failed on CUDA operands: {res}")
    return res[0]


def mesh_train_ref_config() -> ModelConfig:
    """A tiny training model the kernels take: head_dim 96, 8 heads (GQA
    8:4: kv heads divide by seq x tensor), 4 layers."""
    return ModelConfig.tiny(hidden_size=768, num_heads=8, num_kv_heads=4,
                            num_layers=MESH_TRAIN_LAYERS,
                            pos_embed_max_size=64)


def recipe_flags(recipe: str) -> dict:
    """The TrainConfig fields of a MeshRun's recipe."""
    if recipe == "lora":
        return dict(use_lora=True, lora_rank=LORA_RANK)
    if recipe.startswith("distill"):
        return dict(DISTILL, distill_guidance=(
            DISTILL["distill_guidance"] if recipe == "distill_guided"
            else None))
    return {}


def mesh_train_ref_trainer(device, mixed: str, run: MeshRun,
                           mesh: bool = True, **sd):
    """The small-input reference's trainer of ``run``'s recipe, on its
    mesh (``mesh``) or one rank."""
    c = run.cfg
    cfg = stage_config(1, frame_num=MESH_TRAIN_FRAMES, lr=TRAIN_LR,
                       lr_scheduler="constant", adam_epsilon=1e-5,
                       mixed_precision=mixed,
                       batch_size_per_device=run.rows // (c.data if mesh
                                                          else 1),
                       sp_attention=run.sp, pp_microbatches=run.nm,
                       **recipe_flags(run.recipe))
    return Trainer(mesh_train_ref_config(), cfg, None,
                   vae_cfg=VAEConfig.tiny(), target_resolution=MESH_TRAIN_PX,
                   device=device, seed=3, mesh_cfg=c if mesh else None, **sd)


def record_grads(optimizer) -> list:
    """Each update's gradients (this rank's parts, reduced), on the host,
    as the optimizer receives them (before the clip)."""
    seen = []
    update = optimizer._update

    def recording(grads, norm):
        # a copy: the update clips the gradients in place
        seen.append([g.detach().float().to("cpu", copy=True)
                     for g in grads])
        return update(grads, norm)
    optimizer._update = recording
    return seen


def frozen_copy(trainer) -> dict:
    """Device copies of what a recipe's step must leave bit-equal: a LoRA
    run's base, a distillation run's teacher (empty for training)."""
    if trainer.teacher is not None:
        return {n: t.clone() for n, t in trainer.teacher.state_dict()
                .items()}
    return {n: p.detach().clone() for n, p in trainer.model
            .named_parameters() if not p.requires_grad}


def frozen_kept(trainer, frozen: dict) -> bool:
    """Whether :func:`frozen_copy`'s tensors are bit-equal now."""
    now = (trainer.teacher.state_dict() if trainer.teacher is not None
           else dict(trainer.model.named_parameters()))
    return all(torch.equal(now[n].detach(), t) for n, t in frozen.items())


def mesh_train_ref_steps(trainer, samples, post, draws,
                         start=None) -> dict:
    """MESH_TRAIN_STEPS steps of ``trainer`` (on a mesh: this rank's rows)
    on the given global batch, posterior noise and loss (or distillation)
    draws, sliced to the rank's as the trainer slices its own draws, from
    the whole trained weights ``start`` when given (a LoRA run's adapters,
    a distillation run's student other than its teacher, the warm start;
    each rank keeps its part): each step's loss, gradient norm, launches
    and the trained parameters' gradient parts; their ZeRO dimensions; the
    replicated parameters' divergence across the ranks; whether the LoRA
    base or the teacher stayed bit-equal."""
    from video_gpt_tpu_torch.parallel.mesh import SEQ_AXIS, batch_rows
    from video_gpt_tpu_torch.training.loss import take_part
    from video_gpt_tpu_torch.training.trainer import draw_part, part_of
    from video_gpt_tpu_torch.utils.parity import replicated_divergence
    state = trainer.build()
    mesh, dev, model = trainer.mesh, trainer.device, trainer.model
    if start is not None:
        params = dict(model.named_parameters())
        with torch.no_grad():
            for n, w in start.items():
                if n in params:  # a pipe rank's stage
                    params[n].copy_(part_of(n, w.to(dev), model, mesh))
    frozen = frozen_copy(trainer)
    seen = record_grads(state.optimizer)
    rows = batch_rows(mesh, len(samples))
    tb = collate(samples[rows], tokens_per_frame(*MESH_TRAIN_PX),
                 sp_multiple=1 if mesh is None else mesh.size(SEQ_AXIS),
                 uncond=trainer.cfg.distill_guidance is not None).to(dev)
    kind = DistillDraws if trainer.cfg.distill else LossDraws
    f = MESH_TRAIN_FRAMES
    steps = []
    for i in range(MESH_TRAIN_STEPS):
        reset_counts()
        with torch.no_grad(), autocast(trainer.cfg, dev):
            lat = trainer.vae.encode(tb.pixels, noise=post[i][
                rows.start * f:rows.stop * f].to(dev))
        inputs = tb.inputs._replace(x1=lat[tb.noisy_sel.long()],
                                    clean_latents=lat[tb.clean_sel.long()])
        part, den = draw_part(mesh, tb.inputs, tb.clean_valid, False)
        mine = take_part(kind(*(x.to(dev) for x in draws[i])), part, inputs)
        m = (trainer._step_fn(state, inputs, mine) if trainer.cfg.distill
             else trainer._step_fn(state, inputs, mine, denominator=den))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        steps.append(dict(loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"]),
                          launches=counts()))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return dict(
        coords=None if mesh is None else mesh.coords, steps=steps,
        grads=[dict(zip(names, g)) for g in seen],
        dims=dict(zip(names, (p.dim for p in state.optimizer.places))),
        divergence=(0.0 if mesh is None else replicated_divergence(
            model.named_parameters(), mesh)),
        frozen_kept=frozen_kept(trainer, frozen))


def mesh_train_ref_rank(runs: list, sd) -> list:
    """One gloo rank of the small-input mesh training reference (bf16 on
    the card, the kernels): each of ``runs`` ((run, samples, posterior
    noise, draws, trained start) of one world size) in turn, each on its
    own mesh; per run its record and its seconds on this rank."""
    out = []
    for run, samples, post, draws, start in runs:
        t0 = time.perf_counter()
        rec = mesh_train_ref_steps(
            mesh_train_ref_trainer(MESH_TRAIN_DEVICE, "bf16", run, **sd),
            samples, post, draws, start)
        rec["wall_s"] = time.perf_counter() - t0
        out.append(rec)
        gc.collect()
    return out


def whole_grads(res: list, mesh_cfg, step: int, names) -> torch.Tensor:
    """A mesh's gradient of ``step`` put together from its ranks' parts
    (a layer's from its pipe stage's ranks), flattened in the order of
    ``names``."""
    from video_gpt_tpu_torch.parallel.mesh import rank_grid
    from video_gpt_tpu_torch.utils.weights import unshard
    grid = rank_grid(mesh_cfg)
    cfg = mesh_train_ref_config()
    per = cfg.num_layers // mesh_cfg.pipe

    def stage(n):
        return (int(n.split(".")[2]) // per if n.startswith("llm.layers.")
                else 0)

    out = []
    for n in names:
        ranks = grid[..., stage(n)]
        holder = res[int(ranks[0, 0, 0])]
        out.append(unshard(
            n, lambda d, t: res[int(ranks[d, 0, t])]["grads"][step][n],
            holder["dims"][n], mesh_cfg.data, mesh_cfg.tensor,
            cfg).flatten())
    return torch.cat(out)


def mesh_train_ref_inputs(rows: int, recipe: str, sd: dict, starts: dict):
    """The global batch of ``rows`` rows, its posterior noise and loss (or
    distillation) draws per step, and the one-rank CPU steps of
    ``recipe`` on them in fp32 (the reference) and with bf16 autocast (the
    floor), from the recipe's trained weights in ``starts`` (by recipe
    family: "lora", "distill"), if any."""
    rng = np.random.default_rng(12)
    f, (h, w) = MESH_TRAIN_FRAMES, MESH_TRAIN_PX
    samples = [ClipSample(preprocess_to_resolution(
        [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(f)],
        h, w), (1,) * f) for _ in range(rows)]
    tb = collate(samples, tokens_per_frame(h, w))
    gen = torch.Generator().manual_seed(13)
    hl, wl = h // 8, w // 8
    nn_, nc = tb.noisy_sel.shape[0], tb.clean_sel.shape[0]
    distill = recipe.startswith("distill")
    post, draws = [], []
    for _ in range(MESH_TRAIN_STEPS):
        post.append(torch.randn((rows * f, hl, wl, 4), generator=gen))
        x0 = torch.randn((nn_, hl, wl, 4), generator=gen)
        per_row = (torch.randint(0, DISTILL["distill_student_steps"],
                                 (rows, f), generator=gen) if distill
                   else torch.rand((rows, f), generator=gen))
        draws.append((DistillDraws if distill else LossDraws)(
            x0, per_row, torch.randn((nc, hl, wl, 4), generator=gen),
            torch.rand((nc,), generator=gen)))
    one = MeshRun(MeshConfig(), rows=rows, recipe=recipe)
    start = starts.get("distill" if distill else recipe)
    want, floor = (mesh_train_ref_steps(mesh_train_ref_trainer(
        "cpu", mixed, one, mesh=False, **sd), samples, post, draws, start)
        for mixed in ("no", "bf16"))
    return samples, post, draws, want, floor, start


def mesh_train_reference_phase() -> dict:
    """The small-input mesh training reference: MESH_TRAIN_STEPS steps of
    a tiny model on each mesh of MESH_TRAIN_REF (gloo ranks sharing the
    card, bf16, the kernels) against the one-rank step on the CPU in fp32
    (plain versions), all on one global batch (of the mesh's rows) and one
    set of random numbers. Bars, per step: the whole gradient's relative
    error within TRAIN_REF_FLOOR_FACTOR times the CPU's own bf16 error,
    the loss within 2^-8; the replicated parameters bit-equal across the
    ranks; each rank exactly its step's launches."""
    cpu = mesh_train_ref_trainer("cpu", "no", MeshRun(MeshConfig()),
                                 mesh=False)
    cpu.build()
    randomise_heads_(cpu.model, seed=4)
    sd = dict(init_state_dict={k: v.clone() for k, v in
                               cpu.model.state_dict().items()},
              vae_state_dict={k: v.clone() for k, v in
                              cpu.vae.state_dict().items()})
    # the trained weights both sides start from, drawn on the host (a
    # trainer draws its adapters on its own device's generator): LoRA's
    # adapters (B random too, so that every adapter has a gradient from
    # the first step), and a distillation run's student, the warm start
    # (its teacher) moved by another draw. A student equal to its teacher
    # makes the loss mostly bf16 rounding (distill_reference_phase)
    gen = torch.Generator().manual_seed(14)
    lora = VideoGPT(dataclasses.replace(mesh_train_ref_config(),
                                        lora_rank=LORA_RANK), device="meta")
    starts = dict(
        lora={n: torch.randn(p.shape, generator=gen) * (
            p.shape[1] ** -0.5 if ".lora_A." in n else 0.02)
            for n, p in lora.named_parameters() if is_adapter(n)},
        distill={k: v + 0.03 * torch.randn(v.shape, generator=gen)
                 for k, v in sd["init_state_dict"].items()})
    inputs = {key: mesh_train_ref_inputs(*key, sd, starts)
              for key in sorted({(r.rows, r.recipe)
                                 for r in MESH_TRAIN_REF})}

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def run_size(group):
        # one set of ranks runs every mesh of its world size in turn: the
        # ranks' start-up (imports, CUDA context, gloo) is paid once a size
        args = [(run,) + tuple(inputs[run.rows, run.recipe][i]
                               for i in (0, 1, 2, 5)) for run in group]
        with tempfile.TemporaryDirectory() as workdir:
            res = spawn_ranks(mesh_train_ref_rank, (args, sd),
                              group[0].cfg.num_devices, workdir,
                              timeout=900, threads=1,
                              start_method="forkserver")
        return {run: [r[i] for r in res] for i, run in enumerate(group)}

    sizes = {}
    for run in MESH_TRAIN_REF:
        sizes.setdefault(run.cfg.num_devices, []).append(run)
    t0 = time.perf_counter()
    runs = {}
    with concurrent.futures.ThreadPoolExecutor(len(sizes)) as pool:
        for done in pool.map(run_size, sizes.values()):
            runs.update(done)
    log(f"small-input mesh training reference: {len(MESH_TRAIN_REF)} "
        f"meshes on {len(sizes)} sets of ranks at once, "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start-up")
    out, faults = {}, []
    for run in MESH_TRAIN_REF:
        name = train_mesh_name(run)
        res = runs[run]
        wall = max(r["wall_s"] for r in res)
        _, _, _, want, floor, _ = inputs[run.rows, run.recipe]
        names = list(want["grads"][0])
        sizes = [g.numel() for g in want["grads"][0].values()]
        want_l = mesh_train_launches(run, MESH_TRAIN_LAYERS)
        rec = dict(ranks=run.cfg.num_devices, rows=run.rows, wall_s=wall,
                   steps=[])
        for i in range(MESH_TRAIN_STEPS):
            want_g = torch.cat([g.flatten() for g in want["grads"][i]
                                .values()])
            floor_g = torch.cat([g.flatten() for g in floor["grads"][i]
                                 .values()])
            got_g = whole_grads(res, run.cfg, i, names)
            loss, want_loss = (x["steps"][i]["loss"] for x in (res[0], want))
            step = dict(
                loss=loss, loss_rel_err=abs(loss - want_loss) / abs(
                    want_loss),
                floor_loss_rel_err=abs(floor["steps"][i]["loss"] - want_loss)
                / abs(want_loss),
                grad_rel_err=rel(got_g, want_g),
                floor_grad_rel_err=rel(floor_g, want_g),
                launches=[r["steps"][i]["launches"] for r in res])
            # distillation's loss is the MSE of an amplified difference (the
            # target inverts a teacher step: x (1 - s) / (s_next - s)), not
            # a mean of well-conditioned terms: its bf16 error is the CPU's
            # own times the gradient's factor, where that exceeds 2^-8
            loss_bar = BF16_U if not run.recipe.startswith("distill") else \
                max(BF16_U, TRAIN_REF_FLOOR_FACTOR
                    * step["floor_loss_rel_err"])
            rec["steps"].append(step)
            log(f"small-input mesh training {name} step {i + 1}: loss "
                f"{loss:.6f} (CPU fp32 {want_loss:.6f}, rel err "
                f"{step['loss_rel_err']:.3e}, CPU bf16 "
                f"{step['floor_loss_rel_err']:.3e}, bar {loss_bar:.2e}); "
                f"gradient rel err {step['grad_rel_err']:.3e} (CPU bf16 "
                f"{step['floor_grad_rel_err']:.3e}, bar "
                f"{TRAIN_REF_FLOOR_FACTOR}x); launches per rank "
                f"{step['launches'][0]} (expected {want_l})")
            if any(c != want_l for c in step["launches"]):
                faults.append(f"mesh training {name} step {i + 1}: "
                              f"launches {step['launches']} != {want_l}")
            step["launches"] = step["launches"][0]  # every rank's
            if not (torch.isfinite(got_g).all()
                    and float(got_g.abs().max()) > 0):
                faults.append(f"mesh training {name}: the gradient is zero "
                              f"or not finite")
            if not (step["loss_rel_err"] <= loss_bar and step["grad_rel_err"]
                    <= TRAIN_REF_FLOOR_FACTOR * step["floor_grad_rel_err"]):
                # the parameters whose gradients are farthest off
                per = sorted(((rel(a, b), n) for n, a, b in zip(
                    names, got_g.split(sizes), want_g.split(sizes))),
                    reverse=True)[:6]
                faults.append(f"mesh training {name} step {i + 1} "
                              f"disagrees with the CPU's: {step}; worst "
                              f"parameters {per}")
        rec["divergence"] = max(r["divergence"] for r in res)
        rec["frozen_kept"] = all(r["frozen_kept"] for r in res)
        log(f"small-input mesh training {name}: replicated parameters' "
            f"divergence across the ranks {rec['divergence']}, the LoRA "
            f"base or the teacher bit-equal on every rank "
            f"{rec['frozen_kept']}, {wall:.1f} s on the ranks")
        if rec["divergence"] != 0.0:
            faults.append(f"mesh training {name}: replicated parameters "
                          f"diverge across the ranks by {rec['divergence']}")
        if not rec["frozen_kept"]:
            faults.append(f"mesh training {name}: a step changed the LoRA "
                          f"base or the teacher")
        out[name] = rec
    log(json.dumps({"mesh_training_reference": out}))
    for msg in faults:
        log(msg)
    if faults:
        fail(f"{len(faults)} faults in the small-input mesh training "
             f"reference (above)")
    return out


def mesh_train_samples(stage: int, rows: int) -> list:
    """``rows`` full-width clips of ``stage`` (train_batch's frames and
    blocks, each row its own frames)."""
    n = TRAIN_PATHS[stage][0]
    blocks = ((1,) * n if stage == 1 else
              random_block_partition(n, random.Random(PARTITION_SEED)))
    return [ClipSample(preprocess_to_resolution(
        synthetic_frames(n, seed=1 + r), H_PX, W_PX), blocks)
        for r in range(rows)]


def mesh_train_full_rank(run: MeshRun) -> dict:
    """One gloo rank of a full-width mesh training run (ModelConfig() at
    ``run.layers`` layers, the stage's recipe, heads randomised): a
    warm-up step and a timed one through the Trainer's own step, with its
    launches, the bytes its collectives took in (forward; backward with
    the optimizer's; the hops' apart), its peak memory, the gradient into
    its first layer's attention (on a pipe rank its stage's first) and
    into the patch embedder (under pipe, after the input gradient's pipe
    sum), the watched parameters' moves and the replicated parameters'
    divergence across the ranks."""
    import torch.distributed as dist
    from video_gpt_tpu_torch.parallel.mesh import (SEQ_AXIS, batch_rows,
                                                   stage_layers)
    from video_gpt_tpu_torch.utils.parity import replicated_divergence
    c = run.cfg
    cfg = stage_config(run.stage, lr=TRAIN_LR, lr_scheduler="constant",
                       adam_epsilon=1e-5, sp_attention=run.sp,
                       pp_microbatches=run.nm,
                       batch_size_per_device=run.rows // c.data,
                       **recipe_flags(run.recipe))
    t0 = time.perf_counter()
    trainer = Trainer(ModelConfig(num_layers=run.layers), cfg, None,
                      vae_cfg=VAEConfig(), target_resolution=(H_PX, W_PX),
                      device=MESH_TRAIN_DEVICE, seed=0, mesh_cfg=c)
    state = trainer.build()
    mesh, model = trainer.mesh, trainer.model
    randomise_heads_(model, seed=1)
    if trainer.teacher is not None:
        # the teacher is the student's warm start (in bf16): a zero head
        # makes every target 0
        trainer.teacher.load_state_dict(model.state_dict())
    frozen = frozen_copy(trainer)
    build_s = time.perf_counter() - t0
    samples = mesh_train_samples(run.stage, run.rows)
    rows = batch_rows(mesh, run.rows)
    tb = collate(samples[rows], tokens_per_frame(H_PX, W_PX),
                 sp_multiple=mesh.size(SEQ_AXIS),
                 uncond=cfg.distill_guidance is not None).to(
                     MESH_TRAIN_DEVICE)
    mine = stage_layers(mesh, run.layers)
    first, last = mine[0], mine[-1]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    if run.recipe == "lora":
        # lora_B has a gradient from the first step on (lora_A's is 0
        # while B is)
        attn = f"llm.layers.{first}.self_attn."
        norms_of = {"qkv_lora_B_first": names.index(
            attn + "qkv_proj.lora_B.weight"),
            "o_lora_B_first": names.index(attn + "o_proj.lora_B.weight")}
        watched = tuple(attn + f"{m}.lora_{ab}.weight"
                        for m in ("qkv_proj", "o_proj") for ab in "AB")
    else:
        norms_of = {"qkv_first": names.index(
            f"llm.layers.{first}.self_attn.qkv_proj.weight"),
            "x_embedder": names.index("x_embedder.proj.weight")}
        watched = ("x_embedder.proj.weight",
                   f"llm.layers.{first}.self_attn.qkv_proj.weight",
                   f"llm.layers.{last}.mlp.down_proj.weight",
                   "llm.norm.weight", "final_layer.linear.weight")
    grad_norms = {k: [] for k in norms_of}
    update = state.optimizer._update

    def watching(grads, norm):
        for k, i in norms_of.items():
            grad_norms[k].append(float(torch.linalg.vector_norm(grads[i])))
        return update(grads, norm)
    state.optimizer._update = watching
    params = dict(model.named_parameters())
    steps = []
    for i in range(2):  # a warm-up step, then the timed one
        if i == 1:
            before = host_copy({n: params[n] for n in watched})
            torch.cuda.reset_peak_memory_stats()
            mesh.stats.reset()
        reset_counts()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        m = trainer.train_step(state, tb, i)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        steps.append(dict(step_s=step_s, loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"]),
                          launches=counts()))
    moved = {n: float((params[n].detach().cpu() - before[n]).abs().max())
             for n in watched}
    st = mesh.stats
    return dict(
        coords=mesh.coords, build_s=build_s, steps=steps,
        frozen_kept=frozen_kept(trainer, frozen),
        frozen_params=sum(t.numel() for t in frozen.values()),
        trained_params=sum(params[n].numel() for n in names),
        tokens=tb.inputs.batch.input_ids.numel(),
        forward_bytes=st.moved, forward_calls=st.calls,
        backward_bytes=st.backward_moved, backward_calls=st.backward_calls,
        hop_forward_bytes=st.hop_moved,
        hop_backward_bytes=st.hop_backward_moved,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        grad_norms=grad_norms, moved=moved, layers_held=[first, last],
        params_held=sum(p.numel() for p in model.parameters()),
        divergence=replicated_divergence(model.named_parameters(), mesh))


def mesh_timed_phase(smi: str, clips=MESH_CLIPS, check_clip=None) -> dict:
    """The mesh's timed runs, alone on the card after every reference: on
    one set of gloo ranks a world size, each full-width clip of ``clips``
    ((seq, tensor)) in turn, then every run of MESH_TRAIN_FULL of that
    size, each freed before the next, so that the ranks' start-up is paid
    once. ``check_clip(seq, tensor, res)`` checks a clip from its ranks'
    records ([{"clip": ...}], :func:`mesh_clip_phase`). Each training run:
    each rank exactly its step's launches, finite loss and gradient norm,
    a nonzero gradient into its first layer's attention and into the
    patch embedder, the watched parameters moved (by at most ~lr an
    element), the replicated parameters bit-equal across the ranks. Clip
    and step times are the slowest rank's. Returns {run name: record}."""
    out = {}
    # the ranks' allocators grow segments in place: four ranks at 16-17
    # GiB each, every one encoding its clip's frames at once, leave no
    # room for the blocks a fixed-segment allocator strands. The ranks are
    # spawned, not forked from the forkserver: they take this environment
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sizes = {}
    for seq, tensor in clips:
        sizes.setdefault(seq * tensor, ([], []))[0].append((seq, tensor))
    for run in MESH_TRAIN_FULL:
        sizes.setdefault(run.cfg.num_devices, ([], []))[1].append(run)
    try:
        for n, (cs, runs) in sizes.items():
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as workdir:
                res = spawn_ranks(mesh_timed_ranks, (cs, runs), n, workdir,
                                  timeout=1200)
            log(f"the mesh's timed runs: {len(cs)} full-width clips and "
                f"{len(runs)} training runs on one set of {n} ranks, "
                f"{time.perf_counter() - t0:.1f} s with the ranks' "
                f"start-up")
            for i, (seq, tensor) in enumerate(cs):
                check_clip(seq, tensor, [{"clip": r["clips"][i]}
                                         for r in res])
            for i, run in enumerate(runs):
                out[train_mesh_name(run)] = mesh_train_full_run(
                    run, [r["runs"][i] for r in res], smi)
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    return out


def mesh_timed_ranks(clips: list, runs: list) -> dict:
    """One gloo rank of :func:`mesh_timed_phase`: each clip of ``clips``
    (:func:`mesh_rank`'s record), then the training runs ``runs``
    (:func:`mesh_train_full_ranks`)."""
    out = []
    for seq, tensor in clips:
        out.append(mesh_rank(seq, tensor, False, True)["clip"])
        gc.collect()
        torch.cuda.empty_cache()
    return dict(clips=out, runs=mesh_train_full_ranks(runs))


def mesh_train_full_ranks(runs: list) -> list:
    """One gloo rank of the full-width mesh training runs ``runs`` (of one
    world size), each in turn on its own mesh and freed before the next;
    per run its record (:func:`mesh_train_full_rank`) and its seconds on
    this rank, the build included."""
    out = []
    for run in runs:
        t0 = time.perf_counter()
        rec = mesh_train_full_rank(run)
        rec["wall_s"] = time.perf_counter() - t0
        out.append(rec)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_train_full_run(run: MeshRun, res: list, smi: str) -> dict:
    """The checks and the record of one run of MESH_TRAIN_FULL from its
    ranks' records ``res`` (:func:`mesh_timed_phase`)."""
    name = train_mesh_name(run)
    c = run.cfg
    n = c.num_devices
    wall = max(x["wall_s"] for x in res)
    want = mesh_train_launches(run, run.layers)
    for r, x in enumerate(res):
        timed = x["steps"][-1]
        log(f"mesh training {name} rank {r} {x['coords']}: build "
            f"{x['build_s']:.1f} s, steps "
            f"{[round(s['step_s'], 3) for s in x['steps']]} s, loss "
            f"{timed['loss']:.6f}, grad norm {timed['grad_norm']:.4e}, "
            f"launches {timed['launches']} (expected {want}), collective "
            f"bytes forward {x['forward_bytes']} backward "
            f"{x['backward_bytes']} (hops {x['hop_forward_bytes']} / "
            f"{x['hop_backward_bytes']}), peak {x['peak_mem_gib']:.2f} "
            f"GiB, layers {x['layers_held']}, gradient norms "
            f"{x['grad_norms']}, moved {x['moved']}, divergence "
            f"{x['divergence']}")
        if any(s["launches"] != want for s in x["steps"]):
            fail(f"mesh training {name} rank {r}: launches "
                 f"{[s['launches'] for s in x['steps']]} != {want}")
        if not all(np.isfinite([s["loss"], s["grad_norm"]]).all()
                   for s in x["steps"]):
            fail(f"mesh training {name} rank {r}: loss or gradient "
                 f"norm not finite")
        for k, norms in x["grad_norms"].items():
            if not all(np.isfinite(g) and g > 0 for g in norms):
                fail(f"mesh training {name} rank {r}: no gradient "
                     f"reached {k} ({norms})")
        for p, d in x["moved"].items():
            # Adam's normalised update and the weight decay
            if not 0 < d <= 4 * TRAIN_LR:
                fail(f"mesh training {name} rank {r}: AdamW moved {p} "
                     f"by {d}")
        if x["divergence"] != 0.0:
            fail(f"mesh training {name}: replicated parameters "
                 f"diverge across the ranks by {x['divergence']}")
        if not x["frozen_kept"]:
            fail(f"mesh training {name} rank {r}: a step changed the LoRA "
                 f"base or the teacher")
    step_s = max(x["steps"][-1]["step_s"] for x in res)
    # each data rank's rows (its first pipe rank's)
    tokens = res[0]["tokens"] * c.data
    rec = dict(
        ranks=n, data=c.data, seq=c.seq, tensor=c.tensor, pipe=c.pipe,
        zero3=c.zero_params, sp_attention=run.sp,
        microbatches=(run.nm or c.pipe) if c.pipe > 1 else 0,
        rows=run.rows, stage=run.stage, layers=run.layers,
        recipe=run.recipe, step_s=step_s, tokens_per_step=tokens,
        tokens_per_s=tokens / step_s,
        loss=res[0]["steps"][-1]["loss"],
        grad_norm=res[0]["steps"][-1]["grad_norm"],
        forward_bytes_per_rank=[x["forward_bytes"] for x in res],
        backward_bytes_per_rank=[x["backward_bytes"] for x in res],
        hop_forward_bytes_per_rank=[x["hop_forward_bytes"] for x in res],
        hop_backward_bytes_per_rank=[x["hop_backward_bytes"]
                                     for x in res],
        peak_mem_gib_per_rank=[x["peak_mem_gib"] for x in res],
        params_held_per_rank=[x["params_held"] for x in res],
        trained_params_per_rank=[x["trained_params"] for x in res],
        frozen_params_per_rank=[x["frozen_params"] for x in res],
        frozen_kept=all(x["frozen_kept"] for x in res),
        launches_per_rank_step=res[0]["steps"][-1]["launches"],
        divergence=max(x["divergence"] for x in res), wall_s=wall,
        device=smi, note="gloo ranks sharing one card: not multi-GPU "
                         "speed")
    log(f"mesh training {name}: stage {run.stage}, {run.layers} layers, "
        f"recipe {run.recipe}, {step_s:.3f} s/step (slowest rank), "
        f"{rec['tokens_per_s']:.1f} tokens/s, peak "
        f"{max(rec['peak_mem_gib_per_rank']):.2f} GiB a rank, trained "
        f"parameters a rank {rec['trained_params_per_rank']}, frozen "
        f"{rec['frozen_params_per_rank']} (bit-equal: "
        f"{rec['frozen_kept']}), on {smi} (gloo ranks sharing one card: "
        f"not multi-GPU speed); {wall:.1f} s on the ranks with the build")
    log(json.dumps({f"mesh_training_{name}": rec}))
    return rec


def ring_pipe_kernels(dev):
    """K6 and K7 at the new launch shapes of part B: a ring hop of the
    (seq 2, tensor 2) stage-4 run (a rank's 16 heads: the ring splits the
    sequence over seq and the heads over tensor alone; a 17,760-query
    chunk over a 17,760-key chunk of the stage-4 layout), in both
    directions: q chunk 1 over k chunk 0, and q chunk 0 over k chunk 1
    (most of its rows see no key there); K7 there is handed the global
    (out, lse) of the two-chunk merge (``parallel.ring.merge`` of K6 over
    both chunks), and so is the plain K7. Then a GPipe microbatch's (32
    heads, stage 1, L 7104, B 1). Yields (kernel, key of its record,
    result)."""
    from video_gpt_tpu_torch.parallel.ring import LSE_START, merge
    heads = ModelConfig().num_heads
    bf16 = _bf16_maker(dev, 41)
    meta, q, k, v, _ = stage_operands(dev, bf16, 4, heads=heads // 2)
    L = meta.index.shape[1]
    c = L // 2
    chunks = [slice(0, c), slice(c, L)]
    cm = [meta.cols(s) for s in chunks]
    qc = [q[:, s].contiguous() for s in chunks]
    kc = [k[:, s].contiguous() for s in chunks]
    vc = [v[:, s] for s in chunks]
    src = "video_gpt_tpu_torch/csrc/"
    for i, j in ((1, 0), (0, 1)):
        qm, km = cm[i], cm[j]
        q_, k_, v_ = qc[i], kc[j], vc[j]
        h, d = q_.shape[2], q_.shape[3]
        pairs = visible_pairs(qm, km)
        label = (f" (a ring hop: {h} heads, q chunk {i} over k chunk {j} "
                 f"of the stage-4 layout, {pairs} visible pairs)")
        log(f"ring hop q{i} k{j}: {c} x {c}, {pairs} visible pairs "
            f"({pairs / c ** 2:.3f})")
        # the global (out, lse) of q chunk i: the merge over both chunks
        o = torch.zeros(q_.shape, dtype=torch.float32, device=dev)
        lse = torch.full((1, h, c), LSE_START, dtype=torch.float32,
                         device=dev)
        for jj in (i, 1 - i):
            o, lse = merge(o, lse, *fa._inline_forward(
                q_, kc[jj], vc[jj], qm, cm[jj], with_lse=True))
        out = o.to(q_.dtype)
        do = bf16(1, c, h, d)
        mask = fa._padded_visibility(qm, km, c, c)[:, None]
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q_, k_, v_))

        def k6_plain(absv=False, q_=q_, k_=k_, v_=v_, qm=qm, km=km):
            vf = v_.float()
            return fa.inline_attention_reference(
                *f32(q_, k_), vf.abs() if absv else vf, qm, km)[0]

        def lib(qh=qh, kh=kh, vh=vh, mask=mask):
            with torch.no_grad():
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=mask)

        def k7(q_=q_, k_=k_, v_=v_, qm=qm, km=km, out=out, do=do, lse=lse):
            return fa.flash_mha_inline_bwd(q_, k_, v_, qm, km, out, do, lse)

        def k7_plain(absv=False, q_=q_, k_=k_, v_=v_, qm=qm, km=km,
                     out=out, do=do, lse=lse):
            return fa.inline_attention_backward_reference(
                *f32(q_, k_, v_), qm, km, *f32(out, do), magnitude=absv,
                lse=lse)

        lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        do_h = do.transpose(1, 2).contiguous()

        def k7_lib(lib_out=lib_out, qh=qh, kh=kh, vh=vh, do_h=do_h):
            return torch.autograd.grad(lib_out, (qh, kh, vh), do_h,
                                       retain_graph=True)

        mb = (meta_bytes(qm) + meta_bytes(km))
        key = f"ring_hop_q{i}_k{j}"
        yield "K6", key, check_and_time("K6", dict(
            fn=lambda q_=q_, k_=k_, v_=v_, qm=qm, km=km: fa._inline_forward(
                q_, k_, v_, qm, km, with_lse=True)[0],
            plain=k6_plain, lib=lib, route="cuda",
            source=src + "inline_attention.cu",
            replaces=f"{TPU_KERNELS}:1071",
            bytes=nbytes(q_, k_, v_, q_) + 4 * h * c + mb,
            flops=4 * h * d * pairs), label)
        rec = check_and_time("K7", dict(
            fn=k7, plain=k7_plain, lib=k7_lib, route="cuda",
            source=src + "inline_attention_bwd.cu",
            replaces=f"{TPU_KERNELS}:1215,1249",
            bytes=nbytes(q_, k_, v_, out, do, lse, q_, k_, v_) + mb,
            flops=5 * 2 * h * d * pairs), label)
        rec["lse"] = "global: the two-chunk merge's, given to the plain K7 too"
        yield "K7", key, rec
        del qh, kh, vh, lib_out, mask, o, lse, out, do
        torch.cuda.empty_cache()
    del meta, q, k, v, qc, kc, vc
    torch.cuda.empty_cache()
    meta, q, k, v, pairs = stage_operands(dev, bf16, 1)
    res = inline_train_records(
        bf16, meta, q, k, v, pairs,
        " (a GPipe microbatch: 32 heads, stage 1, L 7104, B 1)")
    for name, rec in res.items():
        yield name, "pipe_microbatch_shape", rec
    del q, k, v, res
    torch.cuda.empty_cache()


def mesh_train_kernels(dev):
    """The training kernels at a mesh rank's shapes: K3/K9 at 16 heads
    over the stage-1 layout (a tensor-2 rank), K6/K7 at 16 heads over the
    stage-1 layout (a seq-2 rank's Ulysses heads) and at 8 heads over the
    stage-4 layout (a (seq 2, tensor 2) rank); then part B's (a ring hop,
    a GPipe microbatch: :func:`ring_pipe_kernels`). Yields (kernel, key of
    its record, result)."""
    heads = ModelConfig().num_heads
    meta = AttnMeta(*(x.to(dev) for x in train_batch(1).inputs.batch.meta))
    label = f" (a tensor-2 training rank: {heads // 2} heads, L 7104)"
    for name, rec in bias_train_records(dev, meta, label,
                                        heads=heads // 2).items():
        yield name, "mesh_tensor_train_shape", rec
    torch.cuda.empty_cache()
    bf16 = _bf16_maker(dev, 40)
    for stage, h, key in ((1, heads // 2, "mesh_seq_train_shape"),
                          (4, heads // 4, "mesh_seq_tensor_stage4_shape")):
        meta, q, k, v, pairs = stage_operands(dev, bf16, stage, heads=h)
        label = f" (a training rank's Ulysses heads: {h}, L " \
                f"{meta.index.shape[1]})"
        res = inline_train_records(bf16, meta, q, k, v, pairs, label)
        res["K6"]["tile_map"] = inline_tile_map("K6" + label, meta, q)
        for name, rec in res.items():
            yield name, key, rec
        del q, k, v, res
        torch.cuda.empty_cache()
    yield from ring_pipe_kernels(dev)


@contextlib.contextmanager
def fp32_linears():
    """Every ``F.linear`` as a TF32 GEMM of its operands upcast to fp32,
    rounded once to the input's dtype: bf16 operands are exact in TF32, so
    this is a one-rank matmul with its fp32 accumulation in another
    order."""
    linear, tf32 = F.linear, torch.backends.cuda.matmul.allow_tf32

    def upcast(x, w, b=None):
        return linear(x.float(), w.float(),
                      None if b is None else b.float()).to(x.dtype)

    F.linear, torch.backends.cuda.matmul.allow_tf32 = upcast, True
    try:
        yield
    finally:
        F.linear, torch.backends.cuda.matmul.allow_tf32 = linear, tf32


def mesh_clip_reference(dev, seed: int = 0) -> tuple:
    """(the single-rank clip's final latents on the host, its floor) of
    the mesh clips' model (MESH_CLIP_LAYERS layers) and recipe, weights
    and noise from ``seed``: the floor is the relative MSE of the same clip
    with :func:`fp32_linears`, another fp32 summation order."""
    pipe = VideoGPTPipeline.build(ModelConfig(num_layers=MESH_CLIP_LAYERS),
                                  VAEConfig(), device=dev,
                                  dtype=torch.bfloat16, seed=seed)
    frames = synthetic_frames(N_CLEAN)
    kw = dict(gen_nums=(N_GEN,), img_guidance_scale=CFG_SCALE,
              max_frame_window=N_CLEAN + N_GEN, num_inference_steps=STEPS,
              seed=seed, return_latents=True)
    _, lat = pipe.generate(frames, **kw)
    single = torch.stack(lat).float().cpu()
    with fp32_linears():
        _, lat = pipe.generate(frames, **kw)
    return single, rel_mse(torch.stack(lat).float().cpu(), single)


def mesh_margin(dev, smi: str, seeds) -> None:
    """For each seed: the single-rank clip of the mesh clips' model
    (MESH_CLIP_LAYERS layers; the main path's recipe, weights and noise
    from the seed), its floor (:func:`mesh_clip_reference`), and the (seq
    2, tensor 2) clip over 4 gloo ranks; prints each one's relative MSE
    against the single-rank clip (the smoke's bar is REF_REL_MSE_BAR)."""
    rows = []
    for seed in seeds:
        single, floor = mesh_clip_reference(dev, seed)
        freed(f"the single-rank clips of seed {seed}")
        res = run_mesh(2, 2, False, True, seed)
        mesh = max(rel_mse(r["clip"]["latents"], single) for r in res)
        div = max(r["clip"]["divergence"] for r in res)
        rows.append(dict(seed=seed, floor_rel_mse=floor,
                         mesh_seq2_tensor2_rel_mse=mesh,
                         shard_divergence=div))
        log(f"mesh margin, seed {seed}: (seq 2, tensor 2) relative MSE vs "
            f"one rank {mesh:.3e}, one rank with fp32 linears {floor:.3e} "
            f"(bar {REF_REL_MSE_BAR}), divergence {div}; {smi}")
    log(json.dumps({"mesh_margin": rows, "device": smi}))


class SeededNoise:
    """The pipeline's noise drawn from one seeded CPU generator in fp32 and
    moved to the run's device, so two runs on two devices see the same
    numbers."""

    def __init__(self, seed: int, device: torch.device):
        self.generator = torch.Generator().manual_seed(seed)
        self.device = device

    def __call__(self, kind, shape, dtype):
        return torch.randn(tuple(shape), generator=self.generator).to(
            self.device, dtype)


def reference_phase(dev, cfg: ModelConfig = None,
                    dtype: torch.dtype = torch.bfloat16,
                    label: str = "small-input reference") -> dict:
    """The slice end to end on a small input: the port on the card (bf16,
    the CUDA kernels) against the port on the CPU (fp32, the kernels'
    plain versions), with the same bf16-made weights and the same noise.
    Two blocks without re-noise, so prefill (K3, or K6 above the config's
    ``precompute_bias_limit``), both decode rows (K1, K2) and the cache
    extend (K1) all run. In bf16 the CPU in bf16 gives the rounding floor
    the card's error is read against, and the bar is REF_REL_MSE_BAR. With
    ``dtype`` fp32 the card runs in fp32 (the fp32 kernel; no bf16 kernel
    may launch) and the floor is the CPU's fp32 clip rerun with its linears
    in another summation order (:func:`split_linears`): the bar is
    FP32_REF_BAR, or twice the floor where the floor is above it. ``cfg``:
    the tiny model at head_dim 96 (GQA 2:1) by default. Returns {rel_mse,
    floor, bar, launches}."""
    cfg = cfg or ModelConfig.tiny(hidden_size=192, num_heads=2,
                                  num_kv_heads=1)
    vae_cfg = VAEConfig.tiny()
    gpu = VideoGPTPipeline.build(cfg, vae_cfg, device=dev, dtype=dtype,
                                 seed=0)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
              for _ in range(3)]
    kw = dict(gen_nums=(2, 2), num_inference_steps=3,
              img_guidance_scale=CFG_SCALE, clean_image_noise_level=0.0,
              max_input_image_size=64, max_frame_window=8,
              return_latents=True)

    def latents(pipe):
        _, lat = pipe.generate(frames, noise=SeededNoise(0, pipe.device),
                               **kw)
        return torch.stack(lat).float().cpu()

    reset_counts()
    got = latents(gpu)
    torch.cuda.synchronize()
    ran = counts()

    def cpu(cpu_dtype):
        return VideoGPTPipeline.build(
            cfg, vae_cfg, device="cpu", dtype=cpu_dtype,
            state_dict=gpu.model.state_dict(),
            vae_state_dict=gpu.vae.state_dict())

    want = latents(cpu(torch.float32))
    fp32 = dtype == torch.float32
    if fp32:
        with split_linears():
            floor = latents(cpu(torch.float32))
    else:
        floor = latents(cpu(torch.bfloat16))

    def rel_mse_of(x):
        return float(((x - want) ** 2).mean() / (want ** 2).mean())

    rel_mse, floor_mse = rel_mse_of(got), rel_mse_of(floor)
    bar = max(FP32_REF_BAR, 2 * floor_mse) if fp32 else REF_REL_MSE_BAR
    prefill = "K3" if cfg.precompute_bias_limit else "K6"
    ran_k = [k + ("-fp32" if fp32 else "") for k in ("K1", "K2", prefill)]
    other = [k for k in ("K1", "K2", "K3", "K6", "K1-fp32", "K2-fp32",
                         "K3-fp32", "K6-fp32") if k not in ran_k]
    log(f"{label}: card ({'fp32' if fp32 else 'bf16'}, kernels; head_dim "
        f"{cfg.head_dim}) vs CPU (fp32, plain) final-latent relative MSE "
        f"{rel_mse:.3e} (bar {bar:.3e}; "
        f"{'CPU fp32 with its linears split' if fp32 else 'CPU bf16'} vs "
        f"fp32: {floor_mse:.3e}), launches {ran}")
    if not all(ran[k] for k in ran_k) or any(ran[k] for k in other):
        fail(f"{label}: the run skipped a kernel of {ran_k} or ran another: "
             f"{ran}")
    if not torch.isfinite(got).all() or not rel_mse <= bar:
        fail(f"{label}: the card's generate disagrees with the CPU's: "
             f"{rel_mse} (bar {bar})")
    return dict(rel_mse=rel_mse, floor=floor_mse, bar=bar, launches=ran)


@contextlib.contextmanager
def split_linears():
    """Every ``F.linear`` as two products over the halves of its reduction,
    summed: the same fp32 arithmetic in another summation order (on the
    CPU, the floor of an fp32 reference)."""
    linear = F.linear

    def split(x, w, b=None):
        k = x.shape[-1] // 2
        y = linear(x[..., :k], w[:, :k]) + linear(x[..., k:], w[:, k:])
        return y if b is None else y + b

    F.linear = split
    try:
        yield
    finally:
        F.linear = linear


def width_reference_phase(dev) -> dict:
    """This slice's small-input references: (a) the flagship recipe of the
    small input (:func:`reference_phase`) in fp32 at head_dim 96, on the
    bias route (fp32 K3, K1, K2) and at ``precompute_bias_limit`` 0 (its
    prefill on the inline route: fp32 K6), each held to FP32_REF_BAR or
    twice its floor; (b) ``--tiny_model``'s config (head_dim 16, the bf16
    kernels at padded width 32) in bf16 at REF_REL_MSE_BAR."""
    wide = ModelConfig.tiny(hidden_size=192, num_heads=2, num_kv_heads=1)
    return {
        "fp32": reference_phase(dev, wide, torch.float32,
                                "fp32 small-input reference"),
        "fp32_inline": reference_phase(
            dev, dataclasses.replace(wide, precompute_bias_limit=0),
            torch.float32, "fp32 small-input reference, inline route"),
        "tiny_bf16": reference_phase(dev, tiny_model_config(),
                                     torch.bfloat16,
                                     "tiny-model small-input reference")}


def tiny_model_config() -> ModelConfig:
    """The model of ``--tiny_model`` (head_dim 16), as the CLI builds it."""
    return cli._configs(argparse.Namespace(tiny_model=True))[0]


def fp32_clip_phase(dev, smi: str) -> dict:
    """``generate --dtype fp32`` at full width and depth: the main path's
    recipe (8 -> 16 frames, 10 steps, CFG 1.5, a 24-frame window) with
    fp32 weights (random from seed 0, head and adaLN random), after a
    1-step warm-up: the fp32 kernel exactly nl K3 (its prefill), nl x 10
    K1 and nl x 10 K2, one build of the bias's map, and no bf16 kernel;
    uint8 frames of the right shape and finite latents on the card. The
    GEMMs and convolutions run in full fp32 (no TF32)."""
    t0 = time.perf_counter()
    pipe = VideoGPTPipeline.build(ModelConfig(), VAEConfig(), device=dev,
                                  dtype=torch.float32, seed=0)
    torch.cuda.synchronize()
    log(f"build the fp32 pipeline: {time.perf_counter() - t0:.1f} s")
    frames = synthetic_frames(N_CLEAN)
    kw = dict(gen_nums=(N_GEN,), num_inference_steps=STEPS,
              img_guidance_scale=CFG_SCALE, max_frame_window=N_CLEAN + N_GEN,
              seed=0, return_latents=True)
    t0 = time.perf_counter()
    pipe.generate(frames, **dict(kw, num_inference_steps=1))
    torch.cuda.synchronize()
    log(f"fp32 warm-up generate at 1 step: {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, lat = pipe.generate(frames, **kw)
    torch.cuda.synchronize()
    clip_s = time.perf_counter() - t0
    launches = counts()
    nl = pipe.model.cfg.num_layers
    want = expect(**{"K1-fp32": nl * STEPS, "K2-fp32": nl * STEPS,
                     "K3-fp32": nl}, bias_map_builds=1)
    log(f"fp32 clip launches {launches} (expected {want})")
    if launches != want:
        fail(f"fp32 clip launch counts {launches} != {want}")
    gen = out[-N_GEN:]
    if len(out) != N_CLEAN + N_GEN or not all(
            f.dtype == np.uint8 and f.shape == (H_PX, W_PX, 3) for f in gen):
        fail(f"the fp32 clip returned {len(out)} frames, not uint8 "
             f"{H_PX}x{W_PX}x3")
    lat = torch.stack(lat)
    if lat.device.type != dev.type or lat.dtype != torch.float32 \
            or not torch.isfinite(lat).all():
        fail(f"fp32 clip latents on {lat.device}, {lat.dtype}, or not "
             f"finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res = dict(clip_s=clip_s, frames_per_s=N_GEN / clip_s,
               peak_mem_gib=peak, launches=launches, device=smi)
    log(f"fp32 main path: {N_GEN}-frame clip {clip_s:.3f} s, "
        f"{N_GEN / clip_s:.3f} frames/s, peak {peak:.2f} GiB, on {smi}")
    log(json.dumps({"fp32_main_path": res}))
    return res


# the CLI's own generate at --tiny_model on the card, in both dtypes
CLI_TINY_ARGS = ("--tiny_model", "--device", "cuda", "--clean_image_num",
                 "2", "--gen_nums", "4", "4", "--num_inference_steps", "4",
                 "--img_guidance_scale", "1.5", "--seed", "0")


def cli_tiny_phase(dev) -> dict:
    """``python -m video_gpt_tpu_torch.cli generate --tiny_model --device
    cuda`` (head_dim 16) in bf16 and in fp32, 2 -> 4 + 4 frames at 4 steps
    with guidance 1.5, through the CLI's own ``main`` in this process, so
    that its launch counters can be read: the bf16 run launches the bf16
    kernels (K1, K2, K3 at padded width 32) and no fp32 kernel, the fp32
    run the converse. The script needs neither cv2 nor PIL:
    ``cli.read_conditioning`` returns synthetic 176x320 frames in place of
    a decoded video, and a frame is written as .npy where PIL is not
    installed.
    Each run must write its 10 frames (the 2 conditioning frames and the
    8 generated), uint8 of one shape."""
    out = {}
    saved = []

    class _Image:  # PIL.Image's fromarray(...).save(path), in numpy
        @staticmethod
        def fromarray(a):
            class _Saver:
                @staticmethod
                def save(path):
                    np.save(path + ".npy", a)
                    saved.append(a)
            return _Saver

    read = cli.read_conditioning
    try:
        import PIL  # noqa: F401
        stub = False
    except ImportError:
        stub = True
    if stub:
        sys.modules["PIL"] = type(sys)("PIL")
        sys.modules["PIL"].Image = _Image
    cli.read_conditioning = lambda path, n: synthetic_frames(n)
    try:
        for dtype in ("bf16", "fp32"):
            with tempfile.TemporaryDirectory() as tmp:
                argv = ["generate", *CLI_TINY_ARGS, "--dtype", dtype,
                        "--video_path", "synthetic.mp4", "--save_dir", tmp]
                saved.clear()
                reset_counts()
                t0 = time.perf_counter()
                cli.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                ran = counts()
                files = sorted(os.listdir(tmp))
            mine = ("K1", "K2", "K3") if dtype == "bf16" else (
                "K1-fp32", "K2-fp32", "K3-fp32")
            others = [k for k in ("K1", "K2", "K3", "K6", "K1-fp32",
                                  "K2-fp32", "K3-fp32", "K6-fp32")
                      if k not in mine]
            log(f"cli generate --tiny_model --dtype {dtype}: {wall:.2f} s, "
                f"{len(files)} frames written, launches {ran}")
            if not all(ran[k] for k in mine) or any(ran[k] for k in others):
                fail(f"cli generate --dtype {dtype} ran {ran}, not {mine}")
            if len(files) != 10 or (stub and (
                    len(saved) != 10 or any(a.dtype != np.uint8
                                           or a.shape != saved[0].shape
                                           for a in saved))):
                fail(f"cli generate --dtype {dtype} wrote {files}")
            out[dtype] = dict(wall_s=wall, frames=len(files), launches=ran,
                              **({"frame_shape": list(saved[0].shape)}
                                 if saved else {}))
    finally:
        cli.read_conditioning = read
        if stub:
            del sys.modules["PIL"]
    return out


# the CLI's own train / train-image at --tiny_model on the card: one step
CLI_TRAIN_ARGS = ("--tiny_model", "--device", "cuda", "--max_steps", "1",
                  "--log_every", "1", "--ckpt_every", "1000", "--seed", "0",
                  "--no_auto_resume")
CLI_TRAIN_RUNS = (("train", "bf16"), ("train", "no"), ("train-image", "no"))


class SyntheticClips:
    """``VideoClipDataset`` in the CLI's ``train`` on the card's machine,
    which has no cv2: clips of synthetic 176x320 frames through the port's
    preprocessing, blocked by the scheme's partition of a seeded draw."""

    def __init__(self, source, frame_num, target_resolution, scheme, seed,
                 **kw):
        self.frame_num, self.res = frame_num, tuple(target_resolution)
        self.scheme, self.seed = scheme, seed

    def __len__(self):
        return 4

    def sample(self, index):
        rng = random.Random(self.seed * 1000 + index)
        pixels = preprocess_to_resolution(
            synthetic_frames(self.frame_num, seed=index), *self.res)
        blocks = (random_block_partition(self.frame_num, rng)
                  if self.scheme == "frame_block" else (1,) * self.frame_num)
        return ClipSample(pixels, blocks)


def cli_train_phase(dev) -> dict:
    """``python -m video_gpt_tpu_torch.cli train --tiny_model --device
    cuda`` (head_dim 16) one step in bf16 and one with ``--mixed_precision
    no``, and ``train-image --tiny_model --mixed_precision no`` one step,
    through the CLI's own ``main`` in this process, so that its launch
    counters can be read: each step exactly 2 K3 and 1 K9 a layer (the
    per-layer recompute) and one map build, of the bf16 kernels at padded
    width 32 (bf16) or of the fp32 kernels with no bf16 launch (fp32), and
    a finite loss in its log line. The card's machine has neither cv2 nor
    PIL: the video dataset is :class:`SyntheticClips`, and the image
    dataset reads synthetic arrays in place of its PNG files."""
    from video_gpt_tpu_torch.data import image_text
    from video_gpt_tpu_torch.training import trainer as trainer_mod
    nl = tiny_model_config().num_layers
    out = {}
    clips, load = trainer_mod.VideoClipDataset, \
        image_text.ImageTextDataset._load
    trainer_mod.VideoClipDataset = SyntheticClips
    image_text.ImageTextDataset._load = \
        lambda self, path, size: resize_center_crop(
            synthetic_image(max(size), 4), size)
    try:
        for command, mixed in CLI_TRAIN_RUNS:
            with tempfile.TemporaryDirectory() as tmp:
                if command == "train":
                    data = ["--video_dir_path", "synthetic", "--frame_num",
                            "4", "--target_resolution", "64", "96"]
                else:
                    jf = os.path.join(tmp, "data.json")
                    with open(jf, "w") as f:
                        json.dump([{"instruction": IMAGE_PROMPT,
                                    "output_image": "out.png"}], f)
                    data = ["--json_file", jf, "--height", "64", "--width",
                            "64"]
                argv = [command, *CLI_TRAIN_ARGS, *data, "--mixed_precision",
                        mixed, "--results_dir", os.path.join(tmp, "run")]
                reset_counts()
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    cli.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ran = counts()
            suffix = "-fp32" if mixed == "no" else ""
            want = expect(**{f"K3{suffix}": 2 * nl, f"K9{suffix}": nl},
                          bias_map_builds=1)
            losses = [float(line.split("loss=")[1].split()[0])
                      for line in buf.getvalue().splitlines()
                      if "loss=" in line]
            name = f"{command} --mixed_precision {mixed}"
            log(f"cli {name} --tiny_model: {wall:.2f} s, losses {losses}, "
                f"launches {ran}")
            if ran != want:
                fail(f"cli {name} launches {ran} != {want}")
            if len(losses) != 1 or not np.isfinite(losses[0]):
                fail(f"cli {name} logged losses {losses}")
            out[f"{command}_{mixed}"] = dict(wall_s=wall, loss=losses[0],
                                            launches=ran)
    finally:
        trainer_mod.VideoClipDataset = clips
        image_text.ImageTextDataset._load = load
    return out


def synthetic_frames(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    # smooth gradients plus noise, so the VAE sees image-like input
    y, x = np.mgrid[0:H_PX, 0:W_PX]
    frames = []
    for i in range(n):
        base = np.stack([(x + 8 * i) % 256, (y * 2 + 4 * i) % 256,
                         (x + y) % 256], -1).astype(np.float32)
        noisy = base + rng.normal(0, 12, base.shape)
        frames.append(np.clip(noisy, 0, 255).astype(np.uint8))
    return frames


KERNEL_GROUPS = (  # (group, substrings of kernel names), first match wins
    ("K1/K2 rank_attention", ("rank_attention",)),
    # the tile maps' launches (csrc/tile_map.cuh): the bias's, once per
    # bias; K6's and K7's, in each of their launches
    ("tile maps", ("bias_tile_map", "tile_summary", "meta_tile_map",
                   "tile_order")),
    ("K9 bias_attention_bwd", ("bias_attention_delta", "bias_attention_dkdv",
                               "bias_attention_dq")),
    ("K3 bias_attention", ("bias_attention",)),
    ("K7 inline_attention_bwd", ("inline_attention_delta",
                                 "inline_attention_dkdv",
                                 "inline_attention_dq")),
    ("K6 inline_attention", ("inline_attention",)),
    ("memcpy/memset", ("Memcpy", "Memset")),
    ("conv (cuDNN)", ("conv", "fprop", "cudnn", "winograd")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
)


def kernel_group(name: str) -> str:
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (elementwise, norms, softmax, copies)"


def profile_phase(pipe, frames, kw, clip_s, name: str = "profile") -> None:
    """One more serving run (``generate(frames, **kw)``) under
    torch.profiler, tracing the device only (no host op records): device
    time by kernel group, and the device busy time against the wall clock
    of this same run. Tracing adds host time, so the run's wall time is
    printed beside the unprofiled one's (``clip_s``; None where that run
    was not timed alone)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pipe.generate(frames, **kw)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    groups, busy, top = device_groups(prof)
    log(json.dumps({name: {
        "device_ms_by_group": groups, "device_busy_ms": busy,
        "wall_ms": wall_ms, "idle_share": 1.0 - busy / wall_ms,
        "unprofiled_clip_ms": None if clip_s is None else clip_s * 1e3,
        "top_kernels": top}}))


def device_groups(prof, ranges=()):
    """(device ms by kernel group, device busy ms, the 12 largest kernels)
    of a profiler run. A kernel that starts inside the device span of a
    ``record_function`` range named in ``ranges`` goes to that range's
    group; the spans themselves are not kernels and count nothing."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.name in ranges]
    groups, by_kernel = {}, {}
    for e in events:
        if e.name in ranges:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        start = e.time_range.start
        g = next((n for n, a, b in spans if a <= start < b), None)
        g = g or kernel_group(e.name)
        groups[g] = groups.get(g, 0.0) + ms
        t, n = by_kernel.get(e.name[:80], (0.0, 0))
        by_kernel[e.name[:80]] = (t + ms, n + 1)
    busy = sum(groups.values())
    if not busy > 0:
        fail("the profiler recorded no device time")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    return groups, busy, [dict(name=k, ms=ms, calls=n)
                          for k, (ms, n) in top]


def rollout_phase(pipe, smi: str, name: str, n_videos: int, steps: int,
                  want: dict) -> dict:
    """The recipe of configs/inference.sh at full width: 56 synthetic
    frames per video, two 24-frame clips, an 80-frame window, guidance 1.5,
    no re-noise, x1 prediction, through ``generate`` (one video) or
    ``generate_batch`` (``n_videos`` as batch rows, seeds 0..N-1). The
    second block slides 24 frames out of the window, so its cache is
    rebuilt by a second prefill. One warm-up rollout at 1 step with the
    host-op check on, then the timed rollout at ``steps`` steps: its
    launch counts must be exactly ``want``; each video gets 56 + 48 uint8
    frames and 48 finite latents on the device."""
    videos = [synthetic_frames(ROLLOUT_CLEAN, seed=1 + i)
              for i in range(n_videos)]
    kw = dict(gen_nums=ROLLOUT_GEN, img_guidance_scale=CFG_SCALE,
              max_frame_window=ROLLOUT_WINDOW, clean_image_noise_level=0.0,
              max_input_image_size=320, prediction_type="x1",
              return_latents=True)

    def rollout(num_steps):
        if n_videos == 1:
            return [pipe.generate(videos[0], seed=0,
                                  num_inference_steps=num_steps, **kw)]
        return pipe.generate_batch(videos, seeds=list(range(n_videos)),
                                   num_inference_steps=num_steps, **kw)

    host = HostFloatOps()
    t0 = time.perf_counter()
    with host:
        rollout(1)
    torch.cuda.synchronize()
    log(f"{name}: warm-up at 1 step {time.perf_counter() - t0:.2f} s "
        f"(host-op check on)")
    if host.ops:
        fail(f"{name}: float ops ran on the host: {sorted(host.ops)}")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = rollout(steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counts()
    log(f"{name}: launches {launches} (expected {want})")
    if launches != want:
        fail(f"{name} launch counts {launches} != {want}")
    n_gen = sum(ROLLOUT_GEN)
    for frames, lat in outs:
        if len(frames) != ROLLOUT_CLEAN + n_gen or len(lat) != n_gen:
            fail(f"{name}: {len(frames)} frames / {len(lat)} latents")
        if not all(f.dtype == np.uint8 and f.shape == (H_PX, W_PX, 3)
                   for f in frames):
            fail(f"{name}: frames are not uint8 {H_PX}x{W_PX}x3")
        lat = torch.stack(lat)
        if lat.device != pipe.device or not torch.isfinite(lat).all():
            fail(f"{name}: latents on {lat.device} or not finite")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rec = dict(videos=n_videos, steps=steps, blocks=len(ROLLOUT_GEN),
               clean_frames=ROLLOUT_CLEAN, generated_frames_per_video=n_gen,
               wall_s=wall_s, frames_per_s_per_video=n_gen / wall_s,
               frames_per_s=n_videos * n_gen / wall_s, peak_mem_gib=peak_gib,
               launches=launches, device=smi)
    log(f"{name}: {n_videos} x {n_gen} frames in {steps} steps per block: "
        f"{wall_s:.3f} s, {n_gen / wall_s:.4f} frames/s per video, peak "
        f"{peak_gib:.2f} GiB, on {smi}")
    log(json.dumps({name: rec}))
    if n_videos == 1:
        # where the time goes: the first block once more, profiled
        profile_phase(pipe, videos[0],
                      dict(kw, gen_nums=ROLLOUT_GEN[:1],
                           num_inference_steps=ROLLOUT_PROFILE_STEPS),
                      None, name=f"{name}_block_profile")
    return rec


def counts():
    """Every kernel's launches since the last :func:`reset_counts`, and the
    builds of the bias's tile map. K4, K5 and K10 are the launches of K1,
    K2 and K3 past the TPU's 8192-key cap, where the TPU runs its k-tiled
    kernels; ``K*-fp32`` the fp32 kernel's launches under each wrapper
    (fp32 operands), apart from the bf16 kernels'."""
    return {"K1": fa.flash_mha_decode_split.launches,
            "K2": fa.flash_mha_decode.launches, "K3": fa.flash_mha.launches,
            "K4": fa.flash_mha_decode_split.long_launches,
            "K5": fa.flash_mha_decode.long_launches,
            "K10": fa.flash_mha.long_launches,
            "K9": fa.flash_mha_bwd.launches,
            "K6": fa.flash_mha_inline.launches,
            "K7": fa.flash_mha_inline_bwd.launches,
            # the fp32 kernel (csrc/fp32_attention.cu) under each mask
            "K1-fp32": fa.flash_mha_decode_split.fp32_launches,
            "K2-fp32": fa.flash_mha_decode.fp32_launches,
            "K3-fp32": fa.flash_mha.fp32_launches,
            "K6-fp32": fa.flash_mha_inline.fp32_launches,
            # the fp32 backward (csrc/fp32_attention_bwd.cu) under each mask
            "K9-fp32": fa.flash_mha_bwd.fp32_launches,
            "K7-fp32": fa.flash_mha_inline_bwd.fp32_launches,
            "P1-serial": overlap_probe.overlap_serial.launches,
            "P1-pipelined": overlap_probe.overlap_pipelined.launches,
            "bias_map_builds": fa.flash_mha.bias_map_builds}


def expect(**launches) -> dict:
    """A run's expected counts: the given ones, every other kernel 0."""
    return {k: launches.get(k, 0) for k in counts()}


def reset_counts() -> None:
    fa.reset_launch_counts()
    overlap_probe.overlap_serial.launches = 0
    overlap_probe.overlap_pipelined.launches = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    # fp32 VAE convolutions in full fp32 (cuDNN's default is TF32); the
    # bf16 runs below do not read the flag
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--mesh-margin"]:
        _cuda.libraries()
        mesh_margin(torch.device("cuda"), smi,
                    [int(a) for a in sys.argv[2:]])
        return 0
    if sys.argv[1:2] == ["--mesh-train"]:
        _cuda.libraries()
        mesh_train_only(torch.device("cuda"), smi)
        return 0
    run(torch.device("cuda"), smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev: torch.device, smi: str) -> None:
    t_run = t0 = time.perf_counter()
    _cuda.libraries()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    spills = []
    for line in _cuda.build_log().splitlines():
        if ("registers" in line or "spill" in line or "entry function" in line
                or "Performance Loss" in line or line.startswith("==")):
            log(f"  {line.strip()}")
        spilled = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill",
                            line)
        if spilled and spilled.groups() != ("0", "0"):
            spills.append(line.strip())
    # every kernel instance keeps its registers (ptxas -v: 0 spill bytes)
    if spills:
        fail(f"ptxas spilled registers: {spills}")
    log(f"rank_attention_kernel (K1/K2): {fa.rank_attention_smem()} bytes of "
        f"dynamic shared memory per block")

    records = kernels_phase(dev)
    torch.cuda.empty_cache()
    mark("the kernels phase")
    reference_phase(dev)
    width_refs = width_reference_phase(dev)
    mark("the small-input serving references")

    # ---- main path ----------------------------------------------------------
    t0 = time.perf_counter()
    pipe = VideoGPTPipeline.build(ModelConfig(), VAEConfig(), device=dev,
                                  dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.model.parameters())
    log(f"build pipeline: {time.perf_counter() - t0:.1f} s, "
        f"{n_params / 1e9:.3f}B model params")
    frames = synthetic_frames(N_CLEAN)
    # a 24-frame window keeps all 8 conditioning frames in the context (the
    # default 16-frame window would slide them out before a 16-frame clip)
    kw = dict(gen_nums=(N_GEN,), num_inference_steps=STEPS,
              img_guidance_scale=CFG_SCALE, max_frame_window=N_CLEAN + N_GEN,
              seed=0, return_latents=True)

    host = HostFloatOps()
    t0 = time.perf_counter()
    with host:
        pipe.generate(frames, **kw)
    torch.cuda.synchronize()
    log(f"warm-up generate: {time.perf_counter() - t0:.2f} s "
        f"(host-op check on)")
    if host.ops:
        fail(f"float ops ran on the host: {sorted(host.ops)}")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, lat = pipe.generate(frames, **kw)
    torch.cuda.synchronize()
    clip_s = time.perf_counter() - t0
    launches = counts()
    nl = pipe.model.cfg.num_layers
    want = expect(K1=nl * STEPS, K2=nl * STEPS, K3=nl, bias_map_builds=1)
    log(f"main path launches {launches} (expected {want})")
    if launches != want:
        fail(f"main-path launch counts {launches} != {want}")
    gen = out[-N_GEN:]
    if len(out) != N_CLEAN + N_GEN or len(lat) != N_GEN:
        fail(f"{len(out)} frames / {len(lat)} latents returned")
    if not all(f.dtype == np.uint8 and f.shape == (H_PX, W_PX, 3)
               for f in gen):
        fail(f"generated frames are not uint8 {H_PX}x{W_PX}x3")
    lat = torch.stack(lat)
    if lat.device.type != dev.type:
        fail(f"latents on {lat.device}, not {dev}")
    n_bad = int((~torch.isfinite(lat)).sum())
    if n_bad:
        fail(f"{n_bad} of {lat.numel()} latent values are not finite")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    main = dict(clip_s=clip_s, frames_per_s=N_GEN / clip_s,
                peak_mem_gib=peak_gib, latent_std=float(lat.float().std()),
                frame_std=float(np.std(np.stack(gen))), device=smi)
    log(f"main path: {N_GEN}-frame clip {clip_s:.3f} s, "
        f"{main['frames_per_s']:.3f} frames/s, peak {peak_gib:.2f} GiB, "
        f"on {smi}")
    log(json.dumps({"main_path": main}))
    mfu_line("clip", clip_flops(pipe.model), clip_s, smi)

    # ---- extend path --------------------------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    out2 = pipe.generate(frames, gen_nums=(4, 4), num_inference_steps=2,
                         img_guidance_scale=CFG_SCALE,
                         clean_image_noise_level=0.0, seed=1)
    torch.cuda.synchronize()
    ext = counts()
    # one prefill (K3) for block 0; block 1 extends the cache through K1:
    # one extend launch per layer + 2 blocks x 2 steps of decode per layer
    want_ext = expect(K1=nl + 2 * 2 * nl, K2=2 * 2 * nl, K3=nl,
                      bias_map_builds=1)
    log(f"extend path: {time.perf_counter() - t0:.2f} s, launches {ext} "
        f"(expected {want_ext})")
    if ext != want_ext:
        fail(f"extend-path launch counts {ext} != {want_ext}")
    if len(out2) != N_CLEAN + 8:
        fail(f"extend path returned {len(out2)} frames")

    profile_phase(pipe, frames, kw, clip_s)
    del out, lat, out2

    # ---- long and batched rollouts (configs/inference.sh) ------------------
    # both blocks prefill 56 frames (the second after the window slides):
    # K3 with a bias at B 1 (12,432^2 within precompute_bias_limit, past
    # 8192 keys: K10's function), K6 at B 2 (2 x 12,432^2 above it); K1
    # (over 17,760 keys: K4's function) and K2 (5,328 keys) in every step
    long_rollout = rollout_phase(
        pipe, smi, "long_rollout", 1, ROLLOUT_STEPS, expect(
            K3=2 * nl, K10=2 * nl, K1=2 * ROLLOUT_STEPS * nl,
            K4=2 * ROLLOUT_STEPS * nl, K2=2 * ROLLOUT_STEPS * nl,
            bias_map_builds=2))
    batched_rollout = rollout_phase(
        pipe, smi, "batched_rollout", BATCH_VIDEOS, BATCH_STEPS, expect(
            K6=2 * nl, K1=2 * BATCH_STEPS * nl, K4=2 * BATCH_STEPS * nl,
            K2=2 * BATCH_STEPS * nl))
    del pipe
    freed("the serving paths")
    fp32_clip = fp32_clip_phase(dev, smi)
    freed("the fp32 clip")
    cli_tiny = cli_tiny_phase(dev)
    freed("the CLI's tiny runs")
    cli_train = cli_train_phase(dev)
    freed("the CLI's tiny training runs")
    drift_counts = cfg_drift_phase(dev, smi)
    freed("the cfg_drift sweep")

    # ---- the mesh: gloo ranks sharing the card ----------------------------
    mesh_clips, mesh_training = mesh_phases(dev, smi)
    late_cut()

    train_reference_phase(dev)
    inline_ref = train_reference_phase(dev, bias_limit=0)
    # fp32 training (--mixed_precision no) on both routes, and the tiny
    # model (head_dim 16) in bf16 on the inline route (K6/K7 at Dp 32)
    train_reference_phase(dev, mixed="no")
    fp32_inline_ref = train_reference_phase(dev, bias_limit=0, mixed="no")
    tiny_ref = train_reference_phase(dev, bias_limit=0,
                                     mcfg=tiny_model_config())
    mark("the small-input training references")
    train_counts = training_phase(dev, smi, stage=1)
    # two 56 GiB training states do not fit one card: the stage-1 trainer
    # is gone before the stage-4 one is built
    freed("the stage-1 path")
    stage4_counts = training_phase(dev, smi, stage=4)
    freed("the stage-4 path")
    fp32_train_counts = training_phase(dev, smi, stage=1, mixed="no")
    freed("the fp32 stage-1 path")
    lora_counts, adapters = lora_phase(dev, smi)
    freed("the LoRA path")
    distill_reference_phase(dev)
    distill_counts, student = distill_phase(dev, smi)
    freed("the distillation path")
    student_counts = products_phase(dev, smi, student, adapters)
    del student, adapters
    freed("serving the products")
    image_reference_phase(dev)
    image_serving = image_serving_phase(dev, smi)
    freed("the image serving path")
    fp32_image = fp32_image_phase(dev, smi)
    freed("the fp32 image")
    train_image_counts = train_image_phase(dev, smi)
    freed("the train-image path")
    input_head_counts = input_head_phase(dev, smi)
    freed("the input-head path")
    # the offload optimizer last, so that nothing it leaves on the host
    # (the pinned allocator's cache, the pages of its 49 GiB of state) is
    # around while the mesh ranks copy their collectives through host
    # memory
    offload_reference_phase(dev)
    freed("the small-input offload reference")
    offload_counts = offload_phase(dev, smi)
    freed("the offload path")

    # launches: each kernel's count in its own path's timed run (serving:
    # one clip; training: the timed steps of its stage). K8 is K6's kernel
    # on the route of a stage-1 recipe whose B*L^2 exceeds the bias limit:
    # its count is the small-input reference's at precompute_bias_limit=0.
    # K4 and K10 (K1 and K3 past 8192 keys) count in the long rollout. K5
    # (K2 past 8192 keys: a tail-only row of a 37+-frame clip) and the
    # probe lie on no path: theirs is the sum over every path's timed run.
    paths = {"main path": launches, "extend path": ext,
             "long rollout": long_rollout["launches"],
             "batched rollout": batched_rollout["launches"],
             "stage-1 training": train_counts,
             "stage-4 training": stage4_counts, "LoRA training": lora_counts,
             "guided distillation": distill_counts,
             "guided student": student_counts,
             "text to image": image_serving["text_to_image"]["launches"],
             "image editing": image_serving["editing_3way"]["launches"],
             "train-image": train_image_counts,
             "input-head training": input_head_counts,
             "cfg_drift sweep": drift_counts,
             "offload training": offload_counts,
             "fp32 stage-1 training": fp32_train_counts}
    for k, r in records.items():
        if k in ("K6", "K7"):
            r.update(launches=stage4_counts[k], launches_per_train_step=(
                stage4_counts[k] // TRAIN_PATHS[4][1]))
        elif k == "K8":
            r.update(launches=inline_ref["K6"], launches_path=(
                "small-input stage-1 training reference at "
                "precompute_bias_limit=0"))
        elif k == "K9":
            r.update(launches=train_counts[k], launches_per_train_step=(
                train_counts[k] // TRAIN_PATHS[1][1]))
        elif k in ("K4", "K10"):
            r.update(launches=long_rollout["launches"][k],
                     launches_path="long rollout")
        elif k in ("K5", "P1-serial", "P1-pipelined"):
            r.update(launches=sum(p[k] for p in paths.values()),
                     launches_path="every path: " + ", ".join(paths))
        elif k in ("K1-fp32", "K2-fp32", "K3-fp32"):
            r.update(launches=fp32_clip["launches"][k],
                     launches_path="the fp32 clip (generate --dtype fp32)")
        elif k == "K6-fp32":
            r.update(launches=width_refs["fp32_inline"]["launches"][k],
                     launches_path=(
                         "fp32 small-input reference at "
                         "precompute_bias_limit=0 (its prefill)"))
        elif k == "K9-fp32":
            r.update(launches=fp32_train_counts[k], launches_per_train_step=(
                fp32_train_counts[k] // FP32_TRAIN_STEPS), launches_path=(
                    "the fp32 stage-1 training step (train "
                    "--mixed_precision no)"))
        elif k == "K7-fp32":
            r.update(launches=fp32_inline_ref[k], launches_path=(
                "fp32 small-input training reference at "
                "precompute_bias_limit=0"))
        else:
            r.update(launches=launches[k], launches_per_clip=launches[k])
    records["K3"]["launches_per_train_step"] = train_counts["K3"] \
        // TRAIN_PATHS[1][1]
    # the bias's tile map, which K3 and K9 read: builds per clip (its
    # prefill), per long rollout (two prefills) and per stage-1 step
    records["K3"]["bias_map_builds"] = dict(
        per_clip=launches["bias_map_builds"],
        per_long_rollout=long_rollout["launches"]["bias_map_builds"],
        per_train_step=train_counts["bias_map_builds"] // TRAIN_PATHS[1][1])
    for k in ("K1", "K2", "K4", "K6"):
        records[k]["launches_batched_rollout"] = \
            batched_rollout["launches"][k]
    for k in ("K3", "K9"):
        records[k]["launches_per_lora_step"] = lora_counts[k] // LORA_STEPS
        records[k]["launches_per_distill_step"] = \
            distill_counts[k] // DISTILL_STEPS
    records["K3"]["bias_map_builds"].update(
        per_lora_step=lora_counts["bias_map_builds"] // LORA_STEPS,
        per_distill_step=distill_counts["bias_map_builds"] // DISTILL_STEPS)
    # each mesh rank's launches in its full-width clip (every rank alike)
    for k in ("K1", "K2", "K6"):
        records[k]["launches_per_mesh_rank_clip"] = {
            name: c["launches_per_rank"][k] for name, c in mesh_clips.items()}
    # each mesh training rank's launches in a timed full-width step
    for name, key, run_name in (
            ("K3", "mesh_tensor_train_shape", "data2_tensor2_zero3"),
            ("K9", "mesh_tensor_train_shape", "data2_tensor2_zero3"),
            ("K6", "mesh_seq_train_shape", "data2_seq2"),
            ("K7", "mesh_seq_train_shape", "data2_seq2"),
            ("K6", "mesh_seq_tensor_stage4_shape", "seq2_tensor2"),
            ("K7", "mesh_seq_tensor_stage4_shape", "seq2_tensor2"),
            ("K6", "ring_hop_q1_k0", "seq2_tensor2_ring"),
            ("K7", "ring_hop_q1_k0", "seq2_tensor2_ring"),
            ("K6", "ring_hop_q0_k1", "seq2_tensor2_ring"),
            ("K7", "ring_hop_q0_k1", "seq2_tensor2_ring"),
            ("K6", "pipe_microbatch_shape", "pipe4_nm4"),
            ("K7", "pipe_microbatch_shape", "pipe4_nm4")):
        records[name][key]["launches"] = \
            mesh_training[run_name]["launches_per_rank_step"][name]
        records[name][key]["launches_path"] = \
            f"each rank of the full-width mesh training run {run_name}"
    # the mesh recipes: each rank's launches in a timed full-width step of
    # LoRA on (data 2, tensor 2, zero3) (K3/K9 at 16 heads) and of guided
    # distillation on (seq 2, tensor 2) (K6/K7 over the stage-1 layout at
    # 8 heads: T = 2 halves a seq-2 rank's 16)
    for name, key, run_name in (
            ("K3", "mesh_tensor_train_shape", "data2_tensor2_zero3_lora"),
            ("K9", "mesh_tensor_train_shape", "data2_tensor2_zero3_lora"),
            ("K6", "mesh_seq_train_shape", "seq2_tensor2_distill_guided"),
            ("K7", "mesh_seq_train_shape", "seq2_tensor2_distill_guided")):
        records[name][key][f"launches_{run_name}"] = \
            mesh_training[run_name]["launches_per_rank_step"][name]
    records["K1"]["launches_per_student_clip"] = student_counts["K1"]
    records["K3"]["launches_per_student_clip"] = student_counts["K3"]
    # the image family: K3 per image (every context's prefill and cached
    # decode steps), K3 and K9 per train-image and per input-head step
    records["K3"]["launches_per_image"] = {
        k: r["launches"]["K3"] for k, r in image_serving.items()}
    records["K3"]["bias_map_builds"]["per_image"] = {
        k: r["launches"]["bias_map_builds"] for k, r in image_serving.items()}
    for k in ("K3", "K9"):
        records[k]["launches_per_train_image_step"] = \
            train_image_counts[k] // TRAIN_IMAGE_STEPS
        records[k]["launches_per_input_head_step"] = \
            input_head_counts[k] // INPUT_HEAD_STEPS
    # the cfg_drift sweep (8 layers: K3 per prefill, K1 per cond and K2 per
    # uncond evaluation) and the offload path's steps at grad_splits 1
    for k in ("K1", "K2", "K3"):
        records[k]["launches_cfg_drift"] = drift_counts[k]
    for k in ("K3", "K9"):
        records[k]["launches_per_offload_step"] = \
            offload_counts[k] // OFFLOAD_STEPS
    records["K3"]["bias_map_builds"]["per_offload_step"] = \
        offload_counts["bias_map_builds"] // OFFLOAD_STEPS
    # the fp32 kernel per 1024x1024 fp32 image (FP32_IMAGE_STEPS steps) and
    # per CLI --tiny_model run; the bf16 kernels at head_dim 16 per CLI
    # --tiny_model bf16 run (no path runs head_dim 64 or 128)
    records["K3-fp32"]["launches_per_fp32_image"] = \
        fp32_image["launches"]["K3-fp32"]
    for k in ("K1", "K2", "K3"):
        records[f"{k}-fp32"]["launches_cli_tiny_fp32"] = \
            cli_tiny["fp32"]["launches"][f"{k}-fp32"]
    for k in ("K1", "K2", "K3", "K6"):
        for d in WIDTHS:
            records[k][f"bf16_d{d}"]["launches"] = (
                cli_tiny["bf16"]["launches"][k] if d == 16 else 0)
            records[k][f"bf16_d{d}"]["launches_path"] = (
                "generate --tiny_model (bf16, CLI)" if d == 16
                else "no path runs this head width")
    # the backward kernels at the other widths and dtype: K9 at head_dim 16
    # per CLI --tiny_model bf16 train step, K7 at head_dim 16 in the tiny
    # model's small-input reference on the inline route; no path of the
    # smoke trains at 64 or 128, nor runs the ring at a width other than 96
    records["K3-fp32"]["launches_per_fp32_train_step"] = \
        fp32_train_counts["K3-fp32"] // FP32_TRAIN_STEPS
    records["K3-fp32"]["fp32_train"].update(
        launches=fp32_train_counts["K3-fp32"] // FP32_TRAIN_STEPS,
        launches_path="per fp32 stage-1 step (train --mixed_precision no)")
    for k in ("K3", "K9"):
        records[k]["launches_cli_tiny_train"] = \
            cli_train["train_bf16"]["launches"][k]
        for run_name in ("train_no", "train-image_no"):
            records[f"{k}-fp32"][f"launches_cli_tiny_{run_name}"] = \
                cli_train[run_name]["launches"][f"{k}-fp32"]
    for d in WIDTHS:
        key = f"bf16_d{d}"
        for name, rkey, n, path in (
                ("K9", key, cli_train["train_bf16"]["launches"]["K9"],
                 "train --tiny_model (bf16, CLI), one step"),
                ("K7", f"{key}_seq2_rank", tiny_ref["K7"],
                 "the tiny model's small-input training reference at "
                 "precompute_bias_limit=0")):
            records[name][rkey]["launches"] = n if d == 16 else 0
            records[name][rkey]["launches_path"] = (
                path if d == 16 else "no path trains at this head width")
        if d in RING_HOP_WIDTHS:
            records["K7"][f"{key}_ring_hop_q1_k0"].update(
                launches=0,
                launches_path="no path runs the ring at this width")
    records["K7-fp32"]["fp32_ring_hop_q1_k0"].update(
        launches=0, launches_path="no path runs the ring in fp32")
    log(json.dumps({"runtime_depth_cuts": CUTS}))
    log(f"every phase: {time.perf_counter() - t_run:.1f} s")
    log(json.dumps({"kernels": list(records.values())}))


def mesh_phases(dev, smi: str) -> tuple:
    """The mesh on gloo ranks sharing the card: the references at once
    (none timed), then the timed full-width clips and training runs alone.
    Returns ({clip name: record}, {training run name: record})."""
    def mesh_launches(seq, tensor, layers=2, steps=3):
        # the small-input reference: a prefill (K6 under Ulysses, K3 with
        # its bias on a tensor-only mesh), one extend and 2 blocks of
        # cond and uncond rows
        prefill = (dict(K6=layers) if seq > 1
                   else dict(K3=layers, bias_map_builds=1))
        return expect(K1=layers + 2 * steps * layers,
                      K2=2 * steps * layers, **prefill)

    # the mesh clips are held to the single-rank clip of their model and to
    # its floor: how far the same clip moves with its linears in another
    # fp32 summation order (TP's row-parallel split is one such order)
    main_latents, mesh_floor = mesh_clip_reference(dev)
    log(f"single-rank clip at {MESH_CLIP_LAYERS} layers with fp32 linears: "
        f"relative MSE {mesh_floor:.3e} (the mesh clips' floor)")
    freed("the mesh clips' single-rank clip")
    # the references, none of them timed, all at once (their ranks' start-up
    # and the host's work overlap): the serving meshes and the collective
    # probe in threads, the training reference here
    want_ref, _ = mesh_reference_latents(None)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        serving_ref = pool.submit(mesh_reference_phase, want_ref,
                                  mesh_launches)
        probe = pool.submit(collective_probe)
        mesh_train_reference_phase()
        probe.result()
        serving_ref.result()
    freed("the mesh references")
    # then the timed runs alone: the full-width clips and training runs
    cl = MESH_CLIP_LAYERS
    mesh_want = expect(K6=cl, K1=cl * STEPS, K2=cl * STEPS)
    mesh_clips = {}

    def check_clip(seq, tensor, res):
        mesh_clips[mesh_name(seq, tensor)] = mesh_clip_phase(
            seq, tensor, res, main_latents, mesh_floor, mesh_want, smi)

    mesh_training = mesh_timed_phase(smi, MESH_CLIPS, check_clip)
    freed("the mesh's timed runs")
    return mesh_clips, mesh_training


def mesh_training_phases(smi: str) -> dict:
    """The mesh's training half on gloo ranks sharing the card: the
    collective probe, the small-input reference, the full-width runs."""
    collective_probe()
    mesh_train_reference_phase()
    mark("the mesh training reference")
    out = mesh_timed_phase(smi, clips=())
    freed("the mesh training phases")
    return out


def mesh_train_only(dev, smi: str) -> None:
    """``--mesh-train``: the mesh training kernels' records and phases
    alone (a development reading; no device line)."""
    t0 = time.perf_counter()
    recs = list(mesh_train_kernels(dev))
    freed("the mesh training kernels")
    runs = mesh_training_phases(smi)
    for name, key, rec in recs:
        run_name = {"mesh_tensor_train_shape": "data2_tensor2_zero3",
                    "mesh_seq_train_shape": "data2_seq2",
                    "mesh_seq_tensor_stage4_shape": "seq2_tensor2",
                    "ring_hop_q1_k0": "seq2_tensor2_ring",
                    "ring_hop_q0_k1": "seq2_tensor2_ring",
                    "pipe_microbatch_shape": "pipe4_nm4"}[key]
        rec["launches"] = runs[run_name]["launches_per_rank_step"][name]
    log(json.dumps({"mesh_train_kernels": [
        dict(rec, shape=key) for _, key, rec in recs]}))
    log(f"mesh training phases: {time.perf_counter() - t0:.1f} s")


def clip_flops(model) -> float:
    """Model flops of the main path's clip, ``bench.py``'s count
    (separate CFG): the prefix's prefill, then every step the cond row's
    tail over the cached prefix and the uncond row over its own tokens:
    2PT dense plus QK^T and PV."""
    from video_gpt_tpu_torch.utils.profiling import (attention_flops,
                                                     count_params,
                                                     dense_model_flops)
    n_img = tokens_per_frame(H_PX, W_PX)
    lay_c = frame_block_inference_layout(N_CLEAN, N_GEN, n_img, False)
    lay_u = frame_block_inference_layout(0, N_GEN, n_img, False)
    tail = lay_c.noisy_tail_len()
    prefix, l_c, l_u = lay_c.length - tail, lay_c.length, lay_u.length
    p, cfg = count_params(model), model.cfg

    def attn(q, kv):
        return attention_flops(cfg.num_layers, cfg.hidden_size, q, kv)

    return (dense_model_flops(p, prefix) + attn(prefix, prefix)
            + STEPS * (dense_model_flops(p, tail) + attn(tail, l_c))
            + STEPS * (dense_model_flops(p, l_u) + attn(l_u, l_u)))


def train_step_flops(model, tokens: int) -> float:
    """Model flops of a train step over ``tokens`` tokens,
    ``bench_suite.py``'s count: 6PT (forward and backward; the recompute
    not counted) plus 3x the QK^T and PV flops."""
    from video_gpt_tpu_torch.utils.profiling import (attention_flops,
                                                     count_params,
                                                     dense_model_flops)
    cfg = model.cfg
    return 3.0 * (dense_model_flops(count_params(model), tokens)
                  + attention_flops(cfg.num_layers, cfg.hidden_size, tokens,
                                    tokens))


def mfu_line(name: str, flops: float, seconds: float, smi: str) -> None:
    """A line of its own: ``name``'s MFU (``utils.profiling.mfu``: model
    flops / seconds / the card's bf16 dense peak) beside the card."""
    from video_gpt_tpu_torch.utils.profiling import mfu, peak_flops
    m = mfu(flops, seconds)
    peak = peak_flops()
    log(f"MFU {name}: {m if m is None else round(m, 4)} ({flops:.4e} model "
        f"flops in {seconds:.3f} s against "
        f"{peak if peak is None else peak / 1e12} TFLOP/s bf16 dense) on "
        f"{smi}")
    log(json.dumps({"mfu": {"path": name, "mfu": m, "model_flops": flops,
                            "seconds": seconds, "peak_flops": peak,
                            "device": smi}}))


# the parameters a training model starts at zero that randomise_heads_
# redraws
HEAD_PARAMS = ("x_embedder.proj.weight",
               "final_layer.adaLN_modulation.1.weight",
               "final_layer.linear.weight")


def randomise_heads_(model, seed: int, std: float = 0.02) -> None:
    """Random weights for the parts a training model starts at zero (the
    head and the noisy-patch embedder, HEAD_PARAMS): with a zero head no
    gradient reaches the trunk, and the attention backward would see
    dO = 0."""
    gen = torch.Generator(model.llm.norm.weight.device).manual_seed(seed)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for n in HEAD_PARAMS:
            params[n].normal_(0.0, std, generator=gen)


def train_reference_phase(dev, bias_limit=None, mixed: str = "bf16",
                          mcfg: ModelConfig = None) -> dict:
    """One loss and backward of a tiny training model on the card (bf16
    autocast over fp32 parameters, the kernels) against the same weights,
    batch and random numbers on the CPU in fp32 (plain versions). The CPU
    in bf16 gives the rounding floor the card's errors are read against:
    the flattened gradient's relative error must stay within
    TRAIN_REF_FLOOR_FACTOR times it, the loss's within 2^-8. With
    ``bias_limit=0`` no bias is precomputed, so the model runs the inline
    route of stages 2-4 (K6, K7) instead of K3/K9. With ``mixed`` "no"
    the card trains in fp32 (``--mixed_precision no``: the fp32 kernels,
    fp32 GEMMs without TF32; no bf16 kernel may launch), and the floor is
    the CPU's fp32 step rerun with its linears summed in two halves
    (:func:`split_linears`): the loss's and the gradient's relative errors
    must stay within FP32_REF_BAR, or twice their floor where that is
    higher. ``mcfg``: the tiny model at head_dim 96 (GQA 2:1) by default.
    Returns the card run's launch counts."""
    limit = {} if bias_limit is None else dict(
        precompute_bias_limit=bias_limit)
    if mcfg is None:
        mcfg = ModelConfig.tiny(hidden_size=192, num_heads=2,
                                num_kv_heads=1,
                                pos_embed_max_size=64,  # head_dim 96; GQA 2:1
                                **limit)
    else:
        mcfg = dataclasses.replace(mcfg, **limit)
    fp32 = mixed == "no"
    route = ("K6", "K7") if bias_limit == 0 else ("K3", "K9")
    if fp32:
        route = tuple(f"{k}-fp32" for k in route)
    # the bias route builds the bias's tile map once for the step
    builds = 0 if bias_limit == 0 else 1
    res, n_frames = (64, 96), 4
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, res + (3,), dtype=np.uint8)
              for _ in range(n_frames)]
    sample = ClipSample(preprocess_to_resolution(frames, *res),
                        (1,) * n_frames)
    tb_host = collate([sample], tokens_per_frame(*res))

    def trainer(device, mixed, **sd):
        cfg = stage_config(1, frame_num=n_frames, mixed_precision=mixed)
        return Trainer(mcfg, cfg, None, vae_cfg=VAEConfig.tiny(),
                       target_resolution=res, device=device, seed=3, **sd)

    card = trainer(dev, mixed)
    card.build()
    randomise_heads_(card.model, seed=4)
    sd = dict(init_state_dict={k: v.cpu() for k, v in
                               card.model.state_dict().items()},
              vae_state_dict={k: v.cpu() for k, v in
                              card.vae.state_dict().items()})
    # the same random numbers for every run, drawn on the host
    gen = torch.Generator().manual_seed(5)
    hl, wl = res[0] // 8, res[1] // 8
    post = torch.randn((n_frames, hl, wl, 4), generator=gen)
    nn_, nc = tb_host.noisy_sel.shape[0], tb_host.clean_sel.shape[0]
    draws = LossDraws(torch.randn((nn_, hl, wl, 4), generator=gen),
                      torch.rand((1, n_frames), generator=gen),
                      torch.randn((nc, hl, wl, 4), generator=gen),
                      torch.rand((nc,), generator=gen))

    def loss_and_grad(tr):
        if tr.model is None:
            tr.build()
        d = tr.device
        tb = tb_host.to(d)
        with torch.no_grad(), autocast(tr.cfg, d):
            lat = tr.vae.encode(tb.pixels, noise=post.to(d))
        inputs = tb.inputs._replace(x1=lat[tb.noisy_sel.long()],
                                    clean_latents=lat[tb.clean_sel.long()])
        with autocast(tr.cfg, d):
            loss, _ = training_loss(tr.model, inputs, LossDraws(
                *(x.to(d) for x in draws)))
        loss.backward()
        grad = torch.cat([p.grad.float().flatten()
                          for p in tr.model.parameters()])
        return float(loss.detach()), grad.cpu()

    reset_counts()
    got = loss_and_grad(card)
    torch.cuda.synchronize()
    ran = counts()
    want = loss_and_grad(trainer("cpu", "no", **sd))
    if fp32:
        with split_linears():
            floor = loss_and_grad(trainer("cpu", "no", **sd))
    else:
        floor = loss_and_grad(trainer("cpu", "bf16", **sd))

    def errs(x):
        return (abs(x[0] - want[0]) / abs(want[0]),
                float((x[1] - want[1]).norm() / want[1].norm()))

    (l_err, g_err), (l_floor, g_floor) = errs(got), errs(floor)
    if fp32:
        l_bar = max(FP32_REF_BAR, 2 * l_floor)
        g_bar = max(FP32_REF_BAR, 2 * g_floor)
        floor_name = "CPU fp32 with its linears split"
    else:
        l_bar, g_bar = BF16_U, TRAIN_REF_FLOOR_FACTOR * g_floor
        floor_name = "CPU bf16"
    log(f"small-input training reference ({'/'.join(route)} route, head_dim "
        f"{mcfg.head_dim}): card ({'fp32' if fp32 else 'bf16'}, kernels) "
        f"vs CPU (fp32, plain): loss rel err {l_err:.3e} ({floor_name} "
        f"{l_floor:.3e}; bar {l_bar:.3e}), gradient rel err {g_err:.3e} "
        f"({floor_name} {g_floor:.3e}; bar {g_bar:.3e}); loss "
        f"{got[0]:.6f} vs {want[0]:.6f}; launches {ran}")
    if not all(ran[k] for k in route) or any(
            n for k, n in ran.items()
            if k not in route + ("bias_map_builds",)):
        fail(f"the small-input training run left the {route} route: {ran}")
    if ran["bias_map_builds"] != builds:
        fail(f"the small-input training run built the bias's tile map "
             f"{ran['bias_map_builds']} times, not {builds}")
    if not (float(got[1].abs().max()) > 0 and torch.isfinite(got[1]).all()):
        fail("the small-input training gradient is zero or not finite")
    if not (l_err <= l_bar and g_err <= g_bar):
        fail(f"the card's training step disagrees with the CPU's: loss "
             f"{l_err} (bar {l_bar}), gradient {g_err} (bar {g_bar})")
    log(json.dumps({"train_reference": dict(
        route=route, head_dim=mcfg.head_dim, mixed_precision=mixed,
        loss_rel_err=l_err, loss_floor=l_floor, loss_bar=l_bar,
        grad_rel_err=g_err, grad_floor=g_floor, grad_bar=g_bar)}))
    return ran


def cfg_drift_phase(dev, smi: str) -> dict:
    """The port's ``scripts/cfg_drift.py`` at its defaults (8 layers of the
    flagship's width, random bf16 weights, the head re-rolled, 10 steps,
    guidance 1.5) over its whole sweep and, last, the reference schedule
    against itself: the measured uncond / cond ratio, then a line per
    schedule. Checks: the reference against itself drifts by exactly 0,
    every drift is finite, every plan is ``step_kinds``', and the launches
    are exactly K3 per prefill, K1 per cond and K2 per uncond evaluation
    (the ratio's timed calls included). Returns the launch counts."""
    from video_gpt_tpu_torch.sampling.scheduler import step_kinds
    from video_gpt_tpu_torch.scripts import cfg_drift
    reset_counts()
    t0 = time.perf_counter()
    res = cfg_drift.run(dev, num_layers=cfg_drift.NUM_LAYERS,
                        schedules=cfg_drift.SCHEDULES + ";ival=none",
                        log=lambda line: log(f"cfg_drift: {line}"))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ran = counts()
    records = res["records"]
    if records[-1]["rel_final_latent_mse"] != 0.0:
        fail(f"cfg_drift: the reference schedule drifts from itself by "
             f"{records[-1]['rel_final_latent_mse']}")
    for r in records:
        kinds = step_kinds(cfg_drift.parse_schedule(r["schedule"]))
        if r["kinds"] != "".join(cfg_drift.KIND_CHARS[k] for k in kinds):
            fail(f"cfg_drift: {r['schedule']} ran {r['kinds']}, not "
                 f"{kinds}")
        if not np.isfinite(r["rel_final_latent_mse"]):
            fail(f"cfg_drift: {r['schedule']} drift is not finite")
    nl, calls = cfg_drift.NUM_LAYERS, 1 + cfg_drift.RATIO_CALLS
    prefills = 2 + len(records)  # the ratio's, the reference's, each's
    cond = calls + cfg_drift.STEPS + sum(r["num_steps"] for r in records)
    uncond = calls + cfg_drift.STEPS + sum(r["uncond_evals"]
                                           for r in records)
    want = expect(K3=nl * prefills, K1=nl * cond, K2=nl * uncond,
                  bias_map_builds=prefills)
    log(f"cfg_drift: {len(records)} schedules at {nl} layers in "
        f"{wall_s:.2f} s, uncond/cond {res['ratio']['uncond_over_cond']:.4f} "
        f"on {smi}; launches {ran} (expected {want})")
    if ran != want:
        fail(f"cfg_drift launch counts {ran} != {want}")
    return ran


def offload_reference_phase(dev) -> dict:
    """One offload step of a tiny training model (head_dim 96, GQA 2:1) on
    the card (bf16 parameters, the kernels, the update on the host) against
    the same step on the CPU in fp32 (plain versions) and the CPU's own
    bf16 step, from the same bf16-valued weights, batch and random numbers:
    the loss within 2^-8 of the fp32 step's, the gradient that reached the
    host update within TRAIN_REF_FLOOR_FACTOR times the CPU bf16 error; on
    the card every parameter is bf16(master) after the step and the master
    is fp32. Returns the card step's launch counts."""
    from video_gpt_tpu_torch.training import offload
    mcfg = ModelConfig.tiny(hidden_size=192, num_heads=2, num_kv_heads=1,
                            pos_embed_max_size=64)
    res, n_frames = (64, 96), 4
    rng = np.random.default_rng(13)
    frames = [rng.integers(0, 256, res + (3,), dtype=np.uint8)
              for _ in range(n_frames)]
    tb_host = collate([ClipSample(preprocess_to_resolution(frames, *res),
                                  (1,) * n_frames)], tokens_per_frame(*res))

    def trainer(device, mixed, **sd):
        cfg = stage_config(1, frame_num=n_frames, mixed_precision=mixed,
                           lr=TRAIN_LR, lr_scheduler="constant",
                           adam_epsilon=1e-5, offload_optimizer=True)
        return Trainer(mcfg, cfg, None, vae_cfg=VAEConfig.tiny(),
                       target_resolution=res, device=device, seed=3, **sd)

    card = trainer(dev, "bf16")
    card_state = card.build()
    randomise_heads_(card.model, seed=4)
    sync_master_(card_state)
    sd = dict(init_state_dict={k: v.float().cpu() for k, v in
                               card.model.state_dict().items()},
              vae_state_dict={k: v.cpu() for k, v in
                              card.vae.state_dict().items()})
    gen = torch.Generator().manual_seed(5)
    hl, wl = res[0] // 8, res[1] // 8
    post = torch.randn((n_frames, hl, wl, 4), generator=gen)
    nn_, nc = tb_host.noisy_sel.shape[0], tb_host.clean_sel.shape[0]
    draws = LossDraws(torch.randn((nn_, hl, wl, 4), generator=gen),
                      torch.rand((1, n_frames), generator=gen),
                      torch.randn((nc, hl, wl, 4), generator=gen),
                      torch.rand((nc,), generator=gen))

    def one_step(tr, state):
        d = tr.device
        tb = tb_host.to(d)
        with torch.no_grad(), autocast(tr.cfg, d):
            lat = tr.vae.encode(tb.pixels, noise=post.to(d))
        inputs = tb.inputs._replace(x1=lat[tb.noisy_sel.long()],
                                    clean_latents=lat[tb.clean_sel.long()])
        grads = []
        update = offload.host_update_

        def recording(buf, *args):
            # the gradient, as received (the update overwrites the buffer)
            grads.append(buf.float().flatten().clone())
            update(buf, *args)

        offload.host_update_ = recording
        try:
            m = tr._step_fn(state, inputs, LossDraws(*(x.to(d)
                                                      for x in draws)))
        finally:
            offload.host_update_ = update
        return float(m["loss"]), torch.cat(grads)

    reset_counts()
    got = one_step(card, card_state)
    torch.cuda.synchronize()
    ran = counts()
    want, floor = [one_step(tr, tr.build()) for tr in (
        trainer("cpu", mixed, **sd) for mixed in ("no", "bf16"))]

    def errs(x):
        return (abs(x[0] - want[0]) / abs(want[0]),
                float((x[1] - want[1]).norm() / want[1].norm()))

    (l_err, g_err), (l_floor, g_floor) = errs(got), errs(floor)
    log(f"small-input offload reference: card (bf16 parameters, kernels, "
        f"host update) vs CPU (fp32, plain): loss rel err {l_err:.3e} (CPU "
        f"bf16 {l_floor:.3e}), gradient rel err {g_err:.3e} (CPU bf16 "
        f"{g_floor:.3e}); bar {TRAIN_REF_FLOOR_FACTOR}x the CPU bf16 error, "
        f"loss {BF16_U:.2e}; launches {ran}")
    nl = mcfg.num_layers
    if ran != expect(K3=2 * nl, K9=nl, bias_map_builds=1):
        fail(f"the small-input offload step's launches {ran}")
    if not (float(got[1].abs().max()) > 0 and torch.isfinite(got[1]).all()):
        fail("the small-input offload gradient is zero or not finite")
    if not (l_err <= BF16_U and g_err <= TRAIN_REF_FLOOR_FACTOR * g_floor):
        fail(f"the card's offload step disagrees with the CPU's: loss "
             f"{l_err}, gradient {g_err}")
    bad = master_mismatch(card_state)
    if bad:
        fail(f"after the small-input offload step: {bad}")
    return ran


def sync_master_(state) -> None:
    """The offload master of the parameters :func:`randomise_heads_`
    redrew, from their (bf16) values, as the build makes it."""
    params = dict(state.model.named_parameters())
    for n in HEAD_PARAMS:
        state.optimizer.master[n].copy_(params[n].detach())


def master_mismatch(state, names=None) -> list:
    """The offload parameters (``names``, default all) that are not bf16,
    or not exactly bf16 of their master, or whose master is not fp32."""
    bad = []
    for n, p in state.model.named_parameters():
        if names is not None and n not in names:
            continue
        m = state.optimizer.master[n]
        if p.dtype != torch.bfloat16 or m.dtype != torch.float32 or not \
                torch.equal(p.detach().cpu(), m.to(torch.bfloat16)):
            bad.append(n)
    return bad


class PhaseHostOps(HostFloatOps):
    """:class:`HostFloatOps` with the offload step's host update apart: the
    ops recorded inside ``offload.host_update_`` (wrapped while the mode
    is on) go to ``update``, every other to ``other``."""

    def __init__(self):
        super().__init__()
        self.other, self.update = set(), set()
        self.ops = self.other

    def __enter__(self):
        from video_gpt_tpu_torch.training import offload
        update = self._host_update = offload.host_update_

        def recording(*args):
            self.ops = self.update
            try:
                update(*args)
            finally:
                self.ops = self.other

        offload.host_update_ = recording
        return super().__enter__()

    def __exit__(self, *exc):
        from video_gpt_tpu_torch.training import offload
        offload.host_update_ = self._host_update
        return super().__exit__(*exc)


def host_update_ops() -> set:
    """The host ops of the shared AdamW arithmetic as the offload update
    runs it (``offload.host_update_`` on small host tensors)."""
    from video_gpt_tpu_torch.training.offload import host_update_
    rec = HostFloatOps()
    buf = torch.ones(4, 3, dtype=torch.bfloat16)
    master, mu, nu = (torch.full((4, 3), 0.5) for _ in range(3))
    with rec:
        host_update_(buf, master, mu, nu, 0.5, 1e-4, 0.1, 0.05,
                     TrainConfig())
    return rec.ops


def path_config(**kw) -> ModelConfig:
    """ModelConfig() at full width, at PATH_LAYERS layers once the paths
    after the mesh were cut (:func:`late_cut`)."""
    if PATH_LAYERS is not None:
        kw.setdefault("num_layers", PATH_LAYERS)
    return ModelConfig(**kw)


def late_cut() -> None:
    """Cut the paths after the mesh to LATE_LAYERS layers when the script
    is past LATE_AT_S seconds (printed and listed in CUTS)."""
    global PATH_LAYERS
    at = time.perf_counter() - T_START
    if at > LATE_AT_S:
        PATH_LAYERS = LATE_LAYERS
        cut = (f"the paths after the mesh at {LATE_LAYERS} of "
               f"{ModelConfig().num_layers} layers (the offload path at "
               f"most that): the mesh ended {at:.1f} s into the script, "
               f"past {LATE_AT_S:.0f} s")
        CUTS.append(cut)
        log(f"CUT: {cut}")


def offload_layers(full: int) -> tuple:
    """(layers, the host's MemAvailable GiB, the state's GiB at that
    depth): the depth whose offload state (OFFLOAD_HOST_BYTES a parameter)
    the host holds with OFFLOAD_HOST_MARGIN to spare, at most ``full``."""
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))

    def need(layers):
        model = VideoGPT(ModelConfig(num_layers=layers), device="meta",
                         train_init=True)
        return OFFLOAD_HOST_BYTES * sum(p.numel() for p in
                                        model.parameters())

    layers = full
    while layers > 1 and OFFLOAD_HOST_MARGIN * need(layers) > avail:
        layers -= 1
    return layers, avail / 2 ** 30, need(layers) / 2 ** 30


def release_pinned() -> None:
    """Return the caching host allocator's free pinned blocks to the OS."""
    for name in ("_accelerator_emptyHostCache", "_host_emptyCache"):
        fn = getattr(torch._C, name, None)
        if fn is not None:
            fn()
            return


def offload_phase(dev, smi: str) -> dict:
    """Stage 1 with the offload optimizer at full width and OFFLOAD_LAYERS
    (a further cut, if the host's memory forces one, printed and listed
    in CUTS)
    through the Trainer's own step: a warm-up (the host-op check on, the
    host update apart), OFFLOAD_STEPS timed steps at grad_splits 1, each
    with exactly stage 1's launches, then one step at grad_splits 2. Each
    step's time split (forward + backward, D2H, host update, H2D, with
    rates), its peak device memory, the host state's size; checks: finite
    loss and gradient norm, a gradient into layer 0's attention, the
    watched masters moved within training_phase's bound, the watched
    parameters bf16 and exactly bf16(master) after every step, the master
    fp32. Returns the launch counts of the grad_splits-1 steps."""
    full = ModelConfig().num_layers
    depth = min(OFFLOAD_LAYERS, PATH_LAYERS or OFFLOAD_LAYERS)
    layers, avail_gib, need_gib = offload_layers(depth)
    log(f"offload: host MemAvailable {avail_gib:.2f} GiB; the state needs "
        f"{need_gib:.2f} GiB at {layers} layers ({OFFLOAD_HOST_BYTES} B a "
        f"parameter, margin {OFFLOAD_HOST_MARGIN}x)")
    if layers < depth:
        cut = (f"offload stage-1 path at {layers} of {depth} layers: the "
               f"host holds {avail_gib:.2f} GiB, the state at {depth} "
               f"needs more with its margin")
        CUTS.append(cut)
        log(f"CUT: {cut}")
    cfg = stage_config(1, lr=TRAIN_LR, lr_scheduler="constant",
                       adam_epsilon=1e-5, offload_optimizer=True)
    rss_gib_before = host_rss_gib()
    t0 = time.perf_counter()
    trainer = Trainer(ModelConfig(num_layers=layers), cfg, None,
                      vae_cfg=VAEConfig(), target_resolution=(H_PX, W_PX),
                      device=dev, seed=0)
    state = trainer.build()
    model, ost, step = trainer.model, state.optimizer, trainer._step_fn
    randomise_heads_(model, seed=1)
    sync_master_(state)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    buf_bytes = sum(b.numel() * b.element_size() for b in step.buffers)
    host_gib = (ost.host_bytes + buf_bytes) / 2 ** 30
    log(f"build offload trainer: {time.perf_counter() - t0:.1f} s, "
        f"{n_params / 1e9:.3f}B bf16 params on the card, host state "
        f"{ost.host_bytes / 2 ** 30:.2f} GiB (fp32 master, mu, nu) + "
        f"{buf_bytes / 2 ** 30:.2f} GiB pinned transfer buffer, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated on "
        f"the card")
    nl = layers
    watched = ["x_embedder.proj.weight",
               "llm.layers.0.self_attn.qkv_proj.weight",
               f"llm.layers.{nl - 1}.mlp.down_proj.weight", "llm.norm.weight",
               "final_layer.linear.weight"]
    bad = master_mismatch(state)
    if bad:
        fail(f"the offload build's parameters are not bf16(master): {bad}")
    tb = train_batch(1).to(dev)
    b, L = tb.inputs.batch.input_ids.shape
    qkv = model.llm.layers[0].self_attn.qkv_proj.weight
    qkv_grads = []
    hook = qkv.register_post_accumulate_grad_hook(
        lambda p: qkv_grads.append(torch.linalg.vector_norm(p.grad.float())))

    def check(label, m):
        g = float(qkv_grads[-1]) if qkv_grads else 0.0
        if not (np.isfinite(g) and g > 0):
            fail(f"offload {label}: no gradient reached layer 0's attention")
        if not all(np.isfinite([float(m["loss"]), float(m["grad_norm"])])):
            fail(f"offload {label}: loss or gradient norm not finite")
        bad = master_mismatch(state, watched)
        if bad:
            fail(f"offload {label}: not bf16(master): {bad}")

    ops = PhaseHostOps()
    t0 = time.perf_counter()
    with ops:
        m = trainer.train_step(state, tb, 0)
    torch.cuda.synchronize()
    want_ops = host_update_ops()
    log(f"warm-up offload step: {time.perf_counter() - t0:.2f} s, loss "
        f"{float(m['loss']):.6f} (host-op check on; host update ops "
        f"{sorted(ops.update)})")
    if ops.other:
        fail(f"float ops ran on the host outside the offload update: "
             f"{sorted(ops.other)}")
    if ops.update != want_ops:
        fail(f"the offload update ran {sorted(ops.update)} on the host, not "
             f"the shared AdamW arithmetic's {sorted(want_ops)}")
    check("warm-up", m)
    before = {n: ost.master[n].clone() for n in watched}

    grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    steps, total = [], dict.fromkeys(counts(), 0)
    want = expect(K3=2 * nl, K9=nl, bias_map_builds=1)
    peaks = {}
    for i, splits in enumerate([1] * OFFLOAD_STEPS + [2], start=2):
        step.grad_splits = splits
        if splits not in peaks:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(state, tb, i - 1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peaks[splits] = torch.cuda.max_memory_allocated() / 2 ** 30
        c = counts()
        sp = dict(step.split)
        rec = dict(grad_splits=splits, step_s=dt, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]), split_s=sp,
                   d2h_gb_per_s=grad_bytes / sp["d2h"] / 1e9,
                   h2d_gb_per_s=grad_bytes / sp["h2d"] / 1e9,
                   update_gb_per_s=OFFLOAD_UPDATE_BYTES * n_params
                   / sp["update"] / 1e9, launches=c)
        steps.append(rec)
        log(f"offload step {i} (grad_splits {splits}): {dt:.3f} s, "
            f"{b * L / dt:.1f} tokens/s, loss {rec['loss']:.6f}, grad norm "
            f"{rec['grad_norm']:.4e}; forward+backward "
            f"{sp['forward_backward']:.3f} s, D2H {sp['d2h']:.3f} s "
            f"({rec['d2h_gb_per_s']:.2f} GB/s), host update "
            f"{sp['update']:.3f} s ({rec['update_gb_per_s']:.2f} GB/s at "
            f"{OFFLOAD_UPDATE_BYTES} B a parameter), H2D {sp['h2d']:.3f} s "
            f"({rec['h2d_gb_per_s']:.2f} GB/s); launches {c}")
        if splits == 1:
            if c != want:
                fail(f"offload step launches {c} != {want}")
            for k in total:
                total[k] += c[k]
        else:
            # two passes over the groups: each its forward (and map), the
            # recompute and backward of the layers its parameters reach
            lo = {k: want[k] for k in ("K3", "K9")}
            if c["bias_map_builds"] != 2 or any(
                    not lo[k] <= c[k] <= 2 * lo[k] for k in lo) or any(
                    c[k] for k in c if k not in lo
                    and k != "bias_map_builds"):
                fail(f"offload grad_splits-2 step launches {c}")
        check(f"step {i}", m)
    hook.remove()
    moved = {}
    n_moves = len(steps)
    for n in watched:
        d = float((ost.master[n] - before[n]).abs().max())
        moved[n] = d
        if not 0 < d <= 2 * n_moves * TRAIN_LR * (1 + float(
                before[n].abs().max())):
            fail(f"the offload update moved the master of {n} by {d}")
    log(f"offload masters moved (max abs change over {n_moves} steps): "
        f"{moved}")
    timed = [r for r in steps if r["grad_splits"] == 1]
    step_s = float(np.mean([r["step_s"] for r in timed]))
    split = {k: float(np.mean([r["split_s"][k] for r in timed]))
             for k in timed[0]["split_s"]}
    out = dict(stage=1, layers=nl, full_layers=full, params=n_params,
               step_s=step_s, tokens_per_s=b * L / step_s,
               tokens_per_step=b * L, split_s=split,
               peak_mem_gib_grad_splits_1=peaks[1],
               peak_mem_gib_grad_splits_2=peaks[2],
               host_state_gib=ost.host_bytes / 2 ** 30,
               pinned_buffer_gib=buf_bytes / 2 ** 30,
               host_mem_available_gib=avail_gib, steps=steps,
               qkv0_grad_norms=[float(x) for x in qkv_grads], device=smi)
    log(f"offload stage-1 path: {nl} layers, L {L}, B {b}: {step_s:.3f} "
        f"s/step, {b * L / step_s:.1f} tokens/s, peak {peaks[1]:.2f} GiB "
        f"(grad_splits 2: {peaks[2]:.2f} GiB), host {host_gib:.2f} GiB, "
        f"on {smi}")
    log(json.dumps({"offload_path": out}))
    mfu_line("offload stage-1 train step", train_step_flops(model, b * L),
             step_s, smi)
    del trainer, state, model, ost, step, ops, m
    gc.collect()
    release_pinned()
    log(f"offload: host RSS {rss_gib_before:.2f} GiB before the build, "
        f"{host_rss_gib():.2f} GiB after freeing the state")
    return total


def host_rss_gib() -> float:
    """This process's resident host memory (VmRSS), GiB."""
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) for line in f
                    if line.startswith("VmRSS:")) / 2 ** 20


def training_phase(dev, smi: str, stage: int, mixed: str = "bf16") -> dict:
    """The training path of ``stage`` at full width through the Trainer's
    own step; returns its kernels' launch counts over the timed steps.
    With ``mixed`` "no" (``train --mixed_precision no``) the step runs in
    fp32 end to end: FP32_TRAIN_STEPS timed steps, each with the fp32
    kernels' launches (the bf16 path's counts under ``K*-fp32``) and no
    bf16 launch, and no profiled step."""
    n_frames, n_steps, per_layer, builds = TRAIN_PATHS[stage]
    fp32 = mixed == "no"
    if fp32:
        n_steps = FP32_TRAIN_STEPS
        per_layer = {f"{k}-fp32": n for k, n in per_layer.items()}
    cfg = stage_config(stage, lr=TRAIN_LR, lr_scheduler="constant",
                       adam_epsilon=1e-5, mixed_precision=mixed)
    t0 = time.perf_counter()
    trainer = Trainer(path_config(), cfg, None, vae_cfg=VAEConfig(),
                      target_resolution=(H_PX, W_PX), device=dev, seed=0)
    state = trainer.build()
    randomise_heads_(trainer.model, seed=1)
    model = trainer.model
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"build trainer: {time.perf_counter() - t0:.1f} s, "
        f"{n_params / 1e9:.3f}B fp32 params + AdamW state, remat "
        f"{trainer.model_cfg.remat}, mixed_precision {mixed}")
    tb = train_batch(stage).to(dev)
    b, L = tb.inputs.batch.input_ids.shape
    real = int((tb.inputs.batch.meta.is_pad == 0).sum())
    # collate pads to 2 F (n_img + 2): 7104 tokens at stage 1, 35520 at
    # stage 4 (176x320)
    want_l = 2 * n_frames * (tokens_per_frame(H_PX, W_PX) + 2)
    if (b, L) != (1, want_l):
        fail(f"stage-{stage} batch is {b}x{L}, not 1x{want_l}")

    # layer 0's attention gradient, read before the optimizer consumes it
    qkv = model.llm.layers[0].self_attn.qkv_proj.weight
    qkv_grads = []
    hook = qkv.register_post_accumulate_grad_hook(
        lambda p: qkv_grads.append(torch.linalg.vector_norm(p.grad)))

    nl = trainer.model_cfg.num_layers
    watched = {n: p for n, p in model.named_parameters() if n in (
        "x_embedder.proj.weight", "llm.layers.0.self_attn.qkv_proj.weight",
        f"llm.layers.{nl - 1}.mlp.down_proj.weight", "llm.norm.weight",
        "final_layer.linear.weight")}
    before = {}

    def check(step, m):
        g = float(qkv_grads[-1])
        if not (np.isfinite(g) and g > 0):
            fail(f"train step {step}: no gradient reached layer 0's "
                 f"attention")
        if step == 1:  # after the warm-up
            before.update({n: p.detach().clone()
                           for n, p in watched.items()})

    want = {k: per_layer.get(k, 0) * nl for k in counts()}
    want["bias_map_builds"] = builds
    label = f"stage-{stage} train" + (" (fp32)" if fp32 else "")
    steps, total, peak_gib, step_s = run_steps(
        trainer, state, tb, label, n_steps, want, check)
    hook.remove()

    # AdamW moved every watched parameter, by at most ~lr per step and
    # element (Adam's normalised update, plus the weight decay)
    moved = {}
    for n, p in watched.items():
        d = float((p.detach() - before[n]).abs().max())
        moved[n] = d
        if not 0 < d <= 2 * n_steps * TRAIN_LR * (1 + float(
                before[n].abs().max())):
            fail(f"AdamW moved {n} by {d}")
    log(f"AdamW moved (max abs change over {n_steps} steps): {moved}")
    # the trunk's matmul work per step: forward, recompute, and the
    # backward's two products per weight, 2 FLOPs per weight and token each
    trunk = sum(m.weight.numel() for m in model.llm.layers.modules()
                if isinstance(m, torch.nn.Linear))
    matmul_tflop = 8 * trunk * b * L / 1e12
    train = dict(stage=stage, frames=n_frames, layers=nl,
                 mixed_precision=mixed, step_s=step_s,
                 tokens_per_s=b * L / step_s,
                 real_tokens_per_s=real / step_s, tokens_per_step=b * L,
                 real_tokens_per_step=real, peak_mem_gib=peak_gib,
                 fp32_state_gib=16 * n_params / 2 ** 30,
                 trunk_matmul_tflop=matmul_tflop, steps=steps,
                 qkv0_grad_norms=[float(x) for x in qkv_grads],
                 params=n_params, device=smi)
    log(f"stage-{stage} training path ({mixed}): {nl} layers, L {L}, B "
        f"{b}: {step_s:.3f} s/step, {b * L / step_s:.1f} tokens/s "
        f"({real} of {L} tokens real), peak {peak_gib:.2f} GiB, on {smi}")
    log(json.dumps({"training_path": train}))
    if fp32:  # no bf16 peak to read an fp32 step against, and no profile
        return total
    mfu_line(f"stage-{stage} train step", train_step_flops(
        model, b * L), step_s, smi)
    profile_train_step(trainer, state, tb, step_s, matmul_tflop, stage,
                       n_steps + 1)
    return total


def profile_train_step(trainer, state, tb, step_s: float,
                       matmul_tflop: float, stage: int, step_idx: int
                       ) -> None:
    """One more train step under torch.profiler (host and device): device
    time by kernel group, the kernels of the optimizer's range
    ("AdamW.step": clip and update) as a group of their own, and the
    device's idle share in this run."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, tb, step_idx)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    groups, busy, top = device_groups(prof, ranges=("AdamW.step",))
    if "AdamW.step" in groups:
        groups["optimizer (AdamW.step: clip + update)"] = groups.pop(
            "AdamW.step")
    else:
        log("optimizer device time: not measured (the profiler showed no "
            "device span of the AdamW.step range)")
    matmul_ms = groups.get("matmul (cuBLAS)", 0.0)
    log(json.dumps({"train_profile": {
        "stage": stage, "device_ms_by_group": groups, "device_busy_ms": busy,
        "wall_ms": wall_ms, "idle_share": 1.0 - busy / wall_ms,
        "unprofiled_step_ms": step_s * 1e3,
        "matmul_tflops": matmul_tflop / (matmul_ms / 1e3) if matmul_ms
        else None, "top_kernels": top}}))


def mark(after: str) -> None:
    """Log the seconds since the script started (the phases' share of its
    time limit)."""
    log(f"after {after}: {time.perf_counter() - T_START:.1f} s since the "
        f"start")


def freed(after: str) -> None:
    """Collect the garbage of a finished phase and fail if 1 GiB or more
    is still allocated on the card; log the seconds since the script
    started (the phases' share of its time limit)."""
    gc.collect()
    torch.cuda.empty_cache()
    left_gib = torch.cuda.memory_allocated() / 2 ** 30
    log(f"after {after}: {left_gib:.2f} GiB allocated")
    mark(after)
    if left_gib > 1.0:
        fail(f"{left_gib:.2f} GiB still allocated after {after}")


def host_copy(tensors: dict) -> dict:
    return {n: t.detach().cpu().clone() for n, t in tensors.items()}


def unchanged(now: dict, before: dict) -> bool:
    """Whether every tensor of ``now`` is bit-equal to its host copy."""
    return all(torch.equal(t.detach().cpu(), before[n])
               for n, t in now.items())


def run_steps(trainer, state, tb, label: str, n_steps: int, want: dict,
              check=None) -> tuple:
    """A warm-up step (host-op check on), then ``n_steps`` timed steps of
    ``trainer`` on ``tb``, each with exactly the launches ``want`` and a
    finite loss and gradient norm; ``check(step, metrics)`` runs after
    every step (the warm-up is step 1). Returns (step records, summed
    launches, peak GiB over the timed steps, mean s/step)."""
    host = HostFloatOps()
    t0 = time.perf_counter()
    with host:
        m = trainer.train_step(state, tb, 0)
    torch.cuda.synchronize()
    log(f"warm-up {label} step: {time.perf_counter() - t0:.2f} s, loss "
        f"{float(m['loss']):.6f} (host-op check on)")
    if host.ops:
        fail(f"float ops ran on the host in the {label} step: "
             f"{sorted(host.ops)}")
    if check is not None:
        check(1, m)
    b, L = tb.inputs.batch.input_ids.shape
    torch.cuda.reset_peak_memory_stats()
    steps, total = [], dict.fromkeys(want, 0)
    for i in range(2, n_steps + 2):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(state, tb, i - 1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = counts()
        steps.append(dict(step_s=dt, loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"])))
        log(f"{label} step {i}: {dt:.3f} s, {b * L / dt:.1f} tokens/s, loss "
            f"{steps[-1]['loss']:.6f}, grad norm "
            f"{steps[-1]['grad_norm']:.4e}, launches {c}")
        if c != want:
            fail(f"{label} step launches {c} != {want}")
        if not all(np.isfinite([steps[-1]["loss"], steps[-1]["grad_norm"]])):
            fail(f"{label} step {i}: loss or gradient norm not finite")
        if check is not None:
            check(i, m)
        for k in total:
            total[k] += c[k]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    return steps, total, peak_gib, float(np.mean([r["step_s"]
                                                  for r in steps]))


def lora_phase(dev, smi: str):
    """The LoRA path at full width through the Trainer's own step: rank-8
    adapters on every layer's qkv_proj and o_proj over a frozen stage-1
    model (random base, heads randomised; fp32 base, bf16 compute), L 7104.
    One warm-up step and LORA_STEPS timed steps, each with exactly 64 K3,
    32 K9 and one bias-map build. The base stays bit-equal; every watched
    lora_B moves in step 1, when lora_A's gradient is exactly 0 (B = 0);
    from step 2 lora_A's gradient is not 0; layer 0's adapter gradient is
    finite and not 0 in every step. Returns (summed launches, the trained
    adapters on the host with B redrawn at random, for the merge)."""
    cfg = stage_config(1, lr=TRAIN_LR, lr_scheduler="constant",
                       adam_epsilon=1e-5, use_lora=True, lora_rank=LORA_RANK)
    t0 = time.perf_counter()
    trainer = Trainer(path_config(), cfg, None, vae_cfg=VAEConfig(),
                      target_resolution=(H_PX, W_PX), device=dev, seed=0)
    state = trainer.build()
    model = trainer.model
    randomise_heads_(model, seed=1)
    mcfg = trainer.model_cfg
    nl, d = mcfg.num_layers, mcfg.hidden_size
    adapters = lora_state_dict(model)
    n_adapter = sum(t.numel() for t in adapters.values())
    qkv = (mcfg.num_heads + 2 * mcfg.num_kv_heads) * mcfg.head_dim
    want_n = nl * LORA_RANK * (d + qkv + mcfg.num_heads * mcfg.head_dim + d)
    if n_adapter != want_n or len(state.optimizer.params) != len(adapters):
        fail(f"{n_adapter} adapter parameters in "
             f"{len(state.optimizer.params)} tensors, not {want_n}")
    base = host_copy({n: p for n, p in model.named_parameters()
                      if not p.requires_grad})
    torch.cuda.synchronize()
    log(f"build LoRA trainer: {time.perf_counter() - t0:.1f} s, "
        f"{sum(t.numel() for t in base.values()) / 1e9:.3f}B frozen fp32 "
        f"params, {n_adapter} adapter params (rank {LORA_RANK})")

    watched = [f"llm.layers.{i}.self_attn.{m}.lora_{ab}.weight"
               for i in (0, nl // 2, nl - 1) for m in ("qkv_proj", "o_proj")
               for ab in "AB"]
    params = dict(model.named_parameters())
    norms = {n: [] for n in watched}
    hooks = [params[n].register_post_accumulate_grad_hook(
        lambda p, n=n: norms[n].append(torch.linalg.vector_norm(p.grad)))
        for n in watched]
    a_before = {}

    def check(step, m):
        g = {n: float(v[-1]) for n, v in norms.items()}
        if not all(np.isfinite(list(g.values()))):
            fail(f"LoRA step {step}: an adapter gradient is not finite")
        a0 = "llm.layers.0.self_attn.qkv_proj.lora_"
        if not (g[a0 + "B.weight"] > 0 and (step == 1 or g[a0 + "A.weight"]
                                             > 0)):
            fail(f"LoRA step {step}: no gradient reached layer 0's "
                 f"adapters: {g}")
        if step == 1:
            if any(g[n] != 0 for n in watched if ".lora_A." in n):
                fail(f"lora_A had a gradient while B = 0: {g}")
            if any(float(params[n].detach().abs().max()) == 0
                   for n in watched if ".lora_B." in n):
                fail("a watched lora_B did not move in step 1")
            a_before.update(host_copy({n: params[n] for n in watched
                                       if ".lora_A." in n}))
        elif any(g[n] == 0 for n in watched):
            fail(f"LoRA step {step}: a watched adapter had no gradient: {g}")

    tb = train_batch(1).to(dev)
    b, L = tb.inputs.batch.input_ids.shape
    steps, total, peak_gib, step_s = run_steps(
        trainer, state, tb, "LoRA", LORA_STEPS,
        expect(K3=2 * nl, K9=nl, bias_map_builds=1), check)
    for hook in hooks:
        hook.remove()
    if not unchanged({n: p for n, p in model.named_parameters()
                      if not p.requires_grad}, base):
        fail("the LoRA steps changed the frozen base")
    if unchanged({n: params[n] for n in a_before}, a_before):
        fail("lora_A did not move after step 1")
    rec = dict(rank=LORA_RANK, layers=nl, step_s=step_s,
               tokens_per_s=b * L / step_s, tokens_per_step=b * L,
               peak_mem_gib=peak_gib, adapter_params=n_adapter,
               frozen_params=sum(t.numel() for t in base.values()),
               steps=steps, layer0_grad_norms={
                   n: [float(x) for x in v] for n, v in norms.items()
                   if n.startswith("llm.layers.0.")}, device=smi)
    log(f"LoRA path: {nl} layers, L {L}: {step_s:.3f} s/step, "
        f"{b * L / step_s:.1f} tokens/s, peak {peak_gib:.2f} GiB, "
        f"{n_adapter} adapter params, base unchanged, on {smi}")
    log(json.dumps({"lora_path": rec}))
    out = host_copy(adapters)
    gen = torch.Generator().manual_seed(7)
    for n, t in out.items():
        if ".lora_B." in n:  # a trained B is ~1e-4: redraw it for the merge
            t.copy_(0.05 * torch.randn(t.shape, generator=gen))
    return total, out


def distill_phase(dev, smi: str):
    """Guided distillation at full width through the Trainer's own step,
    the first round of configs/distill_serving.sh (5 student steps, 2
    substeps, guidance 1.5, distill_lr 1e-4): a random model with
    randomised heads as the teacher (a zero head makes every target 0) and
    the student its copy; fp32 student and AdamW, bf16 teacher and
    compute, L 7104 and the unconditional layout's 3552. One warm-up step
    and DISTILL_STEPS timed steps, each with exactly 192 K3, 32 K9 and two
    bias-map builds. The teacher stays bit-equal, the student moves.
    Returns (summed launches, the student's weights in bf16 on the
    host)."""
    cfg = stage_config(1, lr=TRAIN_LR, lr_scheduler="constant",
                       adam_epsilon=1e-5, **DISTILL)
    t0 = time.perf_counter()
    trainer = Trainer(path_config(), cfg, None, vae_cfg=VAEConfig(),
                      target_resolution=(H_PX, W_PX), device=dev, seed=0)
    state = trainer.build()
    model, teacher = trainer.model, trainer.teacher
    randomise_heads_(model, seed=1)
    teacher.load_state_dict(model.state_dict())
    teacher0 = host_copy(teacher.state_dict())
    torch.cuda.synchronize()
    nl = trainer.model_cfg.num_layers
    log(f"build distillation trainer: {time.perf_counter() - t0:.1f} s, "
        f"student fp32 + AdamW, teacher "
        f"{next(teacher.parameters()).dtype}")
    tb = train_batch(1, uncond=True).to(dev)
    b, L = tb.inputs.batch.input_ids.shape
    lu = tb.inputs.batch_uncond.input_ids.shape[1]
    if lu != TRAIN_PATHS[1][0] * (tokens_per_frame(H_PX, W_PX) + 2):
        fail(f"the unconditional layout has {lu} tokens")
    watched = {n: p for n, p in model.named_parameters() if n in (
        "x_embedder.proj.weight", "llm.layers.0.self_attn.qkv_proj.weight",
        f"llm.layers.{nl - 1}.mlp.down_proj.weight",
        "final_layer.linear.weight")}
    before = {}

    def check(step, m):
        if step == 1:
            before.update({n: p.detach().clone()
                           for n, p in watched.items()})

    steps, total, peak_gib, step_s = run_steps(
        trainer, state, tb, "distillation", DISTILL_STEPS,
        expect(K3=6 * nl, K9=nl, bias_map_builds=2), check)
    moved = {n: float((p.detach() - before[n]).abs().max())
             for n, p in watched.items()}
    if not all(v > 0 for v in moved.values()):
        fail(f"the student did not move: {moved}")
    if not unchanged(teacher.state_dict(), teacher0):
        fail("the distillation steps changed the teacher")
    rec = dict(layers=nl, **{k: v for k, v in DISTILL.items()
                             if k != "distill"},
               step_s=step_s, tokens_per_s=b * L / step_s,
               tokens_per_step=b * L, uncond_tokens=lu,
               peak_mem_gib=peak_gib, steps=steps, student_moved=moved,
               device=smi)
    log(f"distillation path: {nl} layers, L {L} (+ uncond {lu}): "
        f"{step_s:.3f} s/step, {b * L / step_s:.1f} student tokens/s, "
        f"peak {peak_gib:.2f} GiB, teacher unchanged, on {smi}")
    log(json.dumps({"distill_path": rec}))
    student = {n: t.to(torch.bfloat16).cpu()
               for n, t in model.state_dict().items()}
    return total, student


def distill_reference_phase(dev) -> None:
    """One guided distillation loss and backward of a tiny model (head_dim
    96, GQA) on the card (bf16 autocast, fp32 student, bf16 teacher, the
    kernels) against the same student, teacher, batch and random numbers
    on the CPU in fp32 (plain versions), on the bias route, read against
    the CPU's own bf16 error as the training reference is: the student
    gradient's relative error within TRAIN_REF_FLOOR_FACTOR times it, the
    loss within 2^-8."""
    mcfg = ModelConfig.tiny(hidden_size=192, num_heads=2, num_kv_heads=1,
                            pos_embed_max_size=64)
    res, n_frames = (64, 96), 4
    rng = np.random.default_rng(12)
    frames = [rng.integers(0, 256, res + (3,), dtype=np.uint8)
              for _ in range(n_frames)]
    sample = ClipSample(preprocess_to_resolution(frames, *res),
                        (1,) * n_frames)
    tb_host = collate([sample], tokens_per_frame(*res), uncond=True)
    # the student's warm start and the teacher: two random models with
    # random heads. A teacher equal to the student makes the target and
    # the prediction nearly equal, and their difference, the loss, mostly
    # bf16 rounding, far past any bar a bf16 run could meet
    init, teacher = (VideoGPT(mcfg).init_random_(
        torch.Generator().manual_seed(seed)).state_dict() for seed in (6, 9))

    def trainer(device, mixed, **sd):
        cfg = stage_config(1, frame_num=n_frames, mixed_precision=mixed,
                           **DISTILL)
        tr = Trainer(mcfg, cfg, None, vae_cfg=VAEConfig.tiny(),
                     target_resolution=res, device=device, seed=3,
                     init_state_dict=init, **sd)
        tr.build()
        tr.teacher.load_state_dict(teacher)
        return tr

    card = trainer(dev, "bf16")
    vae_sd = {k: v.cpu() for k, v in card.vae.state_dict().items()}
    gen = torch.Generator().manual_seed(8)
    hl, wl = res[0] // 8, res[1] // 8
    post = torch.randn((n_frames, hl, wl, 4), generator=gen)
    nn_, nc = tb_host.noisy_sel.shape[0], tb_host.clean_sel.shape[0]
    draws = DistillDraws(
        torch.randn((nn_, hl, wl, 4), generator=gen),
        torch.randint(0, DISTILL["distill_student_steps"], (1, n_frames),
                      generator=gen),
        torch.randn((nc, hl, wl, 4), generator=gen),
        torch.rand((nc,), generator=gen))

    def loss_and_grad(tr):
        d, cfg = tr.device, tr.cfg
        tb = tb_host.to(d)
        with torch.no_grad(), autocast(cfg, d):
            lat = tr.vae.encode(tb.pixels, noise=post.to(d))
        inputs = tb.inputs._replace(x1=lat[tb.noisy_sel.long()],
                                    clean_latents=lat[tb.clean_sel.long()])
        with autocast(cfg, d):
            loss, _ = distillation_loss(
                tr.model, tr.teacher, inputs,
                DistillDraws(*(x.to(d) for x in draws)),
                student_steps=cfg.distill_student_steps,
                substeps=cfg.distill_substeps,
                input_noise=cfg.distill_input_noise,
                cfg_scale=cfg.distill_guidance)
        loss.backward()
        grad = torch.cat([p.grad.float().flatten()
                          for p in tr.model.parameters()])
        return float(loss.detach()), grad.cpu()

    reset_counts()
    got = loss_and_grad(card)
    torch.cuda.synchronize()
    ran = counts()
    want, floor = (loss_and_grad(trainer("cpu", mixed, vae_state_dict=vae_sd))
                   for mixed in ("no", "bf16"))

    def errs(x):
        return (abs(x[0] - want[0]) / abs(want[0]),
                float((x[1] - want[1]).norm() / want[1].norm()))

    (l_err, g_err), (l_floor, g_floor) = errs(got), errs(floor)
    nl = mcfg.num_layers
    log(f"small-input distillation reference (guided, K3/K9 route): card "
        f"(bf16, kernels) vs CPU (fp32, plain): loss rel err {l_err:.3e} "
        f"(CPU bf16 {l_floor:.3e}), student gradient rel err {g_err:.3e} "
        f"(CPU bf16 {g_floor:.3e}); bar {TRAIN_REF_FLOOR_FACTOR}x the CPU "
        f"bf16 error, loss {BF16_U:.2e}; loss {got[0]:.6e} vs "
        f"{want[0]:.6e}; launches {ran}")
    if ran != expect(K3=6 * nl, K9=nl, bias_map_builds=2):
        fail(f"the small-input distillation step left its route: {ran}")
    if not (float(got[1].abs().max()) > 0 and torch.isfinite(got[1]).all()):
        fail("the small-input distillation gradient is zero or not finite")
    if not (l_err <= BF16_U and g_err <= TRAIN_REF_FLOOR_FACTOR * g_floor):
        fail(f"the card's distillation step disagrees with the CPU's: loss "
             f"{l_err}, gradient {g_err}")


def products_phase(dev, smi: str, student: dict, adapters: dict) -> dict:
    """Serve what the training paths made, at full width: the guided
    student (its bf16 weights) through ``generate`` at its serving line (5
    steps, ``img_guidance_scale`` 1: the cond row alone), one 16-frame clip
    after a warm-up, with exactly 5 nl K1, nl K3 and one bias-map build;
    then the LoRA adapters (B redrawn) merged into those weights on the
    card, each adapted weight's change held to (alpha / r) B A within the
    merged weight's bf16 rounding, and a clip of the merged model. Returns
    the student clip's launches."""
    t0 = time.perf_counter()
    pipe = VideoGPTPipeline.build(path_config(), VAEConfig(), device=dev,
                                  dtype=torch.bfloat16, state_dict=student,
                                  seed=0)
    torch.cuda.synchronize()
    log(f"build the student's pipeline: {time.perf_counter() - t0:.1f} s")
    frames = synthetic_frames(N_CLEAN)
    kw = dict(gen_nums=(N_GEN,), num_inference_steps=STUDENT_STEPS,
              img_guidance_scale=1.0, max_frame_window=N_CLEAN + N_GEN,
              seed=0, return_latents=True)
    nl = pipe.model.cfg.num_layers
    want = expect(K1=STUDENT_STEPS * nl, K3=nl, bias_map_builds=1)

    def clip(label):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lat = pipe.generate(frames, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = counts()
        log(f"{label}: {N_GEN}-frame clip at {STUDENT_STEPS} steps, "
            f"guidance 1: {dt:.3f} s, {N_GEN / dt:.3f} frames/s, launches "
            f"{c} (expected {want})")
        if c != want:
            fail(f"{label} launch counts {c} != {want}")
        lat = torch.stack(lat)
        if (len(out) != N_CLEAN + N_GEN or lat.device.type != dev.type
                or not torch.isfinite(lat).all()
                or not all(f.dtype == np.uint8 and f.shape == (H_PX, W_PX, 3)
                           for f in out[-N_GEN:])):
            fail(f"{label}: {len(out)} frames, latents on {lat.device} or "
                 f"not finite")
        return dt, c, lat

    host = HostFloatOps()
    with host:
        pipe.generate(frames, **kw)
    if host.ops:
        fail(f"float ops ran on the host serving the student: "
             f"{sorted(host.ops)}")
    torch.cuda.reset_peak_memory_stats()
    clip_s, launches, lat_s = clip("guided student")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    base = pipe.model.state_dict()
    alpha = pipe.model.cfg.lora_alpha
    on_card = {n: t.to(dev) for n, t in adapters.items()}
    merged = merge_lora(base, on_card, alpha=alpha)
    worst = 0.0
    for name in on_card:
        if not name.endswith(".lora_A.weight"):
            continue
        layer = name[:-len(".lora_A.weight")]
        a, b_ = on_card[name], on_card[layer + ".lora_B.weight"]
        # the exact sum W + (alpha/r) B A in fp32; the merged bf16 weight
        # may differ from it by its rounding, at most 2^-8 of it
        exact = base[layer + ".weight"].float() + (b_ @ a) * (
            alpha / a.shape[0])
        err = (merged[layer + ".weight"].float() - exact).abs()
        worst = max(worst, float((err / (BF16_U * exact.abs()
                                         + 1e-30)).max()))
    log(f"LoRA merge on the card: {len(on_card) // 2} adapted weights, "
        f"worst |merged - (W + (alpha/r) B A)| / (2^-8 |W + (alpha/r) B A|)"
        f" {worst:.3f}")
    if not worst <= 1.0:
        fail(f"the merged weights are off (alpha/r) B A: {worst}")
    pipe.model.load_state_dict(merged, strict=True)
    del merged, base, on_card
    merged_s, _, lat_m = clip("LoRA-merged model")
    rec = dict(steps=STUDENT_STEPS, img_guidance_scale=1.0,
               clip_s=clip_s, frames_per_s=N_GEN / clip_s,
               peak_mem_gib=peak_gib, merged_clip_s=merged_s,
               merge_err_over_bar=worst,
               merged_vs_student_latent_max=float(
                   (lat_m.float() - lat_s.float()).abs().max()),
               launches=launches, device=smi)
    log(f"guided student: {N_GEN}-frame clip {clip_s:.3f} s, "
        f"{N_GEN / clip_s:.3f} frames/s, peak {peak_gib:.2f} GiB, on {smi}")
    log(json.dumps({"student_serving": rec}))
    return launches


# ---- the image-generation family --------------------------------------------

def synthetic_image(px: int, seed: int) -> np.ndarray:
    """A px x px uint8 RGB image: smooth gradients plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:px, 0:px]
    base = np.stack([(x // 4 + 16 * seed) % 256, (y // 2) % 256,
                     ((x + y) // 8) % 256], -1).astype(np.float32)
    return np.clip(base + rng.normal(0, 12, base.shape), 0,
                   255).astype(np.uint8)


def image_rows():
    """The rows of the smoke's two image scenarios at IMAGE_PX, as the
    pipeline builds them with the stub tokenizer: (a) the prompt and the
    negative prompt, (b) the editing prompt with one input image, the
    negative prompt and the image row. Returns {scenario: ([TextRow],
    n_out)}."""
    proc = ImageGenProcessor(StubTokenizer())
    img = synthetic_image(IMAGE_PX, 1)
    neg = proc.row(DEFAULT_NEGATIVE_PROMPT)[0]
    n_out = (IMAGE_PX // 16) ** 2
    return {"text": ([proc.row(IMAGE_PROMPT)[0], neg], n_out),
            "edit": ([proc.row(EDIT_PROMPT, [img])[0], neg,
                      proc.row("<img><|image_1|></img>", [img])[0]], n_out)}


def image_decode_record(dev, seed: int, row, n_out: int,
                        dtype: torch.dtype = torch.bfloat16) -> dict:
    """K3 as the image path's cached decode runs it: the tail's queries
    (TIME + the output tokens) over the heads-major concatenation of the
    prompt's cache and the tail's own keys (the tail's K/V views of the
    fused projection, concatenated as ``attend_cached`` does), with the
    rectangular bias of the tail's rows over every key and its map built
    once (as once per guidance context); bf16 or fp32 operands."""
    cfg = ModelConfig()
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lay = single_shot_layout([row], n_out)
    meta = AttnMeta.from_layout(lay, dev)
    tail = lay.noisy_tail_len()
    lc = lay.length - tail
    bf16 = _bf16_maker(dev, seed, dtype)
    q = bf16(1, tail, h, d)
    kc, vc = bf16(1, hkv, lc, d), bf16(1, hkv, lc, d)
    kt = bf16(1, tail, hkv, d)
    vt = bf16(1, tail, h + 2 * hkv, d)[:, :, h + hkv:]
    kh = torch.cat([kc, kt.transpose(1, 2)], 2)
    vh = torch.cat([vc, vt.transpose(1, 2)], 2)
    k, v = kh.transpose(1, 2), vh.transpose(1, 2)  # [1, Lk, Hkv, D] views
    bias = fa.precompute_bias(meta.tail(tail), meta)
    bm = fa.bias_map(bias)

    def plain(absv=False):
        return fa.bias_attention_reference(*f32(q, k), *vals(v, absv=absv),
                                           bias)

    qh = q.transpose(1, 2).contiguous()
    bias4 = bias[:, None].to(dtype)

    def lib():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias4)

    return dict(
        fn=lambda: fa.flash_mha(q, k, v, bm), plain=plain, lib=lib,
        route="cuda", source=kernel_source("bias_attention.cu", dtype),
        dtype=dtype, replaces=f"{TPU_KERNELS}:133",
        shape=f"B 1, Lq {tail} vs {lc} cached + {tail} new keys "
              f"(heads-major), bf16 bias",
        bytes=nbytes(q, kh, vh, bias, q),
        flops=4 * h * d * int((bias == 0).sum()),
        tile_map=bias_tile_map(bias))


def train_image_batch(trainer):
    """The train-image path's batch (B 1) on the host: one synthetic
    output image and one input image at TRAIN_IMAGE_PX, the editing prompt
    through the trainer's processor and the training template, collated to
    the trainer's ``pad_to`` with MAX_INPUT_IMAGES clean slots."""
    size = (TRAIN_IMAGE_PX, TRAIN_IMAGE_PX)
    proc = trainer.processor
    row, _ = proc.row(EDIT_PROMPT, [synthetic_image(TRAIN_IMAGE_PX, 2)],
                      add_prefix=True)
    sample = ImageGenSample(
        row, [resize_center_crop(synthetic_image(TRAIN_IMAGE_PX, 2), size)],
        resize_center_crop(synthetic_image(TRAIN_IMAGE_PX, 3), size))
    return collate_image_gen([sample], trainer.pad_to, MAX_INPUT_IMAGES,
                             token_ids=trainer.model_cfg.token_ids)


def image_kernels(dev) -> dict:
    """K3 at the image path's decode shapes: (a)'s cond row (4,097
    queries over its prompt and tail) and (b)'s editing cond row (~8.2k
    keys: the prompt, one 1024x1024 input image's 4,096 tokens, the
    tail); K3 and K9 at the train-image shape (L 4,609)."""
    rows = image_rows()
    out = {}
    for key, (scenario, seed) in (("image_decode_2way", ("text", 21)),
                                  ("image_decode_3way", ("edit", 22))):
        (cond, *_), n_out = rows[scenario]
        out[key] = check_and_time("K3", image_decode_record(dev, seed, cond,
                                                            n_out),
                                  f" ({key})")
        torch.cuda.empty_cache()
    trainer = ImageGenTrainer(ModelConfig(), TrainConfig(), None, None,
                              StubTokenizer(),
                              output_size=(TRAIN_IMAGE_PX,) * 2,
                              max_input_images=MAX_INPUT_IMAGES, device=dev)
    meta = AttnMeta(*(x.to(dev) for x in
                      train_image_batch(trainer).inputs.batch.meta))
    recs = bias_train_records(dev, meta, " (train-image shape)")
    out["train_image_shape"] = recs
    torch.cuda.empty_cache()
    return out


def image_reference_phase(dev) -> dict:
    """The image path end to end on a small input: ``ImageGenPipeline`` on
    the card (bf16, the kernels) against the same weights and noise on the
    CPU in fp32 (plain versions), 2-way (a prompt) and 3-way (an editing
    prompt with one 64x64 input image), each context separately; the CPU
    in bf16 gives the rounding floor. Bar: final-latent relative MSE
    REF_REL_MSE_BAR. Every run holds exactly its K3 launches and map
    builds (per context: the prefill's and the decode's). Returns
    {scenario: relative MSE}."""
    cfg = ModelConfig.tiny(hidden_size=192, num_heads=2, num_kv_heads=1)
    vae_cfg = VAEConfig.tiny()  # head_dim 96 above; GQA 2:1
    proc = ImageGenProcessor(StubTokenizer())
    gpu = ImageGenPipeline.build(proc, cfg, vae_cfg, device=dev,
                                 dtype=torch.bfloat16, seed=0)
    cpu = {dtype: ImageGenPipeline.build(
        proc, cfg, vae_cfg, device="cpu", dtype=dtype,
        state_dict=gpu.model.state_dict(),
        vae_state_dict=gpu.vae.state_dict())
        for dtype in (torch.float32, torch.bfloat16)}
    steps, nl = 3, cfg.num_layers
    out = {}
    for name, prompt, images in (
            ("2-way", IMAGE_PROMPT, None),
            ("3-way", EDIT_PROMPT, [synthetic_image(64, 4)])):
        kw = dict(input_images=images, height=64, width=64,
                  num_inference_steps=steps, guidance_scale=IMAGE_CFG,
                  img_guidance_scale=IMAGE_IMG_CFG, max_input_image_size=64,
                  output_type="np", return_latents=True)

        def latents(pipe):
            return pipe(prompt, noise=SeededNoise(0, pipe.device),
                        **kw)[1].float().cpu()

        reset_counts()
        got = latents(gpu)
        torch.cuda.synchronize()
        ran = counts()
        want, floor = (latents(cpu[d]) for d in (torch.float32,
                                                  torch.bfloat16))

        def rel_mse_of(x):
            return float(((x - want) ** 2).mean() / (want ** 2).mean())

        n_ctx = 2 if images is None else 3
        expected = expect(K3=n_ctx * (nl + steps * nl),
                          bias_map_builds=2 * n_ctx)
        out[name] = rel_mse_of(got)
        log(f"small-input image reference ({name}): card (bf16, kernels) vs "
            f"CPU (fp32, plain) final-latent relative MSE {out[name]:.3e} "
            f"(bar {REF_REL_MSE_BAR}; CPU bf16 vs fp32 "
            f"{rel_mse_of(floor):.3e}), launches {ran}")
        if ran != expected:
            fail(f"the small-input image run ({name}) launched {ran}, not "
                 f"{expected}")
        if not torch.isfinite(got).all() or not out[name] <= REF_REL_MSE_BAR:
            fail(f"the card's image pipeline ({name}) disagrees with the "
                 f"CPU's: {out[name]}")
    return out


def image_serving_phase(dev, smi: str) -> dict:
    """The image path at full width (ModelConfig(), the SDXL-class VAE,
    random bf16 weights from a seed, heads random), stub tokenizer, each
    guidance context at its natural length: (a) text -> image at the CLI's
    defaults (1024x1024, 50 steps, guidance 3.0; the prompt and the
    default negative prompt), exactly 2 (32 + 50 * 32) K3 launches and 4
    map builds; (b) editing, one synthetic 1024x1024 input image, 3-way
    guidance (img_guidance_scale 1.6) at 10 steps (a cut in steps only),
    exactly 3 (32 + 10 * 32) K3 and 6 builds. The decodes of the contexts
    with the input image run over more than 8192 keys: the counters' K10
    column, K3 past the TPU's key cap (there the JAX ``maybe_bias`` gives
    no bias, and the TPU runs K6 at the same math). Each after a warm-up at
    1 step with the host-op check on; one uint8 1024x1024x3 image and
    finite latents on the device. Returns {scenario: record}."""
    t0 = time.perf_counter()
    pipe = ImageGenPipeline.build(ImageGenProcessor(StubTokenizer()),
                                  path_config(), VAEConfig(), device=dev,
                                  dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    log(f"build the image pipeline: {time.perf_counter() - t0:.1f} s")
    nl = pipe.model.cfg.num_layers
    out = {}
    for name, prompt, images, steps in (
            ("text_to_image", IMAGE_PROMPT, None, IMAGE_STEPS),
            ("editing_3way", EDIT_PROMPT, [synthetic_image(IMAGE_PX, 1)],
             EDIT_STEPS)):
        rows, n_out = image_rows()["text" if images is None else "edit"]
        n_ctx = len(rows)
        # K3 launches past 8192 keys: a context's prefill (its prompt) and
        # its decode steps (prompt and tail)
        n_long = sum(
            nl * ((lay.length - lay.noisy_tail_len() > fa.TPU_KEY_CAP)
                  + steps * (lay.length > fa.TPU_KEY_CAP))
            for lay in (single_shot_layout([r], n_out) for r in rows))
        kw = dict(input_images=images, height=IMAGE_PX, width=IMAGE_PX,
                  guidance_scale=IMAGE_CFG, img_guidance_scale=IMAGE_IMG_CFG,
                  seed=0, output_type="np", return_latents=True)
        host = HostFloatOps()
        t0 = time.perf_counter()
        with host:
            pipe(prompt, num_inference_steps=1, **kw)
        torch.cuda.synchronize()
        log(f"{name}: warm-up at 1 step {time.perf_counter() - t0:.2f} s "
            f"(host-op check on)")
        if host.ops:
            fail(f"{name}: float ops ran on the host: {sorted(host.ops)}")
        want = expect(K3=n_ctx * (nl + steps * nl), K10=n_long,
                      bias_map_builds=2 * n_ctx)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images_out, lat = pipe(prompt, num_inference_steps=steps, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = counts()
        log(f"{name}: launches {launches} (expected {want})")
        if launches != want:
            fail(f"{name} launch counts {launches} != {want}")
        if (len(images_out) != 1 or images_out[0].dtype != np.uint8
                or images_out[0].shape != (IMAGE_PX, IMAGE_PX, 3)):
            fail(f"{name}: not one uint8 {IMAGE_PX}x{IMAGE_PX}x3 image")
        f = VAEConfig().downsample_factor
        if (tuple(lat.shape) != (1, IMAGE_PX // f, IMAGE_PX // f, 4)
                or lat.device.type != dev.type
                or not torch.isfinite(lat).all()):
            fail(f"{name}: latents {tuple(lat.shape)} on {lat.device} or "
                 f"not finite")
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        out[name] = dict(steps=steps, contexts=n_ctx, image_s=wall_s,
                         s_per_step=wall_s / steps, peak_mem_gib=peak_gib,
                         launches=launches,
                         image_std=float(np.std(images_out[0])), device=smi)
        log(f"{name}: one {IMAGE_PX}x{IMAGE_PX} image in {steps} steps x "
            f"{n_ctx} contexts: {wall_s:.3f} s ({wall_s / steps:.4f} s a "
            f"step), peak {peak_gib:.2f} GiB, on {smi}")
        log(json.dumps({f"image_{name}": out[name]}))
    return out


# the fp32 image: text -> image at 1024x1024 and 2 contexts, at this many
# steps (a cut in steps only: an fp32 step costs ~10x a bf16 one)
FP32_IMAGE_STEPS = 2


def fp32_image_phase(dev, smi: str) -> dict:
    """``generate-image --dtype fp32``: text -> image at the CLI's 1024x1024
    and guidance 3.0 (the prompt and the default negative prompt, each
    context at its natural length) with fp32 weights, FP32_IMAGE_STEPS
    steps: the fp32 kernel exactly 2 (32 + steps x 32) K3 and 4 map
    builds, no bf16 kernel; one uint8 1024x1024x3 image and finite fp32
    latents on the card."""
    t0 = time.perf_counter()
    pipe = ImageGenPipeline.build(ImageGenProcessor(StubTokenizer()),
                                  path_config(), VAEConfig(), device=dev,
                                  dtype=torch.float32, seed=0)
    torch.cuda.synchronize()
    log(f"build the fp32 image pipeline: {time.perf_counter() - t0:.1f} s")
    nl, steps = pipe.model.cfg.num_layers, FP32_IMAGE_STEPS
    rows, _ = image_rows()["text"]
    want = expect(**{"K3-fp32": len(rows) * (nl + steps * nl)},
                  bias_map_builds=2 * len(rows))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images_out, lat = pipe(IMAGE_PROMPT, height=IMAGE_PX, width=IMAGE_PX,
                           num_inference_steps=steps, guidance_scale=IMAGE_CFG,
                           seed=0, output_type="np", return_latents=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counts()
    log(f"fp32 text_to_image: launches {launches} (expected {want})")
    if launches != want:
        fail(f"fp32 image launch counts {launches} != {want}")
    if (len(images_out) != 1 or images_out[0].dtype != np.uint8
            or images_out[0].shape != (IMAGE_PX, IMAGE_PX, 3)):
        fail(f"the fp32 image is not one uint8 {IMAGE_PX}x{IMAGE_PX}x3")
    if lat.device.type != dev.type or lat.dtype != torch.float32 \
            or not torch.isfinite(lat).all():
        fail("the fp32 image's latents are not finite fp32 on the card")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res = dict(steps=steps, contexts=len(rows), image_s=wall_s,
               s_per_step=wall_s / steps, peak_mem_gib=peak,
               launches=launches, device=smi)
    log(f"fp32 text_to_image: one {IMAGE_PX}x{IMAGE_PX} image in {steps} "
        f"steps x {len(rows)} contexts: {wall_s:.3f} s, peak {peak:.2f} GiB, "
        f"on {smi}")
    log(json.dumps({"image_fp32_text_to_image": res}))
    return res


def train_image_phase(dev, smi: str) -> dict:
    """The train-image path at full width through the image trainer's own
    step (fp32 parameters and AdamW, bf16 compute, per-layer recompute; a
    constant lr as the other training paths): B 1, a 512x512 output image
    and one 512x512 input image, MAX_INPUT_IMAGES clean slots, L 4,609.
    One warm-up step and TRAIN_IMAGE_STEPS timed steps, each with exactly
    64 K3, 32 K9 and one bias-map build; finite loss and gradient norm, a
    nonzero gradient into layer 0's attention, AdamW moving the
    parameters. Returns the summed launches."""
    cfg = TrainConfig(lr=TRAIN_LR, lr_scheduler="constant")
    t0 = time.perf_counter()
    trainer = ImageGenTrainer(path_config(), cfg, None, None,
                              StubTokenizer(),
                              output_size=(TRAIN_IMAGE_PX,) * 2,
                              max_input_images=MAX_INPUT_IMAGES, device=dev,
                              seed=0)
    state = trainer.build()
    model = trainer.model
    randomise_heads_(model, seed=1)
    torch.cuda.synchronize()
    log(f"build image trainer: {time.perf_counter() - t0:.1f} s, pad_to "
        f"{trainer.pad_to}")
    tb = train_image_batch(trainer).to(dev)
    b, L = tb.inputs.batch.input_ids.shape
    n_out = (TRAIN_IMAGE_PX // 16) ** 2
    if (b, L) != (1, 512 + MAX_INPUT_IMAGES * n_out + 1 + n_out):
        fail(f"the train-image batch is {b}x{L}")
    nl = trainer.model_cfg.num_layers
    qkv = model.llm.layers[0].self_attn.qkv_proj.weight
    grads = []
    hook = qkv.register_post_accumulate_grad_hook(
        lambda p: grads.append(torch.linalg.vector_norm(p.grad)))
    watched = {n: p for n, p in model.named_parameters() if n in (
        "x_embedder.proj.weight", "input_x_embedder.proj.weight",
        "llm.layers.0.self_attn.qkv_proj.weight",
        "final_layer.linear.weight")}
    before = {}

    def check(step, m):
        if not (np.isfinite(float(grads[-1])) and float(grads[-1]) > 0):
            fail(f"train-image step {step}: no gradient reached layer 0's "
                 f"attention")
        if step == 1:
            before.update({n: p.detach().clone()
                           for n, p in watched.items()})

    steps, total, peak_gib, step_s = run_steps(
        trainer, state, tb, "train-image", TRAIN_IMAGE_STEPS,
        expect(K3=2 * nl, K9=nl, bias_map_builds=1), check)
    hook.remove()
    moved = {n: float((p.detach() - before[n]).abs().max())
             for n, p in watched.items()}
    if not all(v > 0 for v in moved.values()):
        fail(f"AdamW did not move the image model: {moved}")
    rec = dict(layers=nl, output_px=TRAIN_IMAGE_PX, tokens_per_step=b * L,
               step_s=step_s, tokens_per_s=b * L / step_s,
               peak_mem_gib=peak_gib, steps=steps, moved=moved, device=smi)
    log(f"train-image path: {nl} layers, L {L}: {step_s:.3f} s/step, "
        f"{b * L / step_s:.1f} tokens/s, peak {peak_gib:.2f} GiB, on {smi}")
    log(json.dumps({"train_image_path": rec}))
    return total


def input_head_phase(dev, smi: str) -> dict:
    """Stage 1's training path with ``input_output_return``: the model
    carries the aux input head (zero at init), and the loss adds its
    reconstruction of the clean frames. One warm-up step and
    INPUT_HEAD_STEPS timed steps, each with stage 1's launches (64 K3, 32
    K9, one map build); the head's weight is 0 before the first step, gets
    a nonzero gradient in every step and moves. Returns the summed
    launches."""
    cfg = stage_config(1, lr=TRAIN_LR, lr_scheduler="constant",
                       adam_epsilon=1e-5, input_output_return=True)
    t0 = time.perf_counter()
    trainer = Trainer(path_config(), cfg, None, vae_cfg=VAEConfig(),
                      target_resolution=(H_PX, W_PX), device=dev, seed=0)
    state = trainer.build()
    model = trainer.model
    randomise_heads_(model, seed=1)
    head = model.input_final_layer.weight
    if float(head.detach().abs().max()) != 0:
        fail("the input head is not zero at init")
    grads = []
    hook = head.register_post_accumulate_grad_hook(
        lambda p: grads.append(torch.linalg.vector_norm(p.grad)))
    torch.cuda.synchronize()
    log(f"build input-head trainer: {time.perf_counter() - t0:.1f} s")

    def check(step, m):
        if not (np.isfinite(float(grads[-1])) and float(grads[-1]) > 0):
            fail(f"input-head step {step}: no gradient into the head")

    tb = train_batch(1).to(dev)
    b, L = tb.inputs.batch.input_ids.shape
    nl = trainer.model_cfg.num_layers
    steps, total, peak_gib, step_s = run_steps(
        trainer, state, tb, "input-head", INPUT_HEAD_STEPS,
        expect(K3=2 * nl, K9=nl, bias_map_builds=1), check)
    hook.remove()
    if not float(head.detach().abs().max()) > 0:
        fail("the input head did not move")
    rec = dict(layers=nl, step_s=step_s, tokens_per_s=b * L / step_s,
               tokens_per_step=b * L, peak_mem_gib=peak_gib, steps=steps,
               head_grad_norms=[float(g) for g in grads], device=smi)
    log(f"input-head path: {nl} layers, L {L}: {step_s:.3f} s/step, "
        f"{b * L / step_s:.1f} tokens/s, peak {peak_gib:.2f} GiB, on {smi}")
    log(json.dumps({"input_head_path": rec}))
    return total


if __name__ == "__main__":
    sys.exit(main())
