"""Command-line entry points: ``generate``, ``train``,
``generate-image``, ``train-image`` and ``export``.

    python -m video_gpt_tpu_torch.cli generate --video_path clip.mp4 \\
        --model_ckpt ckpt_dir --vae_ckpt vae.safetensors --gen_nums 16
    python -m video_gpt_tpu_torch.cli train --stage 1 \\
        --video_dir_path videos/ --results_dir results/stage1

Port of ``video_gpt_tpu/cli.py generate`` (every option of the JAX command
parses, so ``configs/inference.sh``'s command line runs as it is) and of
the single-device path of its ``train``, LoRA and distillation
included (``configs/distill_serving.sh``'s command lines run with ``-m
video_gpt_tpu_torch.cli``). ``generate``
takes one video (``--video_path``) or a directory (``--video_path_dir``,
same-shaped videos batched through ``generate_batch``), and the weights of
a reference checkpoint, of a ``train`` run of this port
(``--checkpoint_dir``) or random ones. ``train``: stage 1 runs the bias
kernels (K3, K9); stages 2-4, whose sequences are too long for a
precomputed bias, run the metadata-inline kernels (K6, K7). A later stage
warm-starts from an earlier one's checkpoint with ``--init_checkpoint_dir``
(the parameters or ``--init_ema``, never the optimizer state):

    python -m video_gpt_tpu_torch.cli train --stage 4 \\
        --video_dir_path videos/ --results_dir results/stage4 \\
        --init_checkpoint_dir results/stage3/checkpoints

``train --use_lora`` fine-tunes rank-``--lora_rank`` adapters over frozen
warm-start weights; ``generate --lora_checkpoint_dir`` merges such a run's
adapters into the base weights it serves (``--model_ckpt`` or
``--checkpoint_dir``), whatever mesh the run trained on and whatever mesh
serves them. ``train --distill`` distills the warm start into a student
that serves at ``--distill_student_steps`` steps (with
``--distill_guidance``, at ``--img_guidance_scale 1``). Both run on the
training meshes below, LoRA on every axis but pipe:

    torchrun --nproc_per_node 4 -m video_gpt_tpu_torch.cli train \
        --video_dir_path videos/ --use_lora --mesh_data 2 --mesh_tensor 2 \
        --zero3 --init_checkpoint_dir results/stage1/checkpoints

``generate-image`` and ``train-image`` are the image-generation family
(``image_gen.py``, ``training/image_trainer.py``): text (and input images)
to an image with 2- or 3-way guidance, and its training on a json dataset
of prompts and images with condition dropout and the velocity target.
Without ``--tokenizer`` they hash words (a smoke run; Python salts the
hash per process, so set ``PYTHONHASHSEED`` to serve a run in another
process). ``generate-image --checkpoint_dir`` serves a ``train-image`` run:

    python -m video_gpt_tpu_torch.cli train-image --json_file data.json \
        --results_dir results_image
    python -m video_gpt_tpu_torch.cli generate-image --prompt "a red bird" \
        --checkpoint_dir results_image/checkpoints --output bird.png

``generate --mesh_seq S --mesh_tensor T`` serves over S x T ranks, one
process each, sequence-parallel (Ulysses) over S and tensor-parallel over
T, as the reference serves at SP=4; rank 0 alone prints and writes:

    torchrun --nproc_per_node 4 -m video_gpt_tpu_torch.cli generate \
        --video_path clip.mp4 --mesh_seq 2 --mesh_tensor 2

Each rank takes ``cuda:LOCAL_RANK`` and NCCL (gloo with ``--device cpu``).
``train`` and ``train-image`` train over ``--mesh_data D --mesh_seq S
--mesh_tensor T`` ranks the same way (``--zero3`` shards the parameters
over data too; ``--sp_attention ring`` runs the ring over seq in place of
Ulysses), and ``train`` also over ``--mesh_pipe P`` GPipe stages
(``--pp_microbatches M`` a step, with data only), e.g. the recipes of
``configs/pretrain_multichip_examples.sh``:

    torchrun --nproc_per_node 4 -m video_gpt_tpu_torch.cli train \
        --video_dir_path videos/ --mesh_data 2 --mesh_seq 2
    torchrun --nproc_per_node 8 -m video_gpt_tpu_torch.cli train \
        --video_dir_path videos/ --mesh_data 2 --mesh_pipe 4 \
        --pp_microbatches 4 --batch_size_per_device 4

``--offload_optimizer`` keeps AdamW's fp32 master, mu and nu in host
memory and runs the update on the host CPU (one device; ``train`` and
``train-image``), ``--offload_grad_splits N`` differentiates the
parameters in N backward passes.

``export`` writes a run's parameters (``--ema``: its EMA) as the reference's
safetensors. ``train --input_output_return`` trains the aux
input-reconstruction head; ``generate`` and ``export`` then take
``--input_head``.

Runs on CUDA unless ``--device cpu``; without checkpoints the weights are
random (a smoke run). cv2 (video decode), PIL (image files), safetensors
and transformers are imported only where they are used.
"""
from __future__ import annotations

import argparse
import contextlib
import os

import torch


def _tokenizer(args):
    """The ``--tokenizer`` (a Hugging Face tokenizer path), else the
    word-hash stub."""
    from .image_gen import StubTokenizer
    if args.tokenizer:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(args.tokenizer)
    print("WARNING: no --tokenizer; hashing words (smoke run only)")
    return StubTokenizer()


def _configs(args):
    """The (model, VAE) configs of a command line: the reference width, or
    with ``--tiny_model`` the tiny ones."""
    from .config import ModelConfig
    from .models.vae import VAEConfig
    if args.tiny_model:
        return ModelConfig.tiny(pos_embed_max_size=192), VAEConfig.tiny()
    return ModelConfig(), VAEConfig()


def read_conditioning(path: str, n: int):
    """The first ``n`` conditioning frames of a video, every 4th frame as
    the reference inference script reads them (HWC uint8 RGB; cv2)."""
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    for i in range(n):
        cap.set(cv2.CAP_PROP_POS_FRAMES, i * 4)
        ok, f = cap.read()
        if not ok:
            raise SystemExit(f"cannot read frame {i * 4} of {path}")
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    return frames


def _generate_weights(args):
    """(model state dict or None, prediction type) of a ``generate``
    command line: a reference checkpoint (``--model_ckpt``; a model.pt is a
    velocity model unless ``--prediction_type`` says otherwise), a training
    run of this port (``--checkpoint_dir [--step] [--ema]``), or random
    weights."""
    from .utils import checkpoint as ckpt
    from .utils.torch_import import (load_reference_checkpoint,
                                     resolve_checkpoint_path)

    prediction_type = args.prediction_type
    sd = None
    if args.model_ckpt:
        if prediction_type is None and os.path.basename(
                resolve_checkpoint_path(args.model_ckpt)) == "model.pt":
            # the reference inference script: a model.pt checkpoint is a
            # velocity-prediction model
            prediction_type = "v"
            print("model.pt checkpoint: prediction_type defaults to 'v'")
        sd = load_reference_checkpoint(args.model_ckpt)
    elif args.checkpoint_dir:
        sd, step = ckpt.load_train_params(args.checkpoint_dir, step=args.step,
                                          ema=args.ema,
                                          input_head=args.input_head)
        print(f"weights of {args.checkpoint_dir} step {step}"
              f"{' (EMA)' if args.ema else ''}")
    else:
        print("WARNING: no --model_ckpt; using random weights (smoke run)")
    if args.lora_checkpoint_dir:
        sd = _merge_lora_run(args, sd)
    return sd, prediction_type or "x1"


def _merge_lora_run(args, sd):
    """The base weights ``sd`` with the adapters of a ``train --use_lora``
    run (``--lora_checkpoint_dir [--step] [--ema]``) merged in."""
    from .config import ModelConfig
    from .training.lora import merge_lora
    from .utils import checkpoint as ckpt

    if sd is None:
        raise SystemExit("--lora_checkpoint_dir needs base weights "
                         "(--model_ckpt or --checkpoint_dir)")
    try:
        adapters, step = ckpt.load_lora_adapters(
            args.lora_checkpoint_dir, step=args.step, ema=args.ema)
    except ValueError as e:
        raise SystemExit(str(e))
    rank = next(t.shape[0] for n, t in adapters.items()
                if n.endswith(".lora_A.weight"))
    if rank != args.lora_rank:
        raise SystemExit(f"the LoRA run trained rank {rank}, not "
                         f"--lora_rank {args.lora_rank}")
    print(f"merged LoRA adapters (rank {rank}) of "
          f"{args.lora_checkpoint_dir} step {step}"
          f"{' (EMA)' if args.ema else ''}")
    return merge_lora(sd, adapters, alpha=ModelConfig.lora_alpha)


def _generate_mesh(args):
    """The serving mesh of ``--mesh_seq S --mesh_tensor T`` (None at 1 x
    1), after joining the launch's process group; exits unless the launch
    runs S x T processes."""
    import torch.distributed as dist

    from .config import MeshConfig
    from .parallel.distributed import init_runtime
    from .parallel.mesh import make_mesh

    init_runtime(device=args.device)
    n = args.mesh_seq * args.mesh_tensor
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise SystemExit(
            f"--mesh_seq {args.mesh_seq} --mesh_tensor {args.mesh_tensor} "
            f"serves over {n} processes (torchrun --nproc_per_node {n}); "
            f"this launch runs {world}")
    if n == 1:
        return None
    return make_mesh(MeshConfig(seq=args.mesh_seq, tensor=args.mesh_tensor))


def cmd_generate(args):
    import torch.distributed as dist

    from .parallel.distributed import is_main_process

    mesh = _generate_mesh(args)
    try:
        with contextlib.ExitStack() as stack:
            # every rank computes the same frames; rank 0 alone prints and
            # writes them
            if not is_main_process():
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            _generate(args, mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _generate(args, mesh):
    from .data.processor import preprocess_frames
    from .data.video import list_videos
    from .parallel.distributed import is_main_process
    from .sampling.pipeline import VideoGPTPipeline
    from .utils.torch_import import load_reference_checkpoint

    if args.video_path_dir:
        video_paths = list_videos(args.video_path_dir)
        if not video_paths:
            raise SystemExit(f"no videos under {args.video_path_dir}")
    elif args.video_path:
        video_paths = [args.video_path]
    else:
        raise SystemExit("provide --video_path or --video_path_dir")
    cfg, vae_cfg = _configs(args)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    sd, prediction_type = _generate_weights(args)
    vae_sd = None
    if args.vae_ckpt:
        vae_sd = load_reference_checkpoint(args.vae_ckpt)
    else:
        print("WARNING: no --vae_ckpt; using random VAE weights")
    # fp32 VAE convolutions in full fp32, as the reference computes them
    # (cuDNN's default is TF32); bf16 convolutions do not read the flag
    torch.backends.cudnn.allow_tf32 = False
    pipe = VideoGPTPipeline.build(cfg, vae_cfg, device=args.device,
                                  dtype=dtype, state_dict=sd,
                                  vae_state_dict=vae_sd, seed=args.seed,
                                  input_head=args.input_head, mesh=mesh)
    kw = dict(gen_nums=args.gen_nums,
              num_inference_steps=args.num_inference_steps,
              img_guidance_scale=args.img_guidance_scale,
              max_input_image_size=args.max_input_image_size,
              max_frame_window=args.max_frame_window,
              clean_image_noise_level=args.clean_image_noise_level,
              prediction_type=prediction_type,
              vae_roundtrip_recycle=args.vae_roundtrip_recycle,
              cfg_interval=(tuple(args.cfg_interval) if args.cfg_interval
                            else None),
              uncond_refresh=args.uncond_refresh)
    os.makedirs(args.save_dir, exist_ok=True)

    def save(k, path, images):
        from PIL import Image
        if not is_main_process():
            return
        for i, im in enumerate(images):
            Image.fromarray(im).save(os.path.join(args.save_dir,
                                                  f"{k}_{i}.png"))
        print(f"[{k}] {path}: saved {len(images)} frames to "
              f"{args.save_dir}", flush=True)

    if len(video_paths) == 1:
        save(0, video_paths[0], pipe.generate(
            read_conditioning(video_paths[0], args.clean_image_num),
            seed=args.seed, **kw))
        return
    # videos of one preprocessed shape ride one B = N set of calls
    # (generate_batch), each with the seed of its place in the list
    pre, groups = {}, {}
    for path in video_paths:
        arr = preprocess_frames(read_conditioning(path, args.clean_image_num),
                                args.max_input_image_size)
        pre[path] = arr
        groups.setdefault(arr.shape, []).append(path)
    order = {p: k for k, p in enumerate(video_paths)}
    for paths in groups.values():
        outs = pipe.generate_batch([pre[p] for p in paths],
                                   seeds=[args.seed + order[p] for p in paths],
                                   **kw)
        for p, images in zip(paths, outs):
            save(order[p], p, images)


def _init_state_dict(args):
    """The initial weights of ``train``: a reference checkpoint
    (``--model_ckpt``), else an earlier stage's checkpoint of this port
    (``--init_checkpoint_dir``: its parameters, or its EMA with
    ``--init_ema``; the optimizer starts fresh), else None (random)."""
    from .utils import checkpoint as ckpt
    from .utils.torch_import import load_reference_checkpoint

    if args.model_ckpt:
        return load_reference_checkpoint(args.model_ckpt)
    if args.init_checkpoint_dir:
        sd, step = ckpt.load_train_params(
            args.init_checkpoint_dir, step=args.init_step, ema=args.init_ema,
            input_head=args.input_output_return)
        print(f"warm-start from {args.init_checkpoint_dir} step {step}"
              f"{' (EMA)' if args.init_ema else ''}")
        return sd
    return None


def make_trainer(args, mesh_cfg=None):
    """The ``Trainer`` of a ``train`` command line (nothing built yet), on
    ``mesh_cfg`` (:func:`_train_mesh`)."""
    from .config import stage_config
    from .training.trainer import Trainer
    from .utils.torch_import import load_reference_checkpoint

    cfg = _checked(stage_config(
        args.stage,
        frame_num=args.frame_num or {1: 16, 2: 48, 3: 48, 4: 80}[args.stage],
        batch_size_per_device=args.batch_size_per_device, lr=args.lr,
        results_dir=args.results_dir, log_every=args.log_every,
        ckpt_every=args.ckpt_every, mixed_precision=args.mixed_precision,
        use_ema=args.use_ema, input_noise=args.input_noise,
        auto_resume=not args.no_auto_resume, use_lora=args.use_lora,
        lora_rank=args.lora_rank, sp_attention=args.sp_attention,
        pp_microbatches=args.pp_microbatches, cls_weight=args.cls_weight,
        input_output_return=args.input_output_return,
        offload_optimizer=args.offload_optimizer,
        offload_grad_splits=args.offload_grad_splits, distill=args.distill,
        distill_student_steps=args.distill_student_steps,
        distill_substeps=args.distill_substeps,
        distill_time_shift=args.distill_time_shift,
        distill_input_noise=args.distill_input_noise,
        # a negative --distill_lr inherits --lr
        distill_lr=(None if args.distill_lr is not None
                    and args.distill_lr < 0 else args.distill_lr),
        distill_loss_weight=args.distill_loss_weight,
        distill_guidance=args.distill_guidance,
        lr_scheduler=args.lr_scheduler, lr_warmup_steps=args.lr_warmup_steps,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        max_grad_norm=args.max_grad_norm,
        adam_weight_decay=args.adam_weight_decay,
        adam_epsilon=args.adam_epsilon, adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2, num_workers=args.num_workers,
        prefetch_depth=args.prefetch_depth,
        **({"frame_interval": args.frame_interval}
           if args.frame_interval is not None else {}),
        **({"max_input_length_limit": args.max_input_length_limit}
           if args.max_input_length_limit is not None else {})))
    model_cfg, vae_cfg = _configs(args)
    return Trainer(
        model_cfg, cfg, args.video_dir_path, vae_cfg=vae_cfg,
        vae_state_dict=(load_reference_checkpoint(args.vae_ckpt)
                        if args.vae_ckpt else None),
        init_state_dict=_init_state_dict(args),
        target_resolution=tuple(args.target_resolution), device=args.device,
        seed=args.seed, mesh_cfg=mesh_cfg)


def _checked(cfg):
    """``cfg``, or an exit with the JAX trainer's message on a combination
    it refuses (``config.check_train_config``), before anything is
    built."""
    from .config import check_train_config
    try:
        check_train_config(cfg)
    except ValueError as e:
        raise SystemExit(str(e))
    return cfg


def _train_mesh(args):
    """The training mesh of ``--mesh_data D --mesh_seq S --mesh_tensor T
    [--mesh_pipe P] [--zero3]`` (None at one rank), after joining the
    launch's process group; exits unless the launch runs D x S x T x P
    processes."""
    import torch.distributed as dist

    from .config import MeshConfig
    from .parallel.distributed import init_runtime

    init_runtime(device=args.device)
    cfg = MeshConfig(data=args.mesh_data, seq=args.mesh_seq,
                     tensor=args.mesh_tensor, zero_params=args.zero3,
                     pipe=getattr(args, "mesh_pipe", 1))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != cfg.num_devices:
        pipe = f" --mesh_pipe {cfg.pipe}" if cfg.pipe > 1 else ""
        raise SystemExit(
            f"--mesh_data {cfg.data} --mesh_seq {cfg.seq} --mesh_tensor "
            f"{cfg.tensor}{pipe} trains over {cfg.num_devices} processes "
            f"(torchrun --nproc_per_node {cfg.num_devices}); this launch "
            f"runs {world}")
    return cfg if cfg.num_devices > 1 else None


@contextlib.contextmanager
def _on_the_mesh(args):
    """The training mesh's config for the command's body (rank 0 alone
    prints; the process group is left at the end)."""
    import torch.distributed as dist

    from .parallel.distributed import is_main_process

    mesh_cfg = _train_mesh(args)
    try:
        with contextlib.ExitStack() as stack:
            if not is_main_process():
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            yield mesh_cfg
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _log_writer(args):
    """``--report_to tensorboard``: a tensorboardX writer of
    ``results_dir/tensorboard_log`` on rank 0 when tensorboardX imports,
    else None (the JAX command's behaviour)."""
    from .parallel.distributed import is_main_process
    if args.report_to != "tensorboard" or not is_main_process():
        return None
    try:
        from tensorboardX import SummaryWriter
    except Exception:
        return None
    return SummaryWriter(os.path.join(args.results_dir, "tensorboard_log"))


def cmd_train(args):
    with _on_the_mesh(args) as mesh_cfg:
        trainer = make_trainer(args, mesh_cfg)
        steps = args.max_steps
        if args.epochs is not None:
            # an epoch is a pass of the global batch's rows
            rows = trainer._batch_rows
            steps = args.epochs * max(1, len(trainer.dataset) // rows)
            print(f"--epochs {args.epochs} => {steps} steps "
                  f"({len(trainer.dataset)} clips, {rows} rows/step)")
        trainer.run(steps, log_writer=_log_writer(args))


def _add_train_parser(sub) -> None:
    t = sub.add_parser("train", help="pretrain (stage 1-4 curriculum) on "
                                     "one device or a mesh")
    t.add_argument("--stage", type=int, default=1, choices=[1, 2, 3, 4])
    t.add_argument("--video_dir_path", type=str, required=True,
                   help="directory of videos, or a .txt manifest "
                        "(path<TAB>frame_count per line)")
    t.add_argument("--results_dir", type=str, default="results")
    t.add_argument("--max_steps", type=int, default=1000)
    t.add_argument("--epochs", type=int, default=None,
                   help="train for N passes over the dataset instead of "
                        "--max_steps")
    t.add_argument("--frame_num", type=int, default=None)
    t.add_argument("--frame_interval", type=int, default=None,
                   help="frame stride (the stage recipes default to 4)")
    t.add_argument("--max_input_length_limit", type=int, default=None,
                   help="override the stage recipe's sequence budget")
    t.add_argument("--target_resolution", type=int, nargs=2,
                   default=[176, 320])
    t.add_argument("--batch_size_per_device", type=int, default=1)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--lr_scheduler", default="constant_with_warmup",
                   choices=["constant", "constant_with_warmup", "cosine"])
    t.add_argument("--lr_warmup_steps", type=int, default=1000)
    t.add_argument("--gradient_accumulation_steps", type=int, default=1)
    t.add_argument("--max_grad_norm", type=float, default=1.0)
    t.add_argument("--adam_weight_decay", type=float, default=0.1)
    t.add_argument("--adam_epsilon", type=float, default=1e-8)
    t.add_argument("--adam_beta1", type=float, default=0.9)
    t.add_argument("--adam_beta2", type=float, default=0.95)
    t.add_argument("--mixed_precision", default="bf16",
                   choices=["bf16", "no"],
                   help="bf16 compute over fp32 parameters; 'no' "
                        "trains in fp32 end to end (the fp32 "
                        "attention kernels on CUDA)")
    t.add_argument("--use_ema", action="store_true")
    t.add_argument("--cls_weight", type=float, default=None)
    t.add_argument("--input_noise", type=float, default=0.9)
    t.add_argument("--log_every", type=int, default=100)
    t.add_argument("--ckpt_every", type=int, default=1000)
    t.add_argument("--no_auto_resume", action="store_true")
    t.add_argument("--num_workers", type=int, default=1,
                   help="batch-building worker threads")
    t.add_argument("--prefetch_depth", type=int, default=2)
    t.add_argument("--model_ckpt", type=str, default=None,
                   help="reference-format torch/safetensors initial weights")
    t.add_argument("--init_checkpoint_dir", type=str, default=None,
                   help="warm-start the parameters from an earlier stage's "
                        "checkpoint directory (<results_dir>/checkpoints; "
                        "stage chaining: the optimizer state starts fresh)")
    t.add_argument("--init_ema", action="store_true",
                   help="warm-start from the EMA parameters of "
                        "--init_checkpoint_dir")
    t.add_argument("--init_step", type=int, default=None,
                   help="checkpoint step for --init_checkpoint_dir "
                        "(default: latest)")
    t.add_argument("--vae_ckpt", type=str, default=None)
    t.add_argument("--tiny_model", action="store_true")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    t.add_argument("--use_lora", action="store_true",
                   help="fine-tune LoRA adapters on qkv_proj/o_proj over "
                        "the frozen warm-start weights; checkpoints hold "
                        "the adapters alone")
    t.add_argument("--lora_rank", type=int, default=8)
    t.add_argument("--distill", action="store_true",
                   help="progressive step distillation: the student (a "
                        "copy of the --model_ckpt/--init_checkpoint_dir "
                        "weights) regresses onto the frozen teacher's "
                        "rollouts, to serve at --distill_student_steps "
                        "Euler steps")
    t.add_argument("--distill_student_steps", type=int, default=5,
                   help="sampler step count the student is trained for")
    t.add_argument("--distill_substeps", type=int, default=2,
                   help="teacher Euler substeps per student step")
    t.add_argument("--distill_time_shift", type=float, default=1.0,
                   help="sigma-grid time shift; must match the serving "
                        "scheduler's")
    t.add_argument("--distill_input_noise", type=float, default=1.0,
                   help="conditioning-frame noise floor (1.0 = clean, the "
                        "serving regime)")
    t.add_argument("--distill_lr", type=float, default=1e-4,
                   help="learning rate of the distillation optimizer (in "
                        "place of --lr); a negative value inherits --lr")
    t.add_argument("--distill_loss_weight", default="uniform",
                   choices=["uniform", "endpoint"],
                   help="per-frame weights across grid points; 'endpoint' "
                        "= ((s_next - s) / (1 - s))^2")
    t.add_argument("--distill_guidance", type=float, default=None,
                   help="guidance distillation: the teacher's target is "
                        "uncond + w (cond - uncond) at this w, so the "
                        "student serves at --img_guidance_scale 1")
    t.add_argument("--input_output_return", action="store_true",
                   help="train the aux input-reconstruction head too (its "
                        "loss over the clean frames joins the denoising "
                        "loss); serve or export with --input_head")
    t.add_argument("--report_to", default="tensorboard",
                   help="'tensorboard': results_dir/tensorboard_log when "
                        "tensorboardX imports")
    _add_mesh_args(t)
    t.add_argument("--mesh_pipe", type=int, default=1,
                   help="GPipe pipeline stages: the layer stack split over "
                        "P ranks, microbatches hopping between them "
                        "(composes with --mesh_data)")
    t.add_argument("--pp_microbatches", type=int, default=0,
                   help="microbatches per step when --mesh_pipe > 1 "
                        "(0 = one per stage); must divide "
                        "--batch_size_per_device")
    t.add_argument("--sp_attention", default="ulysses",
                   choices=["ulysses", "ring"],
                   help="sequence parallelism over --mesh_seq: Ulysses "
                        "(all_to_all over heads) or the ring (K/V chunks "
                        "hop between neighbours; any seq degree dividing "
                        "L)")
    t.add_argument("--offload_optimizer", action="store_true",
                   help="host-offloaded AdamW: fp32 master/mu/nu in host "
                        "memory, the update on the host CPU, bf16 "
                        "parameters and transient gradients on the card — "
                        "full-depth training on ONE device (the "
                        "reference's ZeRO-offload analogue)")
    t.add_argument("--offload_grad_splits", type=int, default=1,
                   help="backward passes per step (2 halves the live "
                        "gradients on the card for one forward recompute)")
    t.set_defaults(fn=cmd_train)


def _add_mesh_args(parser) -> None:
    """The training mesh's options (one process per rank, torchrun)."""
    parser.add_argument("--zero3", action="store_true",
                        help="ZeRO-3: the parameters and the EMA sharded "
                             "over the data axis too")
    parser.add_argument("--mesh_data", type=int, default=1,
                        help="data-parallel ranks (batch rows; ZeRO "
                             "optimizer-state sharding)")
    parser.add_argument("--mesh_seq", type=int, default=1,
                        help="sequence-parallel (Ulysses) ranks")
    parser.add_argument("--mesh_tensor", type=int, default=1,
                        help="tensor-parallel ranks (heads and MLP "
                             "features)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="video_gpt_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate", help="autoregressive next-clip "
                                        "prediction")
    g.add_argument("--video_path", type=str, default=None)
    g.add_argument("--video_path_dir", type=str, default=None,
                   help="run every video in a directory; videos of one "
                        "preprocessed shape go through generate_batch")
    g.add_argument("--save_dir", type=str, default="result/test/inference")
    g.add_argument("--model_ckpt", type=str, default=None,
                   help="reference checkpoint (model.pt / model.safetensors "
                        "/ pytorch_model.bin, or a directory holding one)")
    g.add_argument("--checkpoint_dir", type=str, default=None,
                   help="a `train` run's checkpoint directory "
                        "(<results_dir>/checkpoints): train -> serve")
    g.add_argument("--step", type=int, default=None,
                   help="checkpoint step of --checkpoint_dir (default: "
                        "latest)")
    g.add_argument("--ema", action="store_true",
                   help="the EMA weights of --checkpoint_dir")
    g.add_argument("--vae_ckpt", type=str, default=None,
                   help="diffusers AutoencoderKL checkpoint")
    g.add_argument("--clean_image_num", type=int, default=1)
    g.add_argument("--gen_nums", type=int, nargs="+", default=[4, 4])
    g.add_argument("--num_inference_steps", type=int, default=50)
    g.add_argument("--img_guidance_scale", type=float, default=1.0)
    g.add_argument("--max_input_image_size", type=int, default=320)
    g.add_argument("--max_frame_window", type=int, default=16)
    g.add_argument("--clean_image_noise_level", type=float, default=0.1)
    g.add_argument("--vae_roundtrip_recycle", action="store_true",
                   help="VAE-decode and re-encode the recycled predictions "
                        "(reference semantics); default feeds the latents "
                        "back")
    g.add_argument("--prediction_type", default=None, choices=["x1", "v"],
                   help="default: x1, or v when --model_ckpt resolves to a "
                        "model.pt")
    g.add_argument("--cfg_interval", type=float, nargs=2, default=None,
                   metavar=("LO", "HI"),
                   help="apply guidance only where sigma is in [LO, HI)")
    g.add_argument("--uncond_refresh", type=int, default=1,
                   help="evaluate the uncond row only every k-th guided step")
    g.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                   help="bf16 runs the tensor-core attention kernels, fp32 "
                        "the fp32 kernel (csrc/fp32_attention.cu)")
    g.add_argument("--tiny_model", action="store_true")
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    g.add_argument("--lora_checkpoint_dir", type=str, default=None,
                   help="checkpoints of a `train --use_lora` run: its "
                        "adapters (--step, --ema) merge into the base "
                        "weights")
    g.add_argument("--lora_rank", type=int, default=8,
                   help="the rank the LoRA run trained with")
    g.add_argument("--input_head", action="store_true",
                   help="the checkpoint was trained with "
                        "--input_output_return (it holds the aux input head)")
    g.add_argument("--mesh_seq", type=int, default=1,
                   help="sequence-parallel (Ulysses) ranks; with "
                        "--mesh_tensor, launch S*T processes (torchrun)")
    g.add_argument("--mesh_tensor", type=int, default=1,
                   help="tensor-parallel ranks (heads and MLP features)")
    g.set_defaults(fn=cmd_generate)
    _add_train_parser(sub)
    _add_image_parsers(sub)
    _add_export_parser(sub)
    return ap


def cmd_generate_image(args):
    """Text (and input images) -> one image, saved to ``--output``."""
    from .image_gen import ImageGenPipeline, ImageGenProcessor
    from .utils import checkpoint as ckpt
    from .utils.torch_import import load_reference_checkpoint

    cfg, vae_cfg = _configs(args)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    proc = ImageGenProcessor(_tokenizer(args), args.max_input_image_size)
    sd = None
    if args.model_ckpt:
        sd = load_reference_checkpoint(args.model_ckpt)
    elif args.checkpoint_dir:
        try:
            sd, step = ckpt.load_train_params(
                args.checkpoint_dir, step=args.step, ema=args.ema,
                input_head=False)
        except ValueError as e:
            raise SystemExit(str(e))
        print(f"weights of {args.checkpoint_dir} step {step}"
              f"{' (EMA)' if args.ema else ''}")
    else:
        print("WARNING: no --model_ckpt; using random weights (smoke run)")
    vae_sd = None
    if args.vae_ckpt:
        vae_sd = load_reference_checkpoint(args.vae_ckpt)
    else:
        print("WARNING: no --vae_ckpt; using random VAE weights")
    # fp32 VAE convolutions in full fp32 (cuDNN's default is TF32)
    torch.backends.cudnn.allow_tf32 = False
    pipe = ImageGenPipeline.build(proc, cfg, vae_cfg, device=args.device,
                                  dtype=dtype, state_dict=sd,
                                  vae_state_dict=vae_sd)
    images = pipe(args.prompt, input_images=args.input_images or None,
                  height=args.height, width=args.width,
                  num_inference_steps=args.num_inference_steps,
                  guidance_scale=args.guidance_scale,
                  img_guidance_scale=args.img_guidance_scale,
                  max_input_image_size=args.max_input_image_size,
                  seed=args.seed,
                  separate_cfg_infer=not args.no_separate_cfg,
                  cfg_interval=(tuple(args.cfg_interval)
                                if args.cfg_interval else None),
                  uncond_refresh=args.uncond_refresh, output_type="np")
    from PIL import Image
    os.makedirs(os.path.dirname(os.path.abspath(args.output)) or ".",
                exist_ok=True)
    Image.fromarray(images[0]).save(args.output)
    print(f"saved {args.output}")


def cmd_train_image(args):
    with _on_the_mesh(args) as mesh_cfg:
        _train_image(args, mesh_cfg)


def _train_image(args, mesh_cfg):
    from .config import TrainConfig
    from .training.image_trainer import ImageGenTrainer
    from .utils.torch_import import load_reference_checkpoint

    cfg = _checked(TrainConfig(
        batch_size_per_device=args.batch_size_per_device, lr=args.lr,
        results_dir=args.results_dir, log_every=args.log_every,
        ckpt_every=args.ckpt_every, mixed_precision=args.mixed_precision,
        use_ema=args.use_ema, auto_resume=not args.no_auto_resume,
        max_input_length_limit=args.max_input_length_limit,
        offload_optimizer=args.offload_optimizer,
        offload_grad_splits=args.offload_grad_splits,
        num_workers=args.num_workers, prefetch_depth=args.prefetch_depth))
    model_cfg, vae_cfg = _configs(args)
    ImageGenTrainer(
        model_cfg, cfg, args.json_file, args.image_root, _tokenizer(args),
        output_size=(args.height, args.width),
        input_size=((args.input_height, args.input_width)
                    if args.input_height else None),
        condition_dropout_prob=args.condition_dropout_prob,
        max_input_images=args.max_input_images, vae_cfg=vae_cfg,
        vae_state_dict=(load_reference_checkpoint(args.vae_ckpt)
                        if args.vae_ckpt else None),
        device=args.device, seed=args.seed, mesh_cfg=mesh_cfg).run(
            args.max_steps, log_writer=_log_writer(args))


def cmd_export(args):
    """A training run's parameters (or EMA) -> the reference's
    safetensors; the model config checks the shapes first."""
    from .models.video_gpt import VideoGPT
    from .utils import checkpoint as ckpt
    from .utils.torch_export import save_safetensors

    try:
        sd, step = ckpt.load_train_params(args.checkpoint_dir, step=args.step,
                                          ema=args.ema,
                                          input_head=args.input_head)
    except ValueError as e:
        raise SystemExit(str(e))
    cfg, _ = _configs(args)
    # the run's model must be this config's: names and shapes, strictly
    VideoGPT(cfg, device="meta", input_head=args.input_head
             ).load_state_dict(sd, strict=True, assign=True)
    save_safetensors(sd, args.output)
    print(f"exported step {step}{' (EMA)' if args.ema else ''} "
          f"to {args.output}")


def _add_image_parsers(sub) -> None:
    gi = sub.add_parser("generate-image",
                        help="single-shot text(+image) -> image generation")
    gi.add_argument("--prompt", type=str, required=True)
    gi.add_argument("--input_images", type=str, nargs="*", default=None)
    gi.add_argument("--output", type=str, default="result/image.png")
    gi.add_argument("--height", type=int, default=1024)
    gi.add_argument("--width", type=int, default=1024)
    gi.add_argument("--num_inference_steps", type=int, default=50)
    gi.add_argument("--guidance_scale", type=float, default=3.0)
    gi.add_argument("--img_guidance_scale", type=float, default=1.6)
    gi.add_argument("--max_input_image_size", type=int, default=1024)
    gi.add_argument("--model_ckpt", type=str, default=None,
                    help="reference-format torch/safetensors checkpoint")
    gi.add_argument("--checkpoint_dir", type=str, default=None,
                    help="a `train-image` run's checkpoint directory "
                         "(<results_dir>/checkpoints): train -> serve")
    gi.add_argument("--step", type=int, default=None)
    gi.add_argument("--ema", action="store_true",
                    help="the EMA weights of --checkpoint_dir")
    gi.add_argument("--vae_ckpt", type=str, default=None)
    gi.add_argument("--tokenizer", type=str, default=None,
                    help="Hugging Face tokenizer path for the prompts "
                         "(default: the word-hash stub)")
    gi.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                    help="bf16 runs the tensor-core attention kernels, fp32 "
                         "the fp32 kernel (csrc/fp32_attention.cu)")
    gi.add_argument("--tiny_model", action="store_true")
    gi.add_argument("--no_separate_cfg", action="store_true",
                    help="run the guidance contexts as one padded batch "
                         "instead of each at its natural length")
    gi.add_argument("--cfg_interval", type=float, nargs=2, default=None,
                    metavar=("LO", "HI"),
                    help="apply guidance only where sigma is in [LO, HI)")
    gi.add_argument("--uncond_refresh", type=int, default=1,
                    help="evaluate the guidance contexts only every k-th "
                         "guided step")
    gi.add_argument("--seed", type=int, default=None)
    gi.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    gi.set_defaults(fn=cmd_generate_image)

    ti = sub.add_parser("train-image",
                        help="image-generation training (json dataset, "
                             "condition dropout, velocity target) on one "
                             "device")
    ti.add_argument("--json_file", type=str, required=True,
                    help="json/jsonl of instruction/input_images/"
                         "output_image records")
    ti.add_argument("--image_root", type=str, default=None)
    ti.add_argument("--tokenizer", type=str, default=None)
    ti.add_argument("--height", type=int, default=512)
    ti.add_argument("--width", type=int, default=512)
    ti.add_argument("--input_height", type=int, default=None)
    ti.add_argument("--input_width", type=int, default=None)
    ti.add_argument("--condition_dropout_prob", type=float, default=0.1)
    ti.add_argument("--max_input_images", type=int, default=3)
    ti.add_argument("--max_input_length_limit", type=int, default=18000)
    ti.add_argument("--batch_size_per_device", type=int, default=1)
    ti.add_argument("--lr", type=float, default=1e-4)
    ti.add_argument("--max_steps", type=int, default=100000)
    ti.add_argument("--num_workers", type=int, default=1,
                    help="batch-building worker threads")
    ti.add_argument("--prefetch_depth", type=int, default=2)
    ti.add_argument("--results_dir", type=str, default="results_image")
    ti.add_argument("--log_every", type=int, default=100)
    ti.add_argument("--ckpt_every", type=int, default=1000)
    ti.add_argument("--mixed_precision", default="bf16",
                    choices=["bf16", "no"],
                    help="bf16 compute over fp32 parameters; 'no' "
                         "trains in fp32 end to end (the fp32 "
                         "attention kernels on CUDA)")
    ti.add_argument("--use_ema", action="store_true")
    ti.add_argument("--no_auto_resume", action="store_true")
    ti.add_argument("--vae_ckpt", type=str, default=None)
    ti.add_argument("--tiny_model", action="store_true")
    ti.add_argument("--seed", type=int, default=0)
    ti.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ti.add_argument("--offload_optimizer", action="store_true",
                    help="host-offloaded AdamW (see `train`)")
    ti.add_argument("--offload_grad_splits", type=int, default=1)
    _add_mesh_args(ti)
    ti.add_argument("--report_to", default="none",
                    choices=["none", "tensorboard"])
    ti.set_defaults(fn=cmd_train_image)


def _add_export_parser(sub) -> None:
    e = sub.add_parser("export", help="a training run's checkpoint -> the "
                                      "reference's safetensors")
    e.add_argument("--checkpoint_dir", type=str, required=True)
    e.add_argument("--output", type=str, default="model.safetensors")
    e.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    e.add_argument("--ema", action="store_true",
                   help="export the EMA weights")
    e.add_argument("--input_head", action="store_true",
                   help="the run trained with --input_output_return")
    e.add_argument("--tiny_model", action="store_true")
    e.set_defaults(fn=cmd_export)


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
