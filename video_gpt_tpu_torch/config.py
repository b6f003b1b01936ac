"""Model, sampler, mesh and training configuration.

Port of ``video_gpt_tpu/config.py``: the serving fields, the mesh
(``MeshConfig``; the model reads its sharding off the mesh it is built
on, and its sequence-parallel attention off ``ModelConfig.sp_attention``),
and the training fields with the LoRA, distillation, aux input-head
(``input_output_return``), ring and GPipe recipes, and the host-offloaded
AdamW (``offload_optimizer``, ``training/offload.py``);
:func:`check_train_config` raises on the combinations the JAX trainer
refuses.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .tokens import DEFAULT_TOKEN_IDS, TokenIds


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """DiT-over-Phi3 next-clip diffusion model. Defaults are the reference
    width: Phi-3-mini class trunk (hidden 3072, 32 layers, 32 heads of 96),
    patch 2 over 4 latent channels."""

    # backbone (Phi-3 style decoder)
    hidden_size: int = 3072
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 8192
    vocab_size: int = 32064
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    # DiT wrapper
    patch_size: int = 2
    in_channels: int = 4
    pe_interpolation: float = 1.0
    pos_embed_max_size: int = 192
    freq_embed_size: int = 256
    # execution
    remat: bool = False  # recompute each decoder layer in the backward
    # sequence-parallel attention over a mesh's seq axis: 'ulysses' (the
    # all_to_all over seq, parallel/ulysses.py) or 'ring' (K/V chunks hop
    # around the seq group, parallel/ring.py; cached calls stay on
    # Ulysses). 'none', the default, is read as 'ulysses' on a seq mesh:
    # the port has no partitioner to choose
    sp_attention: str = "none"
    # precompute the attention bias once per forward (shared by all layers)
    # when B*Lq*Lk is at most this many elements; beyond it the mask is
    # evaluated in-kernel from the token metadata (K6 forward, K7 backward)
    precompute_bias_limit: int = 256_000_000
    # in-model LoRA on qkv_proj / o_proj: rank 0 = off; the adapters add
    # (lora_alpha / lora_rank) * (x A) B to the layer's output
    lora_rank: int = 0
    lora_alpha: float = 8.0
    token_ids: TokenIds = DEFAULT_TOKEN_IDS
    # the trunk: "phi3" (models/phi3.py) or "afmoe" (models/afmoe.py: the
    # AFMoE block of Arcee's Trinity models, the fields below)
    trunk: str = "phi3"
    # the attention heads' width; 0: hidden_size / num_heads (Phi-3)
    attn_head_dim: int = 0
    # AFMoE: the first num_dense_layers layers run a SwiGLU MLP of
    # intermediate_size, the others a layer of num_experts routed SwiGLU
    # experts of moe_intermediate_size (top num_experts_per_tok by sigmoid
    # score, normalised, times route_scale) plus num_shared_experts shared
    # ones; layer_types[i] is "sliding_attention" (a window of
    # sliding_window positions, RoPE) or "full_attention" (no positional
    # encoding); mup_enabled scales the trunk's input by sqrt(hidden_size)
    num_dense_layers: int = 0
    moe_intermediate_size: int = 0
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    route_scale: float = 1.0
    sliding_window: int = 0
    layer_types: Tuple[str, ...] = ()
    mup_enabled: bool = False

    @property
    def head_dim(self) -> int:
        return self.attn_head_dim or self.hidden_size // self.num_heads

    def window(self, layer: int) -> int:
        """The attention window of ``layer`` in positions (0: none)."""
        if self.trunk == "afmoe" and \
                self.layer_types[layer] == "sliding_attention":
            return self.sliding_window
        return 0

    @classmethod
    def tiny(cls, **kw) -> "ModelConfig":
        """Small config for tests (same widths as the JAX package's)."""
        d = dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4,
                 intermediate_size=128, vocab_size=32064,
                 pos_embed_max_size=16)
        d.update(kw)
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Flow-matching Euler sampler.

    ``cfg_interval=(lo, hi)`` applies guidance only where sigma is in
    ``[lo, hi)`` and skips the unconditional evaluation elsewhere;
    ``uncond_refresh=k`` evaluates the unconditional context every k-th
    guided step and reuses its last prediction in between. The defaults
    (None, 1) are the reference semantics."""

    num_steps: int = 50
    time_shifting_factor: float = 1.0
    prediction_type: str = "x1"  # 'x1' | 'v'
    begin_time: Optional[float] = None
    cfg_interval: Optional[Tuple[float, float]] = None
    uncond_refresh: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process grid: data x sequence x tensor x pipe axes, one process per
    rank (``parallel/mesh.py``). The optimizer state is always sharded over
    ``data`` (ZeRO-1/2); ``zero_params`` (ZeRO-3) shards the parameters and
    the EMA over it too, gathered a layer at a time where they are used;
    ``pipe`` stages the layer stack (GPipe, ``parallel/pipeline.py``).
    ``pipe`` comes last so that positional (data, seq, tensor, zero_params)
    stay as they were."""

    data: int = 1
    seq: int = 1
    tensor: int = 1
    zero_params: bool = False
    pipe: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.seq * self.tensor * self.pipe


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Stage-1..4 training recipes (the single-device fields of the JAX
    package's ``TrainConfig``, with its defaults)."""

    # data
    frame_num: int = 16
    frame_interval: int = 4
    flexible_interval: bool = False
    interval_bound: Optional[int] = None
    frame_block_scheme: str = "interleaved"  # 'interleaved' | 'frame_block'
    max_input_length_limit: int = 18000
    batch_size_per_device: int = 1
    # optimisation
    lr: float = 1e-4
    lr_scheduler: str = "constant_with_warmup"
    lr_warmup_steps: int = 1000
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_weight_decay: float = 0.1
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    mixed_precision: str = "bf16"  # 'bf16' | 'no'
    gradient_checkpointing: bool = True
    # sequence parallelism over the mesh's seq axis: 'ulysses' | 'ring'
    sp_attention: str = "ulysses"
    # GPipe microbatches per step over the pipe axis (0: one per stage)
    pp_microbatches: int = 0
    # loss
    input_noise: float = 0.9
    cls_weight: Optional[float] = None
    input_output_return: bool = False
    # EMA / LoRA
    use_ema: bool = False
    ema_decay: float = 0.9999
    use_lora: bool = False
    lora_rank: int = 8
    # progressive step- and guidance distillation (training/distill.py):
    # the student learns to serve at `distill_student_steps` Euler steps
    # from a frozen teacher's `distill_substeps`-step rollouts; with
    # `distill_guidance` w the teacher's target is the guided
    # uncond + w (cond - uncond), so the student serves without an uncond
    # row. `distill_lr` replaces `lr` in the distillation optimizer (None
    # inherits `lr`); `distill_loss_weight` is 'uniform' or 'endpoint'.
    distill: bool = False
    distill_student_steps: int = 5
    distill_substeps: int = 2
    distill_time_shift: float = 1.0
    distill_input_noise: float = 1.0
    distill_lr: Optional[float] = 1e-4
    distill_loss_weight: str = "uniform"
    distill_guidance: Optional[float] = None
    # AdamW with its fp32 master, mu and nu in host memory and the update
    # on the host CPU (training/offload.py); the gradients in
    # `offload_grad_splits` backward passes over groups of the parameters
    offload_optimizer: bool = False
    offload_grad_splits: int = 1
    # data loading (worker threads feeding the Prefetcher)
    num_workers: int = 1
    prefetch_depth: int = 2
    # run control
    max_steps: Optional[int] = None  # the cosine decay horizon
    log_every: int = 100
    ckpt_every: int = 20000
    auto_resume: bool = True
    results_dir: str = "results"


def check_train_config(cfg: TrainConfig) -> None:
    """Raise (ValueError, with its messages) on the combinations the JAX
    trainer refuses; the offload optimizer on a mesh is refused by the
    trainers, which know the mesh."""
    if not cfg.distill and cfg.distill_guidance is not None:
        raise ValueError("--distill_guidance is a distillation knob; "
                         "pass --distill with it")
    if cfg.distill and cfg.use_lora:
        raise ValueError("distillation trains the full student; "
                         "it does not compose with --use_lora")
    if cfg.distill and cfg.input_output_return:
        raise ValueError("distillation regresses the denoise head only; "
                         "input_output_return is a pretraining option")
    if cfg.offload_grad_splits < 1:
        raise ValueError(
            f"grad_splits must be >= 1, got {cfg.offload_grad_splits}")
    if not cfg.offload_optimizer:
        return
    if cfg.distill:
        raise ValueError("distillation holds teacher+student trees; "
                         "it does not compose with the single-chip "
                         "offload path — use ZeRO over a mesh")
    if cfg.use_lora:
        raise ValueError("offload_optimizer is for full-parameter "
                         "training; LoRA state fits HBM directly")
    if cfg.use_ema:
        raise ValueError("offload_optimizer does not support EMA "
                         "(neither does the reference's offload recipe)")
    if cfg.gradient_accumulation_steps > 1:
        raise ValueError("offload step does not support MultiSteps")


def stage_config(stage: int, **overrides) -> TrainConfig:
    """The 4-stage curriculum (``configs/pretrain_stage{1..4}.sh``)."""
    base = {
        1: dict(frame_num=16, frame_interval=4,
                frame_block_scheme="interleaved"),
        2: dict(frame_num=48, frame_interval=4,
                frame_block_scheme="frame_block", ckpt_every=1000),
        3: dict(frame_num=48, frame_interval=4, flexible_interval=True,
                interval_bound=12, frame_block_scheme="frame_block",
                ckpt_every=1000),
        4: dict(frame_num=80, frame_interval=4, flexible_interval=True,
                interval_bound=12, frame_block_scheme="frame_block",
                max_input_length_limit=1_280_000, ckpt_every=1000),
    }[stage]
    base.update(overrides)
    return TrainConfig(**base)
