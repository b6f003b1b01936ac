"""Video-GPT pretraining on the AFMoE trunk: ``Trainer.train_step`` on one
stage's clips, as ``train_video`` drives the Phi-3 cells, with the AFMoE
configuration, reference and yardstick.

The configuration file holds the published trunk's keys at its top level
and the DiT wrapper's under ``model`` (a trunk key given there too takes
the top-level one's place). The traffic and the comparison are
``train_video``'s; the reference is ``reference/afmoe.py`` and the
yardstick ``flops_afmoe.py``.
"""
from __future__ import annotations

import gc
import time
from typing import List

import torch

from bench_port import flops_afmoe
from bench_port.drivers.train_video import VideoTrainCell
from bench_port.harness import program, weights
from bench_port.harness.training import opt_config, program_dtype
from bench_port.reference import afmoe as ref
from bench_port.reference import model as ref_model
from bench_port.reference.layout import RowSpec, build_layout

# the published keys the program's AFMoE trunk computes as they are
FIXED = {"model_type": "afmoe", "hidden_act": "silu", "score_func": "sigmoid",
         "route_norm": True, "n_group": 1, "topk_group": 1,
         "num_expert_groups": 1, "num_limited_groups": 1}


def arch_of(config: dict) -> dict:
    """The flat architecture of a configuration file: its top-level keys,
    then those under ``model``; ``layer_types`` cut to the layers run."""
    arch = {k: v for k, v in config.items() if not isinstance(v, dict)}
    arch.update(config["model"])
    arch["layer_types"] = list(arch["layer_types"][:arch[
        "num_hidden_layers"]])
    for key, want in FIXED.items():
        if arch.get(key) != want:
            raise ValueError(f"the AFMoE trunk computes {key} = {want!r}, "
                             f"the configuration says {arch.get(key)!r}")
    return arch


def model_config(arch: dict):
    """The program's ModelConfig of an AFMoE architecture."""
    from video_gpt_tpu_torch.config import ModelConfig
    return ModelConfig(
        trunk="afmoe", hidden_size=arch["hidden_size"],
        num_layers=arch["num_hidden_layers"],
        num_heads=arch["num_attention_heads"],
        num_kv_heads=arch["num_key_value_heads"],
        attn_head_dim=arch["head_dim"],
        intermediate_size=arch["intermediate_size"],
        vocab_size=arch["vocab_size"], rope_theta=float(arch["rope_theta"]),
        rms_norm_eps=arch["rms_norm_eps"], patch_size=arch["patch_size"],
        in_channels=arch["in_channels"],
        pe_interpolation=arch["pe_interpolation"],
        pos_embed_max_size=arch["pos_embed_max_size"],
        freq_embed_size=arch["freq_embed_size"],
        precompute_bias_limit=arch["precompute_bias_limit"],
        num_dense_layers=arch["num_dense_layers"],
        moe_intermediate_size=arch["moe_intermediate_size"],
        num_experts=arch["num_experts"],
        num_experts_per_tok=arch["num_experts_per_tok"],
        num_shared_experts=arch["num_shared_experts"],
        route_scale=arch["route_scale"],
        sliding_window=arch["sliding_window"],
        layer_types=tuple(arch["layer_types"]),
        mup_enabled=arch["mup_enabled"])


class AfmoeTrainCell(VideoTrainCell):
    """The training cell of ``train_video`` on the AFMoE trunk: its own
    construction (the architecture, parameters and yardstick of the AFMoE
    trunk) and reference; the window, the traffic and the comparison are
    ``TrainCell``'s."""

    def __init__(self, ctx, with_program: bool = True):
        self.ctx = ctx
        self.device = ctx.device
        self.arch = arch_of(ctx.config)
        self.vae = ctx.config["vae"]
        self.specs = ref.param_specs(self.arch)
        self.ref_names = [s.name for s in self.specs]
        self.opt = opt_config(ctx.cell, self.target)
        self.compute_dtype = program_dtype(ctx.traffic["mixed_precision"])
        self.setup_traffic()
        if not with_program:
            return
        sd = weights.draw(self.specs + ref.buffer_specs(self.arch), ctx.seed,
                          "model", self.device, torch.float32)
        vsd = weights.draw(ref_model.vae_param_specs(self.vae), ctx.seed,
                           "vae", self.device, torch.float32)
        self.trainer = self.make_trainer(sd, vsd)
        self.state = self.trainer.build()
        sd.clear()
        vsd.clear()
        ctx.mark("weights drawn, trainer built")
        self.names = [n for n, _ in self.trainer.model.named_parameters()]
        self.step = 0
        self.losses: List[float] = []
        for _ in range(int(ctx.check["steps"])):
            if not self.unit(self.step):
                break
            ctx.mark(f"set-up step {self.step}")
            if self.step == 1:
                b1 = self.state.optimizer.cfg.adam_beta1
                self.first_grad = {
                    n: float(torch.linalg.vector_norm(m.double())) / (1 - b1)
                    for n, m in zip(self.names, self.state.optimizer.mu)}
        self.check_losses = list(self.losses)
        self.change = self.change_norms(dict(
            self.trainer.model.named_parameters()))
        ctx.log(f"set-up steps: losses {self.check_losses}")

    def setup_traffic(self):
        t = self.ctx.traffic
        self.frames, self.rows = t["frames"], t["rows"]
        self.hw = (t["height"], t["width"])
        self.blocks = tuple(t["frame_blocks"])
        self.n_img = (self.hw[0] // 16) * (self.hw[1] // 16)
        self.layout = build_layout(
            [RowSpec(self.blocks, "training")] * self.rows, self.n_img,
            pad_to=2 * self.frames * (self.n_img + 2))
        self.work = flops_afmoe.train_step(
            self.arch, self.layout, self.n_img, self.layout.num_clean_frames,
            self.device)
        self.tokens = self.work["tokens"]

    def make_trainer(self, sd, vsd):
        from video_gpt_tpu_torch.config import stage_config
        from video_gpt_tpu_torch.data.video import ClipSample
        from video_gpt_tpu_torch.training.data import collate
        from video_gpt_tpu_torch.training.trainer import Trainer
        import numpy as np
        t = self.ctx.traffic
        o = t["optimizer"]
        tcfg = stage_config(
            t["stage"], frame_num=self.frames, batch_size_per_device=self.rows,
            lr=o["lr"], lr_scheduler="constant", adam_beta1=o["beta1"],
            adam_beta2=o["beta2"], adam_epsilon=o["eps"],
            adam_weight_decay=o["weight_decay"],
            max_grad_norm=o["max_grad_norm"], input_noise=o["input_noise"],
            mixed_precision=t["mixed_precision"])
        trainer = Trainer(model_config(self.arch), tcfg, None,
                          program.vae_config(self.ctx.config),
                          vae_state_dict=vsd, init_state_dict=sd,
                          target_resolution=self.hw, device=self.device,
                          seed=self.ctx.seed)
        dummy = np.zeros((self.frames, 1, 1, 3), np.float32)
        self.template = collate([ClipSample(dummy, self.blocks)] * self.rows,
                                self.n_img).to(self.device)
        return trainer

    def reference_readings(self, prec_mode: str, rows_kept: int = 0):
        """(losses, first gradients, changes) of the AFMoE reference's
        steps in ``prec_mode``."""
        if rows_kept:
            raise ValueError("the AFMoE cells run one row")
        P = weights.draw(self.specs + ref.buffer_specs(self.arch),
                         self.ctx.seed, "model", self.device, torch.float32)
        V = weights.draw(ref_model.vae_param_specs(self.vae), self.ctx.seed,
                         "vae", self.device, torch.float32)
        prec = ref_model.Precision(prec_mode)
        n = int(self.ctx.check["steps"])
        data = [self.reference_step(k, V, prec) for k in range(n)]
        t0 = time.perf_counter()
        losses, first = ref.train_steps(P, self.ref_names, self.arch, prec,
                                        data, self.opt)
        self.ctx.log(f"reference ({prec_mode}) {n} steps "
                     f"{time.perf_counter() - t0:.1f} s: losses {losses}")
        change = self.change_norms(P)
        del P, V
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return losses, first, change


def build(ctx, with_program: bool = True):
    return AfmoeTrainCell(ctx, with_program)
