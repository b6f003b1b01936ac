"""The program's configuration objects, filled from a configuration file.

The port is imported here, inside functions, so that the benchmark's own
modules (the reference, the yardstick, the tests of both) load without it.
"""
from __future__ import annotations

import numpy as np
import torch

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def model_config(config: dict):
    from video_gpt_tpu_torch.config import ModelConfig
    m = config["model"]
    return ModelConfig(
        hidden_size=m["hidden_size"], num_layers=m["num_hidden_layers"],
        num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"],
        intermediate_size=m["intermediate_size"],
        vocab_size=m["vocab_size"], rope_theta=m["rope_theta"],
        rms_norm_eps=m["rms_norm_eps"], patch_size=m["patch_size"],
        in_channels=m["in_channels"], pe_interpolation=m["pe_interpolation"],
        pos_embed_max_size=m["pos_embed_max_size"],
        freq_embed_size=m["freq_embed_size"],
        precompute_bias_limit=m["precompute_bias_limit"])


def vae_config(config: dict):
    from video_gpt_tpu_torch.models.vae import VAEConfig
    v = config["vae"]
    return VAEConfig(
        in_channels=v["in_channels"], out_channels=v["out_channels"],
        latent_channels=v["latent_channels"],
        block_out_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"],
        norm_num_groups=v["norm_num_groups"],
        scaling_factor=v["scaling_factor"])


def step_generator_seed(seed: int, step: int) -> int:
    """The seed of a trainer's generator for step ``step``, the rule the
    trainers document: every random number of a step (the VAE's posterior
    draws, then the loss's) comes from one generator seeded from (seed,
    step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
