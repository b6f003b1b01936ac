"""LoRA fine-tuning of ``qkv_proj`` / ``o_proj``.

Port of ``video_gpt_tpu/training/lora.py`` (the reference's peft wrapper,
rank-8 adapters on ``qkv_proj`` / ``o_proj``). The adapters live in the
model (``models.phi3.LoraLinear`` at ``ModelConfig.lora_rank > 0``), named
in peft's torch layout: ``...qkv_proj.lora_A.weight`` [r, in] and
``...qkv_proj.lora_B.weight`` [out, r]. Training freezes the base
(:func:`freeze_base_`), so only the adapters get gradients and optimizer
state; serving folds them into the base weights (:func:`merge_lora`) and
runs a rank-0 model.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from ..models.phi3 import LoraLinear


def is_adapter(name: str) -> bool:
    """Whether a parameter name is a LoRA adapter's."""
    return ".lora_A." in name or ".lora_B." in name


@torch.no_grad()
def init_lora_(model: nn.Module, generator: torch.Generator,
               whole: nn.Module = None, part=None) -> nn.Module:
    """A ~ N(0, 1) / sqrt(fan_in) and B = 0 in every adapter (``init_lora``:
    the adapted model starts exactly at its base weights).

    A model on a mesh holding parts of the adapters passes ``whole`` (the
    unsharded model, on the meta device) and ``part(name, tensor)`` (this
    rank's part of a whole parameter, its tensor and ZeRO part): every
    rank draws each whole A in the one-rank order and keeps its part, so
    the mesh starts where the one-rank run of ``generator`` starts."""
    mine = dict(model.named_modules())
    for name, module in (whole or model).named_modules():
        if not (isinstance(module, LoraLinear) and module.rank):
            continue
        dst = mine[name]
        a = module.lora_A.weight
        if whole is not None:
            a = torch.empty(a.shape, device=dst.lora_A.weight.device)
        a.normal_(0.0, 1.0, generator=generator)
        a.div_(module.in_features ** 0.5)
        if whole is not None:
            dst.lora_A.weight.copy_(part(name + ".lora_A.weight", a))
        dst.lora_B.weight.zero_()
    return model


def freeze_base_(model: nn.Module) -> nn.Module:
    """Only the adapters require a gradient."""
    for name, p in model.named_parameters():
        p.requires_grad_(is_adapter(name))
    return model


def lora_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The adapter entries of the model's state dict."""
    return {n: t for n, t in model.state_dict().items() if is_adapter(n)}


@torch.no_grad()
def merge_lora(state_dict: Mapping[str, torch.Tensor],
               adapters: Mapping[str, torch.Tensor],
               alpha: float = 8.0) -> Dict[str, torch.Tensor]:
    """``state_dict`` (a rank-0 model's) with the adapters folded in:
    W + (alpha / r) (A^T B^T)^T = W + (alpha / r) B A per adapted weight,
    formed in fp32 and cast to W's dtype on W's device (``merge_lora`` /
    ``LVMPipeline.merge_lora``). The other entries are passed through."""
    out = dict(state_dict)
    for name in adapters:
        if not name.endswith(".lora_A.weight"):
            continue
        layer = name[:-len(".lora_A.weight")]
        w = out[layer + ".weight"]
        a = adapters[name].to(w.device, torch.float32)
        b = adapters[layer + ".lora_B.weight"].to(w.device, torch.float32)
        delta = (b @ a) * (alpha / a.shape[0])
        out[layer + ".weight"] = (w.float() + delta).to(w.dtype)
    return out
