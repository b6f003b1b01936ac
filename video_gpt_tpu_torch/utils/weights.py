"""Weight bridge: JAX/Flax parameter trees (as numpy) -> torch state dicts.

``videogpt_state_dict_from_jax`` emits the reference torch model's names
(``llm.layers.{i}.self_attn.qkv_proj.weight``, ...), the same mapping as
``video_gpt_tpu/utils/torch_export.py``; ``vae_state_dict_from_jax`` emits
diffusers AutoencoderKL names, the inverse of
``video_gpt_tpu/models/vae.py:vae_params_from_diffusers``;
``lora_state_dict_from_jax`` unstacks LoRA adapters into peft's names;
``offload_state_from_jax`` carries a JAX offload optimizer's state. The port's
modules carry these names, so both load with ``strict=True``. Pure numpy
on the input side: pass ``jax.device_get(params)`` or any nested mapping of
arrays. :func:`tp_shard_state_dict` cuts a standard-layout state dict into
tensor rank t's part, which a model built on a (tensor T) mesh loads
(``videogpt_state_dict_from_jax(..., tp_shard=(T, t))`` does both), and
:func:`tp_unshard` puts the parts back together;
:func:`zero_shard_state_dict` cuts one into data rank i's ZeRO part (a
warm start onto a ZeRO-3 mesh).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..models.vae import VAEConfig
from ..parallel.mesh import zero_dim
from ..parallel.tensor import fused_group_sizes, regroup_columns, tp_order


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _unwrap(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def videogpt_state_dict_from_jax(params: Mapping, cfg: ModelConfig,
                                 tp_shard: Optional[Tuple[int, int]] = None
                                 ) -> Dict[str, torch.Tensor]:
    """Flax VideoGPT params (the standard fused layout, unsharded) ->
    reference torch state dict (float32); with
    ``tp_shard=(T, t)``, tensor rank t's part of it
    (:func:`tp_shard_state_dict`)."""
    p = _unwrap(params)
    sd: Dict[str, torch.Tensor] = {}

    def dense(dst, node):
        sd[dst + ".weight"] = _t(np.asarray(node["kernel"]).T)
        if "bias" in node:
            sd[dst + ".bias"] = _t(node["bias"])

    def conv_from_dense(dst, node):
        k = np.asarray(node["kernel"], np.float32)  # [(p, p, C), D]
        sd[dst + ".weight"] = _t(k.reshape(
            cfg.patch_size, cfg.patch_size, cfg.in_channels,
            k.shape[-1]).transpose(3, 2, 0, 1))
        sd[dst + ".bias"] = _t(node["bias"])

    conv_from_dense("x_embedder.proj", p["x_embedder"]["proj"])
    conv_from_dense("input_x_embedder.proj", p["input_x_embedder"]["proj"])
    for name in ("time_token", "t_embedder"):
        dense(f"{name}.mlp.0", p[name]["fc1"])
        dense(f"{name}.mlp.2", p[name]["fc2"])
    dense("final_layer.adaLN_modulation.1",
          p["final_layer"]["adaLN_modulation"])
    dense("final_layer.linear", p["final_layer"]["linear"])
    if "input_final_layer" in p:  # a model with the aux input head
        dense("input_final_layer", p["input_final_layer"])

    sd["llm.embed_tokens.weight"] = _t(p["embed_tokens"]["embedding"])
    layers = p["llm"]["layers"]
    for i in range(cfg.num_layers):
        base = f"llm.layers.{i}."
        for mod, name in (("self_attn", "qkv_proj"), ("self_attn", "o_proj"),
                          ("mlp", "gate_up_proj"), ("mlp", "down_proj")):
            sd[f"{base}{mod}.{name}.weight"] = _t(
                np.asarray(layers[mod][name]["kernel"][i]).T)
        for name in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{base}{name}.weight"] = _t(layers[name]["weight"][i])
    sd["llm.norm.weight"] = _t(p["llm"]["norm"]["weight"])
    return sd if tp_shard is None else tp_shard_state_dict(sd, cfg, *tp_shard)


def offload_state_from_jax(ostate, cfg: ModelConfig) -> dict:
    """A JAX ``OffloadState`` (``video_gpt_tpu/training/offload.py``: the
    count, and mu, nu and the master as parameter trees whose leaves are
    tuples of axis-0 chunks) -> the state dict of the port's
    ``training.offload.OffloadState``: each leaf's chunks concatenated and
    named as :func:`videogpt_state_dict_from_jax` names the parameters."""
    def whole(tree):
        if isinstance(tree, Mapping):
            return {k: whole(v) for k, v in tree.items()}
        return np.concatenate([np.asarray(c, np.float32) for c in tree],
                              axis=0)

    sd = {"count": int(np.asarray(ostate.count))}
    for field in ("mu", "nu", "master"):
        sd[field] = videogpt_state_dict_from_jax(
            whole(getattr(ostate, field)), cfg)
    return sd


# row-parallel weights: [out, in] with the contraction (in) over the ranks
_ROW_PARALLEL = ("o_proj.weight", "o_proj.lora_A.weight", "down_proj.weight")


def tp_shard_state_dict(sd: Mapping[str, torch.Tensor], cfg: ModelConfig,
                        tp: int, rank: int) -> Dict[str, torch.Tensor]:
    """Tensor rank ``rank``'s part of a standard-layout state dict over
    ``tp`` ranks (Megatron column/row parallel, :func:`tp_shard`); every
    entry but the four projections is replicated. A LoRA model is merged
    before it is sharded."""
    return {name: tp_shard(name, w, cfg, tp, rank) for name, w in sd.items()}


def tp_shard(name: str, w: torch.Tensor, cfg: ModelConfig, tp: int,
             rank: int) -> torch.Tensor:
    """Tensor rank ``rank``'s part of the standard-layout entry ``name``:
    the rows of ``qkv_proj.weight`` for its [q_t|k_t|v_t] and of
    ``gate_up_proj.weight`` for its [gate_t|up_t] (block t of the
    tp-grouped order), the columns of ``o_proj.weight`` and
    ``down_proj.weight`` for its heads and features; ``w`` itself for any
    other entry."""
    if tp == 1:
        return w
    sizes = fused_group_sizes(name, cfg)
    if sizes is not None:
        rows = tp_order(sizes, tp).reshape(tp, -1)[rank]
        return w.index_select(0, torch.from_numpy(rows).to(w.device))
    if name.endswith(_ROW_PARALLEL):
        return w.chunk(tp, dim=1)[rank]
    return w


def tp_unshard(name: str, parts, cfg: ModelConfig) -> torch.Tensor:
    """The standard-layout entry ``name`` from the tensor ranks' parts of
    it, in rank order (the inverse of :func:`tp_shard`)."""
    tp = len(parts)
    sizes = fused_group_sizes(name, cfg)
    if tp > 1 and sizes is not None:
        return regroup_columns(torch.cat(parts, dim=0), sizes, tp,
                               inverse=True)
    if tp > 1 and name.endswith(_ROW_PARALLEL):
        return torch.cat(parts, dim=1)
    return parts[0]


def unshard(name: str, part, dim: Optional[int], data: int, tensor: int,
            cfg: ModelConfig) -> torch.Tensor:
    """The standard-layout entry ``name`` from a mesh's parts of it:
    ``part(d, t)`` is the part of data rank d and tensor rank t (ZeRO
    parts along ``dim`` over data; None: whole on every data rank), put
    together over data, then over tensor (:func:`tp_unshard`)."""
    pieces = []
    for t in range(tensor):
        parts = [part(d, t) for d in range(data if dim is not None else 1)]
        pieces.append(parts[0] if len(parts) == 1
                      else torch.cat(parts, dim=dim))
    return tp_unshard(name, pieces, cfg)


def zero_shard_state_dict(sd: Mapping[str, torch.Tensor], n: int, rank: int
                          ) -> Dict[str, torch.Tensor]:
    """Data rank ``rank``'s ZeRO part of each entry over ``n`` data ranks
    (``mesh.zero_dim``: the first dimension ``n`` divides; the entry
    itself where none does)."""
    out = {}
    for name, w in sd.items():
        d = zero_dim(w.shape, n)
        out[name] = w if d is None else w.chunk(n, dim=d)[rank]
    return out


def lora_state_dict_from_jax(lora: Mapping, cfg: ModelConfig
                             ) -> Dict[str, torch.Tensor]:
    """JAX LoRA adapters -> the port's adapter entries (float32). ``lora``
    is an adapter tree of ``init_lora`` or a grafted params tree of a
    ``lora_rank > 0`` model: the scanned ``lora_a`` [num_layers, in, r] and
    ``lora_b`` [num_layers, r, out] of ``qkv_proj`` / ``o_proj`` become
    ``llm.layers.{i}.self_attn.{name}.lora_A.weight`` [r, in] and
    ``...lora_B.weight`` [out, r]."""
    attn = _unwrap(lora)["llm"]["layers"]["self_attn"]
    sd: Dict[str, torch.Tensor] = {}
    for name in ("qkv_proj", "o_proj"):
        a, b = np.asarray(attn[name]["lora_a"]), np.asarray(
            attn[name]["lora_b"])
        for i in range(cfg.num_layers):
            base = f"llm.layers.{i}.self_attn.{name}."
            sd[base + "lora_A.weight"] = _t(a[i].T)
            sd[base + "lora_B.weight"] = _t(b[i].T)
    return sd


def vae_state_dict_from_jax(params: Mapping, cfg: VAEConfig = VAEConfig()
                            ) -> Dict[str, torch.Tensor]:
    """Flax AutoencoderKL params -> diffusers AutoencoderKL state dict."""
    p = _unwrap(params)
    enc, dec = p["encoder"], p["decoder"]
    sd: Dict[str, torch.Tensor] = {}

    def conv(dst, node):  # flax [kh, kw, I, O] -> torch [O, I, kh, kw]
        sd[dst + ".weight"] = _t(np.asarray(node["kernel"]).transpose(
            3, 2, 0, 1))
        sd[dst + ".bias"] = _t(node["bias"])

    def dense(dst, node):
        sd[dst + ".weight"] = _t(np.asarray(node["kernel"]).T)
        sd[dst + ".bias"] = _t(node["bias"])

    def norm(dst, node):
        sd[dst + ".weight"] = _t(node["scale"])
        sd[dst + ".bias"] = _t(node["bias"])

    def resnet(dst, node):
        norm(dst + ".norm1", node["norm1"])
        conv(dst + ".conv1", node["conv1"])
        norm(dst + ".norm2", node["norm2"])
        conv(dst + ".conv2", node["conv2"])
        if "conv_shortcut" in node:
            conv(dst + ".conv_shortcut", node["conv_shortcut"])

    def mid(dst, node):
        resnet(dst + ".resnets.0", node["mid_res_0"])
        resnet(dst + ".resnets.1", node["mid_res_1"])
        a = node["mid_attn"]
        att = dst + ".attentions.0"
        norm(att + ".group_norm", a["group_norm"])
        for name in ("to_q", "to_k", "to_v"):
            dense(f"{att}.{name}", a[name])
        dense(att + ".to_out.0", a["to_out"])

    n_blocks = len(cfg.block_out_channels)
    conv("encoder.conv_in", enc["conv_in"])
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                   enc[f"down_{i}_res_{j}"])
        if i < n_blocks - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                 enc[f"down_{i}_conv"])
    mid("encoder.mid_block", enc)
    norm("encoder.conv_norm_out", enc["conv_norm_out"])
    conv("encoder.conv_out", enc["conv_out"])
    conv("quant_conv", enc["quant_conv"])

    conv("post_quant_conv", dec["post_quant_conv"])
    conv("decoder.conv_in", dec["conv_in"])
    mid("decoder.mid_block", dec)
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}",
                   dec[f"up_{i}_res_{j}"])
        if i < n_blocks - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv",
                 dec[f"up_{i}_conv"])
    norm("decoder.conv_norm_out", dec["conv_norm_out"])
    conv("decoder.conv_out", dec["conv_out"])
    return sd
