"""Megatron-style tensor parallelism: the fused-column layouts.

Port of ``video_gpt_tpu/parallel/tensor.py`` on the port's state dicts. The
fused projections concatenate their output features in the standard order
[q|k|v] and [gate|up]; a tensor-parallel rank t computes the block
[q_t|k_t|v_t] (its heads) and [gate_t|up_t] (its features), so the
tp-grouped order [A0|B0|C0|A1|B1|C1|...] puts each rank's block in one
contiguous slice. The JAX package regroups a kernel's LAST axis; a torch
``nn.Linear.weight`` is [out, in], so here the fused features are dim 0
(``lora_B.weight`` too). The row-parallel ``o_proj`` / ``down_proj``
contract over head-major rows that are contiguous in either order, so
they are never regrouped.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


# the parameters a tensor rank holds its own part of (Megatron column- and
# row-parallel, and the LoRA adapter on each one's sharded side: the rows
# of qkv_proj's lora_B, the input columns of o_proj's lora_A, as the JAX
# ``param_specs`` shards ``lora_b`` / ``lora_a``); every other parameter is
# replicated over the tensor axis
TP_SHARDED = (".qkv_proj.weight", ".gate_up_proj.weight", ".o_proj.weight",
              ".down_proj.weight", ".qkv_proj.lora_B.weight",
              ".o_proj.lora_A.weight")


def regroup_columns(w: torch.Tensor, sizes: Sequence[int], tp: int,
                    axis: int = 0, inverse: bool = False) -> torch.Tensor:
    """Reorder the concatenated feature groups of ``w`` along ``axis``
    between the standard order [A|B|C] and the tp-grouped order
    [A0|B0|C0|A1|B1|C1|...]; ``sizes`` are the standard-order widths (each
    divisible by ``tp``). ``inverse=True`` undoes it exactly."""
    if tp == 1:
        return w
    if w.shape[axis] != sum(sizes):
        raise ValueError(f"cannot regroup {tuple(w.shape)} along {axis} "
                         f"into {tuple(sizes)}")
    order = tp_order(sizes, tp)
    if inverse:
        order = np.argsort(order)
    return w.index_select(axis, torch.from_numpy(order).to(w.device))


def tp_order(sizes: Sequence[int], tp: int) -> np.ndarray:
    """The standard-order index of each feature in the tp-grouped order;
    its i-th of ``tp`` equal blocks lists tensor rank i's features."""
    if any(s % tp for s in sizes):
        raise ValueError(f"groups {tuple(sizes)} not divisible by {tp}")
    offsets = np.cumsum([0] + list(sizes[:-1]))
    return np.concatenate([
        np.arange(off + i * (s // tp), off + (i + 1) * (s // tp))
        for i in range(tp) for off, s in zip(offsets, sizes)])


def qkv_group_sizes(cfg) -> tuple:
    """Standard fused-qkv feature widths (q, k, v)."""
    d = cfg.head_dim
    return (cfg.num_heads * d, cfg.num_kv_heads * d, cfg.num_kv_heads * d)


def tp_regroup_params(sd: Dict[str, torch.Tensor], cfg, tp: int,
                      inverse: bool = False) -> Dict[str, torch.Tensor]:
    """A state dict between the standard fused layout and the tp-grouped
    one: ``qkv_proj.weight`` and ``qkv_proj.lora_B.weight`` (q, k, v
    groups) and ``gate_up_proj.weight`` (gate, up) are regrouped along dim
    0; every other entry passes through."""
    if tp == 1:
        return dict(sd)
    out = {}
    for name, w in sd.items():
        sizes = fused_group_sizes(name, cfg)
        out[name] = (w if sizes is None
                     else regroup_columns(w, sizes, tp, inverse=inverse))
    return out


def fused_group_sizes(name: str, cfg):
    """The standard-order feature groups along dim 0 of a fused
    column-parallel entry of a state dict (``qkv_proj.weight``,
    ``qkv_proj.lora_B.weight``: q, k, v; ``gate_up_proj.weight``: gate,
    up), else None."""
    if name.endswith((".qkv_proj.weight", ".qkv_proj.lora_B.weight")):
        return qkv_group_sizes(cfg)
    if name.endswith(".gate_up_proj.weight"):
        return (cfg.intermediate_size,) * 2
    return None
