"""Phi-3-style decoder trunk.

Port of ``video_gpt_tpu/models/phi3.py``: RMSNorm, full-dim rotate-half
RoPE with explicit position ids, fused qkv and gate_up projections, SwiGLU
MLP. The layers are a Python loop (``nn.ModuleList``) named like the
reference's torch model, so its state dict loads by name. ``qkv_proj`` and
``o_proj`` are :class:`LoraLinear`: ``nn.Linear`` itself at
``cfg.lora_rank`` 0, with in-module adapters above it.

With ``cfg.remat`` each layer is recomputed in the backward
(``torch.utils.checkpoint``), the counterpart of the JAX package's
``nn.remat``.

The KV cache is heads-major [num_layers, B, H_kv, L_ctx, head_dim], the
layout the decode kernels read; unlike the TPU package it carries no
96->128 lane pad. A cached call goes through ``attend_cached``: with a
columnar DecodeMask the cache and the tail are separate operands of K1,
with a precomputed bias (or none) they are concatenated along the keys.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..ops.attention import AttnMeta, attend, attend_cached


class KVCache(NamedTuple):
    """Stacked per-layer keys/values [num_layers, B, H_kv, L_ctx, D]."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def length(self) -> int:
        return self.k.shape[3]


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        # HF ordering: normalise in fp32, cast back, then scale
        return xf.to(x.dtype) * self.weight.to(x.dtype)


def rope_tables(pos_ids: torch.Tensor, head_dim: int, theta: float,
                dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [B, L, head_dim] for explicit (shared) position ids."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=pos_ids.device)
                                / head_dim))
    freqs = pos_ids.float()[..., None] * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, L, H, D]; cos/sin: [B, L, D] (rotate-half convention)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None, :] + rotated * sin[:, :, None, :]


class LoraLinear(nn.Linear):
    """Bias-free linear layer with optional in-module LoRA adapters, the
    counterpart of the JAX package's ``LoraDense``:
    y = x W^T + (alpha / rank) (x A^T) B^T, with ``lora_A.weight`` [rank,
    in] and ``lora_B.weight`` [out, rank] (peft's layout). The adapters
    act inside the layer, so a frozen-base fine-tune computes gradients
    for them alone. At rank 0 the module is ``nn.Linear`` name for name,
    so checkpoints of a rank-0 model load unchanged."""

    def __init__(self, in_features: int, out_features: int, rank: int = 0,
                 alpha: float = 8.0, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=dtype)
        self.rank = rank
        self.scaling = alpha / rank if rank else 0.0
        if rank:
            kw = dict(bias=False, device=device, dtype=dtype)
            self.lora_A = nn.Linear(in_features, rank, **kw)
            self.lora_B = nn.Linear(rank, out_features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight)
        if self.rank:
            y = y + self.lora_B(self.lora_A(x)) * self.scaling
        return y


class Phi3Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        kw = dict(rank=cfg.lora_rank, alpha=cfg.lora_alpha, device=device,
                  dtype=dtype)
        self.qkv_proj = LoraLinear(cfg.hidden_size, (h + 2 * hkv) * d, **kw)
        self.o_proj = LoraLinear(h * d, cfg.hidden_size, **kw)

    def forward(self, x, cos, sin, q_meta: AttnMeta, k_meta: AttnMeta,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                bias=None):
        """Returns (output, (k, v) of these tokens [B, L, Hkv, D])."""
        cfg = self.cfg
        h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        b, l, _ = x.shape
        q, k, v = self.qkv_proj(x).split([h * d, hkv * d, hkv * d], dim=-1)
        q = apply_rope(q.view(b, l, h, d), cos, sin)
        k = apply_rope(k.view(b, l, hkv, d), cos, sin)
        v = v.view(b, l, hkv, d)
        if cache is not None:
            out = attend_cached(q, cache[0], cache[1], k.transpose(1, 2),
                                v.transpose(1, 2), q_meta, k_meta, bias)
        else:
            out = attend(q, k, v, q_meta, k_meta, bias=bias)
        return self.o_proj(out.reshape(b, l, h * d)), (k, v)


class Phi3Mlp(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_up_proj = nn.Linear(cfg.hidden_size,
                                      2 * cfg.intermediate_size, **kw)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                   **kw)

    def forward(self, x):
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


class Phi3Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       **kw)
        self.self_attn = Phi3Attention(cfg, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, **kw)
        self.mlp = Phi3Mlp(cfg, **kw)

    def forward(self, x, cos, sin, q_meta, k_meta, cache, bias):
        attn_out, new_kv = self.self_attn(self.input_layernorm(x), cos, sin,
                                          q_meta, k_meta, cache, bias)
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_kv


class Phi3Decoder(nn.Module):
    """Decoder trunk with the token embedding (``llm.embed_tokens``)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.layers = nn.ModuleList(Phi3Layer(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)

    def forward(self, inputs_embeds: torch.Tensor, pos_ids: torch.Tensor,
                q_meta: AttnMeta, k_meta: AttnMeta,
                cache: Optional[KVCache] = None, bias=None,
                return_kv: bool = False
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """Final-norm hidden states, and with ``return_kv`` the new tokens'
        keys/values as a heads-major :class:`KVCache`."""
        cfg = self.cfg
        cos, sin = rope_tables(pos_ids, cfg.head_dim, cfg.rope_theta,
                               inputs_embeds.dtype)
        x = inputs_embeds
        kv = None
        if return_kv:
            b, l, _ = x.shape
            shape = (cfg.num_layers, b, cfg.num_kv_heads, l, cfg.head_dim)
            kv = KVCache(x.new_empty(shape), x.new_empty(shape))
        remat = cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            layer_cache = None
            if cache is not None and cache.length > 0:
                layer_cache = (cache.k[i], cache.v[i])
            args = (x, cos, sin, q_meta, k_meta, layer_cache, bias)
            if remat:
                # keep only the layer's input; the backward runs the layer
                # again (the JAX package's nn.remat, nothing_saveable). The
                # layer-invariant inputs (cos/sin, metadata, bias) are
                # passed by reference, never copied per layer.
                x, (k, v) = checkpoint(layer, *args, use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                x, (k, v) = layer(*args)
            if kv is not None:
                kv.k[i].copy_(k.transpose(1, 2))
                kv.v[i].copy_(v.transpose(1, 2))
        return self.norm(x), kv
