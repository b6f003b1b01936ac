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

On a mesh (``parallel/mesh.py``, the model built with ``mesh=``) whose
seq axis S or tensor axis T is above 1, the routing of the JAX
``Phi3Attention`` under Ulysses or tensor parallelism: cached calls go
through ``ulysses_attend_cached`` and the others through
``ulysses_attend``. The model reads S and T off the mesh. With T > 1
qkv/gate_up hold the rank's [q_t|k_t|v_t] / [gate_t|up_t] rows and
o_proj/down_proj its columns (``utils.weights.tp_shard_state_dict``);
the input of qkv_proj/gate_up_proj passes Megatron's ``copy_to`` (its
gradient is summed over the tensor group), and the partial products of
o_proj/down_proj stay fp32 through the all-reduce over the tensor group,
autocast or not, and are rounded once after it, as one rank's matmul
rounds its fp32 accumulator once. LoRA adapters follow their projection:
qkv_proj's lora_B holds the rank's rows and o_proj's lora_A its input
columns; each rank-r intermediate is whole on every rank before it enters
lora_B (:func:`column_parallel`, :func:`row_parallel_lora`), so every
adapter's gradient is the whole one. With S > 1 the trunk pads the sequence
to the seq multiple at its entry, each rank runs its contiguous chunk
through the layers, and the chunks are gathered before the final norm;
the KV cache it returns holds the rank's heads (``mesh.cache_heads``) of
the unpadded tokens. Under ``cfg.sp_attention == 'ring'`` an uncached call
goes through ``ring_attend`` instead (K/V chunks hop around the seq group;
cached calls stay on ``ulysses_attend_cached``, as in the JAX package).
On a pipe mesh each rank builds only its stage's block of layers
(``mesh.stage_layers``), under their global names ``llm.layers.{i}``, and
the trunk runs them as a GPipe stage (``parallel.pipeline``); a pipe axis
does not compose with seq or tensor. On a ZeRO-3 mesh
(``MeshConfig.zero_params``) each
layer's parameters rest as this data rank's parts and are all-gathered at
use (``mesh.gather_params``, in autocast's dtype under autocast: the
matmuls would cast them to it anyway), inside the checkpointed layer, so
the recompute gathers them again and no gathered layer outlives its use.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..ops.attention import AttnMeta, attend, attend_cached
from ..parallel.mesh import (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS,
                             axis_size, gather_params, gather_seq, split_seq,
                             stage_layers)
from ..parallel.pipeline import pipeline_trunk
from ..parallel.ring import ring_attend
from ..parallel.ulysses import (pad_to_seq, ulysses_attend,
                                ulysses_attend_cached)


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


def check_mesh(cfg: ModelConfig, mesh) -> None:
    """Raise on a config that the mesh cannot run."""
    tp = axis_size(mesh, TENSOR_AXIS)
    if axis_size(mesh, PIPE_AXIS) > 1 and (
            tp > 1 or axis_size(mesh, SEQ_AXIS) > 1):
        raise ValueError(
            "pipeline parallelism runs the stage body as local math; "
            "combine pp with data parallelism, not tp/sp "
            f"(got tensor_parallel={tp}, sp_attention={cfg.sp_attention!r}, "
            f"seq={axis_size(mesh, SEQ_AXIS)})")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp \
            or cfg.intermediate_size % tp:
        raise ValueError(f"heads {cfg.num_heads}/{cfg.num_kv_heads} and "
                         f"features {cfg.intermediate_size} must divide by "
                         f"the tensor axis {tp}")


def row_parallel(x: torch.Tensor, weight: torch.Tensor, mesh
                 ) -> torch.Tensor:
    """``F.linear(x, weight)`` of a row-parallel layer whose input features
    are split over the tensor axis: the rank's partial product of x and the
    weight in x's dtype, accumulated in fp32 (autocast off: under autocast
    it would be a bf16 product), summed over the tensor group in fp32 and
    rounded once to ``x``'s dtype."""
    with torch.autocast(x.device.type, enabled=False):
        out = F.linear(x.float(), weight.to(x.dtype).float())
    return mesh.reduce_from(out, TENSOR_AXIS).to(x.dtype)


def column_parallel(x: torch.Tensor, layer: LoraLinear, mesh
                    ) -> torch.Tensor:
    """``layer(x)`` of a column-parallel layer whose output features are
    split over the tensor axis: ``x`` enters through ``copy_to`` (its
    gradient summed over the tensor group). The adapters' rank-r product
    x A^T is whole on every rank and enters ``lora_B`` (the rank's rows)
    through ``copy_to`` too, so that A's gradient, and x's through A, is
    the whole one: each rank's B rows see only the rank's outputs."""
    y = F.linear(mesh.copy_to(x, TENSOR_AXIS), layer.weight)
    if layer.rank:
        u = mesh.copy_to(layer.lora_A(x), TENSOR_AXIS)
        y = y + layer.lora_B(u) * layer.scaling
    return y


def row_parallel_lora(x: torch.Tensor, layer: LoraLinear, mesh
                      ) -> torch.Tensor:
    """``layer(x)`` of a row-parallel layer whose input features are split
    over the tensor axis (:func:`row_parallel`). The adapters' rank-r
    product x A^T (A the rank's input columns) is summed over the tensor
    group like the base product before it enters ``lora_B``, so B's
    gradient is the whole one on every rank."""
    y = row_parallel(x, layer.weight, mesh)
    if layer.rank:
        u = row_parallel(x, layer.lora_A.weight, mesh)
        y = y + layer.lora_B(u) * layer.scaling
    return y


class Phi3Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.tp = tp = axis_size(mesh, TENSOR_AXIS)
        sp = axis_size(mesh, SEQ_AXIS)
        self.ulysses = tp * sp > 1
        self.ring = sp > 1 and cfg.sp_attention == "ring"
        h, hkv, d = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim
        kw = dict(rank=cfg.lora_rank, alpha=cfg.lora_alpha, device=device,
                  dtype=dtype)
        self.qkv_proj = LoraLinear(cfg.hidden_size, (h + 2 * hkv) * d, **kw)
        self.o_proj = LoraLinear(h * d, cfg.hidden_size, **kw)

    def forward(self, x, cos, sin, q_meta: AttnMeta, k_meta: AttnMeta,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                bias=None):
        """Returns (output, (k, v)): the keys/values of these tokens
        [B, L, Hkv, D] that this rank holds, its heads over the full
        (padded) length on a mesh."""
        cfg, tp = self.cfg, self.tp
        h, hkv, d = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim
        b, l, _ = x.shape
        qkv = (column_parallel(x, self.qkv_proj, self.mesh) if tp > 1
               else self.qkv_proj(x))
        q, k, v = qkv.split([h * d, hkv * d, hkv * d], dim=-1)
        q = apply_rope(q.view(b, l, h, d), cos, sin)
        k = apply_rope(k.view(b, l, hkv, d), cos, sin)
        v = v.view(b, l, hkv, d)
        if self.ulysses:
            if cache is not None:
                out, kv = ulysses_attend_cached(
                    q, k.transpose(1, 2), v.transpose(1, 2), cache[0],
                    cache[1], q_meta, k_meta, self.mesh, bias)
            elif self.ring:
                if bias is not None:
                    raise ValueError("the ring attends by the metadata: it "
                                     "takes no bias or DecodeMask")
                out, kv = ring_attend(q, k, v, q_meta, k_meta,
                                      self.mesh), (k, v)
            else:
                out, kv = ulysses_attend(q, k, v, q_meta, k_meta, self.mesh,
                                         bias)
        elif cache is not None:
            out, kv = attend_cached(q, cache[0], cache[1], k.transpose(1, 2),
                                    v.transpose(1, 2), q_meta, k_meta,
                                    bias), (k, v)
        else:
            out, kv = attend(q, k, v, q_meta, k_meta, bias=bias), (k, v)
        out = out.reshape(b, l, h * d)
        if tp > 1:
            return row_parallel_lora(out, self.o_proj, self.mesh), kv
        return self.o_proj(out), kv


class Phi3Mlp(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.tp = axis_size(mesh, TENSOR_AXIS)
        kw = dict(bias=False, device=device, dtype=dtype)
        features = cfg.intermediate_size // self.tp
        self.gate_up_proj = nn.Linear(cfg.hidden_size, 2 * features, **kw)
        self.down_proj = nn.Linear(features, cfg.hidden_size, **kw)

    def forward(self, x):
        if self.tp > 1:
            x = self.mesh.copy_to(x, TENSOR_AXIS)
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        act = F.silu(gate) * up
        if self.tp > 1:
            return row_parallel(act, self.down_proj.weight, self.mesh)
        return self.down_proj(act)


class Phi3Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None, mesh=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       **kw)
        self.self_attn = Phi3Attention(cfg, mesh=mesh, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, **kw)
        self.mlp = Phi3Mlp(cfg, mesh=mesh, **kw)

    def forward(self, x, cos, sin, q_meta, k_meta, cache, bias):
        attn_out, new_kv = self.self_attn(self.input_layernorm(x), cos, sin,
                                          q_meta, k_meta, cache, bias)
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_kv


class Phi3Decoder(nn.Module):
    """Decoder trunk with the token embedding (``llm.embed_tokens``). On a
    pipe mesh it holds this rank's stage of the layers, named by their
    global index."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None, mesh=None):
        super().__init__()
        check_mesh(cfg, mesh)
        self.cfg = cfg
        self.mesh = mesh
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.layers = nn.ModuleList()
        for i in stage_layers(mesh, cfg.num_layers):
            self.layers.add_module(str(i), Phi3Layer(cfg, mesh=mesh, **kw))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)

    def forward(self, inputs_embeds: torch.Tensor, pos_ids: torch.Tensor,
                q_meta: AttnMeta, k_meta: AttnMeta,
                cache: Optional[KVCache] = None, bias=None,
                return_kv: bool = False, num_micro: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """Final-norm hidden states, and with ``return_kv`` the new tokens'
        keys/values as a heads-major :class:`KVCache` (on a mesh, of this
        rank's heads). On a pipe mesh the layers run as a GPipe pipeline
        over ``num_micro`` microbatches (``parallel.pipeline``; uncached,
        without a bias)."""
        cfg, mesh = self.cfg, self.mesh
        b, l, _ = inputs_embeds.shape
        if return_kv and cfg.sp_attention == "ring" \
                and axis_size(mesh, SEQ_AXIS) > 1:
            raise ValueError("a prefill under sp_attention='ring' would "
                             "cache chunks, not heads: serve with Ulysses")
        # seq sharding: pad the new tokens to the seq multiple once, here
        # (padded queries are pad rows cropped at the end, padded keys are
        # never visible and never stored), and keep this rank's chunk
        pad, q_meta, k_meta, bias = pad_to_seq(mesh, l, q_meta, k_meta, bias)
        x = inputs_embeds
        if pad:
            x, pos_ids = F.pad(x, (0, 0, 0, pad)), F.pad(pos_ids, (0, pad))
        cos, sin = rope_tables(pos_ids, cfg.head_dim, cfg.rope_theta,
                               inputs_embeds.dtype)
        if axis_size(mesh, PIPE_AXIS) > 1:
            if cache is not None or return_kv or bias is not None:
                raise ValueError("a pipe mesh runs the uncached trunk by the "
                                 "metadata (no cache, no bias)")
            x = pipeline_trunk(self, x, cos, sin, q_meta, k_meta, num_micro)
            return self.norm(x), None
        x, cos, sin = (split_seq(t, mesh) for t in (x, cos, sin))
        kv = None
        if return_kv:
            hkv = cfg.num_kv_heads // (axis_size(mesh, SEQ_AXIS)
                                       * axis_size(mesh, TENSOR_AXIS))
            shape = (cfg.num_layers, b, hkv, l, cfg.head_dim)
            kv = KVCache(x.new_empty(shape), x.new_empty(shape))
        remat = cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            layer_cache = None
            if cache is not None and cache.length > 0:
                layer_cache = (cache.k[i], cache.v[i])
            x, (k, v) = self._run(layer, (x, cos, sin, q_meta, k_meta,
                                          layer_cache, bias), remat)
            if kv is not None:
                kv.k[i].copy_(k[:, :l].transpose(1, 2))
                kv.v[i].copy_(v[:, :l].transpose(1, 2))
        if axis_size(mesh, SEQ_AXIS) > 1:
            x = gather_seq(x, mesh)[:, :l]
        return self.norm(x), kv

    def stage(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
              q_meta: AttnMeta, k_meta: AttnMeta) -> torch.Tensor:
        """This pipe stage's layers on ``x``, uncached and without a bias
        (K6 forward, K7 backward), with no recompute of their own (the
        GPipe schedule recomputes the stage)."""
        for layer in self.layers:
            x, _ = self._run(layer, (x, cos, sin, q_meta, k_meta, None, None),
                             remat=False)
        return x

    def _run(self, layer: nn.Module, args: tuple, remat: bool):
        """One layer's (output, (k, v)): its ZeRO-3 parameters gathered at
        the call, and with ``remat`` recomputed in the backward."""
        mesh = self.mesh
        if mesh is not None and mesh.cfg.zero_params \
                and axis_size(mesh, DATA_AXIS) > 1:
            layer = self._gathered(layer)
        if remat:
            # keep only the layer's input; the backward runs the layer
            # again (the JAX package's nn.remat, nothing_saveable). The
            # layer-invariant inputs (cos/sin, metadata, bias) are passed
            # by reference, never copied per layer.
            return checkpoint(layer, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return layer(*args)

    def _gathered(self, layer: nn.Module):
        """``layer``'s forward on its ZeRO-3 parameters gathered at the
        call (in autocast's dtype under autocast)."""
        def run(*args):
            dev = args[0].device.type
            dtype = (torch.get_autocast_dtype(dev)
                     if torch.is_autocast_enabled(dev) else None)
            return functional_call(layer, gather_params(layer, self.mesh,
                                                        dtype), args)
        return run
