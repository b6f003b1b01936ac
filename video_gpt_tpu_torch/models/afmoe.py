"""AFMoE decoder trunk: the block of Arcee's Trinity models.

The layer equations (``model_type: afmoe`` as Hugging Face transformers
writes it), for layer i with x the residual stream:

- a = RMSNorm(x); q, k, v and the gate g from one fused projection
  (``qkvg_proj``), q and k through an RMSNorm over each head's values
  (QK-norm); RoPE on the sliding-window layers only (the full layers use no
  positional encoding); o = Attn(q, k, v) under the layer's mask, gated by
  sigmoid(g); x += RMSNorm(o Wo) (the norm after the sublayer);
- m = RMSNorm(x); f = SwiGLU(m) on the first ``num_dense_layers`` layers,
  else the expert layer (:class:`AfmoeMoE`); x += RMSNorm(f);
- the trunk's input is scaled by sqrt(hidden_size) once (``mup_enabled``)
  and a final RMSNorm ends it.

A sliding layer attends under the frame-block rule and a window of
``sliding_window`` positions (:class:`~..ops.attention.Window`): on the
bias route it reads a second bias built with the window, on the inline
route K6/K7's windowed instances.

The expert layer routes each token in fp32: s = sigmoid(m W_r), the top
``num_experts_per_tok`` of s + ``expert_bias`` (a buffer, zero and
untrained here), weights s_top / (sum s_top + 1e-20) * ``route_scale``.
Its routed part is one autograd Function (:class:`RoutedExperts`): the
tokens permuted by expert, the grouped SwiGLU products of every expert over
its rows (``torch._grouped_mm`` on CUDA in bf16, a plain loop over the
experts elsewhere), and the weighted combine; its backward is written out
with the same grouped products. The forward, its recompute and the
backward each run inside the ``record_function`` range ``MoE.experts``;
the spans ``vgt.model.moe.route`` and ``vgt.model.moe.experts`` mark the
two parts when the spans are on. Each expert layer keeps its per-expert
token counts of the last forward on the device (:func:`expert_loads`).

The trunk trains on one device: it takes no mesh, no KV cache (serving
would need a windowed K1/K2 and cache) and no LoRA, and raises on each.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch
from torch import nn
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..ops.attention import AttnMeta, Window, attend
from ..ops.flash_attention import BiasMap, bias_map, precompute_bias
from ..utils.profiling import annotate
from .phi3 import RMSNorm, apply_rope, rope_tables

EXPERTS_RANGE = "MoE.experts"
SLIDING = "sliding_attention"
FULL = "full_attention"


def check_afmoe(cfg: ModelConfig, mesh=None) -> None:
    """Raise on what the AFMoE trunk does not run."""
    if mesh is not None:
        raise ValueError("the AFMoE trunk runs on one device: it takes no "
                         "mesh (no expert or sequence parallelism)")
    if cfg.lora_rank:
        raise ValueError("the AFMoE trunk takes no LoRA adapters")
    if len(cfg.layer_types) != cfg.num_layers or not set(
            cfg.layer_types) <= {SLIDING, FULL}:
        raise ValueError(f"layer_types must give {SLIDING!r} or {FULL!r} "
                         f"for each of the {cfg.num_layers} layers")
    if cfg.num_experts_per_tok > cfg.num_experts:
        raise ValueError("num_experts_per_tok exceeds num_experts")


class LayerBiases(NamedTuple):
    """The bias route's two biases with their maps: the full layers' and
    the sliding layers' (the window included), built once a forward."""

    full: BiasMap
    windowed: BiasMap


def afmoe_biases(cfg: ModelConfig, meta: AttnMeta, pos_ids: torch.Tensor
                 ) -> Optional[LayerBiases]:
    """The two biases of a forward over ``meta``, or None past
    ``cfg.precompute_bias_limit`` (the inline route)."""
    b, l = meta.index.shape
    if b * l * l > cfg.precompute_bias_limit:
        return None
    window = Window(cfg.sliding_window, pos_ids, pos_ids)
    return LayerBiases(bias_map(precompute_bias(meta, meta)),
                       bias_map(precompute_bias(meta, meta, window)))


class SwiGLU(nn.Module):
    """down(silu(gate) * up), gate and up in one projection."""

    def __init__(self, hidden: int, inter: int, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_up_proj = nn.Linear(hidden, 2 * inter, **kw)
        self.down_proj = nn.Linear(inter, hidden, **kw)

    def forward(self, x):
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


class AfmoeAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, layer: int, device=None,
                 dtype=None):
        super().__init__()
        self.cfg = cfg
        self.window = cfg.window(layer)
        h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.qkvg_proj = nn.Linear(cfg.hidden_size, (2 * h + 2 * hkv) * d,
                                   **kw)
        self.q_norm = RMSNorm(d, cfg.rms_norm_eps, device=device, dtype=dtype)
        self.k_norm = RMSNorm(d, cfg.rms_norm_eps, device=device, dtype=dtype)
        self.o_proj = nn.Linear(h * d, cfg.hidden_size, **kw)

    def forward(self, x, cos, sin, q_meta: AttnMeta, k_meta: AttnMeta,
                bias=None, window: Optional[Window] = None):
        cfg = self.cfg
        h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        b, l, _ = x.shape
        q, k, v, g = self.qkvg_proj(x).split(
            [h * d, hkv * d, hkv * d, h * d], dim=-1)
        q = self.q_norm(q.view(b, l, h, d))
        k = self.k_norm(k.view(b, l, hkv, d))
        if self.window:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        out = attend(q, k, v.view(b, l, hkv, d), q_meta, k_meta, bias=bias,
                     window=window if self.window else None)
        out = out.reshape(b, l, h * d) * torch.sigmoid(g)
        return self.o_proj(out)


# ---- the expert layer -----------------------------------------------------

def grouped_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """Rows ``offs[e-1]:offs[e]`` of a [M, K] times b[e] [K, N] -> [M, N]:
    ``torch._grouped_mm`` for bf16 CUDA tensors, a loop over the groups
    otherwise."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch._grouped_mm(a, b, offs=offs)
    out = a.new_empty((a.shape[0], b.shape[-1]))
    start = 0
    for e, end in enumerate(offs.tolist()):
        out[start:end] = a[start:end] @ b[e]
        start = end
    return out


def grouped_mm_t(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor
                 ) -> torch.Tensor:
    """Per group e, a_e^T b_e over the rows ``offs[e-1]:offs[e]`` of a
    [M, K] and b [M, N] -> [E, K, N] (an empty group gives zeros): the
    weight gradient of :func:`grouped_mm`."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch._grouped_mm(a.t(), b, offs=offs)
    out = a.new_zeros((offs.shape[0], a.shape[1], b.shape[1]))
    start = 0
    for e, end in enumerate(offs.tolist()):
        out[e] = a[start:end].t() @ b[start:end]
        start = end
    return out


# rows of the routed part's elementwise work a step: its fp32 temporaries
# stay a few hundred MB at stage 4 (35,076 tokens x 8 rows)
CHUNK_ROWS = 1 << 15


def _chunks(n: int):
    for s in range(0, n, CHUNK_ROWS):
        yield slice(s, min(s + CHUNK_ROWS, n))


def _combine(y: torch.Tensor, rows: torch.Tensor, w: torch.Tensor
             ) -> torch.Tensor:
    """out[t] = sum_j w[t, j] y[rows[t, j]] in fp32, in y's dtype."""
    out = y.new_empty((rows.shape[0], y.shape[1]))
    for sl in _chunks(rows.shape[0]):
        out[sl] = (y[rows[sl]].float() * w[sl, :, None]).sum(1).to(y.dtype)
    return out


class RoutedExperts(torch.autograd.Function):
    """The routed part of an expert layer: m [T, H] (the compute dtype),
    weights w [T, k] fp32 and expert ids idx [T, k], the experts' fused
    gate/up weights [E, 2I, H] and down weights [E, H, I] (fp32
    parameters, rounded to m's dtype for the products) -> sum_j w_j
    E_j(m) [T, H]. ``counts`` [E] receives each expert's rows. The rows
    are permuted by expert (``order``; ``inv`` maps each (token, j) to its
    row); the elementwise work runs ``CHUNK_ROWS`` rows at a time.
    Backward: the same grouped products, transposed."""

    @staticmethod
    def forward(ctx, m, w, idx, w_gu, w_down, counts):
        with record_function(EXPERTS_RANGE):
            t, k = idx.shape
            flat = idx.reshape(-1)
            order = torch.argsort(flat, stable=True)
            counts.copy_(torch.bincount(flat, minlength=counts.shape[0]))
            offs = counts.cumsum(0).to(torch.int32)
            inv = torch.argsort(order).view(t, k)
            gu = grouped_mm(m[order // k], w_gu.to(m.dtype).transpose(1, 2),
                            offs)
            gate, up = gu.chunk(2, dim=-1)
            y = grouped_mm(F.silu(gate) * up,
                           w_down.to(m.dtype).transpose(1, 2), offs)
            out = _combine(y, inv, w)
            ctx.save_for_backward(m, w, order, inv, offs, gu, y, w_gu,
                                  w_down)
            return out

    @staticmethod
    def backward(ctx, dout):
        with record_function(EXPERTS_RANGE):
            m, w, order, inv, offs, gu, y, w_gu, w_down = ctx.saved_tensors
            t, k = w.shape
            dt = m.dtype
            dout = dout.to(dt)
            tok, wp = order // k, w.reshape(-1)[order]
            # per row: dy = w dout (the products' operand), and the
            # weight's gradient <dout, y>
            dy = torch.empty_like(y)
            dwp = torch.empty(t * k, dtype=torch.float32, device=m.device)
            for sl in _chunks(t * k):
                d = dout[tok[sl]].float()
                dy[sl] = (d * wp[sl, None]).to(dt)
                dwp[sl] = (d * y[sl].float()).sum(-1)
            dw = torch.empty_like(dwp)
            dw[order] = dwp
            dact = grouped_mm(dy, w_down.to(dt), offs)
            act = torch.empty_like(dact)
            dgu = torch.empty_like(gu)
            inter = dact.shape[1]
            for sl in _chunks(t * k):
                g, u = gu[sl, :inter].float(), gu[sl, inter:].float()
                sg = torch.sigmoid(g)
                da = dact[sl].float()
                act[sl] = (g * sg * u).to(dt)
                dgu[sl, :inter] = (da * u * sg * (1 + g * (1 - sg))).to(dt)
                dgu[sl, inter:] = (da * g * sg).to(dt)
            del dact
            dw_down = grouped_mm_t(dy, act, offs).to(w_down.dtype)
            del dy, act
            dw_gu = grouped_mm_t(dgu, m[tok], offs).to(w_gu.dtype)
            dm = _combine(grouped_mm(dgu, w_gu.to(dt), offs), inv,
                          torch.ones_like(w))
        return dm, dw.view(t, k), None, dw_gu, dw_down, None


class GroupedExperts(nn.Module):
    """``num`` SwiGLU experts of width ``inter``, their weights stacked."""

    def __init__(self, num: int, hidden: int, inter: int, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.gate_up_proj = nn.Parameter(torch.empty(num, 2 * inter, hidden,
                                                     **kw))
        self.down_proj = nn.Parameter(torch.empty(num, hidden, inter, **kw))


class AfmoeMoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d, e = cfg.hidden_size, cfg.num_experts
        kw = dict(device=device, dtype=dtype)
        self.router = nn.Linear(d, e, bias=False, **kw)
        self.register_buffer("expert_bias", torch.zeros(
            e, device=device, dtype=torch.float32))
        self.experts = GroupedExperts(e, d, cfg.moe_intermediate_size, **kw)
        self.shared_experts = SwiGLU(
            d, cfg.moe_intermediate_size * cfg.num_shared_experts, **kw)
        # each expert's rows in the last forward, written by the forward
        self.register_buffer("counts", torch.zeros(
            e, dtype=torch.int64, device=device), persistent=False)

    def route(self, m: torch.Tensor):
        """(weights [T, k] fp32, expert ids [T, k]) of the tokens m [T, H]:
        sigmoid scores in fp32, the top k of the scores plus the bias, their
        scores normalised and scaled."""
        cfg = self.cfg
        with torch.autocast(m.device.type, enabled=False):
            s = torch.sigmoid(F.linear(m.float(), self.router.weight.float()))
        idx = torch.topk(s + self.expert_bias, cfg.num_experts_per_tok,
                         dim=-1).indices
        top = s.gather(-1, idx)
        return top / (top.sum(-1, keepdim=True) + 1e-20) * cfg.route_scale, idx

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        m = x.reshape(-1, shape[-1])
        with annotate("vgt.model.moe.route"):
            w, idx = self.route(m)
        with annotate("vgt.model.moe.experts"):
            routed = RoutedExperts.apply(
                m, w, idx, self.experts.gate_up_proj,
                self.experts.down_proj, self.counts)
        return (routed + self.shared_experts(m)).reshape(shape)


class AfmoeLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, layer: int, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(d, eps, **kw)
        self.self_attn = AfmoeAttention(cfg, layer, **kw)
        self.post_attention_layernorm = RMSNorm(d, eps, **kw)
        self.pre_mlp_layernorm = RMSNorm(d, eps, **kw)
        self.mlp = (SwiGLU(d, cfg.intermediate_size, **kw)
                    if layer < cfg.num_dense_layers else AfmoeMoE(cfg, **kw))
        self.post_mlp_layernorm = RMSNorm(d, eps, **kw)

    def forward(self, x, cos, sin, q_meta, k_meta, bias, window):
        x = x + self.post_attention_layernorm(self.self_attn(
            self.input_layernorm(x), cos, sin, q_meta, k_meta, bias, window))
        return x + self.post_mlp_layernorm(self.mlp(self.pre_mlp_layernorm(x)))


class AfmoeDecoder(nn.Module):
    """The AFMoE trunk with the token embedding (``llm.embed_tokens``), in
    the place of ``Phi3Decoder``: the same call for an uncached forward."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None, mesh=None):
        super().__init__()
        check_afmoe(cfg, mesh)
        self.cfg = cfg
        self.mesh = None
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.layers = nn.ModuleList(
            AfmoeLayer(cfg, i, **kw) for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)

    def forward(self, inputs_embeds: torch.Tensor, pos_ids: torch.Tensor,
                q_meta: AttnMeta, k_meta: AttnMeta, cache=None, bias=None,
                return_kv: bool = False, num_micro: Optional[int] = None):
        """(final-norm hidden states, None). ``bias``: the bias route's
        :class:`LayerBiases`, or None (the inline route)."""
        cfg = self.cfg
        if cache is not None or return_kv:
            raise ValueError("the AFMoE trunk does not serve: a KV cache "
                             "under its window needs a windowed K1/K2")
        if bias is not None and not isinstance(bias, LayerBiases):
            raise ValueError("the AFMoE trunk takes its two biases as "
                             "LayerBiases (afmoe_biases)")
        x = inputs_embeds
        if cfg.mup_enabled:
            x = x * math.sqrt(cfg.hidden_size)
        cos, sin = rope_tables(pos_ids, cfg.head_dim, cfg.rope_theta,
                               x.dtype)
        pos = pos_ids.to(torch.int32).contiguous()
        window = Window(cfg.sliding_window, pos, pos)
        remat = cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            sliding = cfg.window(i) > 0
            layer_bias = None if bias is None else (
                bias.windowed if sliding else bias.full)
            args = (x, cos, sin, q_meta, k_meta, layer_bias,
                    window if sliding else None)
            if remat:
                x = checkpoint(layer, *args, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(*args)
        return self.norm(x), None


def expert_loads(model: nn.Module) -> List[torch.Tensor]:
    """Each expert layer's max / mean of its per-expert token counts in the
    last forward, as device scalars (no host sync until read)."""
    return [(m.counts.max() / m.counts.float().mean().clamp(min=1e-9))
            for m in model.modules() if isinstance(m, AfmoeMoE)]
