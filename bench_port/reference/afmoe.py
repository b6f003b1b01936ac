"""Plain PyTorch reference of Video-GPT on the AFMoE trunk, and its training
step.

Written from the published description: the DiT wrapper, the VAE and the
layout of Video-GPT (arXiv 2505.12489; ``model.py`` here) around the AFMoE
block of Arcee's Trinity models (``model_type: afmoe``; Trinity-Mini's
``config.json``). For layer i, with x the residual stream of one row:

    a = RMSNorm(x)
    q, k, v, g = a Wq, a Wk, a Wv, a Wg        (heads of head_dim)
    q, k = RMSNorm(q), RMSNorm(k)              (each head's values)
    q, k = RoPE(q), RoPE(k)                    (sliding layers only)
    o = Attn(q, k, v) * sigmoid(g)             (the layer's mask)
    x = x + RMSNorm(o Wo)
    m = RMSNorm(x)
    f = SwiGLU(m)                              (the dense layers)
    f = sum_j w_j E_j(m) + E_shared(m)         (the expert layers)
    x = x + RMSNorm(f)

with the trunk's input scaled by sqrt(hidden_size) (``mup_enabled``) and a
final RMSNorm. Routing in fp32: s = sigmoid(m W_r), the top
``num_experts_per_tok`` of s + expert_bias (zero), w = s_top / (sum s_top
+ 1e-20) * route_scale. A sliding layer's key is visible where the
frame-block rule allows it and q_pos - k_pos < sliding_window (positions
are the layout's ``pos_ids``).

Experts run as a loop of dense products over the tokens routed to each;
attention a block of queries at a time under the dense rule and the
window. No cache and no batching; products rounded as :class:`Precision`
says, everything else fp32. Nothing here imports the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .model import (Precision, RowMeta, Spec, _sdpa, final_head, param_specs
                    as wrapper_specs, patch_embed, rms_norm, rope, row_meta,
                    timestep_embed, visible)
from .train import OptConfig, StepData

SLIDING = "sliding_attention"
QUERY_BLOCK = 1024

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def param_specs(arch: dict) -> List[Spec]:
    """Every parameter of the model, with the benchmark's random
    initialisation (normal(0.02) matrices and embeddings, unit norms, zero
    biases); the DiT wrapper's as ``model.param_specs`` gives them."""
    d, std = arch["hidden_size"], 0.02
    h, hkv, hd = (arch["num_attention_heads"], arch["num_key_value_heads"],
                  arch["head_dim"])
    e, inter = arch["num_experts"], arch["moe_intermediate_size"]
    specs = wrapper_specs(dict(arch, num_hidden_layers=0))
    last = specs.pop()  # llm.norm.weight, kept last

    def mat(name, *shape):
        specs.append(Spec(name, tuple(shape), "normal", std))

    def norm(name, n):
        specs.append(Spec(name, (n,), "one", 0.0))

    for i in range(arch["num_hidden_layers"]):
        pre = f"llm.layers.{i}"
        norm(f"{pre}.input_layernorm.weight", d)
        mat(f"{pre}.self_attn.qkvg_proj.weight", (2 * h + 2 * hkv) * hd, d)
        norm(f"{pre}.self_attn.q_norm.weight", hd)
        norm(f"{pre}.self_attn.k_norm.weight", hd)
        mat(f"{pre}.self_attn.o_proj.weight", d, h * hd)
        norm(f"{pre}.post_attention_layernorm.weight", d)
        norm(f"{pre}.pre_mlp_layernorm.weight", d)
        if i < arch["num_dense_layers"]:
            mat(f"{pre}.mlp.gate_up_proj.weight", 2 * arch["intermediate_size"],
                d)
            mat(f"{pre}.mlp.down_proj.weight", d, arch["intermediate_size"])
        else:
            shared = inter * arch["num_shared_experts"]
            mat(f"{pre}.mlp.router.weight", e, d)
            mat(f"{pre}.mlp.experts.gate_up_proj", e, 2 * inter, d)
            mat(f"{pre}.mlp.experts.down_proj", e, d, inter)
            mat(f"{pre}.mlp.shared_experts.gate_up_proj.weight", 2 * shared, d)
            mat(f"{pre}.mlp.shared_experts.down_proj.weight", d, shared)
        norm(f"{pre}.post_mlp_layernorm.weight", d)
    specs.append(last)
    return specs


def buffer_specs(arch: dict) -> List[Spec]:
    """The expert layers' ``expert_bias`` (zero; the update that
    ``load_balance_coeff`` drives is left out)."""
    return [Spec(f"llm.layers.{i}.mlp.expert_bias", (arch["num_experts"],),
                 "zero", 0.0)
            for i in range(arch["num_dense_layers"],
                           arch["num_hidden_layers"])]


# ---- the trunk ----------------------------------------------------------------

def window_visible(m: RowMeta, qs: slice, window: int) -> torch.Tensor:
    """[q, k] bool: the frame-block rule, and with ``window`` > 0 only the
    keys at q_pos - k_pos < window."""
    vis = visible(m, qs)
    if window > 0:
        vis = vis & ((m.pos[qs, None] - m.pos[None, :]) < window)
    return vis


def attention(q, k, v, m: RowMeta, prec: Precision, window: int
              ) -> torch.Tensor:
    """Masked attention of one row, q [L, H, D], k/v [L, Hkv, D] -> [L, H,
    D], a block of queries at a time over the span of keys the block may
    see; fp32 written out, bf16 and fp8 through PyTorch's memory-efficient
    attention on the rounded operands (fp32 softmax inside)."""
    n, h, d = q.shape
    group = h // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    out = []
    for s in range(0, n, QUERY_BLOCK):
        qs = slice(s, min(s + QUERY_BLOCK, n))
        vis = window_visible(m, qs, window)
        cols = torch.nonzero(vis.any(0))
        k0 = int(cols[0]) // 16 * 16 if cols.numel() else 0
        k1 = int(cols[-1]) + 1 if cols.numel() else 1
        k1 = min(n, k1 + -k1 % 16)
        vis = vis[:, k0:k1]
        qb = q[qs].transpose(0, 1)
        kb, vb = k[k0:k1].transpose(0, 1), v[k0:k1].transpose(0, 1)
        if prec.mode == "fp32":
            s_ = prec.matmul(qb, kb.transpose(1, 2)) * d ** -0.5
            p_ = torch.softmax(s_.masked_fill(~vis[None], float("-inf")), -1)
            o = prec.matmul(p_, vb)
        else:
            o = _sdpa(prec.operand(qb)[None], prec.operand(kb)[None],
                      prec.operand(vb)[None], vis[None, None])[0].float()
        out.append(o.transpose(0, 1))
    return torch.cat(out, dim=0)


def swiglu(prec, x, w_gu, w_down):
    gate, up = prec.linear(x, w_gu).chunk(2, -1)
    return prec.linear(F.silu(gate) * up, w_down)


def route(P: dict, arch: dict, pre: str, m: torch.Tensor):
    """(weights [T, k], expert ids [T, k]) of the tokens m [T, H], in
    fp32."""
    s = torch.sigmoid(m.float() @ P[f"{pre}.router.weight"].float().t())
    idx = torch.topk(s + P[f"{pre}.expert_bias"].float(),
                     arch["num_experts_per_tok"], dim=-1).indices
    top = s.gather(-1, idx)
    return top / (top.sum(-1, keepdim=True) + 1e-20) * arch["route_scale"], \
        idx


def experts(P: dict, arch: dict, prec: Precision, pre: str,
            m: torch.Tensor) -> torch.Tensor:
    """The expert layer on m [T, H]: each expert's SwiGLU over the tokens
    routed to it, weighted, plus the shared expert."""
    w, idx = route(P, arch, pre, m)
    out = torch.zeros_like(m, dtype=torch.float32)
    for e in range(arch["num_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(prec, m[tok], P[f"{pre}.experts.gate_up_proj"][e],
                   P[f"{pre}.experts.down_proj"][e])
        out = out.index_add(0, tok, y * w[tok, slot][:, None])
    return out + swiglu(prec, m, P[f"{pre}.shared_experts.gate_up_proj"
                                   ".weight"],
                        P[f"{pre}.shared_experts.down_proj.weight"])


def afmoe_layer(x, P, arch, prec, i, m: RowMeta) -> torch.Tensor:
    pre = f"llm.layers.{i}"
    eps = arch["rms_norm_eps"]
    h, hkv, d = (arch["num_attention_heads"], arch["num_key_value_heads"],
                 arch["head_dim"])
    n = x.shape[0]
    sliding = arch["layer_types"][i] == SLIDING
    window = arch["sliding_window"] if sliding else 0
    a = rms_norm(x, P[f"{pre}.input_layernorm.weight"], eps)
    q, k, v, g = prec.linear(a, P[f"{pre}.self_attn.qkvg_proj.weight"]).split(
        [h * d, hkv * d, hkv * d, h * d], dim=-1)
    q = rms_norm(q.reshape(n, h, d), P[f"{pre}.self_attn.q_norm.weight"], eps)
    k = rms_norm(k.reshape(n, hkv, d), P[f"{pre}.self_attn.k_norm.weight"],
                 eps)
    if sliding:
        q, k = rope(q, m.pos, arch["rope_theta"]), rope(k, m.pos,
                                                         arch["rope_theta"])
    o = attention(q, k, v.reshape(n, hkv, d), m, prec, window).reshape(
        n, h * d) * torch.sigmoid(g)
    x = x + rms_norm(prec.linear(o, P[f"{pre}.self_attn.o_proj.weight"]),
                     P[f"{pre}.post_attention_layernorm.weight"], eps)
    y = rms_norm(x, P[f"{pre}.pre_mlp_layernorm.weight"], eps)
    if i < arch["num_dense_layers"]:
        f = swiglu(prec, y, P[f"{pre}.mlp.gate_up_proj.weight"],
                   P[f"{pre}.mlp.down_proj.weight"])
    else:
        f = experts(P, arch, prec, f"{pre}.mlp", y)
    return x + rms_norm(f, P[f"{pre}.post_mlp_layernorm.weight"], eps)


def forward(P: dict, arch: dict, prec: Precision, layout,
            noisy: torch.Tensor, t: torch.Tensor,
            clean: Sequence[torch.Tensor] = (), recompute: bool = False
            ) -> torch.Tensor:
    """Prediction [Nn, h, w, C] for the noisy frames of ``layout``, as
    ``model.forward`` assembles and reads it, through the AFMoE trunk."""
    dev = noisy.device
    n_emb = patch_embed(P, arch, prec, "x_embedder", noisy).flatten(0, 1)
    t_emb = timestep_embed(P, prec, "time_token", t, arch["freq_embed_size"])
    groups = [g for g in clean if g.shape[0] > 0]
    c_emb = (torch.cat([patch_embed(P, arch, prec, "input_x_embedder", g)
                        .flatten(0, 1) for g in groups]) if groups else None)
    table = P["llm.embed_tokens.weight"]
    scale = math.sqrt(arch["hidden_size"]) if arch["mup_enabled"] else 1.0
    rows = []
    for b in range(layout.batch):
        keep = np.nonzero(layout.kind[b] != 0)[0]  # Kind.PAD == 0
        m = row_meta(layout, b, keep, dev)
        ids = torch.as_tensor(layout.input_ids[b][keep], device=dev).long()
        x = table[ids].float()
        for src, emb in ((layout.noisy_src, n_emb), (layout.time_src, t_emb),
                         (layout.clean_src, c_emb)):
            s = torch.as_tensor(src[b][keep], device=dev).long()
            if emb is not None and bool((s >= 0).any()):
                x = torch.where((s >= 0)[:, None], emb[s.clamp(min=0)], x)
        x = x * scale
        for i in range(arch["num_hidden_layers"]):
            if recompute:
                x = checkpoint(afmoe_layer, x, P, arch, prec, i, m,
                               use_reentrant=False)
            else:
                x = afmoe_layer(x, P, arch, prec, i, m)
        x = rms_norm(x, P["llm.norm.weight"], arch["rms_norm_eps"])
        full = x.new_zeros((layout.length, x.shape[1]))
        rows.append(full.index_copy(0, torch.as_tensor(keep, device=dev), x))
    hidden = torch.cat(rows)
    g = torch.as_tensor(layout.noisy_gather, device=dev).long()
    nn_, hl, wl, _ = noisy.shape
    return final_head(P, arch, prec, hidden[g.reshape(-1)].reshape(
        nn_, -1, hidden.shape[1]), t, hl, wl)


# ---- the training step ---------------------------------------------------------

def step_loss(P: dict, arch: dict, prec: Precision, d: StepData,
              opt: OptConfig) -> torch.Tensor:
    """The scalar loss of one step (``reference/train.py``'s recipe)."""
    t = d.t.float()
    shape = (-1,) + (1,) * (d.x1.dim() - 1)
    xt = t.reshape(shape) * d.x1 + (1.0 - t.reshape(shape)) * d.x0
    clean = []
    for g, x0c, u in zip(d.clean, d.x0c, d.t_in):
        tin = (opt.input_noise + (1.0 - opt.input_noise) * u).reshape(shape)
        clean.append(tin * g + (1.0 - tin) * x0c)
    pred = forward(P, arch, prec, d.layout, xt, t, tuple(clean),
                   recompute=True)
    target = d.x1 if opt.target == "x1" else d.x1 - d.x0
    return ((target - pred) ** 2).flatten(1).mean(-1).mean()


def train_steps(P: dict, names: Sequence[str], arch: dict, prec: Precision,
                data: Sequence[StepData], opt: OptConfig
                ) -> Tuple[List[float], Dict[str, float]]:
    """Run the steps of ``data`` on the parameters ``names`` of ``P`` (fp32,
    updated in place; the moments rest in host memory between steps):
    global-norm clip, then AdamW, as ``reference/train.py``. Returns (each
    step's loss, the first step's clipped gradient norm of each
    parameter)."""
    params = [P[n].requires_grad_(True) for n in names]
    mu: List = [None] * len(params)
    nu: List = [None] * len(params)
    losses: List[float] = []
    first: Dict[str, float] = {}
    for count, d in enumerate(data, start=1):
        loss = step_loss(P, arch, prec, d, opt)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        norm = float(torch.sqrt(sum(g.double().pow(2).sum() for g in grads)))
        clip = 1.0 if norm < opt.max_grad_norm else opt.max_grad_norm / norm
        if count == 1:
            first = {n: float(torch.linalg.vector_norm(g.double())) * clip
                     for n, g in zip(names, grads)}
        bc1 = 1.0 - opt.beta1 ** count
        bc2 = 1.0 - opt.beta2 ** count
        keep = count < len(data)
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                g = g * clip
                m = (torch.zeros_like(p) if mu[i] is None
                     else mu[i].to(p.device))
                v = (torch.zeros_like(p) if nu[i] is None
                     else nu[i].to(p.device))
                m.mul_(opt.beta1).add_(g, alpha=1.0 - opt.beta1)
                v.mul_(opt.beta2).addcmul_(g, g, value=1.0 - opt.beta2)
                upd = (m / bc1) / ((v / bc2).sqrt() + opt.eps)
                p.sub_(opt.lr * (upd + opt.weight_decay * p))
                if keep:
                    mu[i], nu[i] = m.cpu(), v.cpu()
        del grads
        if math.isnan(losses[-1]):
            break
    for p in params:
        p.requires_grad_(False)
    return losses, first
