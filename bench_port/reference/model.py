"""Plain PyTorch reference of the DiT-over-Phi-3 model and its SDXL-class VAE.

Written from the published description (Video-GPT, arXiv 2505.12489;
OmniGen, arXiv 2409.11340; Phi-3-mini's ``config.json``): a Phi-3 decoder
(RMSNorm, rotate-half RoPE over explicit positions, fused qkv and gate-up
projections, SwiGLU) that reads text tokens, patch embeddings of clean and
noisy latents and a timestep token, masked by the frame-block visibility
rule of the layout, and an adaLN head that predicts each noisy frame. The
functions here take a state dict keyed by the reference checkpoints' names
(:func:`param_specs`, :func:`vae_param_specs`) and hold no module state.

No cache and no batching: every evaluation is a full forward over one
row's tokens, pad tokens dropped (a pad key is never visible, and a pad
query's output is never read). The residual stream, norms, softmax, the
sampler and the losses are fp32; the operands of the products are rounded
as :class:`Precision` says. Nothing here imports the program under test.
"""
from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # largest float8 e4m3 value


class Precision:
    """The rounding of every product's operands.

    - ``fp32``: fp32 operands and products (TF32 off: the harness sets it);
    - ``bf16``: operands rounded to bf16, products accumulated in fp32, the
      mixed precision the configurations state;
    - ``fp8``: operands rounded to float8 e4m3 at one scale a tensor (its
      largest magnitude at 448), then multiplied as ``bf16``: the control
      one step below the configurations' precision. Gradients pass the
      rounding unchanged (straight through)."""

    def __init__(self, mode: str):
        if mode not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32":
            return x.float()
        xb = x.to(torch.bfloat16)
        if self.mode == "bf16":
            return xb
        xf = x.detach().float()
        scale = FP8_MAX / xf.abs().amax().clamp(min=1e-30)
        q = ((xf * scale).to(torch.float8_e4m3fn).float() / scale).to(
            torch.bfloat16)
        return xb + (q - xb).detach()

    def linear(self, x, w, b=None) -> torch.Tensor:
        y = F.linear(self.operand(x), self.operand(w)).float()
        return y if b is None else y + b.float()

    def matmul(self, a, b) -> torch.Tensor:
        return torch.matmul(self.operand(a), self.operand(b)).float()

    def conv(self, x, w, b=None, stride=1, padding=0) -> torch.Tensor:
        y = F.conv2d(self.operand(x), self.operand(w), None, stride,
                     padding).float()
        return y if b is None else y + b.float()[None, :, None, None]


# ---- parameters ------------------------------------------------------------

class Spec(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    init: str       # 'normal' | 'one' | 'zero'
    std: float


def param_specs(arch: dict) -> List[Spec]:
    """Every parameter of the model (no aux input head, no adapters), with
    the random initialisation the benchmark draws: normal(0.02) for
    matrices and embeddings, unit norms, zero biases."""
    d, p, c = arch["hidden_size"], arch["patch_size"], arch["in_channels"]
    h, hkv = arch["num_attention_heads"], arch["num_key_value_heads"]
    hd, inter = d // h, arch["intermediate_size"]
    fe, std = arch["freq_embed_size"], 0.02
    specs = []

    def mat(name, *shape):
        specs.append(Spec(name, tuple(shape), "normal", std))

    def bias(name, n):
        specs.append(Spec(name, (n,), "zero", 0.0))

    def norm(name, n):
        specs.append(Spec(name, (n,), "one", 0.0))

    for emb in ("x_embedder", "input_x_embedder"):
        mat(f"{emb}.proj.weight", d, c, p, p)
        bias(f"{emb}.proj.bias", d)
    for t in ("time_token", "t_embedder"):
        mat(f"{t}.mlp.0.weight", d, fe)
        bias(f"{t}.mlp.0.bias", d)
        mat(f"{t}.mlp.2.weight", d, d)
        bias(f"{t}.mlp.2.bias", d)
    mat("final_layer.adaLN_modulation.1.weight", 2 * d, d)
    bias("final_layer.adaLN_modulation.1.bias", 2 * d)
    mat("final_layer.linear.weight", p * p * c, d)
    bias("final_layer.linear.bias", p * p * c)
    mat("llm.embed_tokens.weight", arch["vocab_size"], d)
    for i in range(arch["num_hidden_layers"]):
        pre = f"llm.layers.{i}"
        norm(f"{pre}.input_layernorm.weight", d)
        mat(f"{pre}.self_attn.qkv_proj.weight", (h + 2 * hkv) * hd, d)
        mat(f"{pre}.self_attn.o_proj.weight", d, h * hd)
        norm(f"{pre}.post_attention_layernorm.weight", d)
        mat(f"{pre}.mlp.gate_up_proj.weight", 2 * inter, d)
        mat(f"{pre}.mlp.down_proj.weight", d, inter)
    norm("llm.norm.weight", d)
    return specs


def vae_param_specs(vae: dict) -> List[Spec]:
    """Every parameter of the SDXL-class AutoencoderKL under diffusers'
    names, initialised as the benchmark draws them: fan-in scaled normal
    convolutions and linears, unit GroupNorm scales, zero biases."""
    specs = []
    g_in, g_out = vae["in_channels"], vae["out_channels"]
    chans, lpb = vae["block_out_channels"], vae["layers_per_block"]
    z = vae["latent_channels"]

    def conv(name, cout, cin, k):
        specs.append(Spec(f"{name}.weight", (cout, cin, k, k), "normal",
                          (cin * k * k) ** -0.5))
        specs.append(Spec(f"{name}.bias", (cout,), "zero", 0.0))

    def lin(name, cout, cin):
        specs.append(Spec(f"{name}.weight", (cout, cin), "normal",
                          cin ** -0.5))
        specs.append(Spec(f"{name}.bias", (cout,), "zero", 0.0))

    def gn(name, ch):
        specs.append(Spec(f"{name}.weight", (ch,), "one", 0.0))
        specs.append(Spec(f"{name}.bias", (ch,), "zero", 0.0))

    def resnet(name, cin, cout):
        gn(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cout, cin, 3)
        gn(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cout, cin, 1)

    def mid(name, ch):
        resnet(f"{name}.resnets.0", ch, ch)
        gn(f"{name}.attentions.0.group_norm", ch)
        for t in ("to_q", "to_k", "to_v", "to_out.0"):
            lin(f"{name}.attentions.0.{t}", ch, ch)
        resnet(f"{name}.resnets.1", ch, ch)

    conv("encoder.conv_in", chans[0], g_in, 3)
    prev = chans[0]
    for i, ch in enumerate(chans):
        for j, cin in enumerate([prev] + [ch] * (lpb - 1)):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin, ch)
        if i < len(chans) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch, 3)
        prev = ch
    mid("encoder.mid_block", chans[-1])
    gn("encoder.conv_norm_out", chans[-1])
    conv("encoder.conv_out", 2 * z, chans[-1], 3)
    rev = list(reversed(chans))
    conv("decoder.conv_in", rev[0], z, 3)
    mid("decoder.mid_block", rev[0])
    prev = rev[0]
    for i, ch in enumerate(rev):
        for j, cin in enumerate([prev] + [ch] * lpb):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin, ch)
        if i < len(rev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch, 3)
        prev = ch
    gn("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", g_out, rev[-1], 3)
    conv("quant_conv", 2 * z, 2 * z, 1)
    conv("post_quant_conv", z, z, 1)
    return specs


# ---- the VAE ----------------------------------------------------------------

def _gn(P, name, x, groups):
    return F.group_norm(x.float(), groups, P[f"{name}.weight"].float(),
                        P[f"{name}.bias"].float(), eps=1e-6)


def _conv(P, prec, name, x, stride=1, padding=1):
    return prec.conv(x, P[f"{name}.weight"], P[f"{name}.bias"], stride,
                     padding)


def _resnet(P, prec, name, x, groups):
    h = _conv(P, prec, f"{name}.conv1", F.silu(_gn(P, f"{name}.norm1", x,
                                                      groups)))
    h = _conv(P, prec, f"{name}.conv2", F.silu(_gn(P, f"{name}.norm2", h,
                                                      groups)))
    if f"{name}.conv_shortcut.weight" in P:
        x = _conv(P, prec, f"{name}.conv_shortcut", x, padding=0)
    return x + h


def _vae_mid(P, prec, name, x, groups):
    x = _resnet(P, prec, f"{name}.resnets.0", x, groups)
    a = f"{name}.attentions.0"
    b, c, hh, ww = x.shape
    y = _gn(P, f"{a}.group_norm", x, groups).flatten(2).transpose(1, 2)

    def lin(t, v):
        return prec.linear(v, P[f"{a}.{t}.weight"], P[f"{a}.{t}.bias"])

    q, k, v = lin("to_q", y), lin("to_k", y), lin("to_v", y)
    probs = torch.softmax(prec.matmul(q, k.transpose(1, 2)) * c ** -0.5, -1)
    y = lin("to_out.0", prec.matmul(probs, v))
    x = x + y.transpose(1, 2).reshape(b, c, hh, ww)
    return _resnet(P, prec, f"{name}.resnets.1", x, groups)


def vae_encode(P: dict, vae: dict, prec: Precision, pixels: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] in [-1, 1] -> scaled posterior samples [N, H/8, W/8, z]
    with the standard-normal draw ``noise``."""
    g, chans = vae["norm_num_groups"], vae["block_out_channels"]
    h = _conv(P, prec, "encoder.conv_in", pixels.float().permute(0, 3, 1, 2))
    for i in range(len(chans)):
        for j in range(vae["layers_per_block"]):
            h = _resnet(P, prec, f"encoder.down_blocks.{i}.resnets.{j}", h, g)
        if i < len(chans) - 1:
            h = _conv(P, prec, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                      F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
    h = _vae_mid(P, prec, "encoder.mid_block", h, g)
    h = _conv(P, prec, "encoder.conv_out",
              F.silu(_gn(P, "encoder.conv_norm_out", h, g)))
    moments = _conv(P, prec, "quant_conv", h, padding=0).permute(0, 2, 3, 1)
    mean, logvar = moments.chunk(2, dim=-1)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    return (mean + std * noise.float()) * vae["scaling_factor"]


def vae_decode(P: dict, vae: dict, prec: Precision, latents: torch.Tensor
               ) -> torch.Tensor:
    """Scaled latents [N, h, w, z] -> pixels [N, 8h, 8w, 3] in about
    [-1, 1]."""
    g, chans = vae["norm_num_groups"], vae["block_out_channels"]
    z = latents.float() / vae["scaling_factor"]
    h = _conv(P, prec, "post_quant_conv", z.permute(0, 3, 1, 2), padding=0)
    h = _vae_mid(P, prec, "decoder.mid_block",
                 _conv(P, prec, "decoder.conv_in", h), g)
    for i in range(len(chans)):
        for j in range(vae["layers_per_block"] + 1):
            h = _resnet(P, prec, f"decoder.up_blocks.{i}.resnets.{j}", h, g)
        if i < len(chans) - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(P, prec, f"decoder.up_blocks.{i}.upsamplers.0.conv", h)
    h = _conv(P, prec, "decoder.conv_out",
              F.silu(_gn(P, "decoder.conv_norm_out", h, g)))
    return h.permute(0, 2, 3, 1)


def to_uint8(pixels: torch.Tensor) -> torch.Tensor:
    """[-1, 1] pixels -> uint8, truncating as a viewer's conversion does."""
    return (torch.clamp(pixels.float() * 0.5 + 0.5, 0.0, 1.0) * 255.0).to(
        torch.uint8)


# ---- embedders and head -----------------------------------------------------

def timestep_features(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[N] -> [N, dim] sinusoidal features, cosines first (max period 1e4)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def timestep_embed(P, prec, name, t, dim):
    x = prec.linear(timestep_features(t, dim), P[f"{name}.mlp.0.weight"],
                    P[f"{name}.mlp.0.bias"])
    return prec.linear(F.silu(x), P[f"{name}.mlp.2.weight"],
                       P[f"{name}.mlp.2.bias"])


@functools.lru_cache(maxsize=8)
def pos_table(dim: int, grid: int, hp: int, wp: int,
              base_size: int = 64, interpolation: float = 1.0) -> np.ndarray:
    """The 2D sincos table over a ``grid``² patch grid, center-cropped to
    (hp, wp): the first half of the features encodes the column, the
    second the row (the published checkpoints' convention)."""
    coords = (np.arange(grid, dtype=np.float32) / (grid / base_size)
              / interpolation)

    def one_d(d, pos):
        omega = 1.0 / 10000.0 ** (np.arange(d // 2, dtype=np.float64)
                                  / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    rows = np.broadcast_to(coords[:, None], (grid, grid))
    cols = np.broadcast_to(coords[None, :], (grid, grid))
    table = np.concatenate([one_d(dim // 2, cols), one_d(dim // 2, rows)],
                           axis=1).astype(np.float32)
    top, left = (grid - hp) // 2, (grid - wp) // 2
    t = table.reshape(grid, grid, -1)[top:top + hp, left:left + wp]
    return t.reshape(hp * wp, -1)


def patch_embed(P, arch, prec, name, latents: torch.Tensor) -> torch.Tensor:
    """[N, h, w, C] -> [N, (h/p)(w/p), D]: non-overlapping p x p patches,
    (row, column, channel) minor order, a linear projection, plus the 2D
    sincos table."""
    n, h, w, c = latents.shape
    p = arch["patch_size"]
    x = latents.float().reshape(n, h // p, p, w // p, p, c).permute(
        0, 1, 3, 2, 4, 5).reshape(n, (h // p) * (w // p), p * p * c)
    wt = P[f"{name}.proj.weight"]
    kernel = wt.permute(0, 2, 3, 1).reshape(wt.shape[0], -1)
    tok = prec.linear(x, kernel, P[f"{name}.proj.bias"])
    table = pos_table(arch["hidden_size"], arch["pos_embed_max_size"],
                      h // p, w // p, interpolation=arch["pe_interpolation"])
    return tok + torch.from_numpy(table).to(tok.device)[None]


def final_head(P, arch, prec, hidden: torch.Tensor, t: torch.Tensor,
               h: int, w: int) -> torch.Tensor:
    """[N, T, D] patch states of N noisy frames, [N] timesteps ->
    [N, h, w, C]: adaLN (shift, scale from the timestep) over a
    parameter-free LayerNorm, a linear map to p·p·C, un-patchify."""
    p, c = arch["patch_size"], arch["in_channels"]
    cond = timestep_embed(P, prec, "t_embedder", t, arch["freq_embed_size"])
    mod = prec.linear(F.silu(cond), P["final_layer.adaLN_modulation.1.weight"],
                      P["final_layer.adaLN_modulation.1.bias"])
    shift, scale = mod.chunk(2, dim=-1)
    x = F.layer_norm(hidden.float(), (hidden.shape[-1],), eps=1e-6)
    x = x * (1.0 + scale[:, None]) + shift[:, None]
    out = prec.linear(x, P["final_layer.linear.weight"],
                      P["final_layer.linear.bias"])
    n = out.shape[0]
    out = out.reshape(n, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(n, h, w, c)


# ---- the trunk --------------------------------------------------------------

class RowMeta(NamedTuple):
    """One row's kept (non-pad) tokens: the layout's metadata at them, as
    int64 device tensors; ``index`` is each token's position in the padded
    row, which the visibility rule reads."""

    index: torch.Tensor
    pos: torch.Tensor
    vis_start: torch.Tensor
    noisy_block: torch.Tensor
    noisy_role: torch.Tensor
    q_block: torch.Tensor
    q_offset: torch.Tensor


def row_meta(layout, b: int, keep: np.ndarray, device) -> RowMeta:
    def t(x):
        return torch.as_tensor(np.asarray(x)[keep], dtype=torch.int64,
                               device=device)

    return RowMeta(index=t(np.arange(layout.length)), pos=t(
        layout.pos_ids[b]), vis_start=t(layout.vis_start[b]),
        noisy_block=t(layout.noisy_block[b]),
        noisy_role=t(layout.noisy_role[b]), q_block=t(layout.q_block[b]),
        q_offset=t(layout.q_offset[b]))


def visible(m: RowMeta, qs: slice) -> torch.Tensor:
    """[q, k] bool: may query q (of ``qs``) attend key k. Clean and text
    keys from their ``vis_start``; noisy keys only to queries of their own
    frame block, gated by role (the marker, the timestep, the patches)."""
    causal = m.index[qs, None] >= m.vis_start[None, :]
    nb = m.noisy_block[None, :]
    noisy = ((nb >= 0) & (nb == m.q_block[qs, None])
             & (m.q_offset[qs, None] >= m.noisy_role[None, :]))
    return causal | noisy


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE over the full head width; x [L, H, D] fp32."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = pos.float()[:, None] * inv[None]
    cos = torch.cat([ang, ang], -1).cos()[:, None]
    sin = torch.cat([ang, ang], -1).sin()[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


QUERY_BLOCK = 1024


def attention(q, k, v, m: RowMeta, prec: Precision) -> torch.Tensor:
    """Masked attention of one row, q [L, H, D], k/v [L, Hkv, D] -> [L, H,
    D], a block of queries at a time over the keys up to the last one the
    block may see. In fp32 the products and the softmax are written out;
    in bf16 and fp8 PyTorch's memory-efficient attention takes the rounded
    operands and the boolean mask (fp32 softmax inside)."""
    n, h, d = q.shape
    group = h // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    out = []
    for s in range(0, n, QUERY_BLOCK):
        qs = slice(s, min(s + QUERY_BLOCK, n))
        vis = visible(m, qs)
        cols = torch.nonzero(vis.any(0))
        kmax = int(cols[-1]) + 1 if cols.numel() else 1
        kmax = min(n, kmax + -kmax % 16)  # the kernel's mask alignment
        vis = vis[:, :kmax]
        qb = q[qs].transpose(0, 1)
        kb, vb = k[:kmax].transpose(0, 1), v[:kmax].transpose(0, 1)
        if prec.mode == "fp32":
            s_ = prec.matmul(qb, kb.transpose(1, 2)) * d ** -0.5
            p_ = torch.softmax(s_.masked_fill(~vis[None], float("-inf")), -1)
            o = prec.matmul(p_, vb)
        else:
            o = _sdpa(prec.operand(qb)[None], prec.operand(kb)[None],
                      prec.operand(vb)[None], vis[None, None])[0].float()
        out.append(o.transpose(0, 1))
    return torch.cat(out, dim=0)


def _sdpa(q, k, v, mask):
    if q.device.type != "cuda":
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def decoder_layer(x, P, arch, prec, i, m: RowMeta) -> torch.Tensor:
    pre = f"llm.layers.{i}"
    eps = arch["rms_norm_eps"]
    h, hkv = arch["num_attention_heads"], arch["num_key_value_heads"]
    d = arch["hidden_size"] // h
    n = x.shape[0]
    y = rms_norm(x, P[f"{pre}.input_layernorm.weight"], eps)
    qkv = prec.linear(y, P[f"{pre}.self_attn.qkv_proj.weight"])
    q, k, v = qkv.split([h * d, hkv * d, hkv * d], dim=-1)
    theta = arch["rope_theta"]
    q = rope(q.reshape(n, h, d), m.pos, theta)
    k = rope(k.reshape(n, hkv, d), m.pos, theta)
    att = attention(q, k, v.reshape(n, hkv, d), m, prec).reshape(n, h * d)
    x = x + prec.linear(att, P[f"{pre}.self_attn.o_proj.weight"])
    y = rms_norm(x, P[f"{pre}.post_attention_layernorm.weight"], eps)
    gate, up = prec.linear(y, P[f"{pre}.mlp.gate_up_proj.weight"]).chunk(2, -1)
    return x + prec.linear(F.silu(gate) * up, P[f"{pre}.mlp.down_proj.weight"])


def forward(P: dict, arch: dict, prec: Precision, layout,
            noisy: torch.Tensor, t: torch.Tensor,
            clean: Sequence[torch.Tensor] = (), recompute: bool = False
            ) -> torch.Tensor:
    """Prediction [Nn, h, w, C] for the noisy frames of ``layout`` (every
    row, in the layout's frame order) from their latents ``noisy`` [Nn, h,
    w, C] at timesteps ``t`` [Nn], with the clean conditions ``clean``
    (groups of [N, h', w', C], embedded as one flat patch stream in group
    order). ``recompute`` keeps only each layer's input for the backward."""
    dev = noisy.device
    n_emb = patch_embed(P, arch, prec, "x_embedder", noisy).flatten(0, 1)
    t_emb = timestep_embed(P, prec, "time_token", t, arch["freq_embed_size"])
    groups = [g for g in clean if g.shape[0] > 0]
    c_emb = (torch.cat([patch_embed(P, arch, prec, "input_x_embedder", g)
                        .flatten(0, 1) for g in groups]) if groups else None)
    table = P["llm.embed_tokens.weight"]
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
        for i in range(arch["num_hidden_layers"]):
            if recompute:
                x = checkpoint(decoder_layer, x, P, arch, prec, i, m,
                               use_reentrant=False)
            else:
                x = decoder_layer(x, P, arch, prec, i, m)
        x = rms_norm(x, P["llm.norm.weight"], arch["rms_norm_eps"])
        full = x.new_zeros((layout.length, x.shape[1]))
        rows.append(full.index_copy(0, torch.as_tensor(keep, device=dev), x))
    hidden = torch.cat(rows)
    g = torch.as_tensor(layout.noisy_gather, device=dev).long()
    nn_, hl, wl, _ = noisy.shape
    return final_head(P, arch, prec, hidden[g.reshape(-1)].reshape(
        nn_, -1, hidden.shape[1]), t, hl, wl)
