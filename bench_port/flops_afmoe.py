"""The yardstick of the AFMoE cells: operations and bytes of a training step
of Video-GPT on the AFMoE trunk, from shapes and the cell's own masks (the
layouts of ``reference/``), never from the program. ``flops.py``'s helpers
and peaks, with the trunk's own widths (head_dim is not hidden / heads).

- Model FLOPs: two a weight a token through the linears the token passes
  (qkv and gate, o; the dense layers' SwiGLU; in an expert layer the
  router, its top-k experts and the shared expert), the patch embedders
  and the final layer, plus QK^T and PV over the visible pairs of each
  layer's mask (the window's on a sliding layer), real tokens only. A
  training step is three forwards (the recompute is not counted).
- ``bounds_ms["inline_attention"]``: K6 (forward and recompute, with lse)
  and K7 of every layer, each at the pairs of its layer's mask (pad rows
  see every key), max(bytes / HBM rate, FLOPs / bf16 rate) a call.
- ``bounds_ms["moe"]``: the routed experts' grouped products of every
  expert layer, forward, recompute and backward (whose products are twice
  the forward's): max(routed FLOPs / 989 TFLOP/s, (the experts' bf16
  weights + the permuted rows in and out) / 3.35 TB/s) a pass.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import flops
from .flops import BF16, FP32, INT32, bound_ms

SLIDING = "sliding_attention"
ROW_BLOCK = 2048


def heads(arch: dict):
    return (arch["num_attention_heads"], arch["num_key_value_heads"],
            arch["head_dim"])


def window_pairs(layout, window: int, device="cpu") -> Dict[str, int]:
    """Visible (query, key) pairs under the frame-block rule and, with
    ``window`` > 0, the window over ``pos_ids`` (pad rows see every key):
    {"kernel": with the pad rows, "model": without}, summed over rows."""
    out = {"kernel": 0, "model": 0}
    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    L = layout.length
    for b in range(layout.batch):
        vis, nb, role = (t(layout.vis_start[b]), t(layout.noisy_block[b]),
                         t(layout.noisy_role[b]))
        pos = t(layout.pos_ids[b]).long()
        pad = t(layout.kind[b] == flops.KIND_PAD)
        qb, qo = t(layout.q_block[b]), t(layout.q_offset[b])
        for r0 in range(0, L, ROW_BLOCK):
            rows = slice(r0, min(r0 + ROW_BLOCK, L))
            idx = torch.arange(rows.start, rows.stop, device=dev)
            seen = ((idx[:, None] >= vis[None]) | (
                (nb[None] >= 0) & (nb[None] == qb[rows, None])
                & (qo[rows, None] >= role[None])))
            if window > 0:
                seen &= (pos[rows, None] - pos[None]) < window
            per_q = seen.sum(-1)
            out["model"] += int(per_q[~pad[rows]].sum())
            out["kernel"] += int(per_q[~pad[rows]].sum()) + int(
                pad[rows].sum()) * L
    return out


def layer_linears(arch: dict, dense: bool) -> int:
    """Weights a token passes through in one layer."""
    d = arch["hidden_size"]
    h, hkv, hd = heads(arch)
    attn = d * (2 * h + 2 * hkv) * hd + h * hd * d
    if dense:
        return attn + 3 * d * arch["intermediate_size"]
    inter = arch["moe_intermediate_size"]
    routed = arch["num_experts_per_tok"] * 3 * d * inter
    shared = arch["num_shared_experts"] * 3 * d * inter
    return attn + d * arch["num_experts"] + routed + shared


def train_step(arch: dict, layout, n_img: int, n_clean_real: int,
               device="cpu") -> Dict[str, object]:
    """One training step over ``layout`` on the inline route (K6, K7):
    tokens, model FLOPs, matmul FLOPs (the linears without the routed
    experts) and the bounds of the attention kernels and of the routed
    experts, in ms."""
    layers = arch["num_hidden_layers"]
    types = arch["layer_types"][:layers]
    dense = arch["num_dense_layers"]
    B, L = layout.batch, layout.length
    nn_ = layout.num_noisy_frames
    real = flops.real_tokens(layout)
    h, hkv, hd = heads(arch)
    d, inter = arch["hidden_size"], arch["moe_intermediate_size"]
    k = arch["num_experts_per_tok"]

    by_type = {SLIDING: window_pairs(layout, arch["sliding_window"], device),
               "full_attention": window_pairs(layout, 0, device)}
    weights = sum(layer_linears(arch, i < dense) for i in range(layers))
    routed = k * 3 * d * inter * (layers - min(dense, layers))
    emb = flops.patch_flops(arch, (nn_ + n_clean_real) * n_img)
    head = flops.head_flops(arch, nn_, n_img)
    att = sum(2.0 * flops.FWD_PRODUCTS * by_type[ty]["model"] * hd * h
              for ty in types)
    fwd_model = 2.0 * weights * real + emb + head + att
    fwd_matmul = 2.0 * (weights - routed) * real + emb + head

    meta = flops.metadata_bytes(B, L) + (2 * B * L * INT32 if any(
        ty == SLIDING for ty in types) else 0)
    q_side, kv_side = B * L * h * hd * BF16, B * L * hkv * hd * BF16
    fwd_bytes = 2 * q_side + 2 * kv_side + meta + B * h * L * FP32
    bwd_bytes = (3 * q_side + 2 * kv_side) + (q_side + 2 * kv_side) \
        + B * h * L * FP32 + meta
    attention = 0.0
    for ty in types:
        p = by_type[ty]["kernel"]
        fwd = bound_ms(fwd_bytes, 2.0 * flops.FWD_PRODUCTS * p * hd * h)
        bwd = bound_ms(bwd_bytes, 2.0 * flops.BWD_PRODUCTS * p * hd * h)
        attention += 2 * fwd + bwd

    rows = real * k  # the permuted rows of an expert layer's pass
    w_bytes = arch["num_experts"] * 3 * d * inter * BF16
    pass_flops = 2.0 * rows * 3 * d * inter
    pass_bytes = w_bytes + 2 * rows * d * BF16
    moe = (layers - min(dense, layers)) * (
        2 * bound_ms(pass_bytes, pass_flops)
        + bound_ms(2 * pass_bytes, 2 * pass_flops))
    return {"model_flops": 3 * fwd_model, "matmul_flops": 3 * fwd_matmul,
            "bounds_ms": {"inline_attention": attention, "moe": moe},
            "tokens": real,
            "pairs": {ty: by_type[ty] for ty in set(types)}}
