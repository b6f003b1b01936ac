"""The yardstick: operations and bytes of the work a cell asks for.

Every count here comes from shapes and from the cell's own masks (the
layouts of ``reference/``), never from the program. Peaks are NVIDIA's data
sheet for one H100 SXM at its 700 W limit, dense rates.

- Model FLOPs: two a weight a token through the trunk's linears, the patch
  embedders and the final layer (the vocabulary table is a lookup, not a
  product), plus QK^T and PV over the visible (query, key) pairs of the
  cell's masks, real tokens only. A training step is three forwards (the
  recompute of the per-layer checkpoints is not counted).
- Kernel bounds: max(bytes / HBM rate, FLOPs / bf16 rate) of each attention
  call, each input and output counted once. FLOPs are the visible pairs of
  the forward's two products, or of the four products a backward needs
  (dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q); a kernel that
  recomputes S pays for it in its time, not in its bound. Pad queries
  attend every key under the rule, and a kernel computes them, so kernel
  pairs count them.
- Matmul FLOPs: the model's own products through the linears (two a
  weight a token, real tokens only; a training step three forwards), so
  that the rate reads the same work whatever the program recomputes or
  pads.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2
FP32 = 4
INT32 = 4
FWD_PRODUCTS = 2
BWD_PRODUCTS = 4
KIND_PAD = 0


def bound_ms(nbytes: float, flops: float) -> float:
    """The least time the card could take for this work, in ms."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS) * 1e3


def bound_by(nbytes: float, flops: float) -> str:
    return "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_BF16_FLOPS \
        else "operations"


def row_pairs(layout, b: int, queries: slice = slice(None),
              keys: slice = slice(None), pad_rows: bool = True) -> int:
    """Visible (query, key) pairs of row ``b`` between the tokens
    ``queries`` and ``keys`` under the frame-block rule: a clean or text
    key from its ``vis_start`` on; a noisy key to the queries of its own
    block whose offset reaches its role; a pad query to every key (counted
    only with ``pad_rows``)."""
    L = layout.length
    idx = np.arange(L)[queries]
    vis = layout.vis_start[b][keys]
    nb, role = layout.noisy_block[b][keys], layout.noisy_role[b][keys]
    qb, qo = layout.q_block[b][queries], layout.q_offset[b][queries]
    pad = layout.kind[b][queries] == KIND_PAD
    causal = np.searchsorted(np.sort(vis), idx, side="right")
    noisy = np.zeros(idx.shape, np.int64)
    blocks = np.unique(nb[nb >= 0])
    for g in blocks:
        cnt = np.bincount(role[nb == g], minlength=3)[:3].cumsum()
        sel = qb == g
        noisy[sel] = cnt[np.minimum(qo[sel], 2)]
    per_q = causal + noisy
    n_keys = vis.shape[0]
    if pad_rows:
        per_q = np.where(pad, n_keys, per_q)
    else:
        per_q = np.where(pad, 0, per_q)
    return int(per_q.sum())


def pairs(layout, pad_rows: bool = True, queries: slice = slice(None),
          keys: slice = slice(None)) -> int:
    return sum(row_pairs(layout, b, queries, keys, pad_rows)
               for b in range(layout.batch))


def real_tokens(layout) -> int:
    """Tokens the rows hold, the collate's padding left out."""
    return int((layout.kind != KIND_PAD).sum())


# ---- one attention call ------------------------------------------------------

def attention_fwd(arch: dict, batch: int, n_q: int, n_k: int, n_pairs: int,
                  extra_bytes: int = 0, lse: bool = False) -> Dict[str, float]:
    """Bytes and FLOPs of one forward attention call: q and the output at
    the query heads, k and v at the key heads, in bf16; ``n_pairs`` the
    visible pairs summed over the batch; ``lse`` an fp32 log-sum-exp per
    query and head written for a backward; ``extra_bytes`` the mask's own
    operand (a dense bias, the metadata, a rank vector)."""
    h, hkv, d = _heads(arch)
    nbytes = (2 * batch * n_q * h * d + 2 * batch * n_k * hkv * d) * BF16
    nbytes += extra_bytes + (batch * h * n_q * FP32 if lse else 0)
    flops = 2 * FWD_PRODUCTS * n_pairs * d * h
    return {"bytes": nbytes, "flops": flops}


def attention_bwd(arch: dict, batch: int, n: int, n_pairs: int,
                  extra_bytes: int = 0) -> Dict[str, float]:
    """Bytes and FLOPs of one backward call of self-attention over ``n``
    tokens: reads q, k, v, the output, its gradient and the fp32
    log-sum-exp; writes dq, dk, dv; four products over the visible
    pairs."""
    h, hkv, d = _heads(arch)
    q_side = batch * n * h * d * BF16
    kv_side = batch * n * hkv * d * BF16
    nbytes = (3 * q_side + 2 * kv_side) + (q_side + 2 * kv_side)
    nbytes += batch * h * n * FP32 + extra_bytes
    flops = 2 * BWD_PRODUCTS * n_pairs * d * h
    return {"bytes": nbytes, "flops": flops}


def metadata_bytes(batch: int, n: int) -> int:
    """The seven int32 vectors of the token metadata."""
    return 7 * batch * n * INT32


def call_bound_ms(work: Dict[str, float]) -> float:
    return bound_ms(work["bytes"], work["flops"])


# ---- linears ------------------------------------------------------------------

def _heads(arch: dict):
    h = arch["num_attention_heads"]
    return h, arch["num_key_value_heads"], arch["hidden_size"] // h


def trunk_weights(arch: dict) -> int:
    """Weights of the trunk's linears (qkv, o, gate-up, down) over every
    layer."""
    h, hkv, d = _heads(arch)
    hid, inter = arch["hidden_size"], arch["intermediate_size"]
    per_layer = hid * (h + 2 * hkv) * d + h * d * hid + hid * 2 * inter \
        + inter * hid
    return per_layer * arch["num_hidden_layers"]


def patch_flops(arch: dict, patches: int) -> float:
    p, c = arch["patch_size"], arch["in_channels"]
    return 2.0 * p * p * c * arch["hidden_size"] * patches


def head_flops(arch: dict, frames: int, n_img: int) -> float:
    """The final layer: the adaLN modulation per frame, the linear to
    p·p·C per patch."""
    p, c, d = arch["patch_size"], arch["in_channels"], arch["hidden_size"]
    return 2.0 * frames * (d * 2 * d + n_img * d * p * p * c)


def attention_flops(arch: dict, n_pairs: int) -> float:
    h, _, d = _heads(arch)
    return 2.0 * FWD_PRODUCTS * n_pairs * d * h


# ---- a cell's unit of work -------------------------------------------------------

def serve_request(arch: dict, lay_c, lay_u, prefix: int, n_img: int,
                  steps: int, guided: bool, n_clean: int, n_gen: int
                  ) -> Dict[str, object]:
    """One video's request of one generated block: the prefill of the clean
    context (the bias route: K3 and the bias's map), then each step's
    cached conditional row (K1 over cache and tail) and, when guided, the
    unconditional row alone (K2). Returns the model FLOPs, the matmul
    FLOPs and each kernel family's summed bound in ms."""
    layers = arch["num_hidden_layers"]
    L = lay_c.length
    tail = L - prefix
    w2 = 2.0 * trunk_weights(arch)
    pre = slice(0, prefix)
    p_prefill = pairs(lay_c, queries=pre, keys=pre)
    p_cond = pairs(lay_c, queries=slice(prefix, L))
    p_unc = pairs(lay_u) if guided else 0
    rows = 2 if guided else 1
    lin = w2 * (prefix + steps * (tail + (lay_u.length if guided else 0)))
    emb = patch_flops(arch, n_clean * n_img + steps * rows * n_gen * n_img)
    head = steps * rows * head_flops(arch, n_gen, n_img)
    att = attention_flops(arch, p_prefill + steps * (p_cond + p_unc))
    bias_bytes = prefix * prefix * BF16
    k3 = attention_fwd(arch, 1, prefix, prefix, p_prefill, bias_bytes)
    k1 = attention_fwd(arch, 1, tail, L, p_cond, (L + tail) * INT32)
    bounds = {"bias_attention": layers * call_bound_ms(k3)
              + bound_ms(bias_bytes, 0),
              "rank_attention": layers * steps * call_bound_ms(k1)}
    if guided:
        k2 = attention_fwd(arch, 1, lay_u.length, lay_u.length, p_unc,
                           2 * lay_u.length * INT32)
        bounds["rank_attention"] += layers * steps * call_bound_ms(k2)
    return {"model_flops": lin + emb + head + att,
            "matmul_flops": lin + emb + head, "bounds_ms": bounds}


def train_step(arch: dict, layout, n_img: int, n_clean_real: int,
               bias_limit: int) -> Dict[str, object]:
    """One training step over ``layout`` (B rows padded to one length):
    forward, the recomputed forward of every checkpointed layer, and the
    backward. Attention takes the bias route (K3, K9, one bias map a step)
    while B·L² is within ``bias_limit``, else the inline route (K6, K7,
    each building its map from the metadata). ``n_clean_real`` clean
    frames are real (the collate's padding slots are left out)."""
    layers = arch["num_hidden_layers"]
    B, L = layout.batch, layout.length
    nn_ = layout.num_noisy_frames
    w2 = 2.0 * trunk_weights(arch)
    k_pairs = pairs(layout, pad_rows=True)
    m_pairs = pairs(layout, pad_rows=False)
    real = real_tokens(layout)
    emb_real = patch_flops(arch, (nn_ + n_clean_real) * n_img)
    head = head_flops(arch, nn_, n_img)
    fwd_linears = w2 * real + emb_real + head
    fwd_model = fwd_linears + attention_flops(arch, m_pairs)
    if B * L * L <= bias_limit:
        extra = B * L * L * BF16
        fam = "bias_attention"
        fwd = attention_fwd(arch, B, L, L, k_pairs, extra, lse=True)
        bwd = attention_bwd(arch, B, L, k_pairs, extra)
        maps = bound_ms(extra, 0)
    else:
        extra = metadata_bytes(B, L)
        fam = "inline_attention"
        fwd = attention_fwd(arch, B, L, L, k_pairs, extra, lse=True)
        bwd = attention_bwd(arch, B, L, k_pairs, extra)
        maps = 0.0
    total = layers * (2 * call_bound_ms(fwd) + call_bound_ms(bwd)) + maps
    return {"model_flops": 3 * fwd_model, "matmul_flops": 3 * fwd_linears,
            "bounds_ms": {fam: total}, "tokens": real}
