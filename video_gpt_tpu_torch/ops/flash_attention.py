"""The attention kernels of serving and training, each beside its plain
version.

Port of every Pallas kernel of ``video_gpt_tpu/ops/flash_attention.py``
(the overlap probe of ``scripts/overlap_probe.py`` is
``video_gpt_tpu_torch.probes.overlap_probe``):

- K1 :func:`flash_mha_decode_split` (TPU ``_decode_split_kernel``): the
  cond-row decode step and the cache extend, over separate cache and tail
  K/V operands; past 8192 keys also the TPU's k-tiled
  ``_stream_decode_split_kernel`` (K4), which computes the same function;
- K2 :func:`flash_mha_decode` (TPU ``_decode_kernel``): the uncond row;
  past 8192 keys also ``_stream_decode_kernel`` (K5);
- K3 :func:`flash_mha` (TPU ``_bias_kernel``): the prefill and the stage-1
  training forward, with the bias of :func:`precompute_bias`; past 8192
  keys also ``_stream_kernel`` (K10, ``flash_mha_streaming``);
- K9 :func:`flash_mha_bwd` (TPU ``_bwd_kernel``): the backward of K3;
- K6 :func:`flash_mha_inline` (TPU ``_stream_inline_kernel``, and the
  resident ``_inline_kernel``, K8, which computes the same function): the
  attention with the visibility rule evaluated per tile from the seven
  int32 metadata vectors, where a precomputed bias would be too large
  (stages 2-4, and any B*Lq*Lk above ``precompute_bias_limit``);
- K7 :func:`flash_mha_inline_bwd` (TPU ``_stream_dq_kernel`` and
  ``_stream_dkv_kernel``): the backward of K6.

Every kernel comes in two dtypes. bf16 operands run the tensor-core
kernels named below; fp32 operands run ``csrc/fp32_attention.cu``, one
hand-written fp32 kernel templated on the three masks (columnar rank,
bias and its map, inline metadata and its map), and for the backward
``csrc/fp32_attention_bwd.cu``, its twin under the bias and the inline
masks. Both compute every fp32 product on the bf16 tensor cores, as the
TPU computes an fp32 dot at HIGHEST precision: each operand split exactly
into three bf16 pieces, six of the nine piece products kept, fp32
accumulation (``csrc/fp32_split.cuh``; no TF32). Their plain split,
:func:`split_pieces` and :func:`split_matmul`, serves the tests only.
:func:`forward_kernel` and :func:`backward_kernel` choose, from the
operands' dtype and head width: both kinds take any
head_dim <= 128 that is a multiple of 8, laid out at the least of 32, 64,
96, 128 that holds it, the head dims past head_dim zero-filled on load.
Each wrapper counts its bf16 launches in ``launches`` and its fp32
launches in ``fp32_launches``.

K1 and K2 are one CUDA kernel (``csrc/rank_attention.cu``), which
classifies each key tile from its ranks as it loads them and never loads a
tile that no query of its block sees (plain classes:
:func:`rank_tile_classes_reference`); K3 is ``csrc/bias_attention.cu``, K9
``csrc/bias_attention_bwd.cu``, K6 ``csrc/inline_attention.cu`` and K7
``csrc/inline_attention_bwd.cu``. Those four compute only the tiles that
their mask does not hide entirely, over a tile map (``csrc/tile_map.cuh``;
plain versions
:func:`inline_tile_classes_reference` and
:func:`bias_tile_classes_reference`, the map alone
:func:`inline_tile_classes` and :func:`bias_tile_classes`): K6 and K7 build
the metadata's map in each launch; the bias's map is built once per bias
by :func:`bias_map` (where the model builds the bias) and read by every
K3 and K9 launch over that bias. A K6 block is a TMA producer warpgroup
and one to four consumer warpgroups of 64 query rows that share each
loaded K/V tile: it loads the key tiles that some of its query tiles see
(the union of their rows of the map) and each consumer computes those it
sees; the blocks launch by that count, most first (plain version
:func:`inline_groups_reference`). The kernel chooses the block from the
head width and the grid (:func:`inline_block_rows`); the wrapper counts
its bf16 launches by those rows in ``flash_mha_inline.launches_by_rows``.
K8 (the resident kernel) is the same kernel. Each
wrapper takes its plain PyTorch version (``*_reference``) for CPU tensors
only; for CUDA tensors it launches the kernel or raises, and counts the
launch in its ``launches`` attribute (K1-K3 also in ``long_launches``
past ``TPU_KEY_CAP`` keys, where the TPU runs K4, K5, K10).
:func:`flash_mha` and :func:`flash_mha_inline` are differentiable: under
autograd the forward keeps the per-row logsumexp, and the backward is K9,
resp. K7. The TPU
layout choices are gone: no 96->128 lane pad, no 8192-key VMEM cap, no
VMEM-tuned query blocks, and the bias is not padded. Every CUDA kernel
streams its keys through shared memory in 64-key tiles with no length cap,
so the TPU's streaming variants for rows past 8192 keys (K4, K5, K10) are
the same kernels as K1, K2 and K3: the long rollout's cond-row decode over
17,760 keys is K1, and its prefill is K3 at B = 1 (where the TPU runs K6)
and K6 at B = 2 (B*L^2 above ``precompute_bias_limit``, as on the TPU).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from . import _cuda
from .attention import AttnMeta, Window

BF16_NEG = float(torch.finfo(torch.bfloat16).min) * 0.5
LOG2E = 1.4426950408889634
NEVER = 2 ** 30
# the head widths the CUDA kernels are laid out at (padded_head_dim in
# csrc/attention_common.cuh): a head_dim runs at the least that holds it
KERNEL_HEAD_DIMS = (32, 64, 96, 128)
# the kernels by operand dtype: the tensor-core kernels of each mask
# (bf16), csrc/fp32_attention.cu and csrc/fp32_attention_bwd.cu (fp32)
KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "fp32"}
# the TPU kernels' VMEM cap on a key row; past it the TPU runs its k-tiled
# K4, K5 and K10, whose function K1, K2 and K3 compute here. Those three
# wrappers count such launches apart, in ``long_launches``
TPU_KEY_CAP = 8192
# the tiles of the kernels' tile maps (kBlockQ, kBlockK, kRankTile in csrc),
# and the classes of csrc/tile_map.cuh: no pair visible, some, all
TILE_Q, TILE_K = 64, 64
TILE_EMPTY, TILE_PARTIAL, TILE_FULL = 0, 1, 2


class DecodeMask(NamedTuple):
    """Columnar decode mask: ``visible(q, k) = q_off[q] >= rank[k]``.

    Valid when every query shares one noisy frame-block and every key is
    visible to all of them, never visible, or a same-block noisy key gated
    by its role (host-side predicate: ``layout.decode_rank``)."""

    rank: torch.Tensor   # [B, Lk] int32
    q_off: torch.Tensor  # [B, Lq] int32


def _padded_visibility(q_meta: AttnMeta, k_meta: AttnMeta, lqp: int,
                       lkp: int, window: Optional[Window] = None
                       ) -> torch.Tensor:
    """[B, Lqp, Lkp] bool; padded queries act as pad rows over real keys,
    padded keys are never visible. A ``window`` hides the keys at
    q_pos - k_pos >= its size from the non-pad queries."""
    lq = q_meta.index.shape[1]
    lk = k_meta.vis_start.shape[1]

    def padq(x, fill):
        return torch.nn.functional.pad(x, (0, lqp - lq), value=fill)[:, :, None]

    def padk(x, fill):
        return torch.nn.functional.pad(x, (0, lkp - lk), value=fill)[:, None, :]

    q_idx, q_blk = padq(q_meta.index, 0), padq(q_meta.q_block, -2)
    q_off, q_pad = padq(q_meta.q_offset, 0), padq(q_meta.is_pad, 1)
    vis = padk(k_meta.vis_start, NEVER)
    k_blk, k_role = padk(k_meta.noisy_block, -1), padk(k_meta.noisy_role, 0)
    col = torch.arange(lkp, device=vis.device)[None, None, :]
    out = ((q_idx >= vis)
           | ((k_blk >= 0) & (k_blk == q_blk) & (q_off >= k_role))
           | ((q_pad > 0) & (col < lk)))
    if window is not None and window.size > 0:
        q_pos, k_pos = padq(window.q_pos, 0), padk(window.k_pos, 0)
        out = out & ((q_pos - k_pos < window.size) | (q_pad > 0))
    return out


def precompute_bias(q_meta: AttnMeta, k_meta: AttnMeta,
                    window: Optional[Window] = None) -> torch.Tensor:
    """bf16 additive bias [B, Lq, Lk]: 0 where visible, ``BF16_NEG`` where
    masked (finite, so a fully masked row stays NaN-free). Built once per
    clip and shared by every layer (with a ``window``, by every layer of
    that window)."""
    lq = q_meta.index.shape[1]
    lk = k_meta.vis_start.shape[1]
    visible = _padded_visibility(q_meta, k_meta, lq, lk, window)
    return torch.where(
        visible, torch.zeros((), dtype=torch.bfloat16, device=visible.device),
        torch.tensor(BF16_NEG, dtype=torch.bfloat16, device=visible.device))


# ---- plain versions (CPU path and test oracle) ------------------------------

# query rows per step of the plain versions, which walk one kv head's group
# and this many rows at a time: at L 35520 one head's fp32 [rows, Lk] scores
# are 0.58 GB, so a step holds a few GB, not the 160 GB of a whole-row
# softmax over all heads (the long rollout's K1 row over 17,760 keys: 12 GB)
INLINE_ROWS = 4096
# query heads per step of the plain K9, which holds [B, heads, Lq, Lk] fp32
# products of that many heads at once
BIAS_BWD_HEADS = 32


def _row_steps(b: int, lq: int, hkv: int, group: int):
    """(batch, kv head, its q heads, query rows) for each step of the plain
    versions, ``INLINE_ROWS`` rows at a time."""
    for bi in range(b):
        for r0 in range(0, lq, INLINE_ROWS):
            rows = slice(r0, min(r0 + INLINE_ROWS, lq))
            for g in range(hkv):
                yield bi, g, slice(g * group, (g + 1) * group), rows


def rank_attention_reference(q: torch.Tensor, ks: Sequence[torch.Tensor],
                             vs: Sequence[torch.Tensor],
                             ranks: Sequence[torch.Tensor],
                             q_off: torch.Tensor) -> torch.Tensor:
    """Plain K1/K2 (and the TPU's k-tiled K4/K5, the same function):
    unshifted-exp2 columnar attention over the key operands ``ks``/``vs``
    (heads-major [B,Hkv,Lk_i,D], in order) with per-key ranks ``ranks``
    ([B, Lk_i]). q [B,Lq,H,D] -> [B,Lq,H,D] in q's dtype. The
    probabilities are cast to v's dtype before P.V, as the kernels do. Runs
    one kv head's group and ``INLINE_ROWS`` query rows at a time."""
    b, lq, h, d = q.shape
    kscale = d ** -0.5 * LOG2E
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for bi, g, heads, rows in _row_steps(b, lq, ks[0].shape[1],
                                         h // ks[0].shape[1]):
        qf = q[bi, rows, heads].transpose(0, 1).float()   # [G, n, D]
        qo = q_off[bi, rows, None]
        l = acc = 0.0
        for k, v, rank in zip(ks, vs, ranks):
            s = qf @ k[bi, g].float().T * kscale
            p = torch.where(qo >= rank[bi, None, :],
                            torch.exp2(s.clamp(-100.0, 100.0)),
                            torch.zeros((), device=s.device))
            l = l + p.sum(-1, keepdim=True)
            acc = acc + p.to(v.dtype).float() @ v[bi, g].float()
        o = acc / torch.clamp(l, min=1e-30)
        out[bi, rows, heads] = o.transpose(0, 1).to(q.dtype)
    return out


def bias_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor
                             ) -> torch.Tensor:
    """Plain K3 (and the TPU's k-tiled K10, the same function):
    max-subtracted softmax attention plus an additive bias [B, Lq, Lk];
    q [B,Lq,H,D], k/v [B,Lk,Hkv,D]. The probabilities are cast to v's dtype
    before P.V. Runs one kv head's group and ``INLINE_ROWS`` query rows at
    a time."""
    b, lq, h, d = q.shape
    hkv = k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for bi, g, heads, rows in _row_steps(b, lq, hkv, h // hkv):
        qf = q[bi, rows, heads].transpose(0, 1).float()   # [G, n, D]
        logits = (qf @ k[bi, :, g].float().T * d ** -0.5
                  + bias[bi, rows].float())
        p = torch.softmax(logits, dim=-1)
        o = p.to(v.dtype).float() @ v[bi, :, g].float()
        out[bi, rows, heads] = o.transpose(0, 1).to(q.dtype)
    return out


def bias_attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, bias: torch.Tensor,
                                      o: torch.Tensor, do: torch.Tensor,
                                      magnitude: bool = False):
    """Plain K9: the gradients (dq, dk, dv) of :func:`flash_mha` at output
    ``o`` for the output cotangent ``do``, by the TPU kernel's math in fp32:
    the softmax recomputed over the whole key row, di = rowsum(o * do),
    ds = p (dp - di) scale, dq = ds K, dk = ds^T Q, dv = p^T dO, the GQA
    group's heads summed. Shapes as :func:`flash_mha`; grads in the inputs'
    dtypes.

    ``magnitude=True`` returns instead the same products over absolute
    values, in fp32: (|ds| |K|, |ds|^T |Q|, p^T |dO|), the mass that the
    kernel's bf16 rounding of ds and p before its products is read
    against."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = d ** -0.5
    dq = torch.empty((b, lq, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, lk, hkv, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    bias_f = bias.float()[:, None]
    # BIAS_BWD_HEADS query heads (whole GQA groups) at a time: the [B, H,
    # Lq, Lk] fp32 products of every head at once would not fit the card
    # at 192 heads of 16 over L 7104
    step = max(1, BIAS_BWD_HEADS // group)
    for g0 in range(0, hkv, step):
        gs = slice(g0, min(g0 + step, hkv))
        hs = slice(gs.start * group, gs.stop * group)

        def heads(x, sl, rep=1):
            return x[:, :, sl].transpose(1, 2).float().repeat_interleave(
                rep, dim=1)

        qf, of, dof = heads(q, hs), heads(o, hs), heads(do, hs)
        kf, vf = heads(k, gs, group), heads(v, gs, group)
        p = torch.softmax(qf @ kf.transpose(-1, -2) * scale + bias_f,
                          dim=-1)                            # [B,h,Lq,Lk]
        di = (of * dof).sum(-1, keepdim=True)
        ds = p * (dof @ vf.transpose(-1, -2) - di) * scale
        if magnitude:
            ds, qf, kf, dof = ds.abs(), qf.abs(), kf.abs(), dof.abs()
        dq[:, :, hs] = (ds @ kf).transpose(1, 2)
        for out, x in ((dk, ds.transpose(-1, -2) @ qf),
                       (dv, p.transpose(-1, -2) @ dof)):
            out[:, :, gs] = x.reshape(b, -1, group, lk, d).sum(2).transpose(
                1, 2)
        del p, ds
    if magnitude:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _window_rows(window: Optional[Window], b: int, sl: slice):
    """``window`` at batch row b and the query rows ``sl`` (every key)."""
    if window is None:
        return None
    return Window(window.size, window.q_pos[b:b + 1, sl],
                  window.k_pos[b:b + 1])


def _inline_steps(q_meta: AttnMeta, k_meta: AttnMeta, lq: int, hkv: int,
                  group: int, window: Optional[Window] = None):
    """The steps of :func:`_row_steps` with the visible [rows, Lk] of each:
    K6's rule, ``_padded_visibility`` with no padding."""
    lk = k_meta.vis_start.shape[1]
    at = vis = None
    for b, g, heads, sl in _row_steps(q_meta.index.shape[0], lq, hkv, group):
        if at != (b, sl.start):
            at = (b, sl.start)
            km = AttnMeta(*(x[b:b + 1] for x in k_meta))
            qm = AttnMeta(*(x[b:b + 1, sl] for x in q_meta))
            vis = _padded_visibility(qm, km, sl.stop - sl.start, lk,
                                     _window_rows(window, b, sl))[0]
        yield b, g, heads, sl, vis


def _inline_probs(qf: torch.Tensor, kf: torch.Tensor, vis: torch.Tensor,
                  scale: float):
    """(p, lse) of the rows ``qf`` [G, n, D] over the keys ``kf`` [Lk, D]:
    the softmax over the visible keys and its logsumexp. A row that sees no
    key gets p = 0 and lse = -inf."""
    s = torch.where(vis, qf @ kf.T * scale,
                    torch.tensor(float("-inf"), device=qf.device))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - lse), torch.zeros((), device=s.device))
    return p, lse[..., 0]


def inline_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, q_meta: AttnMeta,
                               k_meta: AttnMeta,
                               window: Optional[Window] = None):
    """Plain K6: softmax attention over the keys that the metadata rule
    makes visible to each query; q [B,Lq,H,D], k/v [B,Lk,Hkv,D] ->
    (out [B,Lq,H,D] in q's dtype, lse [B, H, Lq] fp32, the natural-log
    logsumexp of each row's scaled logits over its visible keys). The
    probabilities are cast to v's dtype before P.V, as the kernels do. Runs
    one kv head's group and ``INLINE_ROWS`` query rows at a time; a
    ``window`` narrows the rule."""
    b, lq, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    for bi, g, heads, sl, vis in _inline_steps(q_meta, k_meta, lq, hkv,
                                               group, window):
        qf = q[bi, sl, heads].transpose(0, 1).float()   # [G, n, D]
        p, lse_g = _inline_probs(qf, k[bi, :, g].float(), vis, d ** -0.5)
        o = p.to(v.dtype).float() @ v[bi, :, g].float()
        out[bi, sl, heads] = o.transpose(0, 1).to(q.dtype)
        lse[bi, heads, sl] = lse_g
    return out, lse


def inline_attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                        v: torch.Tensor, q_meta: AttnMeta,
                                        k_meta: AttnMeta, o: torch.Tensor,
                                        do: torch.Tensor,
                                        magnitude: bool = False,
                                        lse: Optional[torch.Tensor] = None,
                                        window: Optional[Window] = None):
    """Plain K7: the gradients (dq, dk, dv) of :func:`flash_mha_inline` at
    output ``o`` for the cotangent ``do``, by the TPU kernels' math in fp32:
    p = exp(s - lse) where the key is visible, else 0, di = rowsum(o * do),
    ds = p (dp - di) scale, dq = ds K, dk = ds^T Q, dv = p^T dO, the GQA
    group's heads summed. ``lse`` [B, H, Lq] is the logsumexp the kernels
    are handed: a ring chunk's backward gets the global one of the whole
    key row, of which these keys are a part; without it p is the softmax
    over these keys (their own lse). Shapes as :func:`flash_mha_inline`;
    grads in the inputs' dtypes. ``magnitude=True`` returns the same
    products over absolute values, in fp32, as
    :func:`bias_attention_backward_reference` does. Runs one kv head's
    group and ``INLINE_ROWS`` query rows at a time; a ``window`` narrows
    the rule."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = d ** -0.5
    dq = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, lk, hkv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for bi, g, heads, sl, vis in _inline_steps(q_meta, k_meta, lq, hkv,
                                               group, window):
        def rows_of(x):
            return x[bi, sl, heads].transpose(0, 1).float()  # [G, n, D]

        qf, of, dof = rows_of(q), rows_of(o), rows_of(do)
        kf, vf = k[bi, :, g].float(), v[bi, :, g].float()
        if lse is None:
            p, _ = _inline_probs(qf, kf, vis, scale)
        else:
            s = qf @ kf.T * scale - lse[bi, heads, sl].float()[..., None]
            p = torch.where(vis, torch.exp(s), torch.zeros((), device=s.device))
        di = (of * dof).sum(-1, keepdim=True)
        ds = p * (dof @ vf.T - di) * scale
        if magnitude:
            ds, qf, kf, dof = ds.abs(), qf.abs(), kf.abs(), dof.abs()
        dq[bi, sl, heads] = (ds @ kf).transpose(0, 1)
        dk[bi, :, g] += (ds.transpose(-1, -2) @ qf).sum(0)
        dv[bi, :, g] += (p.transpose(-1, -2) @ dof).sum(0)
    if magnitude:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---- the fp32 kernels' split products (plain; tests only) --------------------

# the piece products that the fp32 kernels keep, (A's piece, B's piece) with
# 0 = h, 1 = m, 2 = l: the correction products first, hh last
# (csrc/fp32_split.cuh; ml, lm, ll are dropped)
SPLIT_PRODUCTS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def split_pieces(x: torch.Tensor):
    """The three bf16 pieces (h, m, l) of fp32 ``x`` as the fp32 kernels
    split an operand: h = bf16(x), m = bf16(x - h), l = bf16(x - h - m),
    each subtraction exact in fp32, so h + m + l == x for every x whose
    pieces stay normal (|x| >= 2^-102)."""
    h = x.to(torch.bfloat16)
    r = x - h.float()
    m = r.to(torch.bfloat16)
    return h, m, (r - m.float()).to(torch.bfloat16)


def split_matmul(a: torch.Tensor, b: torch.Tensor,
                 pieces: int = 3) -> torch.Tensor:
    """fp32 ``a @ b`` as the fp32 kernels compute it on the tensor cores:
    the sum of the kept products of the bf16 pieces of ``a`` and ``b``
    (``SPLIT_PRODUCTS``), each piece product exact in fp32. ``pieces`` 1
    or 2 keeps only the products of the first pieces: a plain bf16 product,
    or two pieces (hh, hm, mh, mm), the shortcuts that the fp32 bar tells
    apart from the kernels' three."""
    pa, pb = split_pieces(a.float()), split_pieces(b.float())
    out = None
    for i, j in SPLIT_PRODUCTS:
        if i < pieces and j < pieces:
            x = pa[i].float() @ pb[j].float()
            out = x if out is None else out + x
    return out


def _tile_view(x: torch.Tensor, tile_q: int, tile_k: int) -> torch.Tensor:
    """bool [n, Lk] -> uint8 [ceil(n/tile_q), ceil(Lk/tile_k), tile_q *
    tile_k], the tiles of ``x`` padded with False."""
    n, lk = x.shape
    nq, nk = -(-n // tile_q), -(-lk // tile_k)
    x = torch.nn.functional.pad(x.to(torch.uint8),
                                (0, nk * tile_k - lk, 0, nq * tile_q - n))
    return x.view(nq, tile_q, nk, tile_k).transpose(1, 2).reshape(
        nq, nk, tile_q * tile_k)


def _classes(some: torch.Tensor, every: torch.Tensor) -> torch.Tensor:
    return torch.where(every.bool(), TILE_FULL, torch.where(
        some.bool(), TILE_PARTIAL, TILE_EMPTY)).to(torch.int8)


def _tile_row_steps(lq: int, tile_q: int):
    """Row slices of whole query tiles, about ``INLINE_ROWS`` rows each."""
    step = tile_q * max(1, INLINE_ROWS // tile_q)
    for r0 in range(0, lq, step):
        yield slice(r0, min(r0 + step, lq))


def inline_tile_classes_reference(q_meta: AttnMeta, k_meta: AttnMeta,
                                  tile_q: int = TILE_Q,
                                  tile_k: int = TILE_K,
                                  window: Optional[Window] = None
                                  ) -> torch.Tensor:
    """Plain version of K6's tile map: int8 [B, ceil(Lq/tile_q),
    ceil(Lk/tile_k)], per (query tile, key tile) ``TILE_EMPTY`` when no
    real pair (query < Lq, key < Lk) is visible, ``TILE_FULL`` when the
    tile lies inside [0, Lq) x [0, Lk) and every pair is visible, else
    ``TILE_PARTIAL``: the visibility of K6's rule reduced tile by tile,
    whole query tiles of about ``INLINE_ROWS`` rows at a time."""
    b, lq = q_meta.index.shape
    lk = k_meta.vis_start.shape[1]
    out = torch.empty((b, -(-lq // tile_q), -(-lk // tile_k)),
                      dtype=torch.int8, device=q_meta.index.device)
    for bi in range(b):
        km = AttnMeta(*(x[bi:bi + 1] for x in k_meta))
        for sl in _tile_row_steps(lq, tile_q):
            qm = AttnMeta(*(x[bi:bi + 1, sl] for x in q_meta))
            vis = _padded_visibility(qm, km, sl.stop - sl.start, lk,
                                     _window_rows(window, bi, sl))[0]
            t = _tile_view(vis, tile_q, tile_k)
            out[bi, sl.start // tile_q:-(-sl.stop // tile_q)] = _classes(
                t.any(-1), t.all(-1))
    return out


class InlineGroups(NamedTuple):
    """K6's blocks at ``group`` query tiles a block (the plain version of
    its group counts, order and key lists; csrc/inline_attention.cu)."""

    tiles: torch.Tensor   # bool [B, ng, nk]: the key tiles a block loads
    shared: torch.Tensor  # bool [B, ng, nk]: ... on which each of its
                          # query tiles computes
    counts: torch.Tensor  # int64 [B ng]: each block's loaded key tiles
    order: torch.Tensor   # int64 [B ng]: the blocks by count, most first


def inline_groups_reference(tile_map: torch.Tensor,
                            group: int) -> InlineGroups:
    """Plain version of how K6 walks its map [B, nq, nk] with ``group``
    consecutive query tiles a block (the last group of a batch row
    possibly shorter; ng = ceil(nq / group)): each block loads the key
    tiles that some query tile of its group does not call empty, in order
    of key tile, and the blocks launch by that count, most first (ties in
    order of batch row and group here; the kernel's are in any order)."""
    b, nq, nk = tile_map.shape
    ng = -(-nq // group)
    seen = tile_map != TILE_EMPTY
    pad = (0, 0, 0, ng * group - nq)
    tiles = torch.nn.functional.pad(seen, pad, value=False).view(
        b, ng, group, nk).any(2)
    # a query tile past the last (a short group's) computes nothing and
    # takes no stage
    shared = torch.nn.functional.pad(seen, pad, value=True).view(
        b, ng, group, nk).all(2)
    counts = tiles.sum(-1).flatten()
    order = torch.sort(counts, descending=True, stable=True).indices
    return InlineGroups(tiles, shared, counts, order)


def rank_tile_classes_reference(ranks: Sequence[torch.Tensor],
                                q_off: torch.Tensor, tile_q: int = TILE_Q,
                                tile_k: int = TILE_K) -> torch.Tensor:
    """Plain version of K1/K2's tile classes: int8 [B, ceil(Lq/tile_q),
    sum_i ceil(L_i/tile_k)], the key tiles of each operand ``ranks[i]``
    ([B, L_i] int32) in order, per (query tile, key tile) ``TILE_EMPTY``
    when no real pair has ``q_off >= rank``, ``TILE_FULL`` when the tile
    lies inside [0, Lq) x [0, L_i) and every pair does, else
    ``TILE_PARTIAL``: the columnar mask reduced tile by tile, whole query
    tiles of about ``INLINE_ROWS`` rows at a time."""
    b, lq = q_off.shape
    nk = [-(-r.shape[1] // tile_k) for r in ranks]
    out = torch.empty((b, -(-lq // tile_q), sum(nk)), dtype=torch.int8,
                      device=q_off.device)
    for bi in range(b):
        for sl in _tile_row_steps(lq, tile_q):
            rows = slice(sl.start // tile_q, -(-sl.stop // tile_q))
            k0 = 0
            for rank, n in zip(ranks, nk):
                vis = q_off[bi, sl, None] >= rank[bi, None, :]
                t = _tile_view(vis, tile_q, tile_k)
                out[bi, rows, k0:k0 + n] = _classes(t.any(-1), t.all(-1))
                k0 += n
    return out


def bias_tile_classes_reference(bias: torch.Tensor, tile_q: int = TILE_Q,
                                tile_k: int = TILE_K) -> torch.Tensor:
    """Plain version of K9's tile map of the bias [B, Lq, Lk]: int8 [B,
    ceil(Lq/tile_q), ceil(Lk/tile_k)], per tile ``TILE_FULL`` when it lies
    inside [0, Lq) x [0, Lk) and every entry is 0, ``TILE_EMPTY`` when
    every real entry is at most ``BF16_NEG`` and no row of its query tile
    is at most ``BF16_NEG`` everywhere (such a row sees no key, and its
    softmax is uniform, not 0), else ``TILE_PARTIAL``. Whole query tiles of
    about ``INLINE_ROWS`` rows at a time."""
    b, lq, lk = bias.shape
    out = torch.empty((b, -(-lq // tile_q), -(-lk // tile_k)),
                      dtype=torch.int8, device=bias.device)
    for bi in range(b):
        for sl in _tile_row_steps(lq, tile_q):
            x = bias[bi, sl].float()
            alive = x > BF16_NEG
            dead = _tile_view(~alive.any(-1, keepdim=True), tile_q, 1)
            some = _tile_view(alive, tile_q, tile_k).any(-1) \
                | dead.any(-1)
            every = _tile_view(x == 0, tile_q, tile_k).all(-1)
            out[bi, sl.start // tile_q:-(-sl.stop // tile_q)] = _classes(
                some, every)
    return out


# ---- CUDA launch helpers ----------------------------------------------------

class _RankArgs(ctypes.Structure):
    """Mirror of ``RankAttnArgs`` in csrc/rank_attention.cu."""
    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p * 2),
        ("v", ctypes.c_void_p * 2), ("rank", ctypes.c_void_p * 2),
        ("qoff", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("q_sb", ctypes.c_int64), ("q_sl", ctypes.c_int64),
        ("q_sh", ctypes.c_int64),
        ("k_sb", ctypes.c_int64 * 2), ("k_sl", ctypes.c_int64 * 2),
        ("k_sh", ctypes.c_int64 * 2),
        ("v_sb", ctypes.c_int64 * 2), ("v_sl", ctypes.c_int64 * 2),
        ("v_sh", ctypes.c_int64 * 2), ("rank_sb", ctypes.c_int64 * 2),
        ("qoff_sb", ctypes.c_int64),
        ("o_sb", ctypes.c_int64), ("o_sl", ctypes.c_int64),
        ("o_sh", ctypes.c_int64),
        ("len", ctypes.c_int * 2),
        ("batch", ctypes.c_int), ("heads", ctypes.c_int),
        ("kv_heads", ctypes.c_int), ("lq", ctypes.c_int),
        ("head_dim", ctypes.c_int), ("kscale", ctypes.c_float),
    ]


class _BiasArgs(ctypes.Structure):
    """Mirror of ``BiasAttnArgs`` in csrc/bias_attention.cu."""
    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("bias", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("lse", ctypes.c_void_p),
        ("tile_map", ctypes.c_void_p), ("order", ctypes.c_void_p),
        ("q_sb", ctypes.c_int64), ("q_sl", ctypes.c_int64),
        ("q_sh", ctypes.c_int64),
        ("k_sb", ctypes.c_int64), ("k_sl", ctypes.c_int64),
        ("k_sh", ctypes.c_int64),
        ("v_sb", ctypes.c_int64), ("v_sl", ctypes.c_int64),
        ("v_sh", ctypes.c_int64),
        ("bias_sb", ctypes.c_int64), ("bias_sq", ctypes.c_int64),
        ("o_sb", ctypes.c_int64), ("o_sl", ctypes.c_int64),
        ("o_sh", ctypes.c_int64),
        ("batch", ctypes.c_int), ("heads", ctypes.c_int),
        ("kv_heads", ctypes.c_int), ("lq", ctypes.c_int),
        ("lk", ctypes.c_int), ("head_dim", ctypes.c_int),
        ("scale_log2", ctypes.c_float), ("bias_vec", ctypes.c_int),
    ]


class _BiasMapArgs(ctypes.Structure):
    """Mirror of ``BiasMapArgs`` in csrc/bias_attention.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "bias", "tile_map", "rowdead", "counts", "order")] + [
        ("bias_sb", ctypes.c_int64), ("bias_sq", ctypes.c_int64)] + [
        (name, ctypes.c_int) for name in ("batch", "lq", "lk", "bias_vec")]


class _BiasBwdArgs(ctypes.Structure):
    """Mirror of ``BiasAttnBwdArgs`` in csrc/attention_args.cuh."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "k", "v", "bias", "o", "dout", "lse", "delta", "dq", "dk",
        "dv", "tile_map", "rowdead", "rowref")] + [
        (name, ctypes.c_int64) for name in (
            "q_sb", "q_sl", "q_sh", "k_sb", "k_sl", "k_sh", "v_sb", "v_sl",
            "v_sh", "bias_sb", "bias_sq", "o_sb", "o_sl", "o_sh", "do_sb",
            "do_sl", "do_sh", "dq_sb", "dq_sl", "dq_sh", "dkv_sb", "dkv_sl",
            "dkv_sh")] + [(name, ctypes.c_int) for name in (
                "batch", "heads", "kv_heads", "lq", "lk", "head_dim")] + [
        ("scale", ctypes.c_float), ("scale_log2", ctypes.c_float),
        ("bias_vec", ctypes.c_int)]


# the metadata vectors of the inline kernels, in the order of their
# ``qm``/``km`` pointer arrays (csrc/inline_mask.cuh)
Q_META = ("index", "q_block", "q_offset", "is_pad")
K_META = ("vis_start", "noisy_block", "noisy_role")
_META_FIELDS = [("qm", ctypes.c_void_p * 4), ("km", ctypes.c_void_p * 3),
                ("qm_sb", ctypes.c_int64 * 4), ("km_sb", ctypes.c_int64 * 3)]
# a sliding window's positions [B, Lq] / [B, Lk] with their batch strides
# and its size (0: no window; csrc/inline_mask.cuh)
_WINDOW_FIELDS = [("qpos", ctypes.c_void_p), ("kpos", ctypes.c_void_p),
                  ("qpos_sb", ctypes.c_int64), ("kpos_sb", ctypes.c_int64),
                  ("window", ctypes.c_int)]


class _InlineArgs(ctypes.Structure):
    """Mirror of ``InlineAttnArgs`` in csrc/inline_attention.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "k", "v", "out", "lse")] + _META_FIELDS + [
        (name, ctypes.c_int64) for name in (
            "q_sb", "q_sl", "q_sh", "k_sb", "k_sl", "k_sh", "v_sb", "v_sl",
            "v_sh", "o_sb", "o_sl", "o_sh")] + [
        (name, ctypes.c_int) for name in (
            "batch", "heads", "kv_heads", "lq", "lk", "head_dim")] + [
        ("scale_log2", ctypes.c_float), ("tile_map", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p), ("map_only", ctypes.c_int)] + \
        _WINDOW_FIELDS


class _InlineBwdArgs(ctypes.Structure):
    """Mirror of ``InlineAttnBwdArgs`` in csrc/attention_args.cuh."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "k", "v", "o", "dout", "lse", "delta", "dq", "dk",
        "dv")] + _META_FIELDS + [(name, ctypes.c_int64) for name in (
            "q_sb", "q_sl", "q_sh", "k_sb", "k_sl", "k_sh", "v_sb", "v_sl",
            "v_sh", "o_sb", "o_sl", "o_sh", "do_sb", "do_sl", "do_sh",
            "dq_sb", "dq_sl", "dq_sh", "dkv_sb", "dkv_sl", "dkv_sh")] + [
        (name, ctypes.c_int) for name in (
            "batch", "heads", "kv_heads", "lq", "lk", "head_dim")] + [
        ("scale", ctypes.c_float), ("scale_log2", ctypes.c_float),
        ("tile_map", ctypes.c_void_p), ("scratch", ctypes.c_void_p),
        ("map_only", ctypes.c_int)] + _WINDOW_FIELDS


def _check_operand(name: str, x: torch.Tensor, device: torch.device,
                   dtype: torch.dtype, shape=None,
                   row_vectors: bool = False) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} {tuple(x.shape)} != {tuple(shape)}")
    if row_vectors:
        # 16-byte vector loads of each row: D contiguous, 8-element strides
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dim, strides "
                             f"that are multiples of 8 and a 16-byte aligned "
                             f"start; got strides {x.stride()}")
    elif x.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous last dim")


class KernelChoice(NamedTuple):
    """The kernel that a call's operands select."""

    kernel: str           # "bf16" (tensor cores) or "fp32" (fp32_attention*.cu)
    padded_head_dim: int  # the instance's head width, one of KERNEL_HEAD_DIMS


def forward_kernel(dtypes: Sequence[torch.dtype], head_dim: int, heads: int,
                   kv_heads: int) -> KernelChoice:
    """The forward CUDA kernel for operands of ``dtypes`` (q's, then every
    key and value operand's) at ``head_dim``, ``heads`` query and
    ``kv_heads`` key/value heads: bf16 operands run the tensor-core kernel
    of their mask, fp32 operands ``csrc/fp32_attention.cu``, each at the
    least of ``KERNEL_HEAD_DIMS`` that holds ``head_dim``. Raises on mixed
    dtypes, another dtype, a head_dim above 128 or not a multiple of 8 (the
    kernels load 16-byte rows), and heads that are not a multiple of the kv
    heads: what the Pallas kernels' ``flash_attention_supported`` refuses,
    and the rows the CUDA kernels cannot load."""
    kinds = sorted({str(t) for t in dtypes})
    if len(kinds) != 1:
        raise TypeError(f"the CUDA attention kernels take q, k and v of one "
                        f"dtype, got {', '.join(kinds)}")
    dtype = dtypes[0]
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA attention kernels take bf16 or fp32, got "
                        f"{dtype}")
    if not 0 < head_dim <= KERNEL_HEAD_DIMS[-1]:
        raise ValueError(f"the CUDA attention kernels take head_dim <= "
                         f"{KERNEL_HEAD_DIMS[-1]}, got {head_dim}")
    if head_dim % 8:
        raise ValueError(f"the CUDA attention kernels take a head_dim that "
                         f"is a multiple of 8 (16-byte rows), got {head_dim}")
    if heads % kv_heads:
        raise ValueError(f"{heads} heads not a multiple of {kv_heads} kv "
                         f"heads")
    dp = next(w for w in KERNEL_HEAD_DIMS if w >= head_dim)
    return KernelChoice(KERNEL_DTYPES[dtype], dp)


def backward_kernel(dtypes: Sequence[torch.dtype], head_dim: int,
                    heads: int, kv_heads: int) -> KernelChoice:
    """The backward CUDA kernel (K9 under the bias, K7 under the inline
    metadata) for operands of ``dtypes`` (q's, then k's and v's): bf16
    operands run the tensor-core K9 / K7, fp32 operands
    ``csrc/fp32_attention_bwd.cu``, each at the least of
    ``KERNEL_HEAD_DIMS`` that holds ``head_dim``. It takes what the
    forward takes (:func:`forward_kernel`), so a step whose forward ran has
    a backward; it raises on the same: mixed dtypes, another dtype, a
    head_dim above 128 or not a multiple of 8, heads that are not a
    multiple of the kv heads."""
    return forward_kernel(dtypes, head_dim, heads, kv_heads)


def _check_q(q: torch.Tensor, kv_heads: int, *operands,
             backward: bool = False) -> KernelChoice:
    """The forward (with ``backward``, the backward) kernel of q and the
    key/value ``operands``; raises on what it does not take."""
    h, d = q.shape[2:]
    choose = backward_kernel if backward else forward_kernel
    choice = choose([q.dtype] + [x.dtype for x in operands], d, h, kv_heads)
    _check_operand("q", q, q.device, q.dtype, row_vectors=True)
    return choice


# the C entry point of each kernel: (library, function)
_ENTRY = {("rank", "bf16"): ("rank_attention", "vgt_rank_attention"),
          ("rank", "fp32"): ("fp32_attention", "vgt_fp32_rank_attention"),
          ("bias", "bf16"): ("bias_attention", "vgt_bias_attention"),
          ("bias", "fp32"): ("fp32_attention", "vgt_fp32_bias_attention"),
          ("inline", "bf16"): ("inline_attention", "vgt_inline_attention"),
          ("inline", "fp32"): ("fp32_attention",
                               "vgt_fp32_inline_attention"),
          ("bias_bwd", "bf16"): ("bias_attention_bwd",
                                 "vgt_bias_attention_bwd"),
          ("bias_bwd", "fp32"): ("fp32_attention_bwd",
                                 "vgt_fp32_bias_attention_bwd"),
          ("inline_bwd", "bf16"): ("inline_attention_bwd",
                                   "vgt_inline_attention_bwd"),
          ("inline_bwd", "fp32"): ("fp32_attention_bwd",
                                   "vgt_fp32_inline_attention_bwd")}


def _launch(lib: str, fn: str, args, device: torch.device) -> None:
    """Call a C entry point on the current stream of ``device``; raise if
    the launch was refused."""
    f = getattr(_cuda.libraries()[lib], fn)
    f.argtypes = [ctypes.POINTER(type(args)), ctypes.c_void_p]
    f.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _cuda.check(f(ctypes.byref(args), ctypes.c_void_p(stream)), fn)


def _launch_rank(q: torch.Tensor, operands, q_off: torch.Tensor,
                 out: Optional[torch.Tensor] = None):
    """operands: [(k, v, rank)] with k/v heads-major views [B,Hkv,L,D];
    the result goes into ``out`` when given (a contiguous tensor of q's
    shape and dtype), else into a new tensor. Returns (out, the
    :class:`KernelChoice` that ran)."""
    b, lq, h, d = q.shape
    hkv = operands[0][0].shape[1]
    choice = _check_q(q, hkv, *(x for k, v, _ in operands for x in (k, v)))
    _check_operand("q_off", q_off, q.device, torch.int32, (b, lq))
    if lq > 1 and q_off.stride(1) != 1:
        raise ValueError("q_off needs contiguous rows")
    if out is None:
        out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    elif (out.shape != q.shape or out.dtype != q.dtype
          or out.device != q.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like q")
    a = _RankArgs(q=q.data_ptr(), qoff=q_off.data_ptr(), out=out.data_ptr(),
                  q_sb=q.stride(0), q_sl=q.stride(1), q_sh=q.stride(2),
                  qoff_sb=q_off.stride(0), o_sb=out.stride(0),
                  o_sl=out.stride(1), o_sh=out.stride(2), batch=b, heads=h,
                  kv_heads=hkv, lq=lq, head_dim=d,
                  kscale=d ** -0.5 * LOG2E)
    for i, (k, v, rank) in enumerate(operands):
        lk = k.shape[2]
        for name, x in (("k", k), ("v", v)):
            _check_operand(name, x, q.device, q.dtype, (b, hkv, lk, d),
                           row_vectors=True)
        _check_operand("rank", rank, q.device, torch.int32, (b, lk))
        if lk > 1 and rank.stride(1) != 1:
            raise ValueError("rank needs contiguous rows")
        a.k[i], a.v[i], a.rank[i] = k.data_ptr(), v.data_ptr(), \
            rank.data_ptr()
        a.k_sb[i], a.k_sh[i], a.k_sl[i] = k.stride()[:3]
        a.v_sb[i], a.v_sh[i], a.v_sl[i] = v.stride()[:3]
        a.rank_sb[i] = rank.stride(0)
        a.len[i] = lk
    _launch(*_ENTRY["rank", choice.kernel], a, q.device)
    return out, choice


def rank_attention_smem(head_dim: int = 96) -> int:
    """The dynamic shared memory of a bf16 K1/K2 block at ``head_dim``
    (``RankCfg::kSmem`` in csrc/rank_attention.cu): its ring of K/V tiles
    and their barriers."""
    f = _cuda.libraries()["rank_attention"].vgt_rank_attention_smem
    f.argtypes = [ctypes.c_int]
    f.restype = ctypes.c_int
    return f(head_dim)


@functools.lru_cache(maxsize=256)
def inline_block_rows(batch: int, lq: int, heads: int, head_dim: int,
                      device: torch.device) -> int:
    """The query rows a bf16 K6 block covers (64 a consumer warpgroup) at
    this launch shape on the CUDA ``device``: csrc/inline_attention.cu's
    own choice, which :func:`flash_mha_inline` counts in
    ``launches_by_rows``."""
    f = _cuda.libraries()["inline_attention"].vgt_inline_block_rows
    f.argtypes = [ctypes.c_int] * 4
    f.restype = ctypes.c_int
    with torch.cuda.device(device):
        return f(batch, lq, heads, head_dim)


def _count(fn, choice: KernelChoice, keys: int) -> None:
    """Count a launch of ``fn``'s kernel: bf16 in ``launches`` (and in
    ``long_launches`` past ``TPU_KEY_CAP`` keys), fp32 in
    ``fp32_launches``."""
    if choice.kernel == "fp32":
        fn.fp32_launches += 1
        return
    fn.launches += 1
    if keys > TPU_KEY_CAP and hasattr(fn, "long_launches"):
        fn.long_launches += 1


# ---- K1 / K2 / K3 wrappers --------------------------------------------------

def flash_mha_decode_split(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, mask: DecodeMask
                           ) -> torch.Tensor:
    """K1. q [B,Lq,H,D]; k/v_cache [B,Hkv,Lc,D] (the at-rest KVCache
    layout); k/v_new [B,Hkv,Lt,D] (views are fine). ``mask.rank`` covers
    the concatenated keys [B, Lc+Lt], cache first. Same function as
    :func:`flash_mha_decode` over ``cat([cache, new])``, without the cat."""
    lc = k_cache.shape[2]
    rank_c, rank_t = mask.rank[:, :lc], mask.rank[:, lc:]
    if not q.is_cuda:
        return rank_attention_reference(q, (k_cache, k_new), (v_cache, v_new),
                                        (rank_c, rank_t), mask.q_off)
    out, choice = _launch_rank(q, [(k_cache, v_cache, rank_c),
                                   (k_new, v_new, rank_t)], mask.q_off)
    _count(flash_mha_decode_split, choice, mask.rank.shape[1])
    return out


flash_mha_decode_split.launches = flash_mha_decode_split.long_launches = 0
flash_mha_decode_split.fp32_launches = 0


def flash_mha_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: DecodeMask) -> torch.Tensor:
    """K2. q [B,Lq,H,D], k/v [B,Lk,Hkv,D] -> [B,Lq,H,D]."""
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    if not q.is_cuda:
        return rank_attention_reference(q, (k,), (v,), (mask.rank,),
                                        mask.q_off)
    out, choice = _launch_rank(q, [(k, v, mask.rank)], mask.q_off)
    _count(flash_mha_decode, choice, mask.rank.shape[1])
    return out


flash_mha_decode.launches = flash_mha_decode.long_launches = 0
flash_mha_decode.fp32_launches = 0


def _kv_views(q, k, v, backward: bool = False):
    """(k/v [B,Lk,Hkv,D] as heads-major views [B,Hkv,Lk,D], the forward
    :class:`KernelChoice`, or with ``backward`` the backward one); raises
    on what the kernels over a whole key row (K3, K6; with ``backward`` K7,
    K9) do not take."""
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    b, lq, h, d = q.shape
    hkv, lk = kh.shape[1], kh.shape[2]
    choice = _check_q(q, hkv, kh, vh, backward=backward)
    for name, x in (("k", kh), ("v", vh)):
        _check_operand(name, x, q.device, q.dtype, (b, hkv, lk, d),
                       row_vectors=True)
    return kh, vh, choice


def _bias_vec(bias: torch.Tensor) -> int:
    """1 when the bias rows allow 16-byte loads."""
    return int(bias.stride(0) % 8 == 0 and bias.stride(1) % 8 == 0
               and bias.data_ptr() % 16 == 0)


class BiasMap(NamedTuple):
    """A precomputed bias with its tile map: what K3 and K9 read, built
    once per bias by :func:`bias_map` and shared by every layer (and by a
    layer's forward, its recompute and its backward). On the CPU the map
    fields are None: the plain versions read the bias alone."""

    bias: torch.Tensor                # bf16 [B, Lq, Lk]
    tile_map: Optional[torch.Tensor]  # int8 [B, ceil(Lq/TILE_Q), ceil(Lk/TILE_K)]
    rowdead: Optional[torch.Tensor]   # fp32 [B, Lq]: rows that see no key
    order: Optional[torch.Tensor]     # int32 [B ceil(Lq/TILE_Q)]: query
    #                                   tiles, most non-empty tiles first


def bias_map(bias: torch.Tensor) -> BiasMap:
    """The bf16 bias [B, Lq, Lk] of :func:`precompute_bias` with its tile
    map, built once (on CUDA: the launches of csrc/bias_attention.cu
    ``vgt_bias_tile_map``, counted in ``flash_mha.bias_map_builds``; on
    the CPU the map fields are None): hand it to :func:`flash_mha` and
    :func:`flash_mha_bwd` in place of the bare bias, so that K3 and K9 read
    one map."""
    if not bias.is_cuda:
        return BiasMap(bias, None, None, None)
    b, lq, lk = bias.shape
    _check_operand("bias", bias, bias.device, torch.bfloat16)
    nq = -(-lq // TILE_Q)
    tile_map = torch.empty((b, nq, -(-lk // TILE_K)), dtype=torch.int8,
                           device=bias.device)
    rowdead = torch.empty((b, lq), dtype=torch.float32, device=bias.device)
    counts, order = torch.empty((2, b * nq), dtype=torch.int32,
                                device=bias.device)
    a = _BiasMapArgs(bias=bias.data_ptr(), tile_map=tile_map.data_ptr(),
                     rowdead=rowdead.data_ptr(), counts=counts.data_ptr(),
                     order=order.data_ptr(), bias_sb=bias.stride(0),
                     bias_sq=bias.stride(1), batch=b, lq=lq, lk=lk,
                     bias_vec=_bias_vec(bias))
    _launch("bias_attention", "vgt_bias_tile_map", a, bias.device)
    flash_mha.bias_map_builds += 1
    return BiasMap(bias, tile_map, rowdead, order)


def _as_bias_map(bias) -> BiasMap:
    """A :class:`BiasMap` as it is; a bare bias with its map built here."""
    return bias if isinstance(bias, BiasMap) else bias_map(bias)


def _check_bias_operands(q, k, v, bias, backward: bool = False):
    """(k/v as heads-major views [B,Hkv,Lk,D], the kernel choice as
    :func:`_kv_views` gives it); raises on what K3 (with ``backward``, K9)
    does not take."""
    kh, vh, choice = _kv_views(q, k, v, backward)
    _check_operand("bias", bias, q.device, torch.bfloat16,
                   (q.shape[0], q.shape[1], kh.shape[2]))
    return kh, vh, choice


def _bias_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bm: BiasMap, with_lse: bool):
    """K3 over the map of ``bm`` -> (out, lse): ``lse`` the fp32 per-row
    logsumexp [B, H, Lq] of the biased logits when ``with_lse`` on CUDA,
    else None."""
    if not q.is_cuda:
        return bias_attention_reference(q, k, v, bm.bias), None
    bias = bm.bias
    kh, vh, choice = _check_bias_operands(q, k, v, bias)
    b, lq, h, d = q.shape
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    a = _BiasArgs(
        q=q.data_ptr(), k=kh.data_ptr(), v=vh.data_ptr(),
        bias=bias.data_ptr(), out=out.data_ptr(),
        lse=None if lse is None else lse.data_ptr(),
        tile_map=bm.tile_map.data_ptr(), order=bm.order.data_ptr(),
        q_sb=q.stride(0), q_sl=q.stride(1), q_sh=q.stride(2),
        k_sb=kh.stride(0), k_sl=kh.stride(2), k_sh=kh.stride(1),
        v_sb=vh.stride(0), v_sl=vh.stride(2), v_sh=vh.stride(1),
        bias_sb=bias.stride(0), bias_sq=bias.stride(1),
        o_sb=out.stride(0), o_sl=out.stride(1), o_sh=out.stride(2),
        batch=b, heads=h, kv_heads=kh.shape[1], lq=lq, lk=kh.shape[2],
        head_dim=d, scale_log2=d ** -0.5 * LOG2E, bias_vec=_bias_vec(bias))
    _launch(*_ENTRY["bias", choice.kernel], a, q.device)
    _count(flash_mha, choice, kh.shape[2])
    return out, lse


class _BiasAttention(torch.autograd.Function):
    """K3 forward (keeping the logsumexp), K9 backward; the bias's tile map
    (tile classes, dead rows, row order) rides as inputs without a
    gradient, so the two read the map that was built once. The per-layer
    recompute of a checkpointed layer runs the forward again, alike."""

    @staticmethod
    def forward(ctx, q, k, v, *bm):
        out, lse = _bias_forward(q, k, v, BiasMap(*bm), with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, *bm)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, *bm = ctx.saved_tensors
        dq, dk, dv = flash_mha_bwd(q, k, v, BiasMap(*bm), out, do, lse)
        return (dq, dk, dv) + (None,) * len(bm)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias) -> torch.Tensor:
    """K3. q [B,Lq,H,D], k/v [B,Lk,Hkv,D], ``bias`` the bf16 [B, Lq, Lk]
    of :func:`precompute_bias`, bare or as a :class:`BiasMap` (a bare
    bias on CUDA gets its map built here, once per call) -> [B,Lq,H,D].
    Differentiable in q, k, v: with grad enabled and an input that
    requires it, the backward is K9 (:func:`flash_mha_bwd`), over the
    same map."""
    bm = _as_bias_map(bias)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _BiasAttention.apply(q, k, v, *bm)
    return _bias_forward(q, k, v, bm, with_lse=False)[0]


flash_mha.launches = flash_mha.long_launches = 0
flash_mha.fp32_launches = flash_mha.bias_map_builds = 0


def bias_tile_classes(bias: torch.Tensor) -> torch.Tensor:
    """The tile map of the bf16 bias [B, Lq, Lk] that K3 and K9 read (from
    :func:`bias_map`, a build counted there): int8 [B, ceil(Lq/TILE_Q),
    ceil(Lk/TILE_K)] of ``TILE_EMPTY`` / ``TILE_PARTIAL`` / ``TILE_FULL``.
    For a bias on the CPU, :func:`bias_tile_classes_reference`."""
    if not bias.is_cuda:
        return bias_tile_classes_reference(bias)
    return bias_map(bias).tile_map


def flash_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias, o: torch.Tensor, do: torch.Tensor, lse=None):
    """K9: (dq, dk, dv) of :func:`flash_mha` at its output ``o`` for the
    cotangent ``do`` [B,Lq,H,D]; ``bias`` bare or as the
    :class:`BiasMap` that K3 read. On CUDA ``lse`` is K3's fp32 logsumexp
    [B, H, Lq], from which the kernel recomputes each probability; the plain
    version (CPU tensors) recomputes the softmax over the whole row as the
    TPU kernel does and ignores it."""
    bm = _as_bias_map(bias)
    if not q.is_cuda:
        return bias_attention_backward_reference(q, k, v, bm.bias, o, do)
    bias = bm.bias
    kh, vh, choice = _check_bias_operands(q, k, v, bias, backward=True)
    b, lq, h, d = q.shape
    hkv, lk = kh.shape[1], kh.shape[2]
    do = do.contiguous()
    for name, x in (("o", o), ("do", do)):
        _check_operand(name, x, q.device, q.dtype, (b, lq, h, d),
                       row_vectors=True)
    if lse is None:
        raise ValueError("the K9 kernel needs K3's logsumexp (lse)")
    _check_operand("lse", lse, q.device, torch.float32, (b, h, lq))
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    rowref = torch.empty((b, h, lq, 2), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, lk, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, lk, hkv, d), dtype=v.dtype, device=q.device)
    a = _BiasBwdArgs(
        bias=bias.data_ptr(), tile_map=bm.tile_map.data_ptr(),
        rowdead=bm.rowdead.data_ptr(), bias_sb=bias.stride(0),
        bias_sq=bias.stride(1), batch=b, lq=lq, lk=lk, head_dim=d,
        bias_vec=_bias_vec(bias))
    a.q, a.k, a.v, a.o, a.dout = (x.data_ptr() for x in (q, kh, vh, o, do))
    a.lse, a.delta, a.rowref = lse.data_ptr(), delta.data_ptr(), \
        rowref.data_ptr()
    a.dq, a.dk, a.dv = dq.data_ptr(), dk.data_ptr(), dv.data_ptr()
    for name, x, (sb, sl, sh) in (
            ("q", q, (0, 1, 2)), ("k", kh, (0, 2, 1)), ("v", vh, (0, 2, 1)),
            ("o", o, (0, 1, 2)), ("do", do, (0, 1, 2)),
            ("dq", dq, (0, 1, 2)), ("dkv", dk, (0, 1, 2))):
        setattr(a, f"{name}_sb", x.stride(sb))
        setattr(a, f"{name}_sl", x.stride(sl))
        setattr(a, f"{name}_sh", x.stride(sh))
    a.heads, a.kv_heads = h, hkv
    a.scale, a.scale_log2 = d ** -0.5, d ** -0.5 * LOG2E
    _launch(*_ENTRY["bias_bwd", choice.kernel], a, q.device)
    _count(flash_mha_bwd, choice, lk)
    return dq, dk, dv


flash_mha_bwd.launches = flash_mha_bwd.fp32_launches = 0


# ---- K6 / K7 wrappers -------------------------------------------------------

def _set_meta(a, q_meta: AttnMeta, k_meta: AttnMeta, b: int, lq: int,
              lk: int, device: torch.device) -> None:
    """Point the kernel arguments ``a`` at the seven metadata vectors:
    int32 [B, L] with contiguous rows; the batch stride is passed as it is
    (``AttnMeta.index`` is an expanded view with batch stride 0)."""
    for i, name in enumerate(Q_META):
        x = getattr(q_meta, name)
        _check_operand(name, x, device, torch.int32, (b, lq))
        a.qm[i], a.qm_sb[i] = x.data_ptr(), x.stride(0)
    for i, name in enumerate(K_META):
        x = getattr(k_meta, name)
        _check_operand(name, x, device, torch.int32, (b, lk))
        a.km[i], a.km_sb[i] = x.data_ptr(), x.stride(0)


def _check_meta_shapes(q_meta: AttnMeta, k_meta: AttnMeta, b: int, lq: int,
                       lk: int) -> None:
    """Raise unless the metadata covers the queries [B, Lq] and the keys
    [B, Lk] of the operands."""
    if (tuple(q_meta.index.shape) != (b, lq)
            or tuple(k_meta.vis_start.shape) != (b, lk)):
        raise ValueError(f"metadata {tuple(q_meta.index.shape)} / "
                         f"{tuple(k_meta.vis_start.shape)} for q {(b, lq)}, "
                         f"keys {(b, lk)}")


def _windowed(window: Optional[Window]) -> bool:
    return window is not None and window.size > 0


def _inline_map_args(q_meta: AttnMeta, k_meta: AttnMeta,
                     backward: bool = False,
                     window: Optional[Window] = None):
    """(K6's arguments, or with ``backward`` K7's, with the metadata, the
    window, the tile map and scratch set, ``map_only`` 0; the map [B,
    ceil(Lq/TILE_Q), ceil(Lk/TILE_K)]; the scratch, to be held until the
    launch)."""
    b, lq = q_meta.index.shape
    lk = k_meta.vis_start.shape[1]
    device = q_meta.index.device
    nq, nk = -(-lq // TILE_Q), -(-lk // TILE_K)
    tile_map = torch.empty((b, nq, nk), dtype=torch.int8, device=device)
    # the query- and key-tile summaries (8 ints each); csrc/
    # inline_attention.cu: each query tile's count of non-empty key tiles
    # and the launch order; csrc/inline_attention_bwd.cu: those of the key
    # tiles too; under a window, each tile's range of positions (2 ints)
    orders = b * (nq + nk) if backward else b * nq
    ranges = b * (nq + nk) * 2 if _windowed(window) else 0
    scratch = torch.empty((b * (nq + nk) * 8 + 2 * orders + ranges,),
                          dtype=torch.int32, device=device)
    # head_dim is set by the caller that launches the attention (a launch
    # that builds the map alone reads none)
    a = (_InlineBwdArgs if backward else _InlineArgs)(
        tile_map=tile_map.data_ptr(), scratch=scratch.data_ptr(), batch=b,
        lq=lq, lk=lk)
    _set_meta(a, q_meta, k_meta, b, lq, lk, device)
    if _windowed(window):
        for name, x, n in (("qpos", window.q_pos, lq),
                           ("kpos", window.k_pos, lk)):
            _check_operand(name, x, device, torch.int32, (b, n))
            if n > 1 and x.stride(1) != 1:
                raise ValueError(f"{name} needs contiguous rows")
            setattr(a, name, x.data_ptr())
            setattr(a, f"{name}_sb", x.stride(0))
        a.window = window.size
    return a, tile_map, scratch


def inline_tile_classes(q_meta: AttnMeta, k_meta: AttnMeta,
                        backward: bool = False,
                        window: Optional[Window] = None) -> torch.Tensor:
    """K6's tile map alone (the first launches of :func:`flash_mha_inline`;
    with ``backward``, of :func:`flash_mha_inline_bwd`, which builds the
    same map and counts its columns too): int8 [B, ceil(Lq/TILE_Q),
    ceil(Lk/TILE_K)] of ``TILE_EMPTY`` / ``TILE_PARTIAL`` / ``TILE_FULL``,
    from per-tile summaries of the metadata (and, under a ``window``, of
    the positions). For metadata on the CPU,
    :func:`inline_tile_classes_reference`. Counts no launch."""
    if not q_meta.index.is_cuda:
        return inline_tile_classes_reference(q_meta, k_meta, window=window)
    a, tile_map, scratch = _inline_map_args(q_meta, k_meta, backward,
                                            window)
    a.map_only = 1
    lib = "inline_attention_bwd" if backward else "inline_attention"
    _launch(lib, f"vgt_{lib}", a, q_meta.index.device)
    return tile_map


def _check_window(choice: KernelChoice, window: Optional[Window]) -> None:
    if _windowed(window) and choice.kernel == "fp32":
        raise ValueError("the fp32 inline kernels take no window: run a "
                         "windowed layer in bf16 or on the bias route")


def _count_window(fn, window: Optional[Window]) -> None:
    if _windowed(window):
        fn.window_launches += 1


def _inline_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_meta: AttnMeta, k_meta: AttnMeta, with_lse: bool,
                    window: Optional[Window] = None):
    """K6 -> (out, lse): ``lse`` the fp32 per-row logsumexp [B, H, Lq] when
    ``with_lse`` (always on the CPU, where the plain version computes it
    anyway), else None."""
    if not q.is_cuda:
        return inline_attention_reference(q, k, v, q_meta, k_meta, window)
    kh, vh, choice = _kv_views(q, k, v)
    _check_window(choice, window)
    b, lq, h, d = q.shape
    lk = kh.shape[2]
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _check_meta_shapes(q_meta, k_meta, b, lq, lk)
    a, tile_map, scratch = _inline_map_args(q_meta, k_meta, window=window)
    a.q, a.k, a.v, a.out = (x.data_ptr() for x in (q, kh, vh, out))
    a.lse = None if lse is None else lse.data_ptr()
    for name, x, (sb, sl, sh) in (
            ("q", q, (0, 1, 2)), ("k", kh, (0, 2, 1)), ("v", vh, (0, 2, 1)),
            ("o", out, (0, 1, 2))):
        setattr(a, f"{name}_sb", x.stride(sb))
        setattr(a, f"{name}_sl", x.stride(sl))
        setattr(a, f"{name}_sh", x.stride(sh))
    a.heads, a.kv_heads, a.head_dim = h, kh.shape[1], d
    a.scale_log2 = d ** -0.5 * LOG2E
    _launch(*_ENTRY["inline", choice.kernel], a, q.device)
    _count(flash_mha_inline, choice, lk)
    _count_window(flash_mha_inline, window)
    if choice.kernel == "bf16":
        rows = inline_block_rows(b, lq, h, d, q.device)
        by_rows = flash_mha_inline.launches_by_rows
        by_rows[rows] = by_rows.get(rows, 0) + 1
    return out, lse


def _unpack_meta(size: int, meta):
    """(q_meta, k_meta, window) from the tensors that ride through
    autograd: the fourteen metadata vectors, then, under a window of
    ``size``, its two position vectors."""
    window = Window(size, *meta[14:]) if size > 0 else None
    return AttnMeta(*meta[:7]), AttnMeta(*meta[7:14]), window


class _InlineAttention(torch.autograd.Function):
    """K6 forward (keeping the logsumexp), K7 backward; the fourteen
    metadata vectors (query side, then key side), and a window's two
    position vectors, ride as inputs without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, size, *meta):
        q_meta, k_meta, window = _unpack_meta(size, meta)
        out, lse = _inline_forward(q, k, v, q_meta, k_meta, with_lse=True,
                                   window=window)
        ctx.size = size
        ctx.save_for_backward(q, k, v, out, lse, *meta)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, *meta = ctx.saved_tensors
        q_meta, k_meta, window = _unpack_meta(ctx.size, meta)
        dq, dk, dv = flash_mha_inline_bwd(q, k, v, q_meta, k_meta, out, do,
                                          lse, window=window)
        return (dq, dk, dv, None) + (None,) * len(meta)


def flash_mha_inline(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_meta: AttnMeta, k_meta: AttnMeta,
                     window: Optional[Window] = None) -> torch.Tensor:
    """K6. q [B,Lq,H,D], k/v [B,Lk,Hkv,D] (views are fine: a heads-major
    cache passes ``cache.transpose(1, 2)``) -> [B,Lq,H,D], masked by the
    visibility rule of ``q_meta``/``k_meta`` evaluated in the kernel: no
    [Lq, Lk] tensor exists; a ``window`` narrows it (the kernels' windowed
    instances, counted also in ``window_launches``). Differentiable in q,
    k, v: with grad enabled and an input that requires it, the backward is
    K7 (:func:`flash_mha_inline_bwd`)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        size, pos = ((window.size, (window.q_pos, window.k_pos))
                     if _windowed(window) else (0, ()))
        return _InlineAttention.apply(q, k, v, size, *q_meta, *k_meta, *pos)
    return _inline_forward(q, k, v, q_meta, k_meta, with_lse=False,
                           window=window)[0]


flash_mha_inline.launches = flash_mha_inline.fp32_launches = 0
flash_mha_inline.window_launches = 0
# bf16 launches by the query rows a block covers (inline_block_rows)
flash_mha_inline.launches_by_rows = {}


def flash_mha_inline_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_meta: AttnMeta, k_meta: AttnMeta, o: torch.Tensor,
                         do: torch.Tensor, lse=None,
                         window: Optional[Window] = None):
    """K7: (dq, dk, dv) of :func:`flash_mha_inline` at its output ``o`` for
    the cotangent ``do`` [B,Lq,H,D]. ``lse`` is an fp32 logsumexp
    [B, H, Lq], from which each probability is recomputed: K6's of these
    keys, or the global one of a ring of key chunks. CUDA needs it; the
    plain version (CPU tensors) takes it where given and recomputes the
    softmax over these keys where not. A ``window`` narrows the rule, as
    in :func:`flash_mha_inline`."""
    if not q.is_cuda:
        return inline_attention_backward_reference(q, k, v, q_meta, k_meta,
                                                   o, do, lse=lse,
                                                   window=window)
    kh, vh, choice = _kv_views(q, k, v, backward=True)
    _check_window(choice, window)
    b, lq, h, d = q.shape
    hkv, lk = kh.shape[1], kh.shape[2]
    do = do.contiguous()
    for name, x in (("o", o), ("do", do)):
        _check_operand(name, x, q.device, q.dtype, (b, lq, h, d),
                       row_vectors=True)
    if lse is None:
        raise ValueError("the K7 kernels need K6's logsumexp (lse)")
    _check_operand("lse", lse, q.device, torch.float32, (b, h, lq))
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    _check_meta_shapes(q_meta, k_meta, b, lq, lk)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, lk, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, lk, hkv, d), dtype=v.dtype, device=q.device)
    a, tile_map, scratch = _inline_map_args(q_meta, k_meta, backward=True,
                                            window=window)
    a.q, a.k, a.v, a.o, a.dout = (x.data_ptr() for x in (q, kh, vh, o, do))
    a.lse, a.delta = lse.data_ptr(), delta.data_ptr()
    a.dq, a.dk, a.dv = dq.data_ptr(), dk.data_ptr(), dv.data_ptr()
    for name, x, (sb, sl, sh) in (
            ("q", q, (0, 1, 2)), ("k", kh, (0, 2, 1)), ("v", vh, (0, 2, 1)),
            ("o", o, (0, 1, 2)), ("do", do, (0, 1, 2)),
            ("dq", dq, (0, 1, 2)), ("dkv", dk, (0, 1, 2))):
        setattr(a, f"{name}_sb", x.stride(sb))
        setattr(a, f"{name}_sl", x.stride(sl))
        setattr(a, f"{name}_sh", x.stride(sh))
    a.heads, a.kv_heads, a.head_dim = h, hkv, d
    a.scale, a.scale_log2 = d ** -0.5, d ** -0.5 * LOG2E
    _launch(*_ENTRY["inline_bwd", choice.kernel], a, q.device)
    _count(flash_mha_inline_bwd, choice, lk)
    _count_window(flash_mha_inline_bwd, window)
    return dq, dk, dv


flash_mha_inline_bwd.launches = flash_mha_inline_bwd.fp32_launches = 0
flash_mha_inline_bwd.window_launches = 0

# every wrapper: bf16 launches in ``launches``, fp32 ones in
# ``fp32_launches``
KERNELS = (flash_mha_decode_split, flash_mha_decode, flash_mha,
           flash_mha_bwd, flash_mha_inline, flash_mha_inline_bwd)


def reset_launch_counts() -> None:
    """Every wrapper's launch counts, ``flash_mha.bias_map_builds`` and
    the windowed launches to 0 (``flash_mha_inline.launches_by_rows``
    emptied)."""
    flash_mha.bias_map_builds = 0
    flash_mha_inline.launches_by_rows = {}
    for fn in (flash_mha_inline, flash_mha_inline_bwd):
        fn.window_launches = 0
    for fn in KERNELS:
        fn.launches = fn.fp32_launches = 0
    for fn in (flash_mha_decode_split, flash_mha_decode, flash_mha):
        fn.long_launches = 0
