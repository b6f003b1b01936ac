"""Ring attention over the mesh's seq axis, one process per rank.

Port of ``video_gpt_tpu/parallel/ring.py``: each seq rank keeps its own
contiguous chunk of the queries, and the K/V chunks travel around the seq
group, one neighbour hop a step (``distributed.hop``). Each step attends
the rank's queries over the visiting chunk with K6 (its lse kept) and
folds the result into an fp32 running (out, logsumexp) pair; after S
steps every rank holds its queries' attention over the whole sequence.
Unlike Ulysses, the degree S is not capped by the head count: S only has
to divide L.

The backward runs its own ring (the FlashAttention-2 backward, chunked
over the ranks): K7 per chunk from the GLOBAL (out, lse) and the incoming
dO, which makes every chunk's gradient exact; dq accumulates in fp32 on
the rank, and fp32 dK/dV accumulators travel with their chunk and arrive
home after the full cycle. Forward and backward are one
``torch.autograd.Function`` with explicit loops, so every rank issues the
same hops in the same order (a per-hop Function whose output some rank
leaves unused would skip that rank's backward hop, and the group would
hang).

The metadata is whole on every rank (as the trunk hands it to Ulysses), so
a visiting chunk's key metadata is sliced locally instead of travelling
with it; only K and V (forward) and K, V, dK, dV (backward) hop. The last
forward hop of the JAX ring only brings each chunk home, and the last
backward hop of K/V is never read: both are skipped. Under a tensor axis
each rank runs its H/T heads; with S = 1 (a tensor-only mesh) the call is
``ulysses_attend``'s, as in the JAX package. On the CPU the chunk calls
are the plain K6/K7 (the plain K7 takes the global lse); on CUDA they are
the kernels of the operands' dtype and head width (``forward_kernel``,
``backward_kernel``: bf16 or fp32 at any head_dim the kernels take), with
no fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import AttnMeta, attend
from ..ops.flash_attention import _inline_forward, flash_mha_inline_bwd
from .mesh import SEQ_AXIS, TENSOR_AXIS, Mesh, axis_size
from .ulysses import ulysses_attend

# the merge's starting logsumexp: finite, as the JAX package's. A row that
# sees no key in a chunk comes out of K6 with out 0 and lse -inf, which
# then merges with weight exp(-inf) = 0; from -inf the weights would be
# exp(-inf - (-inf)) = NaN. A row that sees no key at all ends at this
# value, and its gradient is 0 (no key is visible to it)
LSE_START = -1e30


def merge(o_acc: torch.Tensor, lse_acc: torch.Tensor, o_j: torch.Tensor,
          lse_j: torch.Tensor):
    """Fold one chunk's normalised out [B, Lq, H, D] and lse [B, H, Lq]
    into the running fp32 pair: (o_acc, lse_acc) -> the attention over
    both key sets."""
    new = torch.logaddexp(lse_acc, lse_j)
    w_old = torch.exp(lse_acc - new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_j - new).transpose(1, 2)[..., None]
    return o_acc * w_old + o_j.float() * w_new, new


def _chunk(meta: AttnMeta, j: int, n: int) -> AttnMeta:
    """Chunk ``j`` of ``n`` of the (whole) metadata's columns."""
    c = meta.index.shape[1] // n
    return meta.cols(slice(j * c, (j + 1) * c))


class _Ring(torch.autograd.Function):
    """The ring forward (K6 per chunk, merged) and its explicit backward
    (K7 per chunk from the global lse); the fourteen metadata vectors ride
    as inputs without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, *meta):
        s, i = mesh.size(SEQ_AXIS), mesh.index(SEQ_AXIS)
        q_meta, k_meta = _chunk(AttnMeta(*meta[:7]), i, s), AttnMeta(
            *meta[7:])
        b, lq, h, d = q.shape
        o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, lq), LSE_START, dtype=torch.float32,
                         device=q.device)
        kv = torch.stack((k, v))  # one hop carries both
        for step in range(s):
            o_j, lse_j = _inline_forward(q, kv[0], kv[1], q_meta,
                                         _chunk(k_meta, (i - step) % s, s),
                                         with_lse=True)
            o, lse = merge(o, lse, o_j, lse_j)
            if step < s - 1:
                kv = mesh.hop(kv, SEQ_AXIS, (i + 1) % s, (i - 1) % s)
        out = o.to(q.dtype)
        ctx.mesh = mesh
        ctx.save_for_backward(q, k, v, out, lse, *meta)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, *meta = ctx.saved_tensors
        mesh = ctx.mesh
        s, i = mesh.size(SEQ_AXIS), mesh.index(SEQ_AXIS)
        q_meta, k_meta = _chunk(AttnMeta(*meta[:7]), i, s), AttnMeta(
            *meta[7:])
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack((k, v))
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for step in range(s):
            dq_j, dk_j, dv_j = flash_mha_inline_bwd(
                q, kv[0], kv[1], q_meta, _chunk(k_meta, (i - step) % s, s),
                out, do, lse)
            dq += dq_j.float()
            dkv[0] += dk_j.float()
            dkv[1] += dv_j.float()
            nxt, prv = (i + 1) % s, (i - 1) % s
            if step < s - 1:
                kv = mesh.hop(kv, SEQ_AXIS, nxt, prv, backward=True)
            # the accumulators travel with their chunk: after S hops each
            # chunk's dK/dV is home
            dkv = mesh.hop(dkv, SEQ_AXIS, nxt, prv, backward=True)
        return ((dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None)
                + (None,) * len(meta))


def _check(mesh: Mesh, h: int, hkv: int, lq: int, lk: int) -> int:
    """The seq axis's size, after JAX's checks of the (global) heads and
    lengths."""
    s, t = axis_size(mesh, SEQ_AXIS), axis_size(mesh, TENSOR_AXIS)
    if h % t or hkv % t:
        raise ValueError(f"heads ({h}/{hkv}) not divisible by tensor "
                         f"axis {t}")
    if lq % s or lk % s:
        raise ValueError(f"ring SP={s} needs sequence lengths divisible by "
                         f"the seq axis (got Lq={lq}, Lk={lk})")
    return s


def ring_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_meta: AttnMeta, k_meta: AttnMeta, mesh: Optional[Mesh]
                ) -> torch.Tensor:
    """Sequence-parallel ring attention. q [B, L/S, H/T, D] and k/v
    [B, L/S, Hkv/T, D] are this rank's chunk of a sequence whose length L
    (the metadata's, a multiple of S) is padded already; ``q_meta`` /
    ``k_meta`` are whole. Returns this rank's output chunk [B, L/S, H/T, D].
    Differentiable in q, k, v. Without a mesh it is the local call; with a
    seq axis of 1, ``ulysses_attend``'s."""
    if mesh is None:
        return attend(q, k, v, q_meta, k_meta)
    t = axis_size(mesh, TENSOR_AXIS)
    s = _check(mesh, q.shape[2] * t, k.shape[2] * t, q_meta.index.shape[1],
               k_meta.index.shape[1])
    if s == 1:
        return ulysses_attend(q, k, v, q_meta, k_meta, mesh)[0]
    if q.shape[1] * s != q_meta.index.shape[1] \
            or k.shape[1] * s != k_meta.index.shape[1]:
        raise ValueError(f"chunks of {q.shape[1]} queries / {k.shape[1]} "
                         f"keys on {s} seq ranks do not cover the metadata's "
                         f"{q_meta.index.shape[1]} / {k_meta.index.shape[1]}")
    return _Ring.apply(q, k, v, mesh, *q_meta, *k_meta)
