"""Ulysses sequence-parallel attention, one process per rank.

Port of ``video_gpt_tpu/parallel/ulysses.py``. Each rank holds a
contiguous L/S chunk of the sequence and H/T heads (its tensor block); an
``all_to_all`` over the seq group turns q/k/v into the rank's H/(S T)
heads over the full length, the local kernel attends, and a second
``all_to_all`` turns the output back. Global head order is tensor-block
major, seq-chunk minor (``mesh.cache_heads``). The all_to_all is
differentiable (its backward is the reverse all_to_all), so training runs
K6 forward and K7 backward at H/(S T) heads over the full length. The
metadata, and a ``DecodeMask``, are whole on every rank, so the kernels
see global positions.

Lengths. The trunk pads the sequence once, at its entry, to the seq
multiple (:func:`pad_to_seq`): padded queries are pad rows (they see
every key and are cropped after), padded keys are never visible
(``_META_FILLS``, :func:`pad_decode_mask`). A precomputed dense bias cannot
be padded, so that case raises; on a mesh with a seq axis
``maybe_bias`` builds none. The cached call keeps the cache unpadded: only
the tail, which sits at the end of the keys, is padded, and the padded
keys never join the cache (the trunk crops what it stores).

:func:`ulysses_attend_cached` is the cached decode and the cache extend:
the cache is head-sharded at rest, so only the tail crosses the group; with
a ``DecodeMask`` it runs K1 on the local cache and tail as separate
operands (``ops.attention.attend_decode_split``), with no concatenation.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.attention import AttnMeta, attend, attend_cached
from ..ops.flash_attention import DecodeMask
from .mesh import SEQ_AXIS, TENSOR_AXIS, Mesh, axis_size

NEVER = 2 ** 30
# pad fills per AttnMeta field: padded queries are pad rows, padded keys
# are never visible (the JAX package's _META_FILLS)
_META_FILLS = (0, NEVER, -1, 0, -2, 0, 1)


def pad_meta(meta: AttnMeta, pad: int) -> AttnMeta:
    """``meta`` with ``pad`` padded tokens at the end."""
    return AttnMeta(*(F.pad(x, (0, pad), value=f)
                      for x, f in zip(meta, _META_FILLS)))


def pad_decode_mask(mask: DecodeMask, pad: int) -> DecodeMask:
    """``mask`` with ``pad`` padded keys (rank 2**30: never visible) and
    queries (q_off 2**30: they see every key) at the end."""
    return DecodeMask(rank=F.pad(mask.rank, (0, pad), value=NEVER),
                      q_off=F.pad(mask.q_off, (0, pad), value=NEVER))


def pad_to_seq(mesh: Optional[Mesh], length: int, q_meta: AttnMeta,
               k_meta: AttnMeta, bias):
    """(pad, q_meta, k_meta, bias) with the new tokens padded to the seq
    multiple; the new tokens are the last ``length`` keys of ``k_meta``
    (all of them without a cache), so the keys are padded at the end."""
    pad = -length % axis_size(mesh, SEQ_AXIS)
    if not pad:
        return 0, q_meta, k_meta, bias
    if bias is not None and not isinstance(bias, DecodeMask):
        raise ValueError(
            "cannot pad a precomputed dense bias to the seq multiple; pass "
            "metadata or a DecodeMask (maybe_bias builds none on a mesh "
            "with a seq axis)")
    if bias is not None:
        bias = pad_decode_mask(bias, pad)
    return pad, pad_meta(q_meta, pad), pad_meta(k_meta, pad), bias


def _check(mesh: Mesh, h: int, hkv: int, lq: int, q_meta: AttnMeta) -> int:
    """The seq axis's size, after checking the heads and the chunk."""
    s, t = axis_size(mesh, SEQ_AXIS), axis_size(mesh, TENSOR_AXIS)
    if h % (s * t) or hkv % (s * t):
        raise ValueError(f"heads ({h}/{hkv}) not divisible by seq*tensor = "
                         f"{s}*{t}")
    if lq * s != q_meta.index.shape[1]:
        raise ValueError(f"a chunk of {lq} queries on {s} seq ranks does not "
                         f"cover the {q_meta.index.shape[1]} of the metadata;"
                         " pad the sequence first (pad_to_seq)")
    return s


def ulysses_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_meta: AttnMeta, k_meta: AttnMeta, mesh: Optional[Mesh],
                   bias=None):
    """Sequence-parallel attention. q [B, L/S, H/T, D] and k/v
    [B, L/S, Hkv/T, D] are this rank's chunk of a sequence whose length L
    (the metadata's, a multiple of S) is padded already; ``bias`` is None
    (metadata: K6), a ``DecodeMask`` (K2) or a precomputed bias (K3).
    Returns the output chunk [B, L/S, H/T, D] and the rank's heads of k/v
    over the full length, [B, L, Hkv/(S T), D] (what a prefill caches).
    Without a mesh it is the local call."""
    if mesh is None:
        return attend(q, k, v, q_meta, k_meta, bias=bias), (k, v)
    t = axis_size(mesh, TENSOR_AXIS)
    s = _check(mesh, q.shape[2] * t, k.shape[2] * t, q.shape[1], q_meta)
    if s > 1:
        # [B, L/S, H/T, D] -> [B, L, H/(S T), D]
        q, k, v = (mesh.all_to_all(x, SEQ_AXIS, split_dim=2, concat_dim=1)
                   for x in (q, k, v))
    out = attend(q, k, v, q_meta, k_meta, bias=bias)
    if s > 1:
        out = mesh.all_to_all(out, SEQ_AXIS, split_dim=1, concat_dim=2)
    return out, (k, v)


def ulysses_attend_cached(q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, q_meta: AttnMeta,
                          k_meta: AttnMeta, mesh: Optional[Mesh], bias=None):
    """Sequence-parallel cached attention (the cond-row decode, the cache
    extend). q [B, Lq/S, H/T, D] and the tail's k/v_new heads-major
    [B, Hkv/T, Lq/S, D] are this rank's chunk of a tail padded to the seq
    multiple; cache_k/v [B, Hkv/(S T), Lc, D] are the rank's heads of the
    cache, unpadded; ``k_meta`` covers [cache | padded tail]. One
    all_to_all over seq brings the rank's heads of the whole tail, the
    local call attends over cache and tail, one more brings the output
    back. Returns the output chunk and the rank's heads of the new k/v
    over the full (padded) tail, tokens-major [B, Lq, Hkv/(S T), D] (what
    an extend caches). Without a mesh it is ``attend_cached``."""
    s = axis_size(mesh, SEQ_AXIS)
    if mesh is not None:
        t = axis_size(mesh, TENSOR_AXIS)
        _check(mesh, q.shape[2] * t, k_new.shape[1] * t, q.shape[1], q_meta)
    if s > 1:
        q = mesh.all_to_all(q, SEQ_AXIS, split_dim=2, concat_dim=1)
        k_new, v_new = (mesh.all_to_all(x, SEQ_AXIS, split_dim=1,
                                        concat_dim=2)
                        for x in (k_new, v_new))
    out = attend_cached(q, cache_k, cache_v, k_new, v_new, q_meta, k_meta,
                        bias)
    if s > 1:
        out = mesh.all_to_all(out, SEQ_AXIS, split_dim=1, concat_dim=2)
    return out, (k_new.transpose(1, 2), v_new.transpose(1, 2))
