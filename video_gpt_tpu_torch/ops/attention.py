"""Attention with frame-block visibility computed from token metadata.

Port of ``video_gpt_tpu/ops/attention.py``. :class:`AttnMeta` carries
per-token int32 vectors, and the visibility rule is evaluated where it is
needed: a precomputed bias, a columnar :class:`DecodeMask` or the metadata
itself feeds the hand-written kernels of ``ops.flash_attention``; the dense
reference here is a test oracle.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..tokens import Kind


class AttnMeta(NamedTuple):
    """Per-token mask metadata, all int32 [B, L] (see layout.SequenceLayout)."""

    index: torch.Tensor        # global sequence position of each token
    vis_start: torch.Tensor    # key side: visible to queries q >= vis_start
    noisy_block: torch.Tensor  # key side: frame-block id of noisy keys else -1
    noisy_role: torch.Tensor   # key side: 0 diff / 1 time / 2 patch
    q_block: torch.Tensor      # query side: noisy frame-block id else -1
    q_offset: torch.Tensor     # query side: offset within the noisy frame
    is_pad: torch.Tensor       # 1 where PAD

    @classmethod
    def from_layout(cls, layout, device) -> "AttnMeta":
        b, l = layout.kind.shape

        def t(x):
            return torch.as_tensor(x, dtype=torch.int32).to(device)

        idx = torch.arange(l, dtype=torch.int32, device=device)
        return cls(
            index=idx[None].expand(b, l),
            vis_start=t(layout.vis_start),
            noisy_block=t(layout.noisy_block),
            noisy_role=t(layout.noisy_role),
            q_block=t(layout.q_block),
            q_offset=t(layout.q_offset),
            is_pad=t(layout.kind == int(Kind.PAD)),
        )

    def cols(self, sl: slice) -> "AttnMeta":
        """Metadata of the token columns ``sl``."""
        return AttnMeta(*(x[:, sl] for x in self))

    def tail(self, tail_len: int) -> "AttnMeta":
        """Metadata of the trailing ``tail_len`` tokens (the noisy clip in
        inference layouts): the query side of cached decoding."""
        return self.cols(slice(-tail_len, None))


class Window(NamedTuple):
    """A sliding window over the layout's positions (``pos_ids``), on top
    of the frame-block rule: key k stays visible to a non-pad query q only
    where q_pos - k_pos < size. A noisy frame shares its positions with its
    clean copy, so the window covers the same frames in training and in
    serving. The positions ride beside :class:`AttnMeta`, whose seven
    fields are the JAX package's."""

    size: int
    q_pos: torch.Tensor  # [B, Lq] int32
    k_pos: torch.Tensor  # [B, Lk] int32


def visibility(q: AttnMeta, k: AttnMeta,
               window: Optional[Window] = None) -> torch.Tensor:
    """[B, Lq, Lk] bool: may query q attend key k. Pad rows attend
    everything; clean/causal keys from ``vis_start``; noisy keys only within
    the same frame-block, gated by role; with a ``window``, only keys
    within its positions."""
    causal = q.index[:, :, None] >= k.vis_start[:, None, :]
    noisy = ((k.noisy_block[:, None, :] >= 0)
             & (k.noisy_block[:, None, :] == q.q_block[:, :, None])
             & (q.q_offset[:, :, None] >= k.noisy_role[:, None, :]))
    pad_row = q.is_pad[:, :, None] > 0
    vis = causal | noisy | pad_row
    if window is None or window.size <= 0:
        return vis
    near = (window.q_pos[:, :, None] - window.k_pos[:, None, :]) < window.size
    return vis & (near | pad_row)


def attention_bias(q: AttnMeta, k: AttnMeta,
                   dtype: torch.dtype = torch.float32,
                   window: Optional[Window] = None) -> torch.Tensor:
    """Additive [B, 1, Lq, Lk] bias: 0 where visible, finfo.min where not."""
    vis = visibility(q, k, window)
    neg = torch.tensor(torch.finfo(dtype).min, dtype=dtype, device=vis.device)
    return torch.where(vis, torch.zeros((), dtype=dtype, device=vis.device),
                       neg)[:, None]


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain masked attention; q [B,Lq,H,D], k/v [B,Lk,Hkv,D] ->
    [B,Lq,H,D]. fp32 softmax."""
    d = q.shape[-1]
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    group = q.shape[2] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bqhd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_meta: AttnMeta, k_meta: AttnMeta, bias=None,
           window: Optional[Window] = None) -> torch.Tensor:
    """Metadata-masked attention dispatch; q [B,Lq,H,D], k/v [B,Lk,Hkv,D].

    ``bias`` is a ``DecodeMask`` (columnar per-key rank: the decode kernel,
    K2), a precomputed bf16 bias from ``precompute_bias``, bare or with its
    tile map as a ``BiasMap`` (the bias kernel, K3, differentiable: its
    backward is K9, over the same map), or None: the metadata-inline
    kernel K6 evaluates the rule from ``q_meta``/``k_meta`` per tile
    (differentiable: its backward is K7). Each kernel's wrapper runs its
    plain version on CPU tensors. A ``window`` narrows the rule: K6/K7
    evaluate it with the metadata; a bias must have been built with it
    (``precompute_bias(..., window)``); the decode kernels take none.
    """
    from .flash_attention import (DecodeMask, flash_mha, flash_mha_decode,
                                  flash_mha_inline)
    if isinstance(bias, DecodeMask):
        if window is not None:
            raise ValueError("the decode kernels (K1/K2) take no window")
        return flash_mha_decode(q, k, v, bias)
    if bias is not None:
        return flash_mha(q, k, v, bias)
    return flash_mha_inline(q, k, v, q_meta, k_meta, window=window)


def attend_decode_split(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor, mask) -> torch.Tensor:
    """Cached-decode attention with SEPARATE cache and tail operands (the
    split decode kernel, K1): no per-layer ``cat([cache, new])`` copy.
    ``k/v_cache`` are heads-major [B,Hkv,Lc,D]; ``k/v_new`` heads-major
    views [B,Hkv,Lt,D]; ``mask`` a DecodeMask over the concatenated keys."""
    from .flash_attention import DecodeMask, flash_mha_decode_split
    if not isinstance(mask, DecodeMask):
        raise TypeError(f"attend_decode_split needs a DecodeMask, got "
                        f"{type(mask).__name__}")
    return flash_mha_decode_split(q, k_cache, v_cache, k_new, v_new, mask)


def attend_cached(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, k_new: torch.Tensor,
                  v_new: torch.Tensor, q_meta: AttnMeta, k_meta: AttnMeta,
                  bias=None) -> torch.Tensor:
    """Attention of the new tokens' queries over a heads-major cache
    [B,Hkv,Lc,D] and their own keys [B,Hkv,Lt,D] (views), the JAX
    ``Phi3Attention``'s cached branches. A ``DecodeMask`` runs K1 over the
    two operands (:func:`attend_decode_split`); a precomputed bias (a
    ``BiasMap`` [B, Lt, Lc+Lt], the image path's rectangular decode bias)
    runs K3, and None K6 with ``q_meta``/``k_meta``, over the heads-major
    concatenation, handed to :func:`attend` as a [B,Lk,Hkv,D] view."""
    from .flash_attention import DecodeMask
    if isinstance(bias, DecodeMask):
        return attend_decode_split(q, k_cache, v_cache, k_new, v_new, bias)
    k = torch.cat([k_cache.to(k_new.dtype), k_new], dim=2)
    v = torch.cat([v_cache.to(v_new.dtype), v_new], dim=2)
    return attend(q, k.transpose(1, 2), v.transpose(1, 2), q_meta, k_meta,
                  bias=bias)
