"""Static sequence layouts for next-clip diffusion (numpy).

A frozen copy of the layout rules of the system under test: the
reference derives every layout itself from the traffic it is given.
Instead of dense O(L^2) attention masks, a layout is per-token int32
metadata with static shapes:

- ``vis_start``/``noisy_block``/``noisy_role``/``q_block``/``q_offset`` encode
  the frame-block visibility rule; the attention code evaluates it where it
  is needed. Dense masks are rendered only for tests
  (:func:`render_dense_mask`).
- ``clean_src``/``noisy_src``/``time_src`` are gather indices that assemble
  the embedding sequence with vectorised selects.
- ``noisy_gather``/``clean_gather`` extract per-frame hidden states for the
  output heads.

A "frame" occupies ``seg_len = n_img + 2`` tokens:

- noisy frame:  ``[<|diffusion|>, TIME, patch x n_img]``
- clean frame:  ``[<img>, patch x n_img, </img>]``

Schemes:

- ``training``: each frame-block except the last contributes its noisy frames
  then their clean copies; the last block contributes noisy frames only.
- ``inference``: each block except the last contributes clean frames only;
  the last block is the noisy clip being denoised.
- ``uncond``: every block contributes noisy frames only (the training-side
  counterpart of the serving CFG unconditional row ``[0, n_gen]``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .tokens import DEFAULT_TOKEN_IDS, Kind, TokenIds

# Sentinel for "never visible via the causal rule" (noisy + pad keys).
NEVER = np.int32(2**30)


@dataclasses.dataclass(frozen=True)
class RowSpec:
    """One batch row: frame-block partition + layout scheme.

    ``block_aware=True`` selects the coarse mask variant where whole frame
    segments (including the DIFF/TIME/<img>/</img> markers) are mutually
    visible, instead of the per-role intra-frame offsets
    (create_block_mask_training, LVM/processor.py:733-774)."""

    frame_blocks: Tuple[int, ...]
    scheme: str = "inference"  # 'inference' | 'training' | 'uncond'
    block_aware: bool = False

    def __post_init__(self):
        assert self.scheme in ("inference", "training", "uncond"), self.scheme
        assert all(b >= 0 for b in self.frame_blocks)
        assert self.frame_blocks[-1] > 0, "last (noisy) block must be non-empty"

    @property
    def num_noisy_frames(self) -> int:
        if self.scheme in ("training", "uncond"):
            return sum(self.frame_blocks)
        return self.frame_blocks[-1]

    @property
    def num_clean_frames(self) -> int:
        if self.scheme == "uncond":
            return 0
        return sum(self.frame_blocks[:-1])


@dataclasses.dataclass
class SequenceLayout:
    """Batched token-level metadata. All arrays are numpy; convert to torch at
    the model boundary. Shapes: ``[B, L]`` unless noted."""

    # token stream
    input_ids: np.ndarray      # int32
    pos_ids: np.ndarray        # int32 RoPE positions (shared-position scheme)
    kind: np.ndarray           # int32 Kind enum
    # mask metadata (key side)
    vis_start: np.ndarray      # int32; key visible to queries q >= vis_start
    noisy_block: np.ndarray    # int32; frame-block id of noisy keys, else -1
    noisy_role: np.ndarray     # int32; 0 diff / 1 time / 2 patch (noisy keys)
    # mask metadata (query side)
    q_block: np.ndarray        # int32; frame-block id if query in noisy frame
    q_offset: np.ndarray       # int32; offset of query within its noisy frame
    # embedding-assembly gather maps (index into flattened per-frame arrays,
    # -1 where the text embedding is kept)
    clean_src: np.ndarray      # int32 -> [num_clean_frames*n_img]
    noisy_src: np.ndarray      # int32 -> [num_noisy_frames*n_img]
    time_src: np.ndarray       # int32 -> [num_noisy_frames]
    # output-head gather: flat (b*L + pos) indices of patch tokens
    noisy_gather: np.ndarray   # int32 [num_noisy_frames, n_img]
    clean_gather: np.ndarray   # int32 [num_clean_frames, n_img]
    # per-frame bookkeeping
    noisy_frame_row: np.ndarray    # int32 [Nn] batch row of each noisy frame
    noisy_frame_block: np.ndarray  # int32 [Nn] frame-block id
    noisy_video_frame: np.ndarray  # int32 [Nn] frame index within its row's video
    clean_frame_row: np.ndarray    # int32 [Nc]
    clean_video_frame: np.ndarray  # int32 [Nc]
    # scalars / specs
    n_img: int
    seg_len: int
    specs: Tuple[RowSpec, ...] = ()

    @property
    def batch(self) -> int:
        return self.input_ids.shape[0]

    @property
    def length(self) -> int:
        return self.input_ids.shape[1]

    @property
    def num_noisy_frames(self) -> int:
        return self.noisy_gather.shape[0]

    @property
    def num_clean_frames(self) -> int:
        return self.clean_gather.shape[0]


def _build_row(spec: RowSpec, n_img: int, ids: TokenIds):
    """Unpadded per-row token lists. Returns dict of python lists + frame info."""
    seg = n_img + 2
    r = {k: [] for k in (
        "input_ids", "pos_ids", "kind", "vis_start", "noisy_block",
        "noisy_role", "q_block", "q_offset", "clean_src", "noisy_src",
        "time_src")}
    frames = []  # (is_noisy, block_id, video_frame, token_start)
    d_pos = 0    # noisy ("diffusion") position counter
    c_pos = 0    # clean position counter
    video_frame = 0
    clean_done = 0
    last = len(spec.frame_blocks) - 1

    def emit_noisy(block_id: int, vframe: int):
        nonlocal d_pos
        start = len(r["input_ids"])
        frames.append((True, block_id, vframe, start))
        kinds = [Kind.DIFF, Kind.TIME] + [Kind.NOISY_IMG] * n_img
        toks = [ids.diffusion, ids.slot] + [ids.slot] * n_img
        for off, (k, t) in enumerate(zip(kinds, toks)):
            r["input_ids"].append(t)
            r["pos_ids"].append(d_pos + off)
            r["kind"].append(int(k))
            r["vis_start"].append(int(NEVER))
            r["noisy_block"].append(block_id)
            r["noisy_role"].append(0 if spec.block_aware else min(off, 2))
            r["q_block"].append(block_id)
            r["q_offset"].append(off)
            r["clean_src"].append(-1)
            r["noisy_src"].append(-1)
            r["time_src"].append(-1)
        d_pos += seg

    def emit_clean(block_id: int, vframe: int):
        nonlocal c_pos
        start = len(r["input_ids"])
        frames.append((False, block_id, vframe, start))
        kinds = [Kind.IMG_OPEN] + [Kind.CLEAN_IMG] * n_img + [Kind.IMG_CLOSE]
        toks = [ids.img_open] + [ids.slot] * n_img + [ids.img_close]
        for off, (k, t) in enumerate(zip(kinds, toks)):
            r["input_ids"].append(t)
            r["pos_ids"].append(c_pos + off)
            r["kind"].append(int(k))
            # <img> visible from its own row; patches from row+1; </img> from
            # the frame's final row (LVM/processor.py:697-702). The
            # block_aware variant exposes the whole segment from its start
            # (LVM/processor.py:744-763).
            if spec.block_aware or k == Kind.IMG_OPEN:
                vis = start
            elif k == Kind.CLEAN_IMG:
                vis = start + 1
            else:
                vis = start + seg - 1
            r["vis_start"].append(vis)
            r["noisy_block"].append(-1)
            r["noisy_role"].append(0)
            r["q_block"].append(-1)
            r["q_offset"].append(0)
            r["clean_src"].append(-1)
            r["noisy_src"].append(-1)
            r["time_src"].append(-1)
        c_pos += seg

    for k, fb in enumerate(spec.frame_blocks):
        if spec.scheme == "uncond":
            for i in range(fb):
                emit_noisy(k, video_frame)
                video_frame += 1
            continue
        if k != last:
            if spec.scheme == "training":
                base = video_frame
                for i in range(fb):
                    emit_noisy(k, base + i)
                for i in range(fb):
                    emit_clean(k, base + i)
                video_frame += fb
                clean_done += fb
            else:
                for i in range(fb):
                    emit_clean(k, video_frame)
                    video_frame += 1
        else:
            if spec.scheme == "inference":
                d_pos = c_pos  # noisy block continues the clean positions
                               # (LVM/processor.py:527)
            for i in range(fb):
                emit_noisy(k, video_frame)
                video_frame += 1
    return r, frames


def build_layout(
    specs: Sequence[RowSpec],
    n_img: int,
    pad_to_multiple: int = 1,
    pad_to: Optional[int] = None,
    token_ids: TokenIds = DEFAULT_TOKEN_IDS,
) -> SequenceLayout:
    """Build a left-padded batched layout.

    ``pad_to_multiple`` mirrors padding-to-SP-size (LVM/processor.py:813-816);
    ``pad_to`` fixes the total length (shape bucketing).
    """
    rows = [_build_row(s, n_img, token_ids) for s in specs]
    max_l = max(len(r["input_ids"]) for r, _ in rows)
    if pad_to is not None:
        assert pad_to >= max_l, (pad_to, max_l)
        max_l = pad_to
    if max_l % pad_to_multiple:
        max_l += pad_to_multiple - max_l % pad_to_multiple

    B = len(rows)
    out = {k: np.zeros((B, max_l), np.int32) for k in rows[0][0]}
    # defaults for padded positions
    out["input_ids"][:] = token_ids.pad
    out["kind"][:] = int(Kind.PAD)
    out["vis_start"][:] = NEVER
    out["noisy_block"][:] = -1
    out["clean_src"][:] = -1
    out["noisy_src"][:] = -1
    out["time_src"][:] = -1

    seg = n_img + 2
    noisy_gather, clean_gather = [], []
    nf_row, nf_block, nf_vid = [], [], []
    cf_row, cf_vid = [], []
    g_noisy = g_clean = 0

    for b, (r, frames) in enumerate(rows):
        L = len(r["input_ids"])
        pad_l = max_l - L
        for key, vals in r.items():
            arr = np.asarray(vals, np.int32)
            if key == "vis_start":
                arr = np.where(arr == NEVER, NEVER, arr + pad_l)
            out[key][b, pad_l:] = arr
        for is_noisy, block_id, vframe, start in frames:
            start += pad_l
            if is_noisy:
                patch0 = start + 2
                out["time_src"][b, start + 1] = g_noisy
                out["noisy_src"][b, patch0: patch0 + n_img] = (
                    g_noisy * n_img + np.arange(n_img))
                noisy_gather.append(b * max_l + patch0 + np.arange(n_img))
                nf_row.append(b)
                nf_block.append(block_id)
                nf_vid.append(vframe)
                g_noisy += 1
            else:
                patch0 = start + 1
                out["clean_src"][b, patch0: patch0 + n_img] = (
                    g_clean * n_img + np.arange(n_img))
                clean_gather.append(b * max_l + patch0 + np.arange(n_img))
                cf_row.append(b)
                cf_vid.append(vframe)
                g_clean += 1

    def _stack(x, width=None):
        if x:
            return np.asarray(x, np.int32)
        return np.zeros((0, n_img) if width else (0,), np.int32)

    return SequenceLayout(
        input_ids=out["input_ids"], pos_ids=out["pos_ids"], kind=out["kind"],
        vis_start=out["vis_start"], noisy_block=out["noisy_block"],
        noisy_role=out["noisy_role"], q_block=out["q_block"],
        q_offset=out["q_offset"], clean_src=out["clean_src"],
        noisy_src=out["noisy_src"], time_src=out["time_src"],
        noisy_gather=_stack(noisy_gather, width=True),
        clean_gather=_stack(clean_gather, width=True),
        noisy_frame_row=_stack(nf_row), noisy_frame_block=_stack(nf_block),
        noisy_video_frame=_stack(nf_vid), clean_frame_row=_stack(cf_row),
        clean_video_frame=_stack(cf_vid),
        n_img=n_img, seg_len=seg, specs=tuple(specs),
    )


def frame_block_inference_layout(
    n_clean: int, n_gen: int, n_img: int, use_cfg: bool,
    pad_to_multiple: int = 1, pad_to: Optional[int] = None,
    token_ids: TokenIds = DEFAULT_TOKEN_IDS, rows: int = 1,
) -> SequenceLayout:
    """CFG pair for autoregressive next-clip prediction: conditional row
    ``[n_clean, n_gen]`` + unconditional row ``[0, n_gen]``
    (LVM/processor.py:366-421, LVM/pipeline.py:426-448).

    ``rows > 1`` replicates the row for BATCHED serving (N same-shaped
    videos through one B=N program set — pipeline.generate_batch); the
    CFG pair is handled by separate layouts there, so ``use_cfg`` must be
    False."""
    if rows > 1 and use_cfg:
        raise ValueError("rows > 1 batches same-role rows; build the "
                         "uncond layout separately (separate-CFG)")
    blocks = (n_clean, n_gen) if n_clean > 0 else (n_gen,)
    specs = [RowSpec(blocks, "inference")] * rows
    if use_cfg:
        specs.append(RowSpec((0, n_gen), "inference"))
    return build_layout(specs, n_img, pad_to_multiple, pad_to, token_ids)


def render_dense_mask(layout: SequenceLayout) -> np.ndarray:
    """[B, L, L] bool mask (rows=queries). Test/reference path only — the
    attention code evaluates the same rule from the metadata."""
    L = layout.length
    q = np.arange(L, dtype=np.int64)[:, None]
    masks = []
    for b in range(layout.batch):
        causal = q >= layout.vis_start[b][None, :]
        noisy = (
            (layout.noisy_block[b][None, :] >= 0)
            & (layout.noisy_block[b][None, :] == layout.q_block[b][:, None])
            & (layout.q_offset[b][:, None] >= layout.noisy_role[b][None, :])
        )
        pad_row = (layout.kind[b] == Kind.PAD)[:, None]
        masks.append(causal | noisy | pad_row)
    return np.stack(masks)
