"""Token layouts of the image family: ``[pad][text(+images)][TIME][out]``.

A frozen copy of the single-shot layout rule of the system under test, so
that the reference derives the image training layout itself.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .layout import NEVER, SequenceLayout
from .tokens import DEFAULT_TOKEN_IDS, Kind, TokenIds


@dataclasses.dataclass
class TextRow:
    """One prompt row: token ids with inline input-image patch regions."""

    input_ids: List[int]                  # image regions hold slot ids
    image_regions: List[Tuple[int, int]]  # [start, end) within input_ids


def single_shot_layout(rows: Sequence[TextRow], n_out: int,
                       n_region: Optional[int] = None,
                       pad_to_multiple: int = 1,
                       pad_to: Optional[int] = None,
                       token_ids: TokenIds = DEFAULT_TOKEN_IDS
                       ) -> SequenceLayout:
    """Layout of ``[pad][text(+images)][TIME][out image]`` rows. Every row
    has ``n_out`` output tokens; each input-image region takes its size
    from its ``TextRow`` extent, so regions of different sizes are allowed.
    ``n_region`` asserts that every region has that size (the training
    contract; ``clean_gather`` is made only for uniform regions). ``pad_to``
    fixes the total length. ``clean_src`` indexes the flat patch stream of
    the regions in (row, region) order, the order of
    ``VideoGPT._embed_clean_flat``."""
    B = len(rows)
    max_l = max(len(r.input_ids) for r in rows) + n_out + 1
    if pad_to is not None:
        assert pad_to >= max_l, (pad_to, max_l)
        max_l = pad_to
    if max_l % pad_to_multiple:
        max_l += pad_to_multiple - max_l % pad_to_multiple

    arr = {k: np.zeros((B, max_l), np.int32) for k in (
        "input_ids", "pos_ids", "kind", "vis_start", "noisy_block",
        "noisy_role", "q_block", "q_offset", "clean_src", "noisy_src",
        "time_src")}
    arr["input_ids"][:] = token_ids.pad
    arr["kind"][:] = int(Kind.PAD)
    arr["vis_start"][:] = NEVER
    arr["noisy_block"][:] = -1
    arr["q_block"][:] = -1
    for k in ("clean_src", "noisy_src", "time_src"):
        arr[k][:] = -1

    noisy_gather, clean_gather = [], []
    cf_row, cf_vid, nf_row = [], [], []
    flat_off = 0  # running offset into the flat clean patch stream
    uniform = n_region is not None or len({
        e - s for r in rows for (s, e) in r.image_regions}) <= 1
    for b, row in enumerate(rows):
        temp_l = len(row.input_ids)
        pad_l = max_l - temp_l - n_out - 1
        # text prefix: causal, positions continuous after the pads
        sl = slice(pad_l, pad_l + temp_l)
        arr["input_ids"][b, sl] = row.input_ids
        arr["kind"][b, sl] = int(Kind.TEXT)
        arr["vis_start"][b, sl] = pad_l + np.arange(temp_l)
        arr["pos_ids"][b, pad_l:] = np.arange(temp_l + n_out + 1)
        # input-image regions: causal, and bidirectional within a region
        for g, (s, e) in enumerate(row.image_regions):
            n_g = e - s
            if n_region is not None:
                assert n_g == n_region, (s, e, n_region)
            rs = slice(pad_l + s, pad_l + e)
            arr["kind"][b, rs] = int(Kind.CLEAN_IMG)
            arr["noisy_block"][b, rs] = g
            arr["q_block"][b, rs] = g
            arr["clean_src"][b, rs] = flat_off + np.arange(n_g)
            flat_off += n_g
            if uniform:
                clean_gather.append(b * max_l + pad_l + s + np.arange(n_g))
            cf_row.append(b)
            cf_vid.append(g)
        # TIME token: causal
        tpos = pad_l + temp_l
        arr["kind"][b, tpos] = int(Kind.TIME)
        arr["vis_start"][b, tpos] = tpos
        arr["input_ids"][b, tpos] = token_ids.slot
        arr["time_src"][b, tpos] = b
        # output tokens: visible to their own group; they see TIME and the
        # text through vis_start
        out_group = len(row.image_regions) + 1
        osl = slice(tpos + 1, tpos + 1 + n_out)
        arr["kind"][b, osl] = int(Kind.NOISY_IMG)
        arr["input_ids"][b, osl] = token_ids.slot
        arr["noisy_block"][b, osl] = out_group
        arr["q_block"][b, osl] = out_group
        arr["noisy_src"][b, osl] = b * n_out + np.arange(n_out)
        noisy_gather.append(b * max_l + tpos + 1 + np.arange(n_out))
        nf_row.append(b)

    def _a(x):
        return np.asarray(x, np.int32)

    return SequenceLayout(
        input_ids=arr["input_ids"], pos_ids=arr["pos_ids"],
        kind=arr["kind"], vis_start=arr["vis_start"],
        noisy_block=arr["noisy_block"], noisy_role=arr["noisy_role"],
        q_block=arr["q_block"], q_offset=arr["q_offset"],
        clean_src=arr["clean_src"], noisy_src=arr["noisy_src"],
        time_src=arr["time_src"],
        noisy_gather=_a(noisy_gather),
        # rectangular only for uniform regions (the aux head's and the
        # training collate's contract)
        clean_gather=(_a(clean_gather) if clean_gather
                      else np.zeros((0, n_region or n_out), np.int32)),
        noisy_frame_row=_a(nf_row),
        noisy_frame_block=np.zeros((B,), np.int32),
        noisy_video_frame=np.zeros((B,), np.int32),
        clean_frame_row=_a(cf_row), clean_video_frame=_a(cf_vid),
        n_img=n_out, seg_len=n_out + 1, specs=(),
    )
