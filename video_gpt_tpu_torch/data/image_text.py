"""Image-generation training data: a json dataset with condition dropout.

Port of ``video_gpt_tpu/data/image_text.py``. Records are
``{"instruction": str, "input_images": [paths] | null, "output_image":
path}``; with probability ``condition_dropout_prob`` the conditions are
dropped (the instruction becomes ``<cfg>``, the input images go), so the
model learns the unconditional branch that guidance needs. The dropout is
a function of (seed, epoch, index) alone, so a resumed run replays the same
stream. Images are resized and center-cropped to fixed sizes and the token
stream is padded to ``pad_to``, so every batch has one shape.

PIL is imported only to open or resize an image: an HWC uint8 array that
already has the exact size takes a numpy path.
"""
from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..image_gen import IMG_TAG, ImageGenProcessor, TextRow, \
    single_shot_layout
from ..models.video_gpt import Batch
from ..tokens import DEFAULT_TOKEN_IDS, TokenIds
from ..training.data import to_device
from ..training.loss import LossInputs

CFG_PROMPT = "<cfg>"


def resize_center_crop(img, size: Tuple[int, int]) -> np.ndarray:
    """An image (PIL, or an HWC uint8 RGB array) -> [-1, 1] float32 array
    of exactly ``size`` (h, w): resize of the short side keeping the
    aspect (bicubic), then a center crop. An array of exactly ``size``
    needs neither (PIL's resize to the same size returns the image as it
    is) and stays in numpy."""
    h, w = size
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
            and img.shape == (h, w, 3)):
        from PIL import Image
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        img = img.convert("RGB")
        scale = max(h / img.height, w / img.width)
        img = img.resize((max(round(img.width * scale), w),
                          max(round(img.height * scale), h)), Image.BICUBIC)
        left = (img.width - w) // 2
        top = (img.height - h) // 2
        img = img.crop((left, top, left + w, top + h))
    a = np.asarray(img, np.float32) / 255.0
    return (a - 0.5) / 0.5


class ImageGenSample(NamedTuple):
    row: TextRow
    input_pixels: List[np.ndarray]   # each [hr, wr, 3] in [-1, 1]
    output_pixels: np.ndarray        # [h, w, 3] in [-1, 1]


class ImageTextDataset:
    """json / jsonl records -> :class:`ImageGenSample` with condition
    dropout; ``processor`` templates and tokenizes the prompts."""

    def __init__(
        self,
        json_file: str,
        image_root: Optional[str],
        processor: ImageGenProcessor,
        output_size: Tuple[int, int] = (512, 512),
        input_size: Optional[Tuple[int, int]] = None,
        condition_dropout_prob: float = 0.1,
        max_input_length_limit: int = 18000,
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        max_retries: int = 8,
    ):
        with open(json_file) as f:
            head = f.read(1)
            f.seek(0)
            if head == "[":
                records = json.load(f)
            else:  # jsonl
                records = [json.loads(line) for line in f if line.strip()]
        self.records = records[shard_index::shard_count]
        self.image_root = image_root
        self.processor = processor
        self.output_size = output_size
        self.input_size = input_size or output_size
        self.condition_dropout_prob = condition_dropout_prob
        self.max_input_length_limit = max_input_length_limit
        self.seed = seed
        self.max_retries = max_retries

    def __len__(self) -> int:
        return len(self.records)

    def _path(self, p: str) -> str:
        return os.path.join(self.image_root, p) if self.image_root else p

    def _load(self, path: str, size: Tuple[int, int]) -> np.ndarray:
        from PIL import Image
        with Image.open(self._path(path)) as img:
            return resize_center_crop(img, size)

    def _example(self, index: int, epoch: int = 0) -> ImageGenSample:
        rec = self.records[index]
        instruction = rec["instruction"]
        input_images = rec.get("input_images") or None
        # the epoch re-rolls each revisit's dropout; still a function of
        # (seed, epoch, index) alone
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, index]))
        if rng.random() < self.condition_dropout_prob:
            instruction = CFG_PROMPT
            input_images = None
        pixels = [self._load(p, self.input_size)
                  for p in (input_images or [])]
        n_region = (self.input_size[0] // 16) * (self.input_size[1] // 16)
        # the inference template, so training sees what serving feeds
        text = self.processor.add_prefix_instruction(instruction)
        row = self._tokenize_row(text, len(pixels), n_region)
        if len(row.input_ids) > self.max_input_length_limit:
            raise ValueError(f"{len(row.input_ids)} tokens > limit "
                             f"{self.max_input_length_limit}")
        out = self._load(rec["output_image"], self.output_size)
        return ImageGenSample(row, pixels, out)

    def _tokenize_row(self, text: str, n_images: int,
                      n_region: int) -> TextRow:
        """The processor's chunk and region assembly with regions of
        ``n_region`` tokens."""
        chunks = [self.processor.tokenizer(c).input_ids
                  for c in IMG_TAG.split(text)]
        chunks = [c[1:] if c and c[0] == 1 else c for c in chunks]
        n_tags = len(IMG_TAG.findall(text))
        assert n_tags == n_images, (n_tags, n_images, text)
        ids: List[int] = []
        regions: List[Tuple[int, int]] = []
        slot = self.processor.token_ids.slot
        for i, chunk in enumerate(chunks):
            ids.extend(chunk)
            if i < len(chunks) - 1:
                regions.append((len(ids), len(ids) + n_region))
                ids.extend([slot] * n_region)
        return TextRow(ids, regions)

    def sample(self, index: int, epoch: int = 0) -> ImageGenSample:
        """Record ``index`` (a bad record is skipped for the next one, at
        most ``max_retries`` times)."""
        for attempt in range(self.max_retries):
            try:
                return self._example((index + attempt) % len(self), epoch)
            except Exception as e:
                print(f"image_text: bad record {index + attempt}: {e}",
                      flush=True)
        raise RuntimeError("too many bad records")


class ImageGenTrainBatch(NamedTuple):
    inputs: LossInputs          # x1 / clean_latents None until encoded
    out_pixels: torch.Tensor    # [B, h, w, 3]
    in_pixels: torch.Tensor     # [Nc_max, hr, wr, 3] (zero-padded)
    clean_valid: torch.Tensor   # [Nc_max] 1.0 for real input images

    def to(self, device) -> "ImageGenTrainBatch":
        """Every tensor of the batch moved to ``device``."""
        return to_device(self, device)


def collate_image_gen(
    samples: Sequence[ImageGenSample],
    pad_to: int,
    max_input_images: int,
    token_ids: TokenIds = DEFAULT_TOKEN_IDS,
) -> ImageGenTrainBatch:
    """A batch of one shape on the host: the token stream padded to
    ``pad_to``, the clean (input-image) side to ``max_input_images * B``
    slots (``clean_weights`` 0 on the padding)."""
    B = len(samples)
    h, w = samples[0].output_pixels.shape[:2]
    n_out = (h // 16) * (w // 16)
    if any(s.input_pixels for s in samples):
        hr, wr = next(s.input_pixels[0].shape[:2]
                      for s in samples if s.input_pixels)
    else:
        hr, wr = h, w
    n_region = (hr // 16) * (wr // 16)
    layout = single_shot_layout([s.row for s in samples], n_out, n_region,
                                pad_to=pad_to, token_ids=token_ids)

    nc = layout.num_clean_frames
    nc_max = max(max_input_images * B, 1)
    assert nc <= nc_max, (nc, nc_max)
    clean_gather = np.zeros((nc_max, n_region), np.int32)
    clean_gather[:nc] = layout.clean_gather
    layout.clean_gather = clean_gather
    clean_valid = np.zeros((nc_max,), np.float32)
    clean_valid[:nc] = 1.0

    in_pixels = np.zeros((nc_max, hr, wr, 3), np.float32)
    i = 0
    for s in samples:
        for px in s.input_pixels:
            in_pixels[i] = px
            i += 1
    assert i == nc

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    inputs = LossInputs(
        batch=Batch.from_layout(layout, "cpu"),
        x1=None, clean_latents=None,
        noisy_frame_row=t(layout.noisy_frame_row),
        noisy_frame_block=t(layout.noisy_frame_block),
        clean_weights=t(clean_valid))
    return ImageGenTrainBatch(
        inputs=inputs,
        out_pixels=t(np.stack([s.output_pixels for s in samples])),
        in_pixels=t(in_pixels), clean_valid=t(clean_valid))
