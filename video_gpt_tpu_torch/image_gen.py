"""Single-shot text(+image) -> image generation (the OmniGen ancestor
family).

Port of ``video_gpt_tpu/image_gen.py``. A row is
``[pad][prompt text with inline input-image regions][TIME][output image
tokens]``: a causal prompt, input-image regions visible within themselves,
output tokens visible only to themselves, all through the per-token
metadata rule of the video path. Each guidance context prefills its prompt
into a KV cache once; every denoise step recomputes ``[TIME][output
tokens]`` against it, with the context's rectangular decode bias (the
tail's rows over every key) built once before the loop: K3 over the
heads-major concatenation of cache and tail (K6 above
``precompute_bias_limit``). Guidance is 2-way (text) or 3-way (text and
image), run per context at its natural length (the default) or as one
padded batch.

Noise comes from a :class:`TorchNoise` seeded with ``seed`` or from any
callable with its signature (``noise(kind, shape, dtype)``, kinds
``"encode"``, one per VAE encode, then ``"z"``), so a test can hand the
port the JAX pipeline's draws. PIL is imported only to open or resize an
image or to return PIL images.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import ModelConfig, SchedulerConfig
from .data.processor import preprocess_frames
from .layout import NEVER, SequenceLayout
from .models.vae import AutoencoderKL, VAEConfig
from .models.video_gpt import Batch, VideoGPT, maybe_bias
from .sampling.pipeline import TorchNoise, VideoGPTPipeline
from .sampling.scheduler import sample, sample_separate_multi
from .tokens import DEFAULT_TOKEN_IDS, Kind, TokenIds

DEFAULT_NEGATIVE_PROMPT = (
    "low quality, jpeg artifacts, ugly, duplicate, morbid, mutilated, extra "
    "fingers, mutated hands, poorly drawn hands, poorly drawn face, "
    "mutation, deformed, blurry, dehydrated, bad anatomy, bad proportions, "
    "extra limbs, cloned face, disfigured, gross proportions, malformed "
    "limbs, missing arms, missing legs, extra arms, extra legs, fused "
    "fingers, too many fingers.")

IMG_TAG = re.compile(r"<\|image_\d+\|>")


class StubTokenizer:
    """Word-hash tokenizer for smoke runs without a real one: each word is
    ``100 + hash(word) % 1000``. Python salts ``hash`` per process, so two
    processes tokenize alike only under one ``PYTHONHASHSEED``."""

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Out([100 + (hash(w) % 1000) for w in text.split()])


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


class ImageGenProcessor:
    """Prompt templating and tokenization. ``tokenizer`` is any callable
    with ``tokenizer(text).input_ids`` (a Hugging Face tokenizer, or
    :class:`StubTokenizer`); a BOS id 1 at the start of a chunk is
    dropped."""

    def __init__(self, tokenizer, max_image_size: int = 1024,
                 token_ids: Optional[TokenIds] = None):
        self.tokenizer = tokenizer
        self.max_image_size = max_image_size
        # the structural ids of the tokenizer when it has them
        self.token_ids = (token_ids if token_ids is not None
                          else TokenIds.from_tokenizer(tokenizer))

    def add_prefix_instruction(self, prompt: str) -> str:
        return (
            "<|user|>\nGenerate an image according to the following "
            f"instructions\n{prompt}<|end|>\n<|assistant|>\n<|diffusion|>")

    def preprocess_image(self, image) -> np.ndarray:
        """An image (a path, a PIL image or an HWC uint8 array) -> [H, W, 3]
        float32 in [-1, 1] under the resize and crop policy of
        ``data.processor`` (an array that needs no resize stays in numpy)."""
        if isinstance(image, str):
            from PIL import Image
            image = Image.open(image)
        return preprocess_frames([image], self.max_image_size)[0]

    def row(self, prompt: str, images: Optional[Sequence] = None,
            n_region: Optional[int] = None, add_prefix: bool = True
            ) -> Tuple[TextRow, List[np.ndarray]]:
        text = self.add_prefix_instruction(prompt) if add_prefix else prompt
        pixels = [self.preprocess_image(x) for x in (images or [])]
        chunks = [self.tokenizer(c).input_ids for c in IMG_TAG.split(text)]
        chunks = [c[1:] if c and c[0] == 1 else c for c in chunks]
        tags = [int(s.split("|")[1].split("_")[-1])
                for s in IMG_TAG.findall(text)]
        assert len(tags) == len(pixels), (len(tags), len(pixels))
        ids: List[int] = []
        regions: List[Tuple[int, int]] = []
        ordered: List[np.ndarray] = []  # the pixels in region order
        for i, chunk in enumerate(chunks):
            ids.extend(chunk)
            if i < len(chunks) - 1:
                px = pixels[tags[i] - 1]
                n = px.shape[0] * px.shape[1] // 256
                if n_region is not None:
                    assert n == n_region, "input images must share one size"
                regions.append((len(ids), len(ids) + n))
                ids.extend([self.token_ids.slot] * n)
                ordered.append(px)
        return TextRow(ids, regions), ordered


@dataclasses.dataclass
class ImageGenPipeline:
    """Text(+image) -> image with 2/3-way CFG and KV-cached denoising."""

    model: VideoGPT
    vae: AutoencoderKL
    processor: ImageGenProcessor

    @classmethod
    def build(cls, processor: ImageGenProcessor,
              cfg: ModelConfig = ModelConfig(),
              vae_cfg: VAEConfig = VAEConfig(), device="cuda",
              dtype: torch.dtype = torch.bfloat16,
              state_dict: Optional[dict] = None,
              vae_state_dict: Optional[dict] = None, seed: int = 0
              ) -> "ImageGenPipeline":
        """Model and VAE as :meth:`VideoGPTPipeline.build` makes them."""
        base = VideoGPTPipeline.build(cfg, vae_cfg, device=device,
                                      dtype=dtype, state_dict=state_dict,
                                      vae_state_dict=vae_state_dict,
                                      seed=seed)
        return cls(model=base.model, vae=base.vae, processor=processor)

    @property
    def device(self) -> torch.device:
        return self.model.llm.norm.weight.device

    @staticmethod
    def _guidance(n_rows: int, cfg_scale: float, img_scale: float):
        """Guidance of the padded batch: rows [cond, uncond(, img)] mixed
        and the result broadcast back to every row."""
        def fn(pred):
            parts = pred.chunk(n_rows, dim=0)
            if n_rows == 3:
                cond, uncond, img_cond = parts
                out = (uncond + img_scale * (img_cond - uncond)
                       + cfg_scale * (cond - img_cond))
            else:
                cond, uncond = parts
                out = uncond + cfg_scale * (cond - uncond)
            return torch.cat([out] * n_rows, dim=0)
        return fn

    @staticmethod
    def _combine(n_rows: int, cfg_scale: float, img_scale: float):
        """Mix of the per-context predictions: 3-way = uncond +
        img_scale (img_cond - uncond) + cfg_scale (cond - img_cond)."""
        def fn(preds):
            if n_rows == 3:
                cond, uncond, img_cond = preds
                return (uncond + img_scale * (img_cond - uncond)
                        + cfg_scale * (cond - img_cond))
            cond, uncond = preds
            return uncond + cfg_scale * (cond - uncond)
        return fn

    def _context(self, layout: SequenceLayout, clean):
        """The denoise function ``(z, t) -> prediction`` of one guidance
        context (or of the padded batch): its prompt prefilled into a KV
        cache, and the decode's bias of the tail's rows over every key
        built once (None above ``precompute_bias_limit``)."""
        batch = Batch.from_layout(layout, self.device)
        tail = layout.noisy_tail_len()
        cache = self.model.prefill(batch, clean, layout.length - tail)
        bias = maybe_bias(self.model.cfg, batch.meta.tail(tail), batch.meta)

        def denoise(z, t):
            return self.model.decode(batch, z, t, cache, tail, bias=bias)

        return denoise

    @torch.inference_mode()
    def __call__(
        self,
        prompt,
        input_images: Optional[Sequence] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 50,
        guidance_scale: float = 3.0,
        use_img_guidance: bool = True,
        img_guidance_scale: float = 1.6,
        max_input_image_size: int = 1024,
        negative_prompt: str = DEFAULT_NEGATIVE_PROMPT,
        use_input_image_size_as_output: bool = False,
        prediction_type: str = "v",
        time_shifting_factor: float = 1.0,
        seed: Optional[int] = None,
        output_type: str = "pil",
        separate_cfg_infer: bool = True,
        cfg_interval: Optional[Tuple[float, float]] = None,
        uncond_refresh: int = 1,
        noise=None,
        return_latents: bool = False,
    ):
        """Generate one image per prompt. ``output_type``: ``"pil"`` (PIL
        images), ``"np"`` (HWC uint8 arrays) or ``"pt"`` (one NHWC float32
        array in [0, 1], the JAX package's form of the reference's
        tensor output). A prompt list runs each prompt with seed
        ``seed + i`` (``noise`` then a list of noise callables, one per
        prompt), its ``input_images`` one image list per prompt. With
        ``return_latents`` also the final latents [N, hl, wl, C]."""
        if not isinstance(prompt, str):
            if input_images is not None:
                if len(input_images) != len(prompt) or not all(
                        im is None or isinstance(im, (list, tuple))
                        for im in input_images):
                    raise ValueError(
                        "with a prompt list, input_images must be a list of "
                        "per-prompt image lists of the same length")
            base = 0 if seed is None else seed
            out: List = []
            lats = []
            for i, p_ in enumerate(prompt):
                imgs, lat = self(
                    p_, None if input_images is None else input_images[i],
                    height, width, num_inference_steps, guidance_scale,
                    use_img_guidance, img_guidance_scale,
                    max_input_image_size, negative_prompt,
                    use_input_image_size_as_output, prediction_type,
                    time_shifting_factor, base + i, output_type,
                    separate_cfg_infer, cfg_interval, uncond_refresh,
                    None if noise is None else noise[i], True)
                out.extend(imgs)
                lats.append(lat)
            return (out, torch.cat(lats)) if return_latents else out
        proc = self.processor
        proc.max_image_size = max_input_image_size
        if not input_images:
            use_img_guidance = False
        cond_row, pixels = proc.row(prompt, input_images)
        rows = [cond_row, proc.row(negative_prompt, None)[0]]
        if use_img_guidance:
            img_prompt = " ".join(f"<img><|image_{i + 1}|></img>"
                                  for i in range(len(input_images)))
            rows.append(proc.row(img_prompt, input_images)[0])
        n_rows = len(rows)
        if use_input_image_size_as_output:
            if not pixels:
                raise ValueError("use_input_image_size_as_output=True needs "
                                 "at least one input image")
            height, width = pixels[0].shape[:2]
        f = self.vae.cfg.downsample_factor
        p = self.model.cfg.patch_size
        c = self.model.cfg.in_channels
        hl, wl = height // f, width // f
        n_out = (hl // p) * (wl // p)
        # input images of one size: one batched encode and a rectangular
        # clean_gather; of several sizes: one encode and one region size
        # each
        uniform = len({px.shape for px in pixels}) <= 1
        n_region = (pixels[0].shape[0] * pixels[0].shape[1] // 256
                    if pixels and uniform else None)
        dtype, device = self.model.dtype, self.device
        if noise is None:
            noise = TorchNoise(0 if seed is None else seed, device)
        zc = self.vae.cfg.latent_channels

        def encode(px: np.ndarray) -> torch.Tensor:
            n, h, w = px.shape[:3]
            return self.vae.encode(
                torch.from_numpy(px).to(device, dtype),
                noise("encode", (n, h // f, w // f, zc), dtype))

        if pixels and uniform:
            groups = (encode(np.stack(pixels)),)
        else:
            groups = tuple(encode(px[None]) for px in pixels)
        z0 = noise("z", (1, hl, wl, c), dtype)
        sched = SchedulerConfig(num_steps=num_inference_steps,
                                time_shifting_factor=time_shifting_factor,
                                prediction_type=prediction_type,
                                cfg_interval=cfg_interval,
                                uncond_refresh=uncond_refresh)
        if separate_cfg_infer:
            # each guidance context at its natural length
            fns = [self._context(single_shot_layout([r], n_out, n_region),
                                 groups if r.image_regions else None)
                   for r in rows]
            latents = sample_separate_multi(
                z0, fns, self._combine(n_rows, guidance_scale,
                                       img_guidance_scale), sched)
        else:
            if cfg_interval is not None or uncond_refresh != 1:
                # the padded batch evaluates every context in one forward
                raise ValueError(
                    "cfg_interval/uncond_refresh serving schedules need "
                    "separate_cfg_infer=True (the default)")
            # the cond row's regions, then the image row's copies: the
            # (row, region) order clean_src indexes
            clean = groups + groups if use_img_guidance else groups
            denoise = self._context(
                single_shot_layout(rows, n_out, n_region), clean or None)
            latents = sample(torch.cat([z0] * n_rows), denoise, sched,
                             use_cfg=True, cfg_scale=guidance_scale,
                             guidance_fn=self._guidance(
                                 n_rows, guidance_scale,
                                 img_guidance_scale))[:1]
        x = torch.clamp(self.vae.decode(latents).float() * 0.5 + 0.5,
                        0.0, 1.0)
        if output_type == "pt":
            images = x.cpu().numpy()
        else:
            images = list((x * 255.0).to(torch.uint8).cpu().numpy())
            if output_type == "pil":
                from PIL import Image
                images = [Image.fromarray(im) for im in images]
        return (images, latents) if return_latents else images
