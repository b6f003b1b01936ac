"""Autoregressive next-clip prediction pipeline.

Port of ``VideoGPTPipeline.generate`` of
``video_gpt_tpu/sampling/pipeline.py``. Per block: the clean prefix is
prefilled into a KV cache (or the cache is extended by the previous block's
frames), the denoise loop runs the conditional row as a cached ``decode``
and the unconditional row as a tail-only forward (separate CFG), and the
VAE decodes the clip to uint8 on the device. Sliding window, re-noise of
recycled frames (``clean_image_noise_level``), ``cfg_interval``,
``uncond_refresh`` and ``vae_roundtrip_recycle`` keep the JAX package's
semantics.

``generate_batch`` runs N same-shaped videos as the batch rows of one set
of prefill / extend / denoise calls, each video with its own noise stream;
``generate`` is its one-video case. Random numbers come from a
:class:`TorchNoise` (a ``torch.Generator`` on the device) or any callable
with its signature, so a test can hand the port the exact noise the JAX
pipeline drew.

Past 8192 keys (the 80-frame window of ``configs/inference.sh``) the TPU
switches to its k-tiled kernels (K4/K5 in the decode, K6 in the prefill);
the port has no key cap and keeps its kernels: the cond-row decode runs K1
and the uncond row K2 at any length, and the prefill runs K3 with a bias
while B*L^2 stays within ``precompute_bias_limit`` (the long rollout at
B = 1: 12,432^2 = 154.6M) and K6 above it (B = 2: 309.1M, as on the TPU).

Sequence- and tensor-parallel serving: ``build(..., mesh=)`` with a
``parallel.mesh.Mesh`` of S x T ranks (one process each, e.g. ``torchrun
--nproc_per_node S*T``) builds this rank's model, and every rank then runs
``generate`` / ``generate_batch`` with the same arguments: the same
layouts, the same seeded noise (a generator per rank, seeded alike), the
VAE on every rank, so every rank returns the same frames. The trunk splits
the sequence over seq and the heads over (tensor, seq); the prefill runs
K6 (no bias under Ulysses) when S > 1 and K3 with its bias on a
tensor-only mesh, the denoise rows K1/K2 at each rank's H/(S T) heads.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig, SchedulerConfig
from ..parallel.mesh import DATA_AXIS, TENSOR_AXIS, Mesh, axis_size
from ..data.processor import postprocess_frames, preprocess_frames
from ..layout import decode_rank, frame_block_inference_layout
from ..models.vae import AutoencoderKL, VAEConfig
from ..models.video_gpt import Batch, VideoGPT, decode_mask
from ..utils.profiling import annotate
from ..utils.weights import tp_shard_state_dict
from .scheduler import sample, sample_separate_cfg

# noise(kind, shape, dtype) -> standard-normal tensor on the device; kinds in
# draw order per block: "encode" (first block only), "renoise", "z",
# "recycle_encode"
NoiseFn = Callable[[str, Tuple[int, ...], torch.dtype], torch.Tensor]


class TorchNoise:
    """Standard-normal draws from one seeded ``torch.Generator``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def __call__(self, kind: str, shape, dtype) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device, dtype=dtype)


def resolve_device(device) -> torch.device:
    """The serving device: CUDA unless the caller asks for the CPU. Raises
    when a CUDA device is asked for and none is present (no silent CPU
    fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


@dataclasses.dataclass
class VideoGPTPipeline:
    model: VideoGPT
    vae: AutoencoderKL

    @classmethod
    def build(cls, cfg: ModelConfig = ModelConfig(),
              vae_cfg: VAEConfig = VAEConfig(), device="cuda",
              dtype: torch.dtype = torch.bfloat16,
              state_dict: Optional[dict] = None,
              vae_state_dict: Optional[dict] = None,
              seed: int = 0, input_head: bool = False,
              mesh: Optional[Mesh] = None) -> "VideoGPTPipeline":
        """Model and VAE allocated on ``device`` in ``dtype``, loaded from
        the given state dicts (reference / diffusers names, strict) or
        initialised at random on the device from ``seed``. ``input_head``
        builds the model with the aux input head, so that the weights of a
        run trained with ``input_output_return`` load (serving never reads
        the head).

        With a ``mesh`` (seq S, tensor T; data 1) the model is this
        rank's: seq-sharded under Ulysses when S > 1 (the JAX command's
        setting; a tensor-only mesh keeps the prefill's bias), and at T > 1
        built at 1/T of its width with the rank's shard of the weights
        (``tp_shard_state_dict``; random weights are drawn for the whole
        model first, so every mesh serves the one-rank model of ``seed``).
        """
        device = resolve_device(device)
        gen = torch.Generator(device).manual_seed(seed)
        model = cls._model(cfg, device, dtype, input_head, gen, state_dict,
                           mesh)
        vae = AutoencoderKL(vae_cfg, device="meta", dtype=dtype).to_empty(
            device=device)
        if vae_state_dict is None:
            vae.init_random_(gen)
        else:
            vae.load_state_dict(vae_state_dict, strict=True)
        return cls(model=model.eval(), vae=vae.eval())

    @staticmethod
    def _model(cfg, device, dtype, input_head, gen, state_dict, mesh):
        def empty(c, m=None):
            return VideoGPT(c, device="meta", dtype=dtype,
                            input_head=input_head, mesh=m).to_empty(
                device=device)

        if axis_size(mesh, DATA_AXIS) != 1:
            raise NotImplementedError(
                "serving on a mesh with a data axis is not ported: the JAX "
                "pipeline shards nothing over it (every data group would "
                "compute the same clip) and no command reaches it; serve "
                "over --mesh_seq / --mesh_tensor")
        tp = axis_size(mesh, TENSOR_AXIS)
        if tp > 1:
            if state_dict is None:
                # the whole model's draws, then this rank's shard of them
                full = empty(cfg).init_random_(gen)
                state_dict = full.state_dict()
                del full
            state_dict = tp_shard_state_dict(state_dict, cfg, tp,
                                             mesh.index(TENSOR_AXIS))
        model = empty(cfg, mesh)
        if state_dict is None:
            model.init_random_(gen)
        else:
            model.load_state_dict(state_dict, strict=True)
        return model

    @property
    def device(self) -> torch.device:
        return self.model.llm.norm.weight.device

    def _decode_u8(self, latents: torch.Tensor) -> torch.Tensor:
        """VAE decode fused with the [-1, 1] -> uint8 conversion, on the
        device (the same f32 ops as ``postprocess_frames``)."""
        px = self.vae.decode(latents)
        x = torch.clamp(px.float() * 0.5 + 0.5, 0.0, 1.0)
        return (x * 255.0).to(torch.uint8)

    def _denoise(self, batch_c: Batch, batch_u: Optional[Batch], cache,
                 z0: torch.Tensor, tail: int, sched: SchedulerConfig,
                 use_cfg: bool, cfg_scale: float):
        model = self.model
        cached = cache is not None

        def tail_bias(batch: Batch, tl: int):
            # step-invariant: built once, outside the denoise loop
            q_meta = batch.meta.tail(tl) if tl else batch.meta
            return decode_mask(q_meta, batch.meta)

        with annotate("vgt.layout"):
            bias_c = tail_bias(batch_c, tail if cached else 0)
            bias_u = tail_bias(batch_u, 0) if use_cfg else None

        def denoise_cond(z, t):
            if not cached:
                return model(batch_c, z, t, bias=bias_c)
            return model.decode(batch_c, z, t, cache, tail, bias=bias_c)

        if not use_cfg:
            return sample(z0, denoise_cond, sched, use_cfg=False)

        def denoise_pair(z, t):
            return denoise_cond(z, t), model(batch_u, z, t, bias=bias_u)

        return sample_separate_cfg(z0, denoise_pair, sched, cfg_scale,
                                   denoise_cond_fn=denoise_cond)

    def generate(self, input_frames: Sequence, *, seed: Optional[int] = 42,
                 noise: Optional[NoiseFn] = None,
                 return_latents: bool = False, **recipe):
        """Condition on ``input_frames`` (HWC uint8), roll out
        ``recipe["gen_nums"]`` clips (the keyword arguments of
        :meth:`_rollout`). Returns HWC uint8 frames: the VAE round-trip of
        the first block's (windowed) conditioning frames, then every
        generated frame; with ``return_latents`` also the generated latents,
        one [h, w, C] tensor per frame. ``noise`` overrides the draws of a
        :class:`TorchNoise` seeded with ``seed``."""
        if noise is None:
            noise = TorchNoise(0 if seed is None else seed, self.device)
        frames, latents = self._rollout([input_frames], [noise], **recipe)[0]
        return (frames, latents) if return_latents else frames

    def generate_batch(self, inputs_list: Sequence[Sequence],
                       seeds: Optional[Sequence[int]] = None, *,
                       noise: Optional[Sequence[NoiseFn]] = None,
                       seed: Optional[int] = 42,
                       return_latents: bool = False, **recipe):
        """N same-shaped condition clips through ONE B = N set of prefill /
        extend / denoise calls (``frame_block_inference_layout(rows=N)``).
        Every video keeps its own noise stream: ``seeds[i]`` (default
        ``seed + i``) or ``noise[i]``, walking exactly the draws
        :meth:`generate` walks for it, so the outputs match N independent
        calls up to batched-reduction order (N = 1 without seeds or noise
        is :meth:`generate`). Returns a list of N frame lists (ordered as
        :meth:`generate`'s); with ``return_latents``, of (frames, latents)
        pairs. Raises ``ValueError`` on videos whose preprocessed shapes
        differ."""
        n_vid = len(inputs_list)
        if noise is None:
            base = 0 if seed is None else seed
            seeds = ([base + i for i in range(n_vid)] if seeds is None
                     else list(seeds))
            noise = [TorchNoise(s, self.device) for s in seeds]
        elif seeds is not None:
            raise ValueError("pass seeds or noise, not both")
        if len(noise) != n_vid:
            raise ValueError(f"{len(noise)} noise streams for {n_vid} videos")
        outs = self._rollout(inputs_list, noise, **recipe)
        return outs if return_latents else [frames for frames, _ in outs]

    @torch.inference_mode()
    def _rollout(
        self,
        inputs: Sequence[Sequence],
        noises: Sequence[NoiseFn],
        gen_nums: Sequence[int] = (1,),
        num_inference_steps: int = 50,
        img_guidance_scale: float = 1.0,
        use_img_guidance: bool = True,
        max_input_image_size: int = 320,
        max_frame_window: int = 16,
        clean_image_noise_level: float = 0.1,
        time_shifting_factor: float = 1.0,
        prediction_type: str = "x1",
        vae_roundtrip_recycle: bool = False,
        cfg_interval: Optional[Tuple[float, float]] = None,
        uncond_refresh: int = 1,
    ) -> List[Tuple[List[np.ndarray], List[torch.Tensor]]]:
        """The rollout of :meth:`generate` for N same-shaped videos as batch
        rows, video i drawing from ``noises[i]``; returns (frames, latents)
        per video. The JAX package's ``_generate`` / ``_generate_batch``
        semantics: the window slides (and the cache is rebuilt by a prefill)
        when ``n_clean + gen_num > max_frame_window``; recycled frames are
        re-noised by ``clean_image_noise_level`` from the second block on
        (which also rebuilds the cache); otherwise the cache grows through
        ``extend_cache``."""
        if any(not len(f) for f in inputs):
            raise ValueError(
                "generate() needs at least one conditioning frame")
        if img_guidance_scale == 1.0:
            use_img_guidance = False
        n_vid = len(inputs)
        device = self.device
        dtype = self.model.dtype
        with annotate("vgt.generate"):
            with annotate("vgt.preprocess"):
                pix = [preprocess_frames(f, max_input_image_size)
                       for f in inputs]
                shapes = {p.shape for p in pix}
                if len(shapes) != 1:
                    raise ValueError(
                        f"generate_batch needs same-shaped videos after "
                        f"preprocessing; got {sorted(shapes)} — group by "
                        "bucket and batch each group")
                pix_dev = [torch.from_numpy(x).to(device=device, dtype=dtype)
                           for x in pix]
            H, W = pix[0].shape[1:3]
            f = self.vae.cfg.downsample_factor
            p = self.model.cfg.patch_size
            hl, wl = H // f, W // f
            n_img = (hl // p) * (wl // p)
            c = self.model.cfg.in_channels
            lat_shape = (pix[0].shape[0], hl, wl,
                         self.vae.cfg.latent_channels)
            # [N, frames, hl, wl, C]; each video's encode takes its own draw
            clean = torch.stack([
                self.vae.encode(x, noise("encode", lat_shape, dtype))
                for x, noise in zip(pix_dev, noises)])

            def rows(x):  # [N, F, ...] -> [N * F, ...], video-major
                return x.reshape((-1,) + tuple(x.shape[2:]))

            emits: List[Tuple[torch.Tensor, int]] = []  # ([N*F, H, W, 3], F)
            out_latents: List[torch.Tensor] = []         # [N * gen, h, w, C]
            emit_initial = True
            # cross-block KV cache (cache, frames covered): reusable while
            # the window has not slid (positions restart) and recycled
            # predictions are not re-noised (re-noise changes their K/V)
            kv_cache, kv_frames = None, 0
            for k, gen_num in enumerate(gen_nums):
                if clean.shape[1] + gen_num > max_frame_window:
                    clean = clean[:, gen_num + clean.shape[1]
                                  - max_frame_window:]
                    kv_cache, kv_frames = None, 0
                if k > 0 and clean_image_noise_level:
                    kv_cache, kv_frames = None, 0
                n_clean = clean.shape[1]
                with annotate("vgt.layout"):
                    layout_c = frame_block_inference_layout(
                        n_clean, gen_num, n_img, use_cfg=False, rows=n_vid)
                    batch_c = Batch.from_layout(layout_c, device)
                    tail = layout_c.noisy_tail_len()
                    prefix = layout_c.length - tail
                    batch_u = layout_u = None
                    if use_img_guidance:
                        # unconditional context at its natural length
                        layout_u = frame_block_inference_layout(
                            0, gen_num, n_img, use_cfg=False, rows=n_vid)
                        batch_u = Batch.from_layout(layout_u, device)
                    if decode_rank(layout_c, tail) is None or (
                            use_img_guidance
                            and decode_rank(layout_u, layout_u.length)
                            is None):
                        # the denoise rows take the columnar decode kernels
                        # only
                        raise NotImplementedError(
                            "this layout has no columnar decode mask")

                cl = clean
                if k > 0 and clean_image_noise_level:
                    lvl = clean_image_noise_level
                    cl = (1.0 - lvl) * cl + lvl * torch.stack([
                        noise("renoise", tuple(cl.shape[1:]), cl.dtype)
                        for noise in noises])
                z = torch.cat([noise("z", (gen_num, hl, wl, c), dtype)
                               for noise in noises])

                if prefix > 0:
                    n_new = n_clean - kv_frames
                    if kv_cache is not None and 0 < n_new < n_clean:
                        kv_cache = self.model.extend_cache(
                            batch_c, rows(cl[:, -n_new:]), kv_cache,
                            n_new * (n_img + 2), kv_frames)
                    elif kv_cache is None or n_new != 0:
                        kv_cache = self.model.prefill(batch_c, rows(cl),
                                                      prefix)
                    kv_frames = n_clean
                else:
                    kv_cache, kv_frames = None, 0
                sched = SchedulerConfig(
                    num_steps=num_inference_steps,
                    time_shifting_factor=time_shifting_factor,
                    prediction_type=prediction_type,
                    cfg_interval=cfg_interval,
                    uncond_refresh=uncond_refresh)
                samples = self._denoise(batch_c, batch_u, kv_cache, z, tail,
                                        sched, use_img_guidance,
                                        img_guidance_scale)
                if emit_initial:
                    if n_clean:
                        emits.append((self._decode_u8(rows(clean)),
                                      n_clean))
                    emit_initial = False

                recycled = samples
                if vae_roundtrip_recycle:
                    # reference semantics: re-encode the DECODED pixels
                    out_px = self.vae.decode(samples)
                    emits.append((out_px, gen_num))
                    recycled = torch.cat([
                        self.vae.encode(
                            out_px[i * gen_num:(i + 1) * gen_num].to(dtype),
                            noise("recycle_encode",
                                  (gen_num,) + tuple(samples.shape[1:]),
                                  dtype))
                        for i, noise in enumerate(noises)])
                else:
                    emits.append((self._decode_u8(samples), gen_num))
                out_latents.append(samples)
                clean = torch.cat(
                    [clean, recycled.reshape((n_vid, gen_num)
                                             + tuple(recycled.shape[1:]))],
                    dim=1)

            def video(x, i, per):  # video i's rows of a video-major [N*per]
                return x[i * per:(i + 1) * per]

            with annotate("vgt.to_host"):
                return [([im for x, per in emits
                          for im in postprocess_frames(
                              _host(video(x, i, per)))],
                         [l for blk in out_latents
                          for l in video(blk, i, blk.shape[0] // n_vid)])
                        for i in range(n_vid)]


def _host(x: torch.Tensor) -> np.ndarray:
    """Frames to the host: uint8 as they are, floats as fp32."""
    return (x if x.dtype == torch.uint8 else x.float()).cpu().numpy()
