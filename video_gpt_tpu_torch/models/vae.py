"""SDXL-class convolutional VAE (AutoencoderKL).

Port of ``video_gpt_tpu/models/vae.py``. The public functions keep the JAX
package's NHWC latents and pixels; inside, the convolutions run in torch's
NCHW. Module names follow diffusers' AutoencoderKL, so a diffusers VAE
checkpoint (and ``utils.weights.vae_state_dict_from_jax``) loads with
``strict=True``. Plain torch convolutions are the port's choice here: XLA,
not a hand-written kernel, did this work in the JAX package. cuDNN runs
fp32 convolutions in TF32 unless ``torch.backends.cudnn.allow_tf32`` is
False; the entry points (``cli generate``, ``chip_smoke.py``) set it False.

Architecture: 4 down blocks (``layers_per_block`` resnets each) with
stride-2 convs after an asymmetric (0, 1) pad, a mid block with one
single-head attention, a mirrored decoder with ``layers_per_block + 1``
resnets per up block and nearest-neighbour upsampling; GroupNorm + SiLU
throughout; 4 latent channels, 8x spatial reduction. ``encode`` and
``decode`` are the spans ``vgt.vae.encode`` and ``vgt.vae.decode``
(``utils.profiling.annotate``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F

from ..utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    # sdxl-vae config.json: scaling_factor 0.13025, no shift
    scaling_factor: float = 0.13025
    shift_factor: Optional[float] = None

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def tiny(cls) -> "VAEConfig":
        # keeps the real /8 spatial factor with tiny widths
        return cls(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                   norm_num_groups=4)


def _norm(groups, ch, kw):
    return nn.GroupNorm(groups, ch, eps=1e-6, **kw)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int, kw: dict):
        super().__init__()
        self.norm1 = _norm(groups, in_ch, kw)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1, **kw)
        self.norm2 = _norm(groups, out_ch, kw)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, **kw)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1, **kw)
                              if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over HW tokens (mid block)."""

    def __init__(self, ch: int, groups: int, kw: dict):
        super().__init__()
        self.group_norm = _norm(groups, ch, kw)
        self.to_q = nn.Linear(ch, ch, **kw)
        self.to_k = nn.Linear(ch, ch, **kw)
        self.to_v = nn.Linear(ch, ch, **kw)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch, **kw)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)  # [B, HW, C]
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.bmm(q.float(), k.float().transpose(1, 2))
        probs = torch.softmax(logits * c ** -0.5, dim=-1)
        y = torch.bmm(probs.to(v.dtype), v)
        y = self.to_out[0](y)
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class _Sampler(nn.Module):
    """Holds ``conv`` so the names read ``downsamplers.0.conv`` /
    ``upsamplers.0.conv``."""

    def __init__(self, ch: int, kw: dict, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride,
                              padding=0 if stride == 2 else 1, **kw)


class _Block(nn.Module):
    def __init__(self, chans, out_ch, groups, kw, sampler_stride):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(c, out_ch, groups, kw) for c in chans)
        key = "downsamplers" if sampler_stride == 2 else "upsamplers"
        if sampler_stride:
            setattr(self, key,
                    nn.ModuleList([_Sampler(out_ch, kw, sampler_stride)]))


class _Mid(nn.Module):
    def __init__(self, ch, groups, kw):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, groups, kw),
                                      ResnetBlock(ch, ch, groups, kw)])
        self.attentions = nn.ModuleList([AttnBlock(ch, groups, kw)])

    def forward(self, h):
        h = self.resnets[0](h)
        h = self.attentions[0](h)
        return self.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, kw: dict):
        super().__init__()
        g, chans = cfg.norm_num_groups, cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1,
                                 **kw)
        blocks, prev = [], chans[0]
        for i, ch in enumerate(chans):
            last = i == len(chans) - 1
            blocks.append(_Block([prev] + [ch] * (cfg.layers_per_block - 1),
                                 ch, g, kw, 0 if last else 2))
            prev = ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _Mid(chans[-1], g, kw)
        self.conv_norm_out = _norm(g, chans[-1], kw)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3,
                                  padding=1, **kw)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for r in block.resnets:
                h = r(h)
            if hasattr(block, "downsamplers"):
                # diffusers pads asymmetrically (right, bottom) before the
                # stride-2 conv
                h = block.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, kw: dict):
        super().__init__()
        g = cfg.norm_num_groups
        chans = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[0], 3, padding=1,
                                 **kw)
        self.mid_block = _Mid(chans[0], g, kw)
        blocks, prev = [], chans[0]
        for i, ch in enumerate(chans):
            last = i == len(chans) - 1
            blocks.append(_Block([prev] + [ch] * cfg.layers_per_block,
                                 ch, g, kw, 0 if last else 1))
            prev = ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = _norm(g, chans[-1], kw)
        self.conv_out = nn.Conv2d(chans[-1], cfg.out_channels, 3, padding=1,
                                  **kw)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            for r in block.resnets:
                h = r(h)
            if hasattr(block, "upsamplers"):
                h = F.interpolate(h, scale_factor=2.0, mode="nearest")
                h = block.upsamplers[0].conv(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig(), device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.encoder = Encoder(cfg, kw)
        self.decoder = Decoder(cfg, kw)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1, **kw)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Random weights drawn on the parameters' device: fan-in scaled
        normal convs/linears, zero biases, unit GroupNorm scales."""
        for name, p in self.named_parameters():
            if p.ndim == 1:  # GroupNorm scale 1; GroupNorm/conv biases 0
                p.fill_(1.0 if "norm" in name and name.endswith("weight")
                        else 0.0)
            else:
                fan_in = p[0].numel()
                p.normal_(0.0, fan_in ** -0.5, generator=generator)
        return self

    def encode_moments(self, pixels: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] in [-1, 1] -> [N, H/8, W/8, 2*Cz] (mean | logvar)."""
        x = pixels.to(self.dtype).permute(0, 3, 1, 2)
        return self.quant_conv(self.encoder(x)).permute(0, 2, 3, 1)

    def encode(self, pixels: torch.Tensor,
               noise: Union[torch.Tensor, torch.Generator, None] = None,
               sample: bool = True, noise_rows=None) -> torch.Tensor:
        """Posterior sample (or mode), scaled for the diffusion model.
        ``noise`` is the standard-normal draw itself ([N, h, w, Cz]) or a
        Generator on the VAE's device to draw it from; ``noise_rows``
        (first, total): the pixels are rows first.. of a global batch of
        ``total``, whose draw is made and sliced (a data rank's)."""
        with annotate("vgt.vae.encode"):
            mean, logvar = self.encode_moments(pixels).chunk(2, dim=-1)
            if sample:
                if not isinstance(noise, torch.Tensor):
                    first, total = noise_rows or (0, mean.shape[0])
                    noise = torch.randn((total,) + mean.shape[1:],
                                        generator=noise, device=mean.device,
                                        dtype=mean.dtype)
                    noise = noise[first:first + mean.shape[0]]
                std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
                mean = mean + std * noise.to(mean.dtype)
            if self.cfg.shift_factor is not None:
                return ((mean - self.cfg.shift_factor)
                        * self.cfg.scaling_factor)
            return mean * self.cfg.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents [N, h, w, Cz] -> pixels [N, H, W, 3] in [-1, 1]."""
        with annotate("vgt.vae.decode"):
            z = latents.to(self.dtype) / self.cfg.scaling_factor
            if self.cfg.shift_factor is not None:
                z = z + self.cfg.shift_factor
            z = self.post_quant_conv(z.permute(0, 3, 1, 2))
            return self.decoder(z).permute(0, 2, 3, 1)
