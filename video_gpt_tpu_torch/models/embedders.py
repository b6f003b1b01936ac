"""Embedders, positional tables and the diffusion head.

Port of ``video_gpt_tpu/models/embedders.py``. Latents are NHWC at every
public function. The patch embedder is a reshape plus matmul with the
weight kept in the reference's Conv2d shape [D, C, p, p], so reference
checkpoints load by name.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


def sincos_timestep_embedding(t: torch.Tensor, dim: int,
                              max_period: float = 10000.0) -> torch.Tensor:
    """[N] -> [N, dim] fp32 sinusoidal features, cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """Sinusoidal features + 2-layer SiLU MLP (``mlp.0`` / ``mlp.2``)."""

    def __init__(self, hidden_size: int, freq_embed_size: int = 256,
                 device=None, dtype=None):
        super().__init__()
        self.freq_embed_size = freq_embed_size
        kw = dict(device=device, dtype=dtype)
        self.mlp = nn.Sequential(nn.Linear(freq_embed_size, hidden_size, **kw),
                                 nn.SiLU(),
                                 nn.Linear(hidden_size, hidden_size, **kw))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = sincos_timestep_embedding(t, self.freq_embed_size)
        return self.mlp(x.to(self.mlp[0].weight.dtype))


def patchify(latents: torch.Tensor, patch: int) -> torch.Tensor:
    """[N, h, w, C] -> [N, (h/p)(w/p), p*p*C] with (ph, pw, c) minor order
    (a Conv2d(C, D, k=p, s=p) weight permuted to (p, p, C, D))."""
    n, h, w, c = latents.shape
    p = patch
    x = latents.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, h: int, w: int, patch: int, channels: int
               ) -> torch.Tensor:
    """[N, T, p*p*C] -> [N, h, w, C] (inverse of :func:`patchify`)."""
    n = x.shape[0]
    p = patch
    x = x.reshape(n, h // p, w // p, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, w, channels)


class PatchEmbed(nn.Module):
    """Patchify + linear projection; ``proj`` holds the Conv2d-shaped
    weight [D, C, p, p] and bias [D]. ``zero_init`` marks a module whose
    parameters :meth:`VideoGPT.init_random_` zeroes: the training model's
    noisy-patch embedder (the JAX package's ``PatchEmbed(zero_init=True)``).
    """

    def __init__(self, hidden_size: int, patch_size: int, in_channels: int,
                 device=None, dtype=None, zero_init: bool = False):
        super().__init__()
        self.patch_size = patch_size
        self.zero_init = zero_init
        self.proj = nn.Conv2d(in_channels, hidden_size, patch_size,
                              stride=patch_size, device=device, dtype=dtype)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        x = patchify(latents, self.patch_size)
        w = self.proj.weight
        kernel = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
        return F.linear(x.to(w.dtype), kernel.t(), self.proj.bias)


def sincos_2d_pos_embed(dim: int, grid_size: int,
                        interpolation_scale: float = 1.0,
                        base_size: int = 64) -> np.ndarray:
    """[grid*grid, dim] float32 table, the reference's numbers exactly.

    Quirk kept for checkpoint/latent parity: the first ``dim/2`` features
    encode the *column* coordinate and the second half the *row*."""
    coords = (np.arange(grid_size, dtype=np.float32)
              / (grid_size / base_size) / interpolation_scale)

    def one_d(d, pos):
        omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
        omega = 1.0 / 10000.0 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    rows = np.broadcast_to(coords[:, None], (grid_size, grid_size))
    cols = np.broadcast_to(coords[None, :], (grid_size, grid_size))
    emb = np.concatenate([one_d(dim // 2, cols), one_d(dim // 2, rows)],
                         axis=1)
    return emb.astype(np.float32)  # row-major (r, c) flattening


def crop_pos_embed(table: np.ndarray, grid_size: int, h_patches: int,
                   w_patches: int) -> np.ndarray:
    """Center-crop the square table to (h, w) patches and flatten."""
    if h_patches > grid_size or w_patches > grid_size:
        raise ValueError(
            f"frame needs a {h_patches}x{w_patches} patch grid but "
            f"pos_embed_max_size is {grid_size}")
    top = (grid_size - h_patches) // 2
    left = (grid_size - w_patches) // 2
    t = table.reshape(grid_size, grid_size, -1)
    t = t[top: top + h_patches, left: left + w_patches]
    return t.reshape(h_patches * w_patches, -1)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor
             ) -> torch.Tensor:
    """adaLN modulation; shift/scale are per-sample."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class FinalLayer(nn.Module):
    """adaLN-modulated linear head (``adaLN_modulation.1``, ``linear``).
    The JAX package zero-initialises it always; the port does with
    ``zero_init`` (the training model), and its serving model draws it at
    random so a random-weight run predicts non-zeros."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int,
                 device=None, dtype=None, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        kw = dict(device=device, dtype=dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size, **kw))
        self.linear = nn.Linear(hidden_size, patch_size ** 2 * out_channels,
                                **kw)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        # x: [N, T, D] per-frame hidden states; c: [N, D] timestep embedding
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        x = F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)
        return self.linear(modulate(x, shift, scale))
