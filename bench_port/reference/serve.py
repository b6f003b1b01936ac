"""Plain reference of one next-clip serving request.

The rollout of the published pipeline, without a cache: the conditioning
frames are VAE-encoded with their posterior draw; for each generated block
the context window slides, the recycled frames are re-noised from the
second block on, and a flow-matching Euler sampler (x1 prediction, the
time-shifted sigma grid, classifier-free guidance uncond + s (cond -
uncond) at every step) runs the conditional row (the clean context and
the noisy block) and the unconditional row (the noisy block alone) as two
full forwards; the VAE decodes the first block's context and every
generated block. The draws are the ones the program was given, replayed in
order.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .layout import frame_block_inference_layout
from .model import Precision, forward, to_uint8, vae_decode, vae_encode


def sigma_grid(steps: int, shift: float = 1.0) -> np.ndarray:
    t = np.linspace(0.0, 1.0, steps + 1, dtype=np.float64)
    return (t / (t + shift - shift * t)).astype(np.float32)


def pixels_of(frames_u8: np.ndarray) -> np.ndarray:
    """HWC uint8 frames -> float32 in [-1, 1]."""
    return (np.asarray(frames_u8, np.float32) / 255.0 - 0.5) / 0.5


@torch.no_grad()
def rollout(P: dict, V: dict, arch: dict, vae: dict, prec: Precision,
            frames_u8: np.ndarray, draw: Callable, gen_nums: Sequence[int],
            steps: int, guidance: float, window: int,
            renoise: float = 0.0, shift: float = 1.0,
            device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(generated latents [sum(gen_nums), h, w, C] fp32, every emitted
    frame [n, H, W, 3] uint8) of one video conditioned on ``frames_u8``
    [F, H, W, 3]; ``draw(kind, shape)`` replays the program's draws
    ("encode", "renoise", "z") in order."""
    pix = torch.from_numpy(pixels_of(frames_u8)).to(device)
    f = 8
    hl, wl = pix.shape[1] // f, pix.shape[2] // f
    c = arch["in_channels"]
    n_img = (hl // arch["patch_size"]) * (wl // arch["patch_size"])
    clean = vae_encode(V, vae, prec, pix, draw("encode", (pix.shape[0], hl,
                                                          wl, c)))
    sig = sigma_grid(steps, shift)
    emitted: List[torch.Tensor] = []
    generated: List[torch.Tensor] = []
    for k, gen in enumerate(gen_nums):
        if clean.shape[0] + gen > window:
            clean = clean[gen + clean.shape[0] - window:]
        ctx = clean
        if k > 0 and renoise:
            ctx = (1.0 - renoise) * clean + renoise * draw(
                "renoise", tuple(clean.shape))
        z = draw("z", (gen, hl, wl, c)).float()
        lay_c = frame_block_inference_layout(ctx.shape[0], gen, n_img, False)
        lay_u = frame_block_inference_layout(0, gen, n_img, False)
        for i in range(steps):
            t = torch.full((gen,), float(sig[i]), device=device)
            cond = forward(P, arch, prec, lay_c, z, t, (ctx,))
            if guidance != 1.0:
                unc = forward(P, arch, prec, lay_u, z, t)
                pred = unc + guidance * (cond - unc)
            else:
                pred = cond
            v = (pred - z) / float(np.float32(1.0) - sig[i])
            z = z + float(sig[i + 1] - sig[i]) * v
        if k == 0 and clean.shape[0]:
            emitted.append(to_uint8(vae_decode(V, vae, prec, clean)))
        emitted.append(to_uint8(vae_decode(V, vae, prec, z)))
        generated.append(z)
        clean = torch.cat([clean, z])
    return torch.cat(generated), torch.cat(emitted)
