"""Weights drawn from the run's seed, on the device, in a few large calls.

The parameters are grouped (one group a trunk layer, one for the rest of
the model, one for the VAE); each group is one ``torch.randn`` of all its
random entries from a generator seeded by (seed, stream, group), cut into
the parameters and scaled. So the reference can draw any group again, alone
and in the same numbers, after the program's state is freed.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Dict, Iterable, List

import numpy as np
import torch


def group_of(name: str) -> str:
    if name.startswith("llm.layers."):
        return "layer" + name.split(".")[2]
    return "rest"


def seed_of(seed: int, *keys: str) -> int:
    words = [int(seed)] + [zlib.crc32(k.encode()) for k in keys]
    return int(np.random.SeedSequence(words).generate_state(
        1, dtype=np.uint64)[0])


def groups(specs) -> "OrderedDict[str, List]":
    out: "OrderedDict[str, List]" = OrderedDict()
    for s in specs:
        out.setdefault(group_of(s.name), []).append(s)
    return out


def draw_group(members, seed: int, stream: str, group: str, device,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    n = sum(int(np.prod(s.shape)) for s in members if s.init == "normal")
    gen = torch.Generator(device).manual_seed(seed_of(seed, stream, group))
    flat = torch.randn(n, generator=gen, device=device,
                       dtype=torch.float32) if n else None
    out, off = {}, 0
    for s in members:
        if s.init == "normal":
            k = int(np.prod(s.shape))
            out[s.name] = (flat[off:off + k].view(s.shape) * s.std).to(dtype)
            off += k
        elif s.init == "one":
            out[s.name] = torch.ones(s.shape, device=device, dtype=dtype)
        else:
            out[s.name] = torch.zeros(s.shape, device=device, dtype=dtype)
    return out


def draw(specs, seed: int, stream: str, device, dtype: torch.dtype
         ) -> Dict[str, torch.Tensor]:
    """Every parameter of ``specs``."""
    out: Dict[str, torch.Tensor] = {}
    for g, members in groups(specs).items():
        out.update(draw_group(members, seed, stream, g, device, dtype))
    return out


def draw_each_group(specs, seed: int, stream: str, device,
                    dtype: torch.dtype) -> Iterable[Dict[str, torch.Tensor]]:
    """The groups of :func:`draw`, one at a time."""
    for g, members in groups(specs).items():
        yield draw_group(members, seed, stream, g, device, dtype)
