"""Token-id conventions and the token-kind enum for sequence layouts.

A frozen copy of the token conventions of the system under test, so that
the reference builds its own layouts and imports nothing of the program.
Every structural marker is a single added special token, so the video path
needs no tokenizer: four ids, configurable so imported checkpoints line up
with their tokenizer's added-token ids.
"""
from __future__ import annotations

import dataclasses
import enum


class Kind(enum.IntEnum):
    """Per-token kind. Order matters: NOISY roles are (kind - DIFF)."""

    PAD = 0
    # noisy-frame segment: [DIFF, TIME, NOISY_IMG * n]
    DIFF = 1        # <|diffusion|> marker          (visibility role 0)
    TIME = 2        # timestep-embedding slot        (visibility role 1)
    NOISY_IMG = 3   # latent patch being denoised    (visibility role 2)
    # clean-frame segment: [IMG_OPEN, CLEAN_IMG * n, IMG_CLOSE]
    IMG_OPEN = 4    # <img>
    CLEAN_IMG = 5   # conditioning latent patch
    IMG_CLOSE = 6   # </img>
    # free text (image-generation prompts)
    TEXT = 7


@dataclasses.dataclass(frozen=True)
class TokenIds:
    """Vocabulary ids for the structural tokens. ``slot`` is the placeholder
    written where an embedding is replaced (patches, time token); ``pad``
    is the collator's pad id."""

    pad: int = 2
    slot: int = 0
    img_open: int = 32002
    img_close: int = 32003
    diffusion: int = 32004


DEFAULT_TOKEN_IDS = TokenIds()
