"""Export a training run of the port to the reference's safetensors layout.

Port of ``video_gpt_tpu/utils/torch_export.py``. The port's modules carry
the reference torch model's names, so the export is the checkpoint's
``model`` (or ``ema``) state dict itself, every tensor float32 and
contiguous (safetensors writes a tensor's storage as it lies: a
non-contiguous view would be written in the wrong order). safetensors is
imported only when a file is written.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

# a name every full VideoGPT state dict holds (a LoRA run's checkpoint
# holds its adapters alone)
_TRUNK = "llm.norm.weight"


def videogpt_state_dict_to_reference(sd: Mapping[str, torch.Tensor]
                                     ) -> Dict[str, torch.Tensor]:
    """The reference's tensors of a port state dict: float32 and
    contiguous, on the host. Raises on a dict without the model (a LoRA
    run's adapters: merge them into base weights first)."""
    if _TRUNK not in sd:
        raise ValueError("the state dict holds no VideoGPT model (a LoRA "
                         "run's checkpoint holds its adapters alone)")
    return {name: t.detach().to("cpu", torch.float32).contiguous()
            for name, t in sd.items()}


def save_safetensors(sd: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``sd`` (a port state dict) as the reference's safetensors."""
    from safetensors.torch import save_file
    save_file(videogpt_state_dict_to_reference(sd), path)
