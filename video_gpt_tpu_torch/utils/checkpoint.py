"""Checkpoints with auto-resume, in torch's own format.

The surface of ``video_gpt_tpu/utils/checkpoint.py`` (``latest_step``,
``restore_checkpoint``, ``CheckpointWriter``) without orbax: a checkpoint
is ``<directory>/<step>/state.pt``, the ``torch.save`` of the train state's
``state_dict()`` (step, model, optimizer, EMA). Saves are asynchronous: the
state is copied to the host before ``save`` returns, so training may go on
changing it, and the file is written on a background thread.
:func:`load_train_params` reads the parameters (or the EMA) alone, for a
warm start from an earlier stage; :func:`load_lora_adapters` the adapters
of a LoRA run, whose checkpoints hold nothing else of the model.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Optional, Tuple

import torch

_FILE = "state.pt"


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if re.fullmatch(r"\d+", n)
                  and os.path.exists(os.path.join(directory, n, _FILE)))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _write(directory: str, step: int, host_state, keep: int) -> None:
    path = os.path.join(directory, str(step))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(host_state, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    for old in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)


class CheckpointWriter:
    """Saves on a background thread, at most one in flight; ``close()`` (or
    the context manager) waits for the last one."""

    def __init__(self, directory: str, keep: int = 5):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.last_step: Optional[int] = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        self.last_step = step
        host = _to_host(state.state_dict())

        def run():
            try:
                _write(self.directory, step, host, self.keep)
            except Exception as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_durable(self, step: int, state: Any) -> None:
        """A checkpoint of ``state`` at ``step`` on disk before returning
        (written unless the last save was of this step): the save before a
        requested shutdown."""
        if self.last_step != step:
            self.save(step, state)
        self.wait()

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "CheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _path(directory: str, step: Optional[int]) -> Tuple[str, int]:
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return os.path.join(directory, str(step), _FILE), step


def restore_checkpoint(directory: str, state_like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Load the checkpoint of ``step`` (the latest by default) into
    ``state_like`` in place; returns (state_like, step)."""
    path, step = _path(directory, step)
    state_like.load_state_dict(torch.load(path, map_location="cpu",
                                          weights_only=True))
    return state_like, step


def load_train_params(directory: str, step: Optional[int] = None,
                      ema: bool = False, input_head: Optional[bool] = None
                      ) -> Tuple[dict, int]:
    """The model parameters of the checkpoint of ``step`` (the latest by
    default), or its EMA copy, as a state dict on the host: the warm start
    of a later curriculum stage, which never takes the optimizer state.
    The file is memory-mapped and only the returned tensors are copied out
    of it, so the optimizer's moments (and the other copy) are never read
    into host memory. ``input_head`` (when not None) says whether the
    caller's model carries the aux input head; a checkpoint that differs
    is refused with the JAX command's message. Returns (state dict,
    step)."""
    path, step = _path(directory, step)
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    params = sd["ema" if ema else "model"]
    if params is None:
        raise ValueError(f"checkpoint {step} under {directory} has no EMA "
                         "(trained without use_ema)")
    has_head = any(n.startswith("input_final_layer.") for n in params)
    if input_head is not None and has_head != input_head:
        raise ValueError(
            "restore failed: the checkpoint's structure does not match "
            "(--ema given but the run trained without EMA? wrong --step or "
            "model size? run trained with --input_output_return but no "
            "--input_head given?)" + ("" if has_head else
                                      " (it holds no input_final_layer)"))
    return {name: t.clone() for name, t in params.items()}, step


def load_lora_adapters(directory: str, step: Optional[int] = None,
                       ema: bool = False) -> Tuple[dict, int]:
    """The LoRA adapters of a ``train --use_lora`` run's checkpoint of
    ``step`` (the latest by default), or their EMA copy, memory-mapped as
    :func:`load_train_params` reads them. Raises if the checkpoint holds
    anything but adapters. Returns (adapter state dict, step)."""
    from ..training.lora import is_adapter
    sd, step = load_train_params(directory, step=step, ema=ema)
    if not sd or not all(is_adapter(n) for n in sd):
        raise ValueError(f"checkpoint {step} under {directory} is not a LoRA "
                         "run's (it holds more than adapters)")
    return sd, step
