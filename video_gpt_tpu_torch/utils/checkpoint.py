"""Checkpoints with auto-resume, in torch's own format.

The surface of ``video_gpt_tpu/utils/checkpoint.py`` (``latest_step``,
``restore_checkpoint``, ``CheckpointWriter``) without orbax: a checkpoint
is ``<directory>/<step>/state.pt``, the ``torch.save`` of the train state's
``state_dict()`` (step, model, optimizer, EMA). Saves are asynchronous: the
state is copied to the host before ``save`` returns, so training may go on
changing it, and the file is written on a background thread. The part of a
state that already lives on the host and that the step changes in place
(the offload optimizer's master, mu and nu, :class:`HostResident`) is
written from its own tensors, without a second host copy, and ``save``
returns only once it is on disk.
:func:`load_train_params` reads the parameters (or the EMA) alone, for a
warm start from an earlier stage; :func:`load_lora_adapters` the adapters
of a LoRA run, whose checkpoints hold nothing else of the model.

A mesh run writes each rank's part of the train state,
``<directory>/<step>/rank<r>.pt``, and rank 0 a record of the mesh,
``mesh.json`` (its axes, ZeRO-3, each parameter's ZeRO dimension, every
pipe stage's layers included, and the widths the tensor-parallel and pipe
layouts need). It resumes on the same mesh only;
:func:`load_train_params` puts the parameters of the parts back
together into the one-rank layout, reading only the parameters from each
part, so a mesh run's checkpoint serves and warm-starts at any mesh. A
LoRA run's parts and record hold the adapters alone
(:func:`load_lora_adapters` puts them together the same way); a
distillation run's the student alone (the teacher is its warm start).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional, Tuple

import torch

_FILE = "state.pt"
_MESH = "mesh.json"


def _rank_file(rank: int) -> str:
    return f"rank{rank}.pt"


def _mesh_record(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, _MESH)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def _complete(path: str) -> bool:
    if os.path.exists(os.path.join(path, _FILE)):
        return True
    rec = _mesh_record(path)
    return rec is not None and all(
        os.path.exists(os.path.join(path, _rank_file(r)))
        for r in range(rec["ranks"]))


class HostResident(dict):
    """A part of a train state's ``state_dict()`` whose tensors live on the
    host and change in place in the train step: a save writes them as they
    are (a plain dict in the file) and waits for the write."""


def _to_host(obj, resident: list):
    """A host snapshot of ``obj``; each :class:`HostResident` part is kept
    as it is, and appended to ``resident``."""
    if isinstance(obj, HostResident):
        resident.append(obj)
        return dict(obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v, resident) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, resident) for v in obj)
    return obj


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if re.fullmatch(r"\d+", n)
                  and _complete(os.path.join(directory, n)))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _write(directory: str, step: int, host_state, keep: int,
           name: str = _FILE, record: Optional[dict] = None) -> None:
    path = os.path.join(directory, str(step))
    os.makedirs(path, exist_ok=True)
    if record is not None:
        with open(os.path.join(path, _MESH + ".tmp"), "w") as f:
            json.dump(record, f, indent=1)
        os.replace(os.path.join(path, _MESH + ".tmp"),
                   os.path.join(path, _MESH))
    tmp = os.path.join(path, name + ".tmp")
    torch.save(host_state, tmp)
    os.replace(tmp, os.path.join(path, name))
    if name == _FILE or record is not None:  # one writer prunes
        for old in _steps(directory)[:-keep]:
            shutil.rmtree(os.path.join(directory, str(old)),
                          ignore_errors=True)


def mesh_record(mesh, model, only=None) -> dict:
    """What a mesh run's checkpoint records beside its parts: the axes,
    ZeRO-3, each parameter's ZeRO dimension (of the rank's tensor; a pipe
    stage's layers as rank 0's stage's) and the model widths that the
    tensor-parallel and pipe layouts depend on. ``only``: the names of the
    parameters the checkpoint holds (a LoRA run's adapters), else all."""
    cfg, pp = model.cfg, mesh.cfg.pipe
    per = cfg.num_layers // pp
    dims = {}
    for n, p in model.named_parameters():
        if only is not None and n not in only:
            continue
        d = getattr(p, "zero_dim", None)
        layer = re.fullmatch(r"llm\.layers\.(\d+)\.(.*)", n)
        if layer is None:
            dims[n] = d
            continue
        for stage in range(pp):
            dims[f"llm.layers.{int(layer[1]) % per + stage * per}."
                 f"{layer[2]}"] = d
    return dict(data=mesh.cfg.data, seq=mesh.cfg.seq,
                tensor=mesh.cfg.tensor, zero_params=mesh.cfg.zero_params,
                pipe=pp, ranks=mesh.cfg.num_devices, zero_dims=dims,
                model={k: getattr(cfg, k) for k in (
                    "hidden_size", "num_heads", "num_kv_heads",
                    "intermediate_size", "num_layers")})


class CheckpointWriter:
    """Saves on a background thread, at most one in flight; ``close()`` (or
    the context manager) waits for the last one. On a mesh (``mesh`` and
    its ``record``, :func:`mesh_record`) each rank writes its part and
    rank 0 the record."""

    def __init__(self, directory: str, keep: int = 5, mesh=None,
                 record: Optional[dict] = None):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.last_step: Optional[int] = None
        self._name = _FILE if mesh is None else _rank_file(mesh.rank)
        self._record = record if mesh is None or mesh.rank == 0 else None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        self.last_step = step
        resident: list = []
        host = _to_host(state.state_dict(), resident)

        def run():
            try:
                _write(self.directory, step, host, self.keep, self._name,
                       self._record)
            except Exception as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if resident:  # the next step changes those tensors
            self.wait()

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
    """(the step's directory, step)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return os.path.join(directory, str(step)), step


def _mesh_name(rec: Optional[dict]) -> str:
    if rec is None:
        return "one rank"
    pipe = rec.get("pipe", 1)
    return (f"(data {rec['data']}, seq {rec['seq']}, tensor "
            f"{rec['tensor']}{f', pipe {pipe}' if pipe > 1 else ''}"
            f"{', zero3' if rec['zero_params'] else ''})")


def restore_checkpoint(directory: str, state_like: Any,
                       step: Optional[int] = None,
                       mesh=None) -> Tuple[Any, int]:
    """Load the checkpoint of ``step`` (the latest by default) into
    ``state_like`` in place (this rank's part of it on a ``mesh``);
    returns (state_like, step). A checkpoint of another mesh is refused:
    its parts do not fit this one's (warm-start from it instead)."""
    path, step = _path(directory, step)
    rec = _mesh_record(path)
    want = None if mesh is None else dict(
        data=mesh.cfg.data, seq=mesh.cfg.seq, tensor=mesh.cfg.tensor,
        zero_params=mesh.cfg.zero_params, pipe=mesh.cfg.pipe)
    if (rec is None) != (want is None) or (rec is not None and any(
            rec.get(k, 1) != v for k, v in want.items())):
        raise ValueError(
            f"checkpoint {step} under {directory} was written on "
            f"{_mesh_name(rec)}, not {_mesh_name(want)}: resume it on its "
            "mesh, or start a new run from it with --init_checkpoint_dir")
    name = _FILE if mesh is None else _rank_file(mesh.rank)
    # memory-mapped: the state is copied into ``state_like`` as it is read
    # (an offload run's host state is not held twice)
    state_like.load_state_dict(torch.load(os.path.join(path, name),
                                          map_location="cpu",
                                          weights_only=True, mmap=True))
    return state_like, step


def _mesh_params(path: str, rec: dict, field: str) -> Optional[dict]:
    """The one-rank layout of ``field`` ("model" or "ema") put together
    from a mesh checkpoint's parts (``weights.unshard``; the seq-0 ranks'
    parts, a layer's from its pipe stage's ranks, memory-mapped, only the
    parameters read)."""
    from ..config import MeshConfig, ModelConfig
    from ..parallel.mesh import rank_grid
    from .weights import unshard

    pp = rec.get("pipe", 1)
    grid = rank_grid(MeshConfig(rec["data"], rec["seq"], rec["tensor"],
                                pipe=pp))
    cfg = ModelConfig(**rec["model"])
    files = {}

    def state(rank):
        if rank not in files:
            files[rank] = torch.load(os.path.join(path, _rank_file(rank)),
                                     map_location="cpu", weights_only=True,
                                     mmap=True)[field]
        return files[rank]

    if state(0) is None:
        return None
    def stage(name: str) -> int:
        layer = re.match(r"llm\.layers\.(\d+)\.", name)
        if layer is None or pp == 1:
            return 0
        return int(layer[1]) // (cfg.num_layers // pp)

    return {name: unshard(
        name, lambda d, t: state(int(grid[d, 0, t, stage(name)]))[name],
        dim, rec["data"], rec["tensor"], cfg)
        for name, dim in rec["zero_dims"].items()}


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
    rec = _mesh_record(path)
    if rec is not None:
        params = _mesh_params(path, rec, "ema" if ema else "model")
    else:
        sd = torch.load(os.path.join(path, _FILE), map_location="cpu",
                        weights_only=True, mmap=True)
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
