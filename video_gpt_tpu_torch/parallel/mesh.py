"""The process mesh: ranks on a grid of axes, one process group per axis.

Port of ``video_gpt_tpu/parallel/mesh.py`` for one process per rank. Where
the JAX package states shardings and lets XLA insert the collectives, each
rank here holds its own part and calls the collectives itself:

- :func:`make_mesh` places global rank r where ``make_mesh`` of the JAX
  package places device r: ``np.arange(n).reshape(data, seq, tensor)``
  (:func:`rank_grid`; the JAX grid's pipe axis is 1 when serving), and
  creates one group per line of every axis longer than 1 (each rank creates every group, in one order: group
  creation is collective);
- :func:`split_seq` / :func:`gather_seq` take the place of
  ``constrain_activations`` and ``constrain_replicated``: the trunk's
  [B, L, D] activations are split into contiguous L/S chunks over the seq
  axis (``P(data, seq, None)``), and gathered whole before the final norm
  and the heads;
- :func:`cache_heads` is the head rule of ``constrain_cache``: the KV cache
  is head-sharded at rest over (tensor, seq), tensor-major, so global kv
  head ``(t S + s) hkv/(S T) + i`` is rank (s, t)'s local head i.

The pipe axis and the parameter shardings of training (``param_specs``,
``zero_sharding``, ``place_train_state``) are the mesh's training half
(ROADMAP.md queue 1); serving needs only the tensor shard of
``utils.weights``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshConfig
from . import distributed as coll

DATA_AXIS = "data"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"   # Megatron TP: heads / MLP features
AXES = (DATA_AXIS, SEQ_AXIS, TENSOR_AXIS)


def rank_grid(cfg: MeshConfig) -> np.ndarray:
    """[data, seq, tensor] array of global ranks."""
    return np.arange(cfg.num_devices).reshape(cfg.data, cfg.seq, cfg.tensor)


class Mesh:
    """One rank's view of the mesh: its coordinates, the process group of
    each axis it is sharded over, and the bytes its collectives moved
    (``stats``)."""

    def __init__(self, cfg: MeshConfig, rank: int,
                 groups: Dict[str, object]):
        self.cfg = cfg
        self.rank = rank
        where = np.argwhere(rank_grid(cfg) == rank)[0]
        self.coords = dict(zip(AXES, (int(i) for i in where)))
        self.groups = groups
        self.stats = coll.CollectiveStats()

    def size(self, axis: str) -> int:
        return getattr(self.cfg, axis)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        return coll.all_to_all(x, self.groups[axis], split_dim, concat_dim,
                               self.stats)

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return coll.all_reduce(x, self.groups[axis], self.stats)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        return torch.cat(coll.all_gather(x, self.groups[axis], self.stats),
                         dim=dim)


def make_mesh(cfg: MeshConfig) -> Mesh:
    """This process's :class:`Mesh`. The launch's world size must be
    ``cfg.num_devices`` (one process per rank; 1 without a process group).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != cfg.num_devices:
        raise ValueError(f"the mesh {cfg} has {cfg.num_devices} ranks, the "
                         f"launch {world} processes")
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = rank_grid(cfg)
    groups = {}
    for i, axis in enumerate(AXES):
        if grid.shape[i] == 1:
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i]):
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return Mesh(cfg, rank, groups)


def axis_size(mesh: Optional[Mesh], axis: str) -> int:
    """Size of ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(axis)


def cache_heads(mesh: Optional[Mesh], n_heads: int) -> slice:
    """The global heads this rank holds of ``n_heads`` sharded over
    (tensor, seq), tensor-major: the at-rest KV-cache rule of the JAX
    ``constrain_cache``, and the order the Ulysses all_to_all produces."""
    s, t = axis_size(mesh, SEQ_AXIS), axis_size(mesh, TENSOR_AXIS)
    if n_heads % (s * t):
        raise ValueError(f"{n_heads} heads not divisible by seq*tensor = "
                         f"{s}*{t}")
    per = n_heads // (s * t)
    if mesh is None:
        return slice(0, per)
    r = mesh.index(TENSOR_AXIS) * s + mesh.index(SEQ_AXIS)
    return slice(r * per, (r + 1) * per)


def split_seq(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 1
              ) -> torch.Tensor:
    """This rank's contiguous chunk of ``x`` along ``dim`` (a multiple of
    the seq axis)."""
    s = axis_size(mesh, SEQ_AXIS)
    if s == 1:
        return x
    if x.shape[dim] % s:
        raise ValueError(f"length {x.shape[dim]} not divisible by the seq "
                         f"axis {s}")
    return x.chunk(s, dim=dim)[mesh.index(SEQ_AXIS)]


def gather_seq(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 1
               ) -> torch.Tensor:
    """The seq axis's chunks of ``x`` concatenated along ``dim``."""
    if axis_size(mesh, SEQ_AXIS) == 1:
        return x
    return mesh.all_gather(x, SEQ_AXIS, dim)
