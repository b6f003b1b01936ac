"""The process mesh: ranks on a grid of axes, one process group per axis.

Port of ``video_gpt_tpu/parallel/mesh.py`` for one process per rank. Where
the JAX package states shardings and lets XLA insert the collectives, each
rank here holds its own part and calls the collectives itself:

- :func:`make_mesh` places global rank r where ``make_mesh`` of the JAX
  package places device r: ``np.arange(n).reshape(data, seq, tensor,
  pipe)`` (:func:`rank_grid`: pipe is the fastest axis), and creates one
  group per line of every axis longer than 1 (each rank creates every
  group, in one order: group creation is collective);
- the pipe axis stages the layer stack: :func:`stage_layers` is the
  contiguous block of layers a pipe rank holds (the JAX ``param_specs(pp=
  True)`` shards the scanned layer axis ``P('pipe')``); the ZeRO rules
  below apply to a stage's own layers over ``data``;
- :func:`split_seq` / :func:`gather_seq` take the place of
  ``constrain_activations`` and ``constrain_replicated``: the trunk's
  [B, L, D] activations are split into contiguous L/S chunks over the seq
  axis (``P(data, seq, None)``), and gathered whole before the final norm
  and the heads. Both are differentiable: a chunk's backward gathers the
  chunks' gradients, the gather's keeps the rank's chunk, so whatever runs
  before the split or after the gather (the embedders, the final norm, the
  heads) gets its whole gradient on every seq rank;
- :func:`cache_heads` is the head rule of ``constrain_cache``: the KV cache
  is head-sharded at rest over (tensor, seq), tensor-major, so global kv
  head ``(t S + s) hkv/(S T) + i`` is rank (s, t)'s local head i;
- ZeRO (``zero_sharding`` / ``param_specs(zero=...)`` /
  ``place_train_state``): :func:`zero_dim` is the dimension of a tensor
  (the rank's tensor-parallel part of a parameter, or its AdamW moment, or
  its EMA) sharded over ``data``: the first one ``data`` divides, else
  None (replicated); :func:`zero_shard` is the rank's part.
  :func:`shard_params_` makes a model's parameters rest as those parts
  (ZeRO-3), and :func:`gather_params` all-gathers them where they are used
  (backward: the reduce-scatter of their gradients);
- :func:`batch_rows`: this data rank's rows of the global batch
  (``batch_sharding``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshConfig
from . import distributed as coll

DATA_AXIS = "data"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"   # Megatron TP: heads / MLP features
PIPE_AXIS = "pipe"       # GPipe: layer-stack stages
AXES = (DATA_AXIS, SEQ_AXIS, TENSOR_AXIS, PIPE_AXIS)


def rank_grid(cfg: MeshConfig) -> np.ndarray:
    """[data, seq, tensor, pipe] array of global ranks."""
    return np.arange(cfg.num_devices).reshape(cfg.data, cfg.seq, cfg.tensor,
                                              cfg.pipe)


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

    def all_reduce(self, x: torch.Tensor, axis: str,
                   backward: bool = False) -> torch.Tensor:
        """In-place sum over the axis, no backward (``backward``: count
        its bytes as the backward's)."""
        return coll.all_reduce(x, self.groups[axis], self.stats, backward)

    def copy_to(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return coll.copy_to_group(x, self.groups[axis], self.stats)

    def reduce_from(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return coll.reduce_from_group(x, self.groups[axis], self.stats)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int,
                   backward: bool = False) -> torch.Tensor:
        """The axis's chunks concatenated (differentiable); with
        ``backward``, a plain gather whose bytes count as the backward's
        (the optimizer's)."""
        if backward:
            return torch.cat(coll.all_gather(x, self.groups[axis],
                                             self.stats, True), dim=dim)
        return coll.gather_cat(x, self.groups[axis], dim, self.stats)

    def own_chunk(self, x: torch.Tensor, axis: str, dim: int
                  ) -> torch.Tensor:
        return coll.own_chunk(x, self.groups[axis], dim, self.stats)

    def hop(self, x: torch.Tensor, axis: str, dst: Optional[int],
            src: Optional[int], backward: bool = False
            ) -> Optional[torch.Tensor]:
        """``x`` to the axis's rank ``dst``, what its rank ``src`` sends
        back (:func:`distributed.hop`; no backward)."""
        return coll.hop(x, self.groups[axis], dst, src, self.stats, backward)

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int,
                       backward: bool = False) -> torch.Tensor:
        return coll.reduce_scatter(x, self.groups[axis], dim, self.stats,
                                   backward)


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


def stage_layers(mesh: Optional[Mesh], num_layers: int) -> range:
    """The global indices of the layers this pipe rank holds: its
    contiguous block of ``num_layers / pipe`` (all of them without a pipe
    axis)."""
    pp = axis_size(mesh, PIPE_AXIS)
    if num_layers % pp:
        raise ValueError(f"num_layers={num_layers} not divisible by the pipe "
                         f"axis {pp}")
    per = num_layers // pp
    s = 0 if mesh is None else mesh.index(PIPE_AXIS)
    return range(s * per, (s + 1) * per)


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
    the seq axis); its backward all-gathers the chunks' gradients."""
    s = axis_size(mesh, SEQ_AXIS)
    if s == 1:
        return x
    if x.shape[dim] % s:
        raise ValueError(f"length {x.shape[dim]} not divisible by the seq "
                         f"axis {s}")
    return mesh.own_chunk(x, SEQ_AXIS, dim)


def gather_seq(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 1
               ) -> torch.Tensor:
    """The seq axis's chunks of ``x`` concatenated along ``dim``; its
    backward keeps this rank's chunk of the gradient."""
    if axis_size(mesh, SEQ_AXIS) == 1:
        return x
    return mesh.all_gather(x, SEQ_AXIS, dim)


def batch_rows(mesh: Optional[Mesh], rows: int) -> slice:
    """This data rank's contiguous rows of a global batch of ``rows``."""
    d = axis_size(mesh, DATA_AXIS)
    if rows % d:
        raise ValueError(f"{rows} rows not divisible by the data axis {d}")
    i = 0 if mesh is None else mesh.index(DATA_AXIS)
    return slice(i * rows // d, (i + 1) * rows // d)


def zero_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The dimension ZeRO shards over ``n`` data ranks: the first that
    ``n`` divides (the JAX ``zero_sharding`` rule), else None."""
    if n == 1:
        return None
    for d, size in enumerate(shape):
        if size % n == 0 and size >= n:
            return d
    return None


def zero_shard(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This data rank's part of ``x`` (a view), or ``x`` itself where
    :func:`zero_dim` is None."""
    n = axis_size(mesh, DATA_AXIS)
    d = zero_dim(x.shape, n)
    if d is None:
        return x
    return x.chunk(n, dim=d)[mesh.index(DATA_AXIS)]


def shard_params_(module: torch.nn.Module, mesh: Optional[Mesh], device
                  ) -> torch.nn.Module:
    """ZeRO-3: ``module`` (on the meta device) materialised on ``device``
    (uninitialised) with every parameter that :func:`zero_dim` shards
    replaced by a Parameter of this data rank's part, tagged with its
    ``zero_dim``; :func:`gather_params` puts it together where it is
    used."""
    n = axis_size(mesh, DATA_AXIS)
    dims = {}
    for mod_name, mod in module.named_modules():
        for name, p in list(mod._parameters.items()):
            d = None if p is None else zero_dim(p.shape, n)
            if d is None:
                continue
            shape = list(p.shape)
            shape[d] //= n
            mod._parameters[name] = torch.nn.Parameter(
                torch.empty(shape, device=p.device, dtype=p.dtype),
                requires_grad=p.requires_grad)
            dims[f"{mod_name}.{name}" if mod_name else name] = d
    module.to_empty(device=device)  # new Parameter objects: tag them now
    for name, p in module.named_parameters():
        if name in dims:
            p.zero_dim = dims[name]
    return module


class _GatherParam(torch.autograd.Function):
    """A ZeRO-3 parameter's parts all-gathered over ``data`` in ``dtype``;
    backward: the reduce-scatter (sum, in the part's dtype) of the whole
    gradient."""

    @staticmethod
    def forward(ctx, part, mesh, dim, dtype):
        ctx.args = (mesh, dim, part.dtype)
        return torch.cat(coll.all_gather(part.to(dtype),
                                         mesh.groups[DATA_AXIS], mesh.stats),
                         dim=dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, dtype = ctx.args
        return (mesh.reduce_scatter(g.to(dtype), DATA_AXIS, dim, True), None,
                None, None)


def gather_params(module: torch.nn.Module, mesh: Optional[Mesh],
                  dtype: Optional[torch.dtype] = None,
                  skip: str = None) -> Dict[str, torch.Tensor]:
    """The whole tensors of ``module``'s ZeRO-3 parameters (those tagged
    by :func:`shard_params_`, except names starting with ``skip``), by
    name, gathered in ``dtype`` (theirs by default), for
    ``torch.func.functional_call``."""
    return {name: _GatherParam.apply(p, mesh, p.zero_dim, dtype or p.dtype)
            for name, p in module.named_parameters()
            if getattr(p, "zero_dim", None) is not None
            and not (skip and name.startswith(skip))}
