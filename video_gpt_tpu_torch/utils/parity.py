"""Numerical-divergence probes across ranks.

Port of ``video_gpt_tpu/utils/parity.py``, the counterpart of the
reference's rank equality checker (``is_all_equal``): where the JAX package
reads the shards of one array, each rank here holds its own copy of what
should be replicated, and :func:`shard_divergence` gathers them.
"""
from __future__ import annotations

from typing import Any, Iterator, Tuple

import torch
import torch.distributed as dist

from ..parallel.distributed import all_gather


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def max_tree_diff(a: Any, b: Any) -> float:
    """Largest |a - b| over the tensor leaves of two trees of one
    structure (dicts, lists, tuples)."""
    diffs = [float((x.float() - y.float()).abs().max())
             for (_, x), (_, y) in zip(_leaves(a), _leaves(b))
             if isinstance(x, torch.Tensor) and x.numel()]
    return max(diffs, default=0.0)


def shard_divergence(x: torch.Tensor, group=None) -> float:
    """Largest |x_r - x_0| over the ranks r of ``group`` (the world by
    default) of a tensor that every rank should hold alike; the same value
    on every rank, 0.0 without a process group."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return 0.0
    parts = all_gather(x, group)
    return max(float((p.float() - parts[0].float()).abs().max())
               for p in parts[1:])


def assert_replicated(tree: Any, group=None, atol: float = 0.0) -> None:
    """Raise ``AssertionError`` naming the first tensor leaf of ``tree``
    whose ranks differ by more than ``atol``."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            d = shard_divergence(leaf, group)
            if d > atol:
                raise AssertionError(f"{path or 'tensor'} diverges across "
                                     f"ranks: {d}")


def replicated_divergence(named, mesh) -> float:
    """The largest :func:`shard_divergence` of the tensors ``named`` (name,
    tensor) over each mesh axis whose ranks hold them alike: seq always,
    data unless the tensor is a ZeRO-3 part (tagged ``zero_dim``), tensor
    unless it is a tensor rank's own part of a projection, pipe unless it
    is a layer (a stage's own). Every rank calls it with its names in
    their order: the ranks of an axis's group hold the same ones."""
    from ..parallel.mesh import DATA_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS
    from ..parallel.tensor import TP_SHARDED
    worst = 0.0
    for name, x in named:
        axes = [SEQ_AXIS]
        if not name.startswith("llm.layers."):
            axes.append(PIPE_AXIS)
        if getattr(x, "zero_dim", None) is None:
            axes.append(DATA_AXIS)
        if not name.endswith(TP_SHARDED):
            axes.append(TENSOR_AXIS)
        for axis in axes:
            if mesh.size(axis) > 1:
                worst = max(worst, shard_divergence(x.detach(),
                                                    mesh.groups[axis]))
    return worst
