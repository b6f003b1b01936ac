"""Multi-process runtime, collectives and failure handling.

Port of ``video_gpt_tpu/parallel/distributed.py`` onto
``torch.distributed``, one process per rank:

- :func:`init_runtime` joins the process group of a ``torchrun`` launch
  (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
  ``MASTER_PORT``) or of the JAX package's variables
  (``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``), and does
  nothing in a single process;
- :func:`is_main_process`: rank 0, or no process group;
- :class:`GracefulShutdown`: SIGTERM/SIGINT sets a flag that the training
  loops read each step (agreed over the ranks, :meth:`~GracefulShutdown.
  agreed`), to write a checkpoint and return;
- :func:`spawn_ranks` runs a function in one spawned process per rank
  (``torch.multiprocessing``), joined by a file rendezvous, without
  ``torchrun`` (the tests, and the smoke run's ranks sharing one card).

The collectives the mesh runs count the bytes they take in, in the
caller's :class:`CollectiveStats`, in the forward and the backward. The
ones training differentiates through are ``torch.autograd.Function``s:
:func:`all_to_all` (backward: the reverse all_to_all), Megatron's pair
:func:`copy_to_group` / :func:`reduce_from_group`, :func:`gather_cat`
(backward: this rank's chunk), :func:`own_chunk` (backward: the chunks
gathered) and :func:`ppermute` (the neighbour hop of the ring and of
GPipe; backward: the reverse hop); :func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter` (ZeRO's gradient shard) and :func:`hop` (one
point-to-point step, which the ring's and GPipe's own backward schedules
issue) have no backward.
Several ranks sharing one card run the ``gloo`` backend (NCCL refuses two
ranks of one communicator on one device); gloo takes CUDA operands of
these collectives itself, copying them through host memory.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing

def init_runtime(device=None, backend: Optional[str] = None) -> bool:
    """Join the launch's process group; True when one is running.

    ``backend`` None takes ``nccl`` for a CUDA ``device`` and ``gloo`` for
    the CPU; ranks that share one card pass ``"gloo"`` themselves. With
    ``LOCAL_RANK`` set, a CUDA rank's current device is ``cuda:LOCAL_RANK``.
    Without a launch (no world size above 1 in the environment) nothing is
    done."""
    if dist.is_initialized():
        return True
    env = os.environ
    world = int(env.get("WORLD_SIZE") or env.get("NUM_PROCESSES") or 1)
    if world == 1:
        return False
    rank = int(env.get("RANK") or env.get("PROCESS_ID") or 0)
    if env.get("MASTER_ADDR"):
        init_method = "env://"
    elif env.get("COORDINATOR_ADDRESS"):
        init_method = f"tcp://{env['COORDINATOR_ADDRESS']}"
    else:
        raise RuntimeError(f"WORLD_SIZE {world} without MASTER_ADDR or "
                           "COORDINATOR_ADDRESS: launch with torchrun")
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda and env.get("LOCAL_RANK") is not None:
        torch.cuda.set_device(int(env["LOCAL_RANK"]))
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"),
                            init_method=init_method, world_size=world,
                            rank=rank)
    return True


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclasses.dataclass
class CollectiveStats:
    """Bytes a rank's collectives took in, and their count, in the forward
    and in the backward of the autograd collectives; of those, the bytes
    its point-to-point hops (:func:`hop`) sent, forward and backward."""

    moved: int = 0
    calls: int = 0
    backward_moved: int = 0
    backward_calls: int = 0
    hop_moved: int = 0
    hop_backward_moved: int = 0

    def add(self, x: torch.Tensor, backward: bool = False,
            hop: bool = False) -> None:
        n = x.numel() * x.element_size()
        if backward:
            self.backward_moved += n
            self.backward_calls += 1
            self.hop_backward_moved += n if hop else 0
        else:
            self.moved += n
            self.calls += 1
            self.hop_moved += n if hop else 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


def _count(stats: Optional[CollectiveStats], x: torch.Tensor,
           backward: bool = False, hop: bool = False) -> None:
    if stats is not None:
        stats.add(x, backward, hop)


def _all_to_all(x, group, split_dim, concat_dim, stats, backward=False):
    n = dist.get_world_size(group)
    inp = torch.stack(x.chunk(n, dim=split_dim))
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    _count(stats, inp, backward)
    return torch.cat(out.unbind(0), dim=concat_dim)


def _gather_cat(x, group, dim, stats, backward=False):
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    _count(stats, src, backward)
    return torch.cat(parts, dim=dim)


def _own_chunk(x, group, dim):
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim=dim)[i].contiguous()


def hop(x: torch.Tensor, group, dst: Optional[int], src: Optional[int],
        stats: Optional[CollectiveStats] = None,
        backward: bool = False) -> Optional[torch.Tensor]:
    """One point-to-point step over the group, with no backward: send
    ``x`` to group rank ``dst`` (None: send nothing) and return what group
    rank ``src`` sends, a tensor shaped like ``x`` (None where ``src`` is
    None). Every rank of the group calls it at the same point, with the
    ``x`` shape the others use. It is one ``all_to_all_single`` whose
    split sizes carry the whole payload to one peer and 0 to the others:
    the form that both gloo (CPU and CUDA operands) and NCCL take, where
    gloo's ``send`` / ``recv`` take CPU tensors only. The bytes sent count
    in ``stats``."""
    n = dist.get_world_size(group)
    flat = x.detach().contiguous().reshape(-1)
    ins, outs = [0] * n, [0] * n
    if dst is not None:
        ins[dst] = flat.numel()
    if src is not None:
        outs[src] = flat.numel()
    out = flat.new_empty(sum(outs))
    dist.all_to_all_single(out, flat if dst is not None else flat[:0],
                           outs, ins, group=group)
    if dst is not None:
        _count(stats, flat, backward, hop=True)
    return None if src is None else out.view(x.shape)


def _shifted(x, group, shift, stats, backward=False):
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return hop(x, group, (i + shift) % n, (i - shift) % n, stats, backward)


def _all_reduce(x, group, stats, backward=False):
    dist.all_reduce(x, group=group)
    _count(stats, x, backward)
    return x


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim, stats):
        ctx.args = (group, split_dim, concat_dim, stats)
        return _all_to_all(x, group, split_dim, concat_dim, stats)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim, stats = ctx.args
        # the transpose: every chunk goes back where it came from
        return (_all_to_all(g, group, concat_dim, split_dim, stats, True),
                None, None, None, None)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f): the input of
    a column-parallel layer, which every rank of the group reads whole."""

    @staticmethod
    def forward(ctx, x, group, stats):
        ctx.args = (group, stats)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        group, stats = ctx.args
        return _all_reduce(g.clone(), group, stats, True), None, None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g): the partial
    products of a row-parallel layer."""

    @staticmethod
    def forward(ctx, x, group, stats):
        ctx.mark_dirty(x)
        return _all_reduce(x, group, stats)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherCat(torch.autograd.Function):
    """The group's chunks concatenated; backward: this rank's chunk of the
    gradient (what follows is replicated over the group, so every rank
    holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim, stats):
        ctx.args = (group, dim)
        return _gather_cat(x, group, dim, stats)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _own_chunk(g, group, dim), None, None, None


class _OwnChunk(torch.autograd.Function):
    """This rank's chunk of a tensor replicated over the group; backward:
    the chunks' gradients gathered (the transpose of taking a chunk)."""

    @staticmethod
    def forward(ctx, x, group, dim, stats):
        ctx.args = (group, dim, stats)
        return _own_chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, stats = ctx.args
        return _gather_cat(g, group, dim, stats, True), None, None, None


class _Ppermute(torch.autograd.Function):
    """The ring shift; backward: the reverse shift of the gradient."""

    @staticmethod
    def forward(ctx, x, group, shift, stats):
        ctx.args = (group, shift, stats)
        return _shifted(x, group, shift, stats)

    @staticmethod
    def backward(ctx, g):
        group, shift, stats = ctx.args
        return _shifted(g, group, -shift, stats, True), None, None, None


def ppermute(x: torch.Tensor, group, shift: int,
             stats: Optional[CollectiveStats] = None) -> torch.Tensor:
    """``jax.lax.ppermute`` over the group's ring: group rank i sends ``x``
    to rank (i + shift) mod n and returns what rank (i - shift) mod n sent.
    Differentiable: the backward is the reverse shift (its bytes count as
    the backward's). Every rank must reach the backward: a schedule whose
    last hop is unused on some ranks issues its hops itself (:func:`hop`)
    in one explicit backward."""
    return _Ppermute.apply(x, group, shift, stats)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int,
               stats: Optional[CollectiveStats] = None) -> torch.Tensor:
    """Split ``x`` into n chunks along ``split_dim``, send chunk j to the
    group's rank j, and concatenate the chunks received along
    ``concat_dim`` in group-rank order. Differentiable: the backward is the
    reverse all_to_all."""
    return _AllToAll.apply(x, group, split_dim, concat_dim, stats)


def copy_to_group(x: torch.Tensor, group,
                  stats: Optional[CollectiveStats] = None) -> torch.Tensor:
    """``x`` itself; its gradient is summed over the group."""
    return _CopyToGroup.apply(x, group, stats)


def reduce_from_group(x: torch.Tensor, group,
                      stats: Optional[CollectiveStats] = None
                      ) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks (in place; returns ``x``); the
    gradient passes through unchanged."""
    return _ReduceFromGroup.apply(x, group, stats)


def gather_cat(x: torch.Tensor, group, dim: int,
               stats: Optional[CollectiveStats] = None) -> torch.Tensor:
    """Every group rank's ``x`` concatenated along ``dim``, in group-rank
    order; the backward keeps this rank's chunk of the gradient."""
    return _GatherCat.apply(x, group, dim, stats)


def own_chunk(x: torch.Tensor, group, dim: int,
              stats: Optional[CollectiveStats] = None) -> torch.Tensor:
    """This rank's contiguous chunk of ``x`` along ``dim``; the backward
    gathers the chunks' gradients."""
    return _OwnChunk.apply(x, group, dim, stats)


def all_reduce(x: torch.Tensor, group,
               stats: Optional[CollectiveStats] = None,
               backward: bool = False) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks (in place; returns ``x``), with
    no backward (``backward``: count its bytes as the backward's)."""
    return _all_reduce(x, group, stats, backward)


def all_gather(x: torch.Tensor, group,
               stats: Optional[CollectiveStats] = None,
               backward: bool = False) -> List[torch.Tensor]:
    """Every group rank's ``x``, in group-rank order, with no backward
    (``backward``: count its bytes as the backward's)."""
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    _count(stats, src, backward)
    return parts


def reduce_scatter(x: torch.Tensor, group, dim: int,
                   stats: Optional[CollectiveStats] = None,
                   backward: bool = False) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over the
    group's ranks (ZeRO's gradient shard), with no backward."""
    n = dist.get_world_size(group)
    parts = [c.contiguous() for c in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    _count(stats, x, backward)
    return out


class GracefulShutdown:
    """Sets ``requested`` on SIGTERM/SIGINT; the training loops read it
    each step, write a checkpoint at the current step and return.
    :meth:`restore` puts the previous handlers back."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = threading.Event()
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass  # not the main thread: no handler can be installed

    def _handler(self, signum, frame):
        self.requested.set()

    def agreed(self, device=None) -> bool:
        """Whether any rank of the launch saw a signal: one
        ``all_reduce(MAX)`` of the flag over the world, so every rank
        writes its checkpoint at the same step (a rank that acted alone
        would save while the others wait in a collective). Without a
        process group, the local flag."""
        stop = self.requested.is_set()
        if dist.is_initialized() and dist.get_world_size() > 1:
            flag = torch.tensor([float(stop)], device=device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            stop = bool(flag.item() > 0)
        return stop

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}


def _rank_main(rank: int, fn: Callable, args: Sequence, world: int,
               workdir: str, threads: int) -> None:
    if threads:
        torch.set_num_threads(threads)
    if args is None:
        args = torch.load(os.path.join(workdir, "args.pt"),
                          weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdzv",
                            world_size=world, rank=rank)
    try:
        torch.save(fn(*args), os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, args: Sequence, world: int, workdir: str,
                timeout: float = 600.0, threads: int = 0,
                start_method: str = "spawn") -> list:
    """``fn(*args)`` in ``world`` processes of ``torch.multiprocessing``
    (``start_method``: "spawn", or "forkserver", whose ranks fork from one
    server that has imported the main module once), each one rank of a
    gloo process group joined through a file under ``workdir`` (an empty
    directory); returns each rank's result, in rank order (tensors,
    numbers, strings and containers of them: they cross as ``torch.save``
    files). ``fn`` is a module-level function (it is pickled by name). A
    rank that fails stops the others and its error is raised here; past
    ``timeout`` seconds every rank is stopped and ``RuntimeError`` raised.
    ``threads`` (when nonzero) caps each rank's intra-op threads. A
    forkserver's ranks take the environment the server started with, and
    their ``args`` cross as a ``torch.save`` file (the server passes a
    process at most 256 file descriptors: one a shared tensor)."""
    if start_method == "forkserver":
        torch.save(args, os.path.join(workdir, "args.pt"))
        args = None
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, args, world, workdir, threads), nprocs=world,
        join=False, start_method=start_method)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"the {world} ranks still run after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"))
            for r in range(world)]
