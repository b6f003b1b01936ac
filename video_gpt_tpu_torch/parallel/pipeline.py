"""GPipe over the mesh's pipe axis, one process per rank.

Port of ``video_gpt_tpu/parallel/pipeline.py``: pipe rank s holds the
contiguous block of layers ``mesh.stage_layers`` (its stage), and the
rank's rows are split into ``num_micro`` microbatches of contiguous rows
(the JAX ``_micro``; the metadata and the rope tables split the same way,
and ``AttnMeta.index``'s batch-stride-0 view stays a view). Microbatch m
runs through stage s at tick m + s; between ticks each stage hands its
output to the next over the pipe group (``distributed.hop``). The last
stage's outputs are summed over the pipe group with the other stages'
zeros (the JAX ``psum``), so every pipe rank holds the trunk's whole
output: the final norm and the heads run after it on every rank, alike,
and the embedding assembly before it, on every rank too.

The schedule is one ``torch.autograd.Function`` with an explicit
backward, so every rank issues the same collective at every tick whether
or not it has work (a per-hop autograd Function whose output stage 0
ignores would skip its backward hop, and the group would hang):

- forward, under ``no_grad``: each tick, each stage with a microbatch runs
  its layers on it and keeps the microbatch's stage input; the bubble's
  ticks compute nothing (the JAX loop computes every tick and masks the
  garbage) and hop nothing;
- backward, the ticks in reverse: each stage with a microbatch recomputes
  its layers on the kept input with autograd (in the forward's autocast),
  takes the parameter gradients and its input's gradient, summed over the
  microbatches, and hands the input gradient back one stage. This is the
  compute and memory of per-layer recompute (``cfg.remat``): each layer
  runs twice forward and once backward per microbatch, and only the stage
  inputs live between the passes, so the stage needs no layer checkpoint
  of its own;
- the input gradient, which stage 0 alone computes, is summed over the
  pipe group (the transpose of the embedding's replication), so every
  pipe rank backpropagates it through the embedders and holds their
  whole gradient; the final norm's and the heads' gradients are whole on
  every rank already (the pipe sum's backward hands each rank the whole
  cotangent and the last stage takes its own). No parameter gradient is
  reduced over pipe.

On one stage, K6 runs 2 x num_micro x (layers of the stage) times a step
and K7 num_micro x (layers of the stage) times. The attention is the
uncached metadata route with no dense bias, as in the JAX trunk.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import AttnMeta
from .mesh import DATA_AXIS, PIPE_AXIS, axis_size


class _Schedule:
    """One GPipe step of a stage: its microbatches' inputs, rope tables
    and metadata, and the forward's autocast, which the backward's
    recompute takes again."""

    def __init__(self, decoder, x, cos, sin, q_meta: AttnMeta,
                 k_meta: AttnMeta, nm: int):
        self.decoder, self.mesh, self.nm = decoder, decoder.mesh, nm
        self.pp = axis_size(self.mesh, PIPE_AXIS)
        self.s = self.mesh.index(PIPE_AXIS)
        mb = x.shape[0] // nm
        rows = [slice(m * mb, (m + 1) * mb) for m in range(nm)]
        self.cos, self.sin = [cos[r] for r in rows], [sin[r] for r in rows]
        self.q_meta = [AttnMeta(*(f[r] for f in q_meta)) for r in rows]
        self.k_meta = [AttnMeta(*(f[r] for f in k_meta)) for r in rows]
        dev = x.device.type
        self.autocast = (dev, torch.get_autocast_dtype(dev),
                         torch.is_autocast_enabled(dev))
        self.params = list(decoder.layers.parameters())
        self.inputs = [None] * nm

    def stage(self, x: torch.Tensor, m: int) -> torch.Tensor:
        return self.decoder.stage(x, self.cos[m], self.sin[m],
                                  self.q_meta[m], self.k_meta[m])

    def _active(self, t: int, s: int) -> bool:
        """Whether stage ``s`` has a microbatch at tick ``t``."""
        return 0 <= s < self.pp and 0 <= t - s < self.nm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh, s, pp, nm = self.mesh, self.s, self.pp, self.nm
        xs = x.chunk(nm)
        outs = [torch.zeros_like(c) for c in xs]
        recv = None
        for t in range(nm + pp - 1):
            y = None
            if self._active(t, s):
                m = t - s
                self.inputs[m] = xs[m] if s == 0 else recv
                y = self.stage(self.inputs[m], m)
                if s == pp - 1:
                    outs[m] = y
            if t < nm + pp - 2:
                # this stage's output to the next, the previous one's in
                recv = mesh.hop(
                    xs[0] if y is None else y, PIPE_AXIS,
                    s + 1 if s < pp - 1 and y is not None else None,
                    s - 1 if self._active(t, s - 1) else None)
        # the last stage's outputs on every pipe rank: the JAX psum of the
        # other stages' zeros and them
        return mesh.all_reduce(torch.cat(outs), PIPE_AXIS)

    def backward(self, g: torch.Tensor):
        mesh, s, pp, nm = self.mesh, self.s, self.pp, self.nm
        gs = g.chunk(nm)
        grads = [None] * len(self.params)
        dx = [torch.zeros_like(c) for c in gs]
        recv = None
        dev, dtype, enabled = self.autocast
        for t in reversed(range(nm + pp - 1)):
            gin = None
            if self._active(t, s):
                m = t - s
                gy = gs[m] if s == pp - 1 else recv
                inp = self.inputs[m].detach().requires_grad_()
                with torch.enable_grad(), torch.autocast(
                        dev, dtype=dtype, enabled=enabled,
                        cache_enabled=False):
                    y = self.stage(inp, m)
                gin, *gp = torch.autograd.grad(y, [inp] + self.params, gy,
                                               allow_unused=True)
                grads = [a if b is None else b if a is None else a + b
                         for a, b in zip(grads, gp)]
                self.inputs[m] = None
                if s == 0:
                    dx[m] = gin
            if t > 0:
                # this stage's input gradient to the previous stage, the
                # next stage's in
                recv = mesh.hop(
                    gs[0] if gin is None else gin, PIPE_AXIS,
                    s - 1 if s > 0 and gin is not None else None,
                    s + 1 if self._active(t, s + 1) else None,
                    backward=True)
        # only stage 0 read the input: its gradient summed over pipe
        return mesh.all_reduce(torch.cat(dx), PIPE_AXIS, backward=True), grads


class _GPipe(torch.autograd.Function):
    """The schedule's forward and its explicit backward; the stage's
    parameters ride as inputs, so each gets its gradient (the sum over the
    microbatches) once, as from any other forward."""

    @staticmethod
    def forward(ctx, schedule, x, *params):
        ctx.schedule = schedule
        with torch.no_grad():
            return schedule.forward(x)

    @staticmethod
    def backward(ctx, g):
        dx, grads = ctx.schedule.backward(g.contiguous())
        ctx.schedule = None
        return (None, dx) + tuple(grads)


def pipeline_trunk(decoder, x: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, q_meta: AttnMeta, k_meta: AttnMeta,
                   num_micro: Optional[int] = None) -> torch.Tensor:
    """The trunk's layers on this rank's rows ``x`` [B, L, D] as a GPipe
    pipeline over the pipe axis of ``decoder``'s mesh: [B, L, D] of the
    last stage, on every pipe rank. The final norm and the embedding and
    head ends stay outside (``pp_apply``, which is the plain forward
    without a pipe axis). ``num_micro`` (default: the pipe size) must
    divide B."""
    mesh = decoder.mesh
    nm = num_micro or axis_size(mesh, PIPE_AXIS)
    if x.shape[0] % nm:
        dp = axis_size(mesh, DATA_AXIS)
        raise ValueError(f"batch {x.shape[0] * dp} not divisible by "
                         f"num_micro*data = {nm}*{dp}")
    schedule = _Schedule(decoder, x, cos, sin, q_meta, k_meta, nm)
    return _GPipe.apply(schedule, x, *schedule.params)


def pp_apply(model, batch, noisy_latents: torch.Tensor, t: torch.Tensor,
             clean_latents=None, input_output_return: bool = False,
             bias=None, num_micro: Optional[int] = None):
    """``VideoGPT``'s full-sequence forward with the trunk pipelined over
    the pipe axis (``num_micro`` microbatches): the training loss's
    ``apply_fn`` on a pipe mesh, with ``model.forward``'s signature, and
    distillation's for the student and the frozen teacher alike (each over
    its own stage's layers; the teacher's under ``no_grad``, a forward
    schedule whose ticks hop as the student's do). The embedding assembly
    before the trunk and the final norm and heads after it run on every
    pipe rank. On a mesh without a pipe axis it is the plain forward."""
    return model(batch, noisy_latents, t, clean_latents,
                 input_output_return=input_output_return, bias=bias,
                 num_micro=num_micro)
