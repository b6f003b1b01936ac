"""Host-offloaded AdamW: full-depth training with the optimizer in host memory.

Port of ``video_gpt_tpu/training/offload.py``, the reference's ZeRO-offload
recipe (DeepSpeed ``stage3_offload_bf16_dp.json:10-19``): the fp32 master
copy of the parameters and AdamW's mu and nu live in host memory and the
update runs on the host CPU; the device holds the model's parameters (bf16
under ``mixed_precision='bf16'``) and, during a step, their gradients. One
step (:class:`OffloadStep`), in the JAX order:

1. the forward and backward on the device with the model's parameters, in
   ``grad_splits`` passes: each pass differentiates one group of the
   parameters (groups balanced by bytes, :func:`grad_groups`) with the same
   draws, so the loss is the first pass's and the trajectory one pass's;
   each pass's gradients go to the host before the next pass, and their
   squares are summed in fp32 on the device;
2. the clip ``min(1, max_grad_norm / max(norm, 1e-12))``, the learning rate
   of the step count before the step, the bias corrections of the count
   after it;
3. for each axis-0 chunk of each parameter (:func:`chunk_sizes`), on the
   host: the gradient to fp32, the shared AdamW arithmetic
   (``train_state.adamw_update_``) on it, mu, nu and the master, and the
   master in the parameter's dtype written back (:func:`host_update_`);
4. the new parameters copied to the device.

The gradients and the new parameters cross in one transfer buffer, in the
parameters' dtype (2 bytes a parameter in bf16), page-locked when the
model is on CUDA, so that both copies run at the bus's rate; the
gradients of the earlier passes wait there for the norm of the last. The
master, mu and nu (12 bytes a parameter) stay in ordinary pageable memory,
which the CPU's arithmetic reads as fast. On the CPU (tests) everything is
on the CPU and nothing is pinned. :attr:`OffloadStep.split` holds the last
step's time in each phase.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..utils.checkpoint import HostResident
from .loss import LossDraws, LossInputs, training_loss
from .train_state import (TrainState, adamw_update_, autocast, global_norm,
                          lr_schedule)

# Upper bound on the fp32 bytes of one chunk of the host update: it bounds
# each host temporary of the update (the fp32 gradient, the update) to a
# few hundred MB, and it is the unit in which copies can overlap compute.
CHUNK_BYTES_F32 = 384 << 20

PHASES = ("forward_backward", "d2h", "update", "h2d")


def chunk_sizes(shape: tuple, elem_f32_bytes: int = 4) -> tuple:
    """Axis-0 chunk lengths of a tensor of ``shape`` such that each chunk
    is at most :data:`CHUNK_BYTES_F32` as fp32 (one chunk for small
    tensors; scalars and vectors under the bound are never split). The
    count comes from the bytes of one row, so the largest of the balanced
    chunks keeps the bound; a row above it is a chunk of its own."""
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if not shape or shape[0] <= 1 or n * elem_f32_bytes <= CHUNK_BYTES_F32:
        return (shape[0] if shape else 1,)
    row_bytes = (n // shape[0]) * elem_f32_bytes
    rows_per_chunk = max(1, CHUNK_BYTES_F32 // max(row_bytes, 1))
    k = min(shape[0], -(-shape[0] // rows_per_chunk))
    base, rem = divmod(shape[0], k)
    return tuple(base + (1 if i < rem else 0) for i in range(k))


class OffloadState:
    """The offload optimizer's state: ``count`` (optimizer steps taken) and,
    per parameter name, the fp32 ``master``, ``mu`` and ``nu`` on the host.
    It takes the optimizer's place in a :class:`TrainState`."""

    def __init__(self, master: Dict[str, torch.Tensor]):
        self.count = 0
        self.master = master
        self.mu = {n: torch.zeros_like(t) for n, t in master.items()}
        self.nu = {n: torch.zeros_like(t) for n, t in master.items()}

    @property
    def host_bytes(self) -> int:
        return sum(3 * t.numel() * t.element_size()
                   for t in self.master.values())

    def state_dict(self) -> HostResident:
        """The host tensors themselves (a checkpoint writes them without a
        copy, :class:`HostResident`)."""
        return HostResident(count=self.count, mu=self.mu, nu=self.nu,
                            master=self.master)

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Restore into the existing host tensors."""
        self.count = int(sd["count"])
        for field in ("mu", "nu", "master"):
            mine = getattr(self, field)
            if set(sd[field]) != set(mine):
                raise ValueError(f"the checkpoint's offload {field} does not "
                                 "match the model's parameters")
            for name, t in mine.items():
                t.copy_(sd[field][name])


@torch.no_grad()
def init_offload_state(model: torch.nn.Module, cfg: TrainConfig
                       ) -> OffloadState:
    """The host state of ``model``. Under ``mixed_precision='bf16'`` each
    floating parameter is first cast to bf16 in place, one at a time, and
    the master starts from that rounding, as the JAX trainer casts its
    parameters before it builds the master; mu and nu start at zero."""
    master = {}
    for name, p in model.named_parameters():
        if cfg.mixed_precision == "bf16" and p.is_floating_point():
            p.data = p.data.to(torch.bfloat16)
        master[name] = p.detach().to("cpu", torch.float32, copy=True)
    return OffloadState(master)


def grad_groups(params: List[torch.Tensor], splits: int) -> List[List[int]]:
    """The parameters' indices in ``splits`` groups balanced by bytes, the
    JAX rule: largest first, each into the lightest group."""
    n = len(params)
    if splits == 1:
        return [list(range(n))]
    order = sorted(range(n), key=lambda i: -params[i].nbytes)
    totals = [0] * min(splits, n)
    groups: List[List[int]] = [[] for _ in totals]
    for i in order:
        gi = totals.index(min(totals))
        groups[gi].append(i)
        totals[gi] += params[i].nbytes
    return [sorted(g) for g in groups if g]


def host_update_(buf: torch.Tensor, master: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, clip: float, lr: float, bc1: float,
                 bc2: float, cfg: TrainConfig) -> None:
    """One parameter's update on the host, chunk by chunk along axis 0:
    its gradient in ``buf`` (the parameter's dtype) to fp32, the shared
    AdamW arithmetic on ``master``, ``mu`` and ``nu``, and the new master
    in the parameter's dtype written back into ``buf``."""
    sizes = chunk_sizes(tuple(master.shape))
    for b, m, u, v in zip(*(t.split(sizes) for t in (buf, master, mu, nu))):
        adamw_update_(m, b.float(), u, v, clip, lr, bc1, bc2, cfg)
        b.copy_(m)


def _transfer_buffers(params: List[torch.Tensor], pin: bool
                      ) -> List[torch.Tensor]:
    """One host tensor per parameter, in the parameters' (one) dtype:
    views of one flat allocation (the pinned allocator rounds each
    allocation up to a power of two, so one buffer wastes less than
    many)."""
    flat = torch.empty(sum(p.numel() for p in params),
                       dtype=params[0].dtype, pin_memory=pin)
    return [v.view(p.shape) for v, p in zip(
        flat.split([p.numel() for p in params]), params)]


class OffloadStep:
    """``step(state, inputs, draws[, denominator]) -> metrics``: the
    offload step (module docstring) in place on ``state``, whose optimizer
    is an :class:`OffloadState` of ``model``; the signature and metrics of
    ``train_state.make_train_step``'s step. The transfer buffers are made
    here, in the parameters' dtype: build the step after the cast. ``grad_splits`` may change
    between steps; :attr:`groups` holds the last step's groups."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 prediction_target: str = "x1", grad_splits: int = 1):
        if cfg.gradient_accumulation_steps > 1:
            raise ValueError("offload step does not support MultiSteps")
        if grad_splits < 1:
            raise ValueError(f"grad_splits must be >= 1, got {grad_splits}")
        self.model, self.cfg = model, cfg
        self.prediction_target = prediction_target
        self.grad_splits = grad_splits
        self.schedule = lr_schedule(cfg)
        self.groups: Optional[List[List[int]]] = None
        params = list(model.parameters())
        self.buffers = _transfer_buffers(
            params, pin=params[0].device.type == "cuda")
        self.split: Dict[str, float] = {}

    def __call__(self, state: TrainState, inputs: LossInputs,
                 draws: LossDraws, denominator=None) -> dict:
        model, cfg = self.model, self.cfg
        names, params = zip(*model.named_parameters())
        dev = params[0].device
        self.groups = grad_groups(list(params), self.grad_splits)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        split = dict.fromkeys(PHASES, 0.0)
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        loss = aux = None
        try:
            for group in self.groups:
                t0 = time.perf_counter()
                mine = set(group)
                for i, p in enumerate(params):
                    p.requires_grad_(i in mine)
                with autocast(cfg, dev):
                    pass_loss, pass_aux = training_loss(
                        model, inputs, draws, input_noise=cfg.input_noise,
                        prediction_target=self.prediction_target,
                        input_output_return=cfg.input_output_return,
                        denominator=denominator)
                if pass_loss.requires_grad:  # a group the loss reaches
                    pass_loss.backward()
                grads = [params[i].grad if params[i].grad is not None
                         else torch.zeros_like(params[i]) for i in group]
                sq += global_norm(grads) ** 2
                sync()
                t1 = time.perf_counter()
                with torch.no_grad():
                    for i, g in zip(group, grads):
                        self.buffers[i].copy_(g, non_blocking=True)
                        params[i].grad = None
                del grads
                sync()
                split["forward_backward"] += t1 - t0
                split["d2h"] += time.perf_counter() - t1
                if loss is None:  # the same draws: every pass's loss
                    loss, aux = pass_loss.detach(), pass_aux
        finally:
            for p in params:
                p.requires_grad_(True)

        t0 = time.perf_counter()
        ost = state.optimizer
        norm = sq.sqrt()
        clip = float(torch.clamp(
            cfg.max_grad_norm / torch.clamp(norm, min=1e-12), max=1.0))
        lr = self.schedule(ost.count)
        ost.count += 1
        bc1 = 1.0 - cfg.adam_beta1 ** ost.count
        bc2 = 1.0 - cfg.adam_beta2 ** ost.count
        with torch.no_grad():
            for name, buf in zip(names, self.buffers):
                host_update_(buf, ost.master[name], ost.mu[name],
                             ost.nu[name], clip, lr, bc1, bc2, cfg)
            t1 = time.perf_counter()
            for p, buf in zip(params, self.buffers):
                p.detach().copy_(buf, non_blocking=True)
        sync()
        split["update"] = t1 - t0
        split["h2d"] = time.perf_counter() - t1
        self.split = split
        state.step += 1
        return {"loss": loss, "grad_norm": norm,
                "per_frame_loss": aux["per_frame_loss"].detach()}


def init_offload_training(model: torch.nn.Module, cfg: TrainConfig,
                          prediction_target: str = "x1"):
    """(the :class:`TrainState` of an offload run over ``model``, its
    :class:`OffloadStep` at ``cfg.offload_grad_splits``): the trainers'
    build of ``offload_optimizer``."""
    state = TrainState(step=0, model=model,
                       optimizer=init_offload_state(model, cfg))
    return state, OffloadStep(model, cfg, prediction_target=prediction_target,
                              grad_splits=cfg.offload_grad_splits)
