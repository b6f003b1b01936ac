"""Optimizer, schedules, EMA and the train step.

Port of ``video_gpt_tpu/training/train_state.py``. The JAX package chains
``optax.clip_by_global_norm`` and ``optax.adamw`` (wrapped in
``optax.MultiSteps`` under gradient accumulation); :class:`AdamW` computes
the same formulas:

- clip: g * max_norm / ||g|| when ||g|| >= max_norm (no epsilon);
- Adam moments mu = b1 mu + (1-b1) g, nu = b2 nu + (1-b2) g^2, bias
  corrected with the optimizer's own step count, update
  mu_hat / (sqrt(nu_hat) + eps);
- decoupled weight decay on every parameter (norms and biases too), then
  the scheduled learning rate of the step count before the update;
- accumulation: the running mean of the micro-step gradients, one optimizer
  step (and one EMA update) per ``gradient_accumulation_steps``.

The JAX step returns new arrays; the port updates the parameters and the
optimizer state in place, one tensor at a time, so the update holds no
temporary larger than one parameter.

On a mesh (``AdamW(..., mesh=)``, the JAX ``place_train_state`` and the
SPMD partitioner's reductions) each parameter's gradient is reduced in the
backward, as soon as it is complete (a ``post_accumulate_grad`` hook), so
no rank holds its whole fp32 gradient beside its shards:

- summed over ``seq`` for the trunk's layers (each seq rank differentiates
  its own chunk; what runs before ``split_seq`` and after ``gather_seq``
  has its whole gradient already), and averaged over ``data``;
- no reduction over ``tensor``: a sharded parameter's gradient is its own,
  a replicated one's is whole on every tensor rank (``copy_to``; a LoRA
  adapter's through the rank-r intermediate, ``models.phi3``);
- ZeRO-1/2: the moments hold this data rank's part (``mesh.zero_dim``) of
  each parameter, its gradient part arrives by reduce-scatter, the rank
  updates its part and all-gathers the parameter; ZeRO-3: the parameter
  is the part (its gradient part comes from the gather's backward);
- no reduction over ``pipe``: a layer's parameters live on one stage, whose
  gradient is whole there; the pipeline hands every pipe rank the whole
  gradient of what runs before and after the trunk (``parallel.pipeline``);
- the clip's norm sums the squares of each rank's parts over ``data``,
  ``tensor`` and ``pipe``, counting a replicated parameter once;
- under accumulation each micro-step's gradient is reduced (the
  micro-step's norm, a metric, is the global gradient's, as in JAX) and
  the running mean kept in parts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Callable, Dict, List, Optional

import torch

from ..config import TrainConfig
from ..parallel.mesh import (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS,
                             axis_size, zero_dim)
from ..parallel.tensor import TP_SHARDED
from ..utils.profiling import annotate
from .lora import lora_state_dict
from .loss import LossDraws, LossInputs, training_loss


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate of optimizer step ``count`` (0-based), the curves
    of optax's constant, linear-warmup and warmup-cosine schedules."""
    lr, warm = cfg.lr, cfg.lr_warmup_steps
    if cfg.lr_scheduler == "constant":
        return lambda count: lr
    if cfg.lr_scheduler == "constant_with_warmup":
        return lambda count: (_linear(0.0, lr, warm, count) if count < warm
                              else lr)
    if cfg.lr_scheduler == "cosine":
        # decays over the run's step budget (Trainer.run binds
        # cfg.max_steps); any other horizon mis-shapes the schedule
        if not cfg.max_steps:
            raise ValueError(
                "lr_scheduler='cosine' needs TrainConfig.max_steps (the "
                "decay horizon); Trainer.run sets it from its max_steps "
                "argument")
        decay = max(cfg.max_steps, warm + 1) - warm

        def cosine(count: int) -> float:
            if count < warm:
                return _linear(0.0, lr, warm, count)
            c = min(count - warm, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return cosine
    raise ValueError(cfg.lr_scheduler)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, an fp32 device scalar."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def adamw_update_(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                  nu: torch.Tensor, clip, lr: float, bc1: float, bc2: float,
                  cfg: TrainConfig) -> None:
    """AdamW's arithmetic on one tensor, in place: the gradient ``g``
    scaled by ``clip`` (clobbered), the moments ``mu`` and ``nu``, then
    ``p`` moved by ``lr`` (mu_hat / (sqrt(nu_hat) + eps) + wd p), with the
    bias corrections ``bc1`` and ``bc2`` of the step. :class:`AdamW` and
    the host-offloaded update (``training/offload.py``) both call it."""
    b1, b2 = cfg.adam_beta1, cfg.adam_beta2
    g.mul_(clip)
    mu.mul_(b1).add_(g, alpha=1.0 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    upd = (mu / bc1).div_((nu / bc2).sqrt_().add_(cfg.adam_epsilon))
    upd.add_(p, alpha=cfg.adam_weight_decay)
    p.add_(upd, alpha=-lr)


@dataclasses.dataclass(frozen=True)
class Placement:
    """How one parameter sits on the mesh: ``dim``, the dimension of the
    rank's tensor that its optimizer state (and, with ``zero3``, itself)
    is sharded along over ``data`` (None: replicated); ``seq_sum``, its
    gradient is partial per seq rank; ``tp_sharded``, it is a tensor
    rank's own part; ``pipe_staged``, a pipe stage's own layer."""

    dim: Optional[int] = None
    zero3: bool = False
    seq_sum: bool = False
    tp_sharded: bool = False
    pipe_staged: bool = False


def placement(name: str, p: torch.Tensor, mesh) -> Placement:
    """The :class:`Placement` of parameter ``name`` on ``mesh``."""
    zero3 = getattr(p, "zero_dim", None) is not None
    return Placement(
        dim=p.zero_dim if zero3 else zero_dim(p.shape,
                                              axis_size(mesh, DATA_AXIS)),
        zero3=zero3,
        seq_sum=(axis_size(mesh, SEQ_AXIS) > 1
                 and name.startswith("llm.layers.")),
        tp_sharded=(axis_size(mesh, TENSOR_AXIS) > 1 and name.endswith(
            TP_SHARDED)),
        pipe_staged=(axis_size(mesh, PIPE_AXIS) > 1
                     and name.startswith("llm.layers.")))


class AdamW:
    """Clip by global norm, then AdamW with optax's formulas, over
    ``params`` (updated in place from their ``.grad``). On a ``mesh``,
    ``names`` are the parameters' names and the state is ZeRO-sharded
    (module docstring)."""

    def __init__(self, params, cfg: TrainConfig, mesh=None, names=None):
        self.params: List[torch.Tensor] = list(params)
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)
        self.count = 0       # optimizer steps taken (optax's Adam count)
        self.mini_step = 0   # micro-steps into the accumulation cycle
        self.mesh = mesh
        self.places = ([placement(n, p, mesh)
                        for n, p in zip(names, self.params)]
                       if mesh is not None else [Placement()] * len(
                           self.params))
        parts = [self._part(i) for i in range(len(self.params))]
        self.mu = [torch.zeros_like(p) for p in parts]
        self.nu = [torch.zeros_like(p) for p in parts]
        self.acc = ([torch.zeros_like(p) for p in parts]
                    if cfg.gradient_accumulation_steps > 1 else None)
        self.reduced: Optional[List[Optional[torch.Tensor]]] = None
        if mesh is not None and (axis_size(mesh, DATA_AXIS) > 1
                                 or axis_size(mesh, SEQ_AXIS) > 1):
            self.reduced = [None] * len(self.params)
            # the hooks live on the parameters and hold the optimizer
            # weakly: a strong reference would close a cycle through a
            # tensor's hooks that the garbage collector does not see, and
            # keep every parameter and moment of a finished run alive
            ref = weakref.ref(self)
            for i, p in enumerate(self.params):
                p.register_post_accumulate_grad_hook(
                    lambda p, i=i: ref()._reduce(i, p))

    def _part(self, i: int) -> torch.Tensor:
        """This data rank's part of parameter ``i`` (a view)."""
        p, place = self.params[i].data, self.places[i]
        if place.zero3 or place.dim is None:
            return p
        n = axis_size(self.mesh, DATA_AXIS)
        return p.chunk(n, dim=place.dim)[self.mesh.index(DATA_AXIS)]

    def _reduce(self, i: int, p: torch.Tensor) -> None:
        """Parameter ``i``'s gradient, as soon as it is complete, reduced
        to this rank's part of the global gradient."""
        mesh, place = self.mesh, self.places[i]
        g, p.grad = p.grad, None
        n = axis_size(mesh, DATA_AXIS)
        if place.seq_sum:
            mesh.all_reduce(g, SEQ_AXIS, backward=True)
        if n > 1:
            if place.dim is not None and not place.zero3:
                g = mesh.reduce_scatter(g, DATA_AXIS, place.dim,
                                        backward=True)
            elif place.dim is None:
                mesh.all_reduce(g, DATA_AXIS, backward=True)
            g.div_(n)
        self.reduced[i] = g

    def _grads(self) -> List[torch.Tensor]:
        if self.reduced is not None:
            grads = [g if g is not None else torch.zeros_like(self._part(i))
                     for i, g in enumerate(self.reduced)]
            self.reduced = [None] * len(self.params)
            return grads
        for p in self.params:
            if p.grad is None:  # unused this step: optax sees zeros
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def _norm(self, grads) -> torch.Tensor:
        """The global gradient's norm from this rank's parts."""
        if self.mesh is None:
            return global_norm(grads)
        mesh = self.mesh
        axes = (DATA_AXIS, TENSOR_AXIS, PIPE_AXIS)
        first = {a: mesh.index(a) == 0 for a in axes}
        sq = torch.zeros((), device=grads[0].device)
        for g, place in zip(grads, self.places):
            # a part held alike by the ranks of an axis counts once
            if (place.dim is not None or first[DATA_AXIS]) and (
                    place.tp_sharded or first[TENSOR_AXIS]) and (
                    place.pipe_staged or first[PIPE_AXIS]):
                sq = sq + torch.linalg.vector_norm(g.float()) ** 2
        for axis in axes:
            if axis_size(mesh, axis) > 1:
                mesh.all_reduce(sq, axis, backward=True)
        return sq.sqrt()

    def has_updated(self) -> bool:
        """Whether the last :meth:`step` changed the parameters."""
        return self.mini_step == 0 and self.count > 0

    @torch.no_grad()
    @torch.profiler.record_function("AdamW.step")
    def step(self) -> torch.Tensor:
        """Consume the parameters' gradients (set to None after); returns
        this micro-step's gradient norm. Under accumulation the parameters
        change only when the cycle completes (:meth:`has_updated`). A
        profiler sees the clip and the update as the range "AdamW.step"."""
        cfg = self.cfg
        grads = self._grads()
        norm = self._norm(grads)
        k = cfg.gradient_accumulation_steps
        if self.acc is not None:
            for a, g in zip(self.acc, grads):
                a.lerp_(g, 1.0 / (self.mini_step + 1))  # running mean
            self.mini_step = (self.mini_step + 1) % k
            self._clear_grads()
            if self.mini_step != 0:
                return norm
            grads = self.acc
        self._update(grads, norm if self.acc is None else self._norm(grads))
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        self._clear_grads()
        return norm

    def _update(self, grads, norm: torch.Tensor) -> None:
        cfg = self.cfg
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        clip = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm),
                           cfg.max_grad_norm / norm)
        lr = self.schedule(self.count)
        self.count += 1
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for i, (g, m, v) in enumerate(zip(grads, self.mu, self.nu)):
            p = self._part(i)
            adamw_update_(p, g, m, v, clip, lr, bc1, bc2, cfg)
            place = self.places[i]
            if place.dim is not None and not place.zero3 \
                    and axis_size(self.mesh, DATA_AXIS) > 1:
                # ZeRO-1/2: every data rank's updated part, put together
                self.params[i].data.copy_(self.mesh.all_gather(
                    p, DATA_AXIS, place.dim, backward=True))

    def _clear_grads(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        for name in ("mu", "nu", "acc"):
            if getattr(self, name) is not None:
                for dst, src in zip(getattr(self, name), sd[name]):
                    dst.copy_(src)


def make_optimizer(params, cfg: TrainConfig, mesh=None,
                   names=None) -> AdamW:
    return AdamW(params, cfg, mesh=mesh, names=names)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer and the EMA copies, all
    updated in place by the train step. With ``adapters_only`` (LoRA) the
    optimizer and the EMA hold the adapters alone, and so does the
    checkpoint: the frozen base is never written (the JAX package's LoRA
    ``state.params`` is the adapter tree)."""

    step: int
    model: torch.nn.Module
    optimizer: AdamW
    ema: Optional[Dict[str, torch.Tensor]] = None
    adapters_only: bool = False

    def _params(self) -> Dict[str, torch.Tensor]:
        if self.adapters_only:
            return lora_state_dict(self.model)
        return self.model.state_dict()

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self._params(),
                "optimizer": self.optimizer.state_dict(), "ema": self.ema}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        if self.adapters_only:
            params = self._params()
            if set(sd["model"]) != set(params):
                raise ValueError("the checkpoint's adapters do not match "
                                 "the model's")
            for name, t in params.items():
                t.copy_(sd["model"][name])
        else:
            self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.ema is not None:
            for name, t in self.ema.items():
                t.copy_(sd["ema"][name])


def init_train_state(model: torch.nn.Module, cfg: TrainConfig,
                     mesh=None) -> TrainState:
    """The state of ``model`` (built on ``mesh``, if any): AdamW's moments
    made at once in their ZeRO layout, and the EMA in its parameters'."""
    ema = None
    if cfg.use_ema:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    names, params = zip(*model.named_parameters())
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(params, cfg, mesh, names),
                      ema=ema)


def init_lora_train_state(model: torch.nn.Module, cfg: TrainConfig,
                          mesh=None) -> TrainState:
    """The state of a LoRA run: AdamW and the EMA over the adapters (the
    parameters that require a gradient, :func:`lora.freeze_base_`); on a
    ``mesh``, the rank's parts of them, AdamW's moments in their own ZeRO
    layout (the frozen base holds no optimizer state)."""
    adapters = {n: p for n, p in model.named_parameters() if p.requires_grad}
    ema = None
    if cfg.use_ema:
        ema = {n: p.detach().clone() for n, p in adapters.items()}
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(adapters.values(), cfg, mesh,
                                               list(adapters)),
                      ema=ema, adapters_only=True)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: torch.nn.Module,
               decay: float) -> None:
    """ema = ema * decay + params * (1 - decay), in place."""
    for name, p in model.named_parameters():
        e = ema[name]
        e.mul_(decay).add_(p.to(e.dtype), alpha=1.0 - decay)


def ema_update_gated(ema, model, cfg: TrainConfig, optimizer: AdamW) -> None:
    """The EMA update, applied only when the optimizer stepped: under
    gradient accumulation the EMA decays once per completed cycle, not once
    per micro-step."""
    if optimizer.has_updated():
        ema_update(ema, model, cfg.ema_decay)


def autocast(cfg: TrainConfig, device: torch.device):
    """bf16 compute over fp32 parameters under ``mixed_precision='bf16'``.
    No cache of cast weights: with per-layer recompute it would hold a bf16
    copy of every layer's weights through the whole step."""
    if cfg.mixed_precision == "bf16":
        return torch.autocast(device.type, dtype=torch.bfloat16,
                              cache_enabled=False)
    return contextlib.nullcontext()


def loss_step(state: TrainState, loss_fn: Callable, cfg: TrainConfig,
              device: torch.device, update_ema: bool = True) -> dict:
    """``loss_fn()`` (-> loss, aux) under autocast on ``device``, then
    backward, clip and AdamW, and the gated EMA when ``update_ema``, in
    place on ``state``. Metrics are device tensors (reading them waits for
    the device); on a mesh with a data axis the loss is the mean over the
    data ranks (the global batch's), the per-frame losses the rank's. The
    forward and the backward (with its per-layer recompute) are the spans
    ``vgt.train.loss`` and ``vgt.train.backward``."""
    with annotate("vgt.train.loss"), autocast(cfg, device):
        loss, aux = loss_fn()
    with annotate("vgt.train.backward"):
        loss.backward()
    grad_norm = state.optimizer.step()
    if update_ema and state.ema is not None:
        ema_update_gated(state.ema, state.model, cfg, state.optimizer)
    state.step += 1
    loss = loss.detach()
    mesh = state.optimizer.mesh
    if axis_size(mesh, DATA_AXIS) > 1:
        loss = mesh.all_reduce(loss.clone(), DATA_AXIS) / axis_size(
            mesh, DATA_AXIS)
    return {"loss": loss, "grad_norm": grad_norm,
            "per_frame_loss": aux["per_frame_loss"].detach()}


def make_train_step(model: torch.nn.Module, cfg: TrainConfig,
                    prediction_target: str = "x1",
                    apply_fn: Optional[Callable] = None) -> Callable:
    """``step(state, inputs, draws[, denominator]) -> metrics``: loss,
    backward, clip, AdamW and the gated EMA, in place on ``state``
    (``denominator``: ``training_loss``'s, a data rank's).
    ``prediction_target='velocity'`` trains the image family's target;
    ``cfg.input_output_return`` adds the aux input head's loss;
    ``apply_fn`` replaces the model's forward (with its signature): the
    GPipe trunk, ``parallel.pipeline.pp_apply``."""

    def step(state: TrainState, inputs: LossInputs, draws: LossDraws,
             denominator=None):
        return loss_step(state, lambda: training_loss(
            model, inputs, draws, input_noise=cfg.input_noise,
            prediction_target=prediction_target,
            input_output_return=cfg.input_output_return,
            denominator=denominator, apply_fn=apply_fn), cfg,
            inputs.x1.device)

    return step


def make_lora_train_step(model: torch.nn.Module, cfg: TrainConfig
                         ) -> Callable:
    """The train step of a LoRA run (``init_lora_train_state``): the
    training loss through the in-model adapters of ``model`` (built with
    ``ModelConfig.lora_rank > 0``, base frozen), AdamW over the adapters.

    The EMA is left as it is, as the JAX package's ``make_lora_train_step``
    returns ``state.ema_params`` unchanged: under ``use_ema`` the EMA
    adapters stay at their initial values (B = 0), and serving them gives
    the base model."""
    if model.cfg.lora_rank <= 0:
        raise ValueError("make_lora_train_step needs a model built with "
                         "ModelConfig.lora_rank > 0 (in-model adapters)")

    def step(state: TrainState, inputs: LossInputs, draws: LossDraws,
             denominator=None):
        return loss_step(state, lambda: training_loss(
            model, inputs, draws, input_noise=cfg.input_noise,
            input_output_return=cfg.input_output_return,
            denominator=denominator), cfg, inputs.x1.device,
            update_ema=False)

    return step
