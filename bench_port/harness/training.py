"""What the training cells share: one training object built on the seed's
weights and driven through its first steps in set-up, the window's steps
on that same object, and the comparison with the plain reference.

Set-up runs the first ``check.steps`` steps through the window's own call
and feed (the first of them builds the kernels and warms every shape) and
keeps, from the program's own state, each step's loss, each parameter's
first gradient as the optimizer got it (its first moment after one step
over 1 - beta1) and each parameter's change after those steps. After the
window the program is freed, the reference draws the same weights, works
out the same batches and random numbers, runs the same steps, and the
three gaps are compared with their limits (``check_readings``).
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from bench_port.harness import weights
from bench_port.reference import model as ref
from bench_port.reference.train import OptConfig, train_steps

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient


def frame_pixels(seed: int, tag: str, n: int, h: int, w: int, device
                 ) -> torch.Tensor:
    """``n`` synthetic frames [n, h, w, 3] in [-1, 1], made on the device
    from (seed, tag): moving colour gradients at a random phase plus pixel
    noise, rounded to 8-bit levels as decoded video is."""
    gen = torch.Generator(device).manual_seed(weights.seed_of(seed, tag))
    phase = torch.randint(0, 256, (3,), generator=gen, device=device)
    y = torch.arange(h, device=device)[:, None].float()
    x = torch.arange(w, device=device)[None, :].float()
    i = torch.arange(n, device=device).float()[:, None, None]
    base = torch.stack(torch.broadcast_tensors(
        (x + 8 * i + phase[0]) % 256, (2 * y + 4 * i + phase[1]) % 256,
        (x + y + 0 * i + phase[2]) % 256), dim=-1)
    noisy = base + 12.0 * torch.randn(base.shape, generator=gen,
                                      device=device)
    u8 = noisy.clamp(0, 255).floor()
    return (u8 / 255.0 - 0.5) / 0.5


def program_dtype(mixed_precision: str) -> torch.dtype:
    """The compute dtype of a recipe's ``mixed_precision``."""
    return torch.bfloat16 if mixed_precision == "bf16" else torch.float32


def opt_config(cell: dict, target: str) -> OptConfig:
    o = cell["traffic"]["optimizer"]
    return OptConfig(lr=o["lr"], beta1=o["beta1"], beta2=o["beta2"],
                     eps=o["eps"], weight_decay=o["weight_decay"],
                     max_grad_norm=o["max_grad_norm"],
                     input_noise=o["input_noise"], target=target)


def gaps(port: Dict[str, float], want: Dict[str, float],
         names: List[str]) -> float:
    """The worst leaf's |port - reference| over the larger of that leaf's
    reference norm and the median leaf's."""
    if not names:
        return 0.0
    med = float(np.median([want[n] for n in names]))
    worst = 0.0
    for n in names:
        g = abs(port[n] - want[n]) / max(want[n], med, 1e-30)
        if not math.isfinite(port[n]):
            return float("inf")
        worst = max(worst, g)
    return worst


class TrainCell:
    """A training cell. A subclass builds the trainer (``make_trainer``),
    the program's batch of a step (``batch``) and the reference's inputs of
    a step (``reference_step``), and says how many tokens a step holds."""

    target = "x1"

    def __init__(self, ctx, with_program: bool = True):
        """``with_program`` False sets up the traffic and the reference
        alone (the control's runs)."""
        self.ctx = ctx
        self.device = ctx.device
        self.arch = ctx.config["model"]
        self.vae = ctx.config["vae"]
        self.specs = ref.param_specs(self.arch)
        self.ref_names = [s.name for s in self.specs]
        self.opt = opt_config(ctx.cell, self.target)
        self.compute_dtype = program_dtype(ctx.traffic["mixed_precision"])
        self.setup_traffic()
        if not with_program:
            return
        sd = weights.draw(self.specs, ctx.seed, "model", self.device,
                          torch.float32)
        vsd = weights.draw(ref.vae_param_specs(self.vae), ctx.seed, "vae",
                           self.device, torch.float32)
        self.trainer = self.make_trainer(sd, vsd)
        self.state = self.trainer.build()
        sd.clear()
        vsd.clear()
        ctx.mark("weights drawn, trainer built")
        # the program's parameter order, which its optimizer's moments
        # follow (the reference's names are the same set: a strict load)
        self.names = [n for n, _ in self.trainer.model.named_parameters()]
        self.step = 0
        self.losses: List[float] = []
        for _ in range(int(ctx.check["steps"])):
            if not self.unit(self.step):
                break
            ctx.mark(f"set-up step {self.step}")
            if self.step == 1:
                b1 = self.state.optimizer.cfg.adam_beta1
                self.first_grad = {
                    n: float(torch.linalg.vector_norm(m.double())) / (1 - b1)
                    for n, m in zip(self.names, self.state.optimizer.mu)}
        self.check_losses = list(self.losses)
        self.change = self.change_norms(dict(
            self.trainer.model.named_parameters()))
        ctx.log(f"set-up steps: losses {self.check_losses}")

    # -- the window ---------------------------------------------------------

    def unit(self, i: int) -> bool:
        tb = self.batch(self.step)
        out = self.trainer.train_step(self.state, tb, self.step)
        loss, gnorm = float(out["loss"]), float(out["grad_norm"])
        self.losses.append(loss)
        self.step += 1
        return math.isfinite(loss) and math.isfinite(gnorm)

    def end_to_end(self, units: int, wall: float) -> Dict[str, float]:
        return {"train_tokens_per_s": self.tokens * units / wall}

    def unit_info(self) -> dict:
        return self.work

    def release(self) -> None:
        self.trainer = self.state = None
        gc.collect()
        torch.cuda.empty_cache()

    # -- the comparison --------------------------------------------------------

    def change_norms(self, params: Dict[str, torch.Tensor]
                     ) -> Dict[str, float]:
        out = {}
        for group in weights.draw_each_group(self.specs, self.ctx.seed,
                                             "model", self.device,
                                             torch.float32):
            for n, p0 in group.items():
                out[n] = float(torch.linalg.vector_norm(
                    (params[n].detach().float() - p0).double()))
        return out

    def reference_readings(self, prec_mode: str, rows_kept: int = 0):
        """(losses, first gradients, changes) of the reference's steps in
        ``prec_mode``."""
        P = weights.draw(self.specs, self.ctx.seed, "model", self.device,
                         torch.float32)
        V = weights.draw(ref.vae_param_specs(self.vae), self.ctx.seed, "vae",
                         self.device, torch.float32)
        prec = ref.Precision(prec_mode)
        n = int(self.ctx.check["steps"])
        data = [self.reference_step(k, V, prec) for k in range(n)]
        t0 = time.perf_counter()
        losses, first = train_steps(P, self.ref_names, self.arch, prec,
                                    data, self.opt, rows_kept,
                                    self.ctx.check["moments"])
        self.ctx.log(f"reference ({prec_mode}) {n} steps "
                     f"{time.perf_counter() - t0:.1f} s: losses {losses}")
        change = self.change_norms(P)
        del P, V
        gc.collect()
        torch.cuda.empty_cache()
        return losses, first, change

    def check(self) -> Dict[str, dict]:
        mode = self.ctx.check["reference_precision"]
        losses, first, change = self.reference_readings(mode)
        return check_readings(self.ctx.check["limits"], self.check_losses,
                              getattr(self, "first_grad", {}), self.change,
                              losses, first, change, self.ref_names)

    def control(self) -> Dict[str, Dict[str, float]]:
        """The compared numbers of the control (the reference one precision
        below the configuration's, in the program's place) and of the
        faults a training cell can have: part of the batch left out (B >
        1), and a step that leaves the state unchanged (its change reads
        zero; no run needed)."""
        mode = self.ctx.check["reference_precision"]
        base = self.reference_readings(mode)
        limits = self.ctx.check["limits"]

        def numbers(losses, first, change):
            got = check_readings(limits, losses, first, change, *base,
                                 self.ref_names)
            return {k: v["value"] for k, v in got.items()}

        out = {"fp8": numbers(*self.reference_readings("fp8"))}
        if self.rows > 1:
            out["half_batch"] = numbers(*self.reference_readings(
                mode, rows_kept=self.rows // 2))
        out["unchanged"] = numbers(base[0], base[1],
                                   {n: 0.0 for n in self.ref_names})
        out["reference"] = {"losses": base[0]}
        return out


def check_readings(limits, port_losses, port_first, port_change,
                   ref_losses, ref_first, ref_change, names
                   ) -> Dict[str, dict]:
    """The three compared numbers with their limits. Leaves whose reference
    gradient is below a thousandth of the median leaf's move under Adam by
    round-off alone and are left out of the change."""
    if len(port_losses) != len(ref_losses) or not port_first:
        loss_gap = grad_gap = change_gap = float("inf")
    else:
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(port_losses, ref_losses))
        if not all(math.isfinite(x) for x in port_losses):
            loss_gap = float("inf")
        grad_gap = gaps(port_first, ref_first, names)
        med = float(np.median([ref_first[n] for n in names]))
        moved = [n for n in names if ref_first[n] >= EXCLUDE_BELOW * med]
        change_gap = gaps(port_change, ref_change, moved)
    return {"loss_gap": {"value": loss_gap, "limit": limits["loss_gap"]},
            "grad_gap": {"value": grad_gap, "limit": limits["grad_gap"]},
            "change_gap": {"value": change_gap,
                           "limit": limits["change_gap"]}}
