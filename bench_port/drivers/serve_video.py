"""Video-GPT serving: ``VideoGPTPipeline.generate``, one video a request,
one client in a closed loop.

Traffic (the cell's ``traffic``): ``height`` / ``width``, ``n_clean`` (the
conditioning frames), ``gen_nums`` (the frames of each generated block),
``steps``, ``guidance``, ``window`` (the context window in frames),
``renoise`` (the recycled frames' re-noise level) and ``time_shift``. The
conditioning frames are the run's, made from its seed; every request draws
its own noise from (seed, request). A request ends with its uint8 frames on
the host.

The comparison takes a sample of the finished requests, drawn from the
seed, and runs the reference over each with the same frames and the same
draws: the generated latents' relative squared error and the emitted
frames' mean absolute difference, the worst over the sample.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from bench_port import flops
from bench_port.harness import program, weights
from bench_port.harness.training import frame_pixels
from bench_port.reference import model as ref
from bench_port.reference.layout import frame_block_inference_layout
from bench_port.reference.serve import rollout


class RecordedNoise:
    """The program's noise: standard-normal draws from one generator on the
    device, each kept so the reference can replay them. Called with two
    arguments it draws in ``dtype`` (the control's runs, which have no
    program to ask for the draws)."""

    def __init__(self, seed: int, device, dtype=None):
        self.device, self.dtype = device, dtype
        self.gen = torch.Generator(device).manual_seed(seed)
        self.draws: List[torch.Tensor] = []

    def __call__(self, kind, shape, dtype=None):
        x = torch.randn(tuple(shape), generator=self.gen, device=self.device,
                        dtype=dtype or self.dtype)
        self.draws.append(x.clone())
        return x

    def replay(self):
        it = iter(self.draws)
        return lambda kind, shape: next(it)


def conditioning_frames(seed: int, n: int, h: int, w: int, device
                        ) -> np.ndarray:
    px = frame_pixels(seed, "context", n, h, w, device)
    return ((px * 0.5 + 0.5) * 255.0).round().to(torch.uint8).cpu().numpy()


class ServeCell:
    def __init__(self, ctx, with_program: bool = True):
        """``with_program`` False sets up the traffic and the reference
        alone (the control's runs)."""
        self.ctx = ctx
        t = ctx.traffic
        self.device = ctx.device
        self.arch, self.vae = ctx.config["model"], ctx.config["vae"]
        self.dtype = program.DTYPES[ctx.config["dtype"]]
        self.frames = conditioning_frames(ctx.seed, t["n_clean"],
                                          t["height"], t["width"],
                                          self.device)
        self.recipe = dict(gen_nums=tuple(t["gen_nums"]),
                           num_inference_steps=t["steps"],
                           img_guidance_scale=t["guidance"],
                           max_frame_window=t["window"],
                           max_input_image_size=max(t["height"], t["width"]),
                           clean_image_noise_level=t["renoise"],
                           time_shifting_factor=t["time_shift"])
        gens = self.recipe["gen_nums"]
        # the first block's context after the window slides, then every
        # generated frame
        self.emitted = sum(gens) + min(t["n_clean"], max(
            t["window"] - gens[0], 0))
        self.work = self.request_work()
        self.outputs: List[tuple] = []
        if not with_program:
            return
        from video_gpt_tpu_torch.sampling.pipeline import VideoGPTPipeline
        sd = weights.draw(ref.param_specs(self.arch), ctx.seed, "model",
                          self.device, self.dtype)
        vsd = weights.draw(ref.vae_param_specs(self.vae), ctx.seed, "vae",
                           self.device, self.dtype)
        self.pipe = VideoGPTPipeline.build(
            program.model_config(ctx.config), program.vae_config(ctx.config),
            device=self.device, dtype=self.dtype, state_dict=sd,
            vae_state_dict=vsd)
        del sd, vsd
        ctx.mark("weights drawn, pipeline built")
        # warm-up: one whole request of the cell's own shapes
        self.request(weights.seed_of(ctx.seed, "warm-up"))
        self.outputs.clear()
        ctx.mark("warm-up request")

    def request(self, seed: int) -> bool:
        noise = RecordedNoise(seed, self.device)
        frames, latents = self.pipe.generate(self.frames, noise=noise,
                                             return_latents=True,
                                             **self.recipe)
        lat = torch.stack(latents)
        self.outputs.append((noise, np.stack(frames), lat))
        return len(frames) == self.emitted and bool(torch.isfinite(lat).all())

    def unit(self, i: int) -> bool:
        return self.request(weights.seed_of(self.ctx.seed, f"request{i}"))

    def end_to_end(self, units: int, wall: float) -> Dict[str, float]:
        gen = sum(self.recipe["gen_nums"])
        return {"request_s": wall / units,
                "serve_frames_per_s": gen * units / wall}

    def request_work(self) -> dict:
        t = self.ctx.traffic
        if len(t["gen_nums"]) != 1:
            raise ValueError("the yardstick counts one generated block")
        n_img = (t["height"] // 16) * (t["width"] // 16)
        gen, n_clean = t["gen_nums"][0], t["n_clean"]
        lay_c = frame_block_inference_layout(n_clean, gen, n_img, False)
        lay_u = frame_block_inference_layout(0, gen, n_img, False)
        return flops.serve_request(self.arch, lay_c, lay_u,
                                   n_clean * (n_img + 2), n_img, t["steps"],
                                   t["guidance"] != 1.0, n_clean, gen)

    def unit_info(self) -> dict:
        return self.work

    def release(self) -> None:
        self.pipe = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison --------------------------------------------------------

    def reference_weights(self):
        P = {k: v.float() for k, v in weights.draw(
            ref.param_specs(self.arch), self.ctx.seed, "model", self.device,
            self.dtype).items()}
        V = {k: v.float() for k, v in weights.draw(
            ref.vae_param_specs(self.vae), self.ctx.seed, "vae", self.device,
            self.dtype).items()}
        return P, V

    def reference(self, P, V, prec, frames, draw):
        t = self.ctx.traffic
        return rollout(P, V, self.arch, self.vae, prec, frames, draw,
                       t["gen_nums"], t["steps"], t["guidance"], t["window"],
                       t["renoise"], t["time_shift"], device=self.device)

    def sample(self) -> List[int]:
        n = len(self.outputs)
        k = min(int(self.ctx.check["sample"]), n)
        rng = np.random.default_rng(weights.seed_of(self.ctx.seed, "sample"))
        return sorted(rng.choice(n, size=k, replace=False).tolist())

    def check(self) -> Dict[str, dict]:
        limits = self.ctx.check["limits"]
        P, V = self.reference_weights()
        prec = ref.Precision(self.ctx.check["reference_precision"])
        worst_lat = worst_px = 0.0
        for i in self.sample():
            t0 = time.perf_counter()
            noise, frames, lat = self.outputs[i]
            want_lat, want_px = self.reference(P, V, prec, self.frames,
                                               noise.replay())
            worst_lat = max(worst_lat, rel_err(lat, want_lat))
            worst_px = max(worst_px, frame_mae(frames, want_px))
            self.ctx.log(f"reference of request {i}: "
                         f"{time.perf_counter() - t0:.1f} s")
        return {"latent_rel_mse": {"value": worst_lat,
                                   "limit": limits["latent_rel_mse"]},
                "frame_mae": {"value": worst_px,
                              "limit": limits["frame_mae"]}}

    def control(self) -> Dict[str, Dict[str, float]]:
        """The compared numbers of the control: the reference one precision
        below the configuration's, in the program's place, over the first
        requests' frames and draws."""
        P, V = self.reference_weights()
        prec = ref.Precision(self.ctx.check["reference_precision"])
        low = ref.Precision("fp8")
        worst_lat = worst_px = 0.0
        for i in range(int(self.ctx.check["sample"])):
            noise = RecordedNoise(weights.seed_of(
                self.ctx.seed, f"request{i}"), self.device, self.dtype)
            want_lat, want_px = self.reference(P, V, prec, self.frames, noise)
            got_lat, got_px = self.reference(P, V, low, self.frames,
                                             noise.replay())
            worst_lat = max(worst_lat, rel_err(got_lat, want_lat))
            worst_px = max(worst_px, frame_mae(got_px.cpu().numpy(),
                                               want_px))
        return {"fp8": {"latent_rel_mse": worst_lat,
                        "frame_mae": worst_px}}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Squared error over the reference's squared magnitude."""
    got, want = got.double().to(want.device), want.double()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(((got - want) ** 2).sum() / (want ** 2).sum())


def frame_mae(got: np.ndarray, want: torch.Tensor) -> float:
    """Mean absolute difference of the uint8 frames, in 8-bit levels."""
    want = want.cpu().numpy()
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got.astype(np.int16) - want.astype(np.int16)).mean())


def build(ctx, with_program: bool = True):
    return ServeCell(ctx, with_program)
