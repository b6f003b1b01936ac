"""The program's spans and the benchmark's attribution by span, on the CPU.

- ``utils.profiling.annotate`` is a shared no-op outside ``spans()`` and
  makes no call into the profiler; "AdamW.step" is recorded either way.
- With the spans on, a tiny ``generate`` and a tiny ``Trainer.train_step``
  nest as ``PERF.md`` §3 lists them.
- ``bench_port/harness/spans.py`` on synthetic events: the attribution by
  range is the same with and without the program's spans, a kernel
  launched from another thread is filed under the span open at its
  launch, every kernel is counted exactly once, each idle gap is named by
  its span and host event, and the span reader reads a span's kernels and
  None where the span never ran.
"""
import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_port.harness import spans
from video_gpt_tpu_torch.config import ModelConfig, stage_config
from video_gpt_tpu_torch.data.video import ClipSample, random_block_partition
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.sampling.pipeline import VideoGPTPipeline
from video_gpt_tpu_torch.training.data import collate
from video_gpt_tpu_torch.training.trainer import Trainer
from video_gpt_tpu_torch.utils import profiling

H, W = 32, 48   # 4x6 latents, 6 tokens per frame
STEPS = 3
RECIPE = dict(gen_nums=(2,), num_inference_steps=STEPS,
              img_guidance_scale=1.5, max_frame_window=16)


@pytest.fixture(scope="module")
def pipe():
    return VideoGPTPipeline.build(ModelConfig.tiny(), VAEConfig.tiny(),
                                  device="cpu", dtype=torch.float32, seed=0)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            for _ in range(2)]


@pytest.fixture(scope="module")
def trainer_step():
    """One tiny stage-1 step of the Trainer, ready to run."""
    res = (32, 48)
    trainer = Trainer(ModelConfig.tiny(),
                      stage_config(1, frame_num=3, lr=1e-3,
                                   lr_scheduler="constant"),
                      None, vae_cfg=VAEConfig.tiny(), target_resolution=res,
                      device="cpu", seed=0)
    state = trainer.build()
    pixels = np.random.default_rng(1).uniform(
        -1, 1, (3, *res, 3)).astype(np.float32)
    tb = collate([ClipSample(pixels, random_block_partition(
        3, random.Random(1)))], trainer.n_img)
    step = [0]

    def run():
        trainer.train_step(state, tb, step[0])
        step[0] += 1

    return run


def host_events(fn, on: bool):
    """The host events of ``fn()`` under a CPU profile, the spans on or
    off."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if on:
            with profiling.spans():
                fn()
        else:
            fn()
    return spans.events(prof)[0]


def paths(host):
    return [p for p, _, _ in spans.span_paths(host)]


# ---- (a) spans off ----------------------------------------------------------

def test_annotate_off_is_a_shared_no_op(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    a, b = profiling.annotate("vgt.one"), profiling.annotate("vgt.two")
    assert a is b
    with a:
        pass
    assert calls == []
    with profiling.spans():
        with profiling.spans():
            profiling.annotate("vgt.on")
        profiling.annotate("vgt.still_on")
    assert profiling.annotate("vgt.off") is a
    assert calls == ["vgt.on", "vgt.still_on"]


def test_spans_off_record_no_program_span(pipe, frames, trainer_step):
    """A profile of a request and a step with the spans off holds no
    ``vgt.`` range; the optimizer's "AdamW.step" is always on."""
    host = host_events(lambda: (pipe.generate(frames, seed=1, **RECIPE),
                                trainer_step()), on=False)
    names = {n for n, _, _ in host}
    assert not [n for n in names if n.startswith("vgt.")]
    assert paths(host) == ["AdamW.step"]


# ---- (b) spans on -----------------------------------------------------------

def test_generate_nests_its_spans(pipe, frames):
    got = paths(host_events(
        lambda: pipe.generate(frames, seed=1, **RECIPE), on=True))
    g = "vgt.generate"
    step = f"{g}/vgt.sampler.step"
    assert got == (
        [g, f"{g}/vgt.preprocess", f"{g}/vgt.vae.encode", f"{g}/vgt.layout",
         f"{g}/vgt.model.prefill", f"{g}/vgt.layout"]
        + [step, f"{step}/vgt.model.decode", f"{step}/vgt.model.forward"]
        * STEPS
        + [f"{g}/vgt.vae.decode", f"{g}/vgt.vae.decode", f"{g}/vgt.to_host"])


def test_spans_change_no_output(pipe, frames):
    off = pipe.generate(frames, seed=3, **RECIPE)
    with profiling.spans():
        on = pipe.generate(frames, seed=3, **RECIPE)
    assert len(on) == len(off)
    assert all(np.array_equal(a, b) for a, b in zip(on, off))


def test_train_step_nests_its_spans(trainer_step):
    got = paths(host_events(trainer_step, on=True))
    s = "vgt.train.step"
    assert got == [s, f"{s}/vgt.vae.encode", f"{s}/vgt.train.loss",
                   f"{s}/vgt.train.loss/vgt.model.forward",
                   f"{s}/vgt.train.backward", f"{s}/AdamW.step"]


# ---- (c) the attribution on synthetic events -------------------------------

def k(name, a, b, corr=0):
    return (name, a, b, corr)


def test_range_attribution_ignores_program_spans():
    device = [k("gemm", 10, 20), k("adam", 110, 130), k("add", 140, 150)]
    ranges = [("bench.unit", 0, 200), ("AdamW.step", 100, 135)]
    program = [("vgt.train.step", 0, 200), ("vgt.train.backward", 5, 60),
               ("AdamW.step", 100, 135)]
    want = {("gemm", ""): 10e-9, ("adam", "AdamW.step"): 20e-9,
            ("add", ""): 10e-9}
    assert spans.kernels_by_range(device, ranges) == want
    assert spans.kernels_by_range(device, ranges + program) == want
    rec = spans.record([], device, ranges + program, {}, 1, 1e-6)
    assert sorted(map(tuple, rec["kernels"])) == sorted(
        (n, r, s) for (n, r), s in want.items())


def test_kernel_from_another_thread_lands_in_the_open_span():
    """Backward's kernels are launched by autograd's thread while the main
    thread holds ``vgt.train.backward`` open; they run on the device after
    the span has closed on the host."""
    host = [("vgt.train.step", 0, 1000), ("vgt.train.backward", 100, 400),
            ("aten::mm", 150, 160),           # the main thread's own op
            ("cudaLaunchKernel", 300, 305)]   # from autograd's thread
    device = [k("dkdv_kernel", 450, 900, corr=7), k("adam", 950, 960, 8)]
    rec = spans.record(host, device, [], {7: 300, 8: 930}, 1, 1e-6)
    got = {(n, p): s for n, p, s in rec["span_kernels"]}
    assert got == pytest.approx({
        ("dkdv_kernel", "vgt.train.step/vgt.train.backward"): 450e-9,
        ("adam", "vgt.train.step"): 10e-9})
    assert rec["unlinked_kernels"] == 0
    # with no launch in the trace a kernel is filed by its own start
    rec = spans.record(host, device, [], {}, 1, 1e-6)
    assert {p for _, p, _ in rec["span_kernels"]} == {"vgt.train.step"}
    assert rec["unlinked_kernels"] == 2


def test_every_kernel_is_counted_once():
    """Nested spans, kernels in and outside them: the seconds filed by
    span plus those outside every span are the device total, exactly in
    ns."""
    rng = random.Random(0)
    host, t = [], 0
    for _ in range(20):
        a = t + rng.randint(0, 50)
        b = a + rng.randint(200, 400)
        host.append(("vgt.generate", a, b))
        host.append(("vgt.sampler.step", a + 10, a + 100))
        host.append(("vgt.model.decode", a + 20, a + 60))
        t = b
    launches, device = {}, []
    for corr in range(1, 400):
        at = rng.randint(0, t)
        launches[corr] = at
        start = at + rng.randint(0, 30)
        device.append(k(f"kern{corr % 7}", start, start + rng.randint(1, 9),
                        corr))
    by_span, unlinked = spans.kernels_by_span(
        device, launches, spans.SpanIndex(spans.span_paths(host)))
    assert unlinked == 0
    assert sum(by_span.values()) == sum(b - a for _, a, b, _ in device)
    assert spans.OUTSIDE in {p for _, p in by_span}
    rec = spans.record(host, device, [], launches, 2, 1e-3)
    filed = sum(s["device_s"] for s in rec["spans"].values()) * 2
    outside = sum(s for _, p, s in rec["span_kernels"] if p == spans.OUTSIDE)
    total = sum(s for _, _, s in rec["kernels"])
    assert filed + outside == pytest.approx(total, rel=1e-12)
    assert rec["spans"]["vgt.generate/vgt.sampler.step"]["calls"] == 10
    gaps = spans.idle_gaps(spans._union([(a, b) for _, a, b, _ in device]))
    assert sum(rec["span_idle"].values()) * 2 == pytest.approx(
        sum(length for length, _ in gaps) * 1e-9, rel=1e-12)


def test_idle_gaps_are_named_by_span_and_host_event():
    host = [("bench.unit", 0, 1000), ("vgt.generate", 10, 900),
            ("vgt.to_host", 700, 900), ("cudaMemcpyAsync", 700, 850),
            ("cudaStreamSynchronize", 200, 300)]
    device = [k("a", 100, 200), k("b", 250, 600), k("c", 800, 820),
              k("d", 950, 960), k("e", 1100, 1110)]
    rec = spans.record(host, device, [], {}, 1, 1e-6)
    gaps = rec["breakdown"]["idle_gaps"]
    assert [n for n, _ in gaps] == [
        "vgt.generate / bench.unit", "(outside the program) / bench.unit",
        "vgt.to_host / cudaMemcpyAsync",
        "vgt.generate / cudaStreamSynchronize"]
    assert [s for _, s in gaps] == pytest.approx([200e-9, 140e-9, 130e-9,
                                                  50e-9])
    assert rec["span_idle"] == pytest.approx({
        "vgt.generate": 250e-9, "vgt.generate/vgt.to_host": 130e-9,
        spans.OUTSIDE: 140e-9})
    # a span that opens as a gap begins names it
    host.append(("vgt.layout", 600, 650))
    rec = spans.record(host, device, [], {}, 1, 1e-6)
    assert rec["breakdown"]["idle_gaps"][0][0] == "vgt.layout / bench.unit"


def test_span_reader_reads_its_spans():
    """Two units: the VAE's kernels under its two spans, a GEMM under a
    model call; a record of a program without spans reads None."""
    g = "vgt.generate"
    rec = spans.record(
        [(g, 0, 1000), ("vgt.vae.encode", 0, 100), ("vgt.model.decode",
                                                    200, 300),
         ("vgt.vae.decode", 400, 500)],
        [k("cudnn_conv_fprop", 10, 30, 1), k("nvjet_tst", 210, 290, 2),
         k("group_norm_kernel", 410, 440, 3), k("cudnn_conv_fprop", 450,
                                                460, 4)],
        [], {1: 5, 2: 205, 3: 405, 4: 406}, 2, 1e-6)
    vae = ("vgt.vae.encode", "vgt.vae.decode")
    assert spans.span_device_s(rec, vae) == pytest.approx(30e-9)
    assert spans.span_device_s(rec, vae, include=("conv",)) == \
        pytest.approx(15e-9)
    assert spans.span_device_s(rec, vae, exclude=("conv",)) == \
        pytest.approx(15e-9)
    assert spans.span_device_s(rec, (g,)) == pytest.approx(70e-9)
    bare = spans.record([], [k("cudnn_conv_fprop", 10, 30)], [], {}, 1,
                        1e-6)
    assert spans.span_device_s(bare, vae) is None
    assert bare["span_kernels"] == [["cudnn_conv_fprop", spans.OUTSIDE,
                                     pytest.approx(20e-9)]]
