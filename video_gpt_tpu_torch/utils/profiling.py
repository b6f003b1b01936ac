"""Profiler hooks and model-flops utilisation (MFU).

Port of ``video_gpt_tpu/utils/profiling.py``:

- :func:`annotate` is the program's span: a named range at a layer
  boundary (``vgt.generate``, ``vgt.model.decode``, ``vgt.vae.encode``,
  ...). Spans are off by default, and then ``annotate`` returns one shared
  no-op context without a call into the profiler. Inside :func:`spans`
  each is a ``torch.profiler.record_function``, which the profiler keeps
  on the clock of the card's kernels;
- :func:`trace` writes a ``torch.profiler`` trace of a region (the card's
  kernels and the host's ranges, the spans switched on) to a directory,
  readable by TensorBoard's profile plugin or Perfetto;
- :func:`force_ready` waits for the device that computed an output;
- the model-flops arithmetic that ``bench.py`` and ``bench_suite.py``
  report, in the same formulas: :func:`count_params`,
  :func:`dense_model_flops` (2PT), :func:`attention_flops` (QK^T and PV)
  and :func:`mfu` against :func:`peak_flops`, the card's bf16 dense peak
  by its name.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

# bf16 dense tensor-core peak per card, by device name: the H100 SXM's
# 989 TFLOP/s (NVIDIA's H100 datasheet; PCIe and NVL cards have other
# peaks and are not listed). A name not listed has no known peak.
_PEAK_BF16_TFLOPS = (
    ("NVIDIA H100 80GB HBM3", 989.0),
)


_NO_SPAN = contextlib.nullcontext()


class _Spans:
    """How many :func:`spans` regions are open, in any thread: the
    profiler they feed is one per process too."""
    open = 0


@contextlib.contextmanager
def spans():
    """Switch the program's spans (:func:`annotate`) on for the region."""
    _Spans.open += 1
    try:
        yield
    finally:
        _Spans.open -= 1


def annotate(name: str):
    """The program's span ``name``: inside :func:`spans` a named range of
    the profile (``torch.profiler.record_function``), outside it a shared
    no-op context."""
    if not _Spans.open:
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str = "video_gpt_tpu_torch_trace",
          annotate: str = "video_gpt_tpu_torch"):
    """Profile the region (the host, and the card when there is one) into
    a Chrome trace under ``logdir``, the whole region a range named
    ``annotate`` and the program's spans switched on; yields ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        with spans(), torch.profiler.record_function(annotate):
            yield logdir


def force_ready(out):
    """Wait for the device that computed ``out`` (a tensor or a nested
    list, tuple or dict of them) to finish its queued work; returns
    ``out``. A no-op for outputs on the CPU."""
    leaves = [out]
    while leaves:
        x = leaves.pop()
        if isinstance(x, dict):
            leaves.extend(x.values())
        elif isinstance(x, (list, tuple)):
            leaves.extend(x)
        elif isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
            return out
    return out


def peak_flops(device=None) -> Optional[float]:
    """The bf16 dense peak in FLOP/s of the card ``device`` (a
    ``torch.device``, an index, or a device name; default: card 0), or
    None when the card is unknown or absent. The ``BENCH_PEAK_TFLOPS``
    environment variable (a number, in TFLOP/s) overrides it."""
    env = os.environ.get("BENCH_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    elif torch.cuda.is_available():
        name = torch.cuda.get_device_name(device)
    else:
        return None
    for prefix, tf in _PEAK_BF16_TFLOPS:
        if name.startswith(prefix):
            return tf * 1e12
    return None


def count_params(tree) -> int:
    """Elements of the floating-point tensors of ``tree``: a module, a
    state dict, or a nested list / tuple / dict of tensors (the 'P' of
    the 2PT / 6PT model-flops accounting)."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    n, leaves = 0, [tree]
    while leaves:
        x = leaves.pop()
        if isinstance(x, dict):
            leaves.extend(x.values())
        elif isinstance(x, (list, tuple)):
            leaves.extend(x)
        elif isinstance(x, torch.Tensor) and x.is_floating_point():
            n += x.numel()
    return n


def dense_model_flops(n_params: int, q_tokens: int) -> float:
    """Dense (matmul) model flops of one forward over ``q_tokens`` tokens:
    the standard 2*P*T estimate (Kaplan et al.; PaLM appendix B). The
    embedding gather is counted as if it were a matmul (a small
    overcount) and per-element ops are ignored."""
    return 2.0 * float(n_params) * float(q_tokens)


def attention_flops(num_layers: int, hidden: int, q_tokens: int,
                    kv_tokens: int) -> float:
    """QK^T + PV matmul flops: 2 * q * kv * hidden each, per layer (GQA
    shares K/V across query heads, but every query head still multiplies
    against its group's keys, so the count does not depend on the head
    layout). An upper bound: the kernels skip the tiles a mask hides."""
    return 4.0 * float(num_layers) * float(hidden) * float(q_tokens) \
        * float(kv_tokens)


def mfu(flops, seconds, device=None) -> Optional[float]:
    """flops / seconds / the card's peak; None when one is unknown."""
    peak = peak_flops(device)
    if not flops or not seconds or not peak:
        return None
    return flops / seconds / peak
