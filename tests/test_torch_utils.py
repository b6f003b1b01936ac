"""The port's ``utils.profiling`` (the model-flops arithmetic and MFU) and
``utils.logging`` (``create_logger``) against the JAX package's, on the
CPU: the flop formulas and ``mfu`` equal on the same inputs (they are the
same float arithmetic), ``count_params`` counts the same floating-point
elements, ``peak_flops`` knows the H100's bf16 dense peak and no other
card, and ``trace`` writes a profile with the program's spans in it."""
import contextlib
import logging

import numpy as np
import pytest
import torch

from video_gpt_tpu.utils import profiling as jprofiling
from video_gpt_tpu_torch.config import ModelConfig
from video_gpt_tpu_torch.models.video_gpt import VideoGPT
from video_gpt_tpu_torch.utils import logging as tlogging
from video_gpt_tpu_torch.utils import profiling


@pytest.mark.parametrize("layers,hidden,q,kv", [
    (32, 3072, 7104, 7104), (32, 3072, 1776, 1776), (2, 64, 17, 5328)])
def test_flop_formulas_and_mfu_match_jax(monkeypatch, layers, hidden, q, kv):
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "989")
    n = 3_762_000_000
    assert profiling.dense_model_flops(n, q) == \
        jprofiling.dense_model_flops(n, q)
    assert profiling.attention_flops(layers, hidden, q, kv) == \
        jprofiling.attention_flops(layers, hidden, q, kv)
    flops = 3.0 * (profiling.dense_model_flops(n, q)
                   + profiling.attention_flops(layers, hidden, q, q))
    assert profiling.mfu(flops, 0.979) == jprofiling.mfu(flops, 0.979)
    assert profiling.mfu(flops, 0.979) == flops / 0.979 / 989e12
    assert profiling.mfu(None, 1.0) is None and profiling.mfu(flops, 0) \
        is None


def test_count_params_matches_jax():
    """A module, its state dict and a nested tree with an integer leaf
    (not counted) against the JAX count of the same arrays."""
    model = VideoGPT(ModelConfig.tiny())
    sd = model.state_dict()
    tree = {"a": [torch.zeros(3, 4), torch.zeros(5, dtype=torch.int64)],
            "b": (torch.zeros(2, dtype=torch.bfloat16),)}
    jtree = {"a": [np.zeros((3, 4), np.float32), np.zeros(5, np.int64)],
             "b": (np.zeros(2, np.float16),)}
    want = jprofiling.count_params({k: v.numpy() for k, v in sd.items()})
    assert profiling.count_params(model) == profiling.count_params(sd) \
        == want == sum(p.numel() for p in model.parameters())
    assert profiling.count_params(tree) == jprofiling.count_params(jtree) \
        == 14


def test_peak_flops_by_card_name(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    assert profiling.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert profiling.peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert profiling.peak_flops("TPU v5 lite") is None  # no TPU peak
    if not torch.cuda.is_available():
        assert profiling.peak_flops() is None
        assert profiling.mfu(1e15, 1.0) is None
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "500")
    assert profiling.peak_flops("NVIDIA A100-SXM4-80GB") == 500e12
    assert profiling.peak_flops() == jprofiling.peak_flops() == 500e12


def test_trace_and_force_ready(tmp_path):
    """``trace`` switches the spans on: the span ``annotate`` opens inside
    it is in the written trace, one opened after it is a no-op."""
    x = torch.ones(3)
    with profiling.trace(str(tmp_path / "trace")) as logdir:
        with profiling.annotate("vgt.double"):
            y = profiling.force_ready({"y": [x * 2]})
    assert torch.equal(y["y"][0], torch.full((3,), 2.0))
    files = list(tmp_path.joinpath("trace").iterdir())
    assert files, logdir
    assert any("vgt.double" in f.read_text() for f in files)
    assert isinstance(profiling.annotate("vgt.double"),
                      contextlib.nullcontext)


def test_create_logger_writes_log_txt(tmp_path):
    logger = tlogging.create_logger(str(tmp_path / "run"), name="t_utils")
    try:
        logger.info("hello from the port")
        for h in logger.handlers:
            h.flush()
        text = (tmp_path / "run" / "log.txt").read_text()
        assert text.endswith("hello from the port\n")
        assert text.startswith("[\033[34m")  # the JAX logger's format
        assert tlogging.create_logger(name="t_utils") is logger
        assert logger.level == logging.INFO
    finally:
        for h in list(logger.handlers):
            h.close()
            logger.removeHandler(h)
