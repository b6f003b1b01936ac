"""The port stands alone: importing every module of ``video_gpt_tpu_torch``
(and ``chip_smoke.py``) loads no JAX, no Flax and nothing of the JAX
package, and does not build or load the CUDA kernels."""
import os
import pkgutil
import subprocess
import sys

import pytest

import video_gpt_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "video_gpt_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        video_gpt_tpu_torch.__path__, "video_gpt_tpu_torch."))


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for m in ("config", "tokens", "layout", "cli", "data.processor",
              "ops.attention", "ops.flash_attention", "ops._cuda",
              "models.embedders", "models.phi3", "models.video_gpt",
              "models.vae", "sampling.scheduler", "sampling.pipeline",
              "utils.weights", "utils.torch_import", "utils.checkpoint",
              "data.video", "data.prefetch", "training.loss",
              "training.data", "training.train_state", "training.trainer",
              "training.lora", "training.distill",
              "probes.overlap_probe", "image_gen", "data.image_text",
              "training.image_trainer", "utils.torch_export",
              "parallel.distributed", "parallel.mesh", "parallel.tensor",
              "parallel.ulysses", "utils.parity", "parallel.ring",
              "parallel.pipeline", "utils.logging", "utils.profiling",
              "training.offload", "scripts.cfg_drift"):
        assert "video_gpt_tpu_torch." + m in mods, m


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_imports_load_no_jax(target):
    mods = _port_modules() if target == "package" else ["chip_smoke"]
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + ["bad = sorted(m for m in sys.modules if any(",
           "    m == f or m.startswith(f + '.') for f in "
           f"{FORBIDDEN!r}))",
           "print('BAD', bad)",
           "assert not bad, bad",
           "import video_gpt_tpu_torch.ops._cuda as c",
           "assert c.libraries.cache_info().currsize == 0"])
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
