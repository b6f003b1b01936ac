"""Training on CUDA at every dtype and head width the kernels take.

The backward kernels K9 and K7 take what the forward kernels take (bf16
and fp32 operands, any head_dim <= 128 that is a multiple of 8), so
``Trainer`` and ``ImageGenTrainer`` build for a CUDA device with
``--mixed_precision no`` (fp32 attention) and ``--tiny_model`` (head_dim
16) alike: each goes on to ``resolve_device``, here a stand-in that
raises a sentinel, so no card is needed. ``backward_kernel`` names the
kernel each recipe's backward runs. The CPU keeps running both recipes.
"""
import pytest
import torch

from video_gpt_tpu_torch.config import ModelConfig, stage_config
from video_gpt_tpu_torch.image_gen import StubTokenizer
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.ops import flash_attention as fa
from video_gpt_tpu_torch.training import image_trainer, trainer
from video_gpt_tpu_torch.training.image_trainer import ImageGenTrainer
from video_gpt_tpu_torch.training.trainer import Trainer

# head_dim 96 (the flagship's) and the tiny model's 16
WIDE = ModelConfig.tiny(hidden_size=192, num_heads=2, num_kv_heads=1)
TINY = ModelConfig.tiny()
RECIPES = [(WIDE, "no"), (TINY, "bf16"), (TINY, "no")]


class Reached(Exception):
    """The trainer got to ``resolve_device``."""


@pytest.fixture
def sentinel_device(monkeypatch):
    def reached(device):
        raise Reached(device)

    for mod in (trainer, image_trainer):
        monkeypatch.setattr(mod, "resolve_device", reached)


def _video(cfg, mixed, device):
    return Trainer(cfg, stage_config(1, frame_num=2, mixed_precision=mixed),
                   None, vae_cfg=VAEConfig.tiny(), target_resolution=(32, 48),
                   device=device)


def _image(cfg, mixed, device):
    return ImageGenTrainer(cfg, stage_config(1, mixed_precision=mixed), None,
                           None, StubTokenizer(), output_size=(32, 32),
                           vae_cfg=VAEConfig.tiny(), device=device)


@pytest.mark.parametrize("make", [_video, _image])
@pytest.mark.parametrize("cfg,mixed", RECIPES)
def test_trainers_build_on_cuda(sentinel_device, make, cfg, mixed):
    """No refusal before the device: the trainer reaches
    ``resolve_device`` with the CUDA device it was given."""
    with pytest.raises(Reached) as e:
        make(cfg, mixed, "cuda")
    assert e.value.args == ("cuda",)


@pytest.mark.parametrize("cfg,mixed,kernel,dp", [
    (WIDE, "bf16", "bf16", 96), (WIDE, "no", "fp32", 96),
    (TINY, "bf16", "bf16", 32), (TINY, "no", "fp32", 32)])
def test_each_recipe_has_a_backward_kernel(cfg, mixed, kernel, dp):
    """The backward of each recipe's attention: the tensor-core K9 / K7
    under bf16, ``fp32_attention_bwd.cu`` under fp32, at the padded width
    of the model's head_dim."""
    dtype = torch.float32 if mixed == "no" else torch.bfloat16
    choice = fa.backward_kernel([dtype] * 3, cfg.head_dim, cfg.num_heads,
                                cfg.num_kv_heads)
    assert choice == fa.KernelChoice(kernel, dp)
    assert choice == fa.forward_kernel([dtype] * 3, cfg.head_dim,
                                       cfg.num_heads, cfg.num_kv_heads)


@pytest.mark.parametrize("make", [_video, _image])
@pytest.mark.parametrize("cfg,mixed", RECIPES)
def test_the_cpu_keeps_those_recipes(make, cfg, mixed):
    t = make(cfg, mixed, "cpu")
    assert t.device.type == "cpu" and t.cfg.mixed_precision == mixed
    assert t.model_cfg.head_dim == cfg.head_dim
