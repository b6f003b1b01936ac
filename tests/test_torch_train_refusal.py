"""Training on CUDA at what the backward kernels do not take is refused at
build, before any weight is made or CUDA is touched.

The forward kernels take fp32 and every head_dim <= 128; the backward
kernels K7 and K9 are still bf16 at head_dim 96. So ``train`` /
``train-image`` with ``--mixed_precision no`` (fp32 attention) or
``--tiny_model`` (head_dim 16) on a CUDA device would raise inside K9's
or K7's wrapper after a wasted forward: ``Trainer`` and
``ImageGenTrainer`` refuse them first, naming the ROADMAP.md item that
ports the backward kernels there. The CPU keeps running both recipes.
No card is needed: the refusal comes before ``resolve_device``.
"""
import pytest

from video_gpt_tpu_torch.config import ModelConfig, stage_config
from video_gpt_tpu_torch.image_gen import StubTokenizer
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.training import image_trainer, trainer
from video_gpt_tpu_torch.training.image_trainer import ImageGenTrainer
from video_gpt_tpu_torch.training.trainer import (BACKWARD_WIDTHS_ITEM,
                                                  Trainer,
                                                  check_train_device)

# head_dim 96 (the backward kernels' width) and the tiny model's 16
WIDE = ModelConfig.tiny(hidden_size=192, num_heads=2, num_kv_heads=1)
TINY = ModelConfig.tiny()
REFUSED = [(WIDE, "no"), (TINY, "bf16"), (TINY, "no")]


@pytest.fixture
def no_device(monkeypatch):
    """Fail on any step past the refusal: the device, the model."""
    def touched(*a, **k):
        raise AssertionError("the trainer went past its refusal")

    for mod in (trainer, image_trainer):
        monkeypatch.setattr(mod, "resolve_device", touched)


def _video(cfg, mixed, device):
    return Trainer(cfg, stage_config(1, frame_num=2, mixed_precision=mixed),
                   None, vae_cfg=VAEConfig.tiny(), target_resolution=(32, 48),
                   device=device)


def _image(cfg, mixed, device):
    return ImageGenTrainer(cfg, stage_config(1, mixed_precision=mixed), None,
                           None, StubTokenizer(), output_size=(32, 32),
                           vae_cfg=VAEConfig.tiny(), device=device)


@pytest.mark.parametrize("make", [_video, _image])
@pytest.mark.parametrize("cfg,mixed", REFUSED)
def test_trainers_refuse_on_cuda_at_build(no_device, make, cfg, mixed):
    with pytest.raises(NotImplementedError) as e:
        make(cfg, mixed, "cuda")
    msg = str(e.value)
    assert BACKWARD_WIDTHS_ITEM in msg and "ROADMAP.md queue 1" in msg
    if mixed == "no":
        assert "mixed_precision='no'" in msg
    if cfg.head_dim != 96:
        assert f"head_dim {cfg.head_dim}" in msg


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_the_backward_kernels_width_passes(device):
    """bf16 at head_dim 96 is what K7 and K9 take: no refusal."""
    assert check_train_device(WIDE, stage_config(1), device) is None


@pytest.mark.parametrize("make", [_video, _image])
@pytest.mark.parametrize("cfg,mixed", REFUSED)
def test_the_cpu_keeps_those_recipes(make, cfg, mixed):
    t = make(cfg, mixed, "cpu")
    assert t.device.type == "cpu" and t.cfg.mixed_precision == mixed
    assert t.model_cfg.head_dim == cfg.head_dim
