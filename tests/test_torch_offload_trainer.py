"""The offload optimizer in the port's trainers, checkpoints and command
line, on the CPU at a tiny size (the port alone; its numbers against the
JAX package are ``tests/test_torch_offload.py``'s).

- ``Trainer`` with ``offload_optimizer`` and ``offload_grad_splits`` 2 runs
  2 steps, checkpoints, resumes and runs a third: bit-equal to 3 steps
  uninterrupted (parameters, master, mu, nu and count); the checkpoint
  holds the bf16 parameters, as the JAX ``state.params``.
- That checkpoint warm-starts ``cli train --init_checkpoint_dir``.
- Each combination the JAX trainers refuse raises with the JAX message.
- ``cli train --offload_optimizer --offload_grad_splits 2`` and ``cli
  train-image --offload_optimizer`` run a step.
"""
import pytest
import torch

from video_gpt_tpu_torch import cli
from video_gpt_tpu_torch.config import (MeshConfig, ModelConfig, TrainConfig,
                                        check_train_config, stage_config)
from video_gpt_tpu_torch.image_gen import StubTokenizer
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.training.image_trainer import ImageGenTrainer
from video_gpt_tpu_torch.training.offload import OffloadState
from video_gpt_tpu_torch.training.trainer import Trainer
from video_gpt_tpu_torch.utils import checkpoint

from test_torch_image_training import _train_argv
from test_torch_training import _write_videos

COMMON = ["--tiny_model", "--device", "cpu", "--frame_num", "4",
          "--target_resolution", "48", "64", "--lr", "1e-3",
          "--lr_scheduler", "constant", "--log_every", "1"]


def _trainer(videos, results_dir, **kw):
    cfg = stage_config(1, frame_num=4, lr=1e-3, lr_scheduler="constant",
                       log_every=1, ckpt_every=2, offload_optimizer=True,
                       offload_grad_splits=2, results_dir=str(results_dir),
                       **kw)
    return Trainer(ModelConfig.tiny(), cfg, videos, vae_cfg=VAEConfig.tiny(),
                   target_resolution=(48, 64), device="cpu")


def test_trainer_offload_resume_is_bit_equal(tmp_path, capsys):
    videos = str(tmp_path / "videos")
    _write_videos(videos)
    first = _trainer(videos, tmp_path / "run").run(2)
    assert isinstance(first.optimizer, OffloadState)
    saved = torch.load(tmp_path / "run" / "checkpoints" / "2" / "state.pt",
                       weights_only=True)
    assert saved["optimizer"]["count"] == 2 and saved["step"] == 2
    assert all(t.dtype == torch.bfloat16 for t in saved["model"].values())
    assert all(t.dtype == torch.float32
               for t in saved["optimizer"]["master"].values())
    resumed = _trainer(videos, tmp_path / "run").run(3)
    assert "resumed from step 2" in capsys.readouterr().out
    whole = _trainer(videos, tmp_path / "whole").run(3)
    assert resumed.step == whole.step == 3
    assert resumed.optimizer.count == whole.optimizer.count == 3
    for (name, p), q in zip(resumed.model.named_parameters(),
                            whole.model.parameters()):
        assert p.dtype == torch.bfloat16 and torch.equal(p, q), name
    for field in ("master", "mu", "nu"):
        got = getattr(resumed.optimizer, field)
        for name, t in getattr(whole.optimizer, field).items():
            assert torch.equal(got[name], t), (field, name)


def test_offload_checkpoint_warm_starts_a_new_run(tmp_path):
    videos = str(tmp_path / "videos")
    _write_videos(videos)
    cli.main(["train", "--video_dir_path", videos, "--max_steps", "1",
              "--ckpt_every", "1", "--results_dir", str(tmp_path / "off"),
              "--offload_optimizer", *COMMON])
    ckpt_dir = tmp_path / "off" / "checkpoints"
    params, step = checkpoint.load_train_params(str(ckpt_dir))
    assert step == 1
    args = cli.build_parser().parse_args([
        "train", "--video_dir_path", videos, "--max_steps", "1",
        "--results_dir", str(tmp_path / "warm"), "--init_checkpoint_dir",
        str(ckpt_dir), *COMMON])
    trainer = cli.make_trainer(args)
    state = trainer.build()
    assert state.step == 0 and state.optimizer.count == 0
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32
        assert torch.equal(p.detach(), params[name].float()), name


REFUSALS = [
    (dict(distill=True), "does not compose with the single-chip offload"),
    (dict(use_lora=True), "LoRA state fits HBM directly"),
    (dict(use_ema=True), "offload_optimizer does not support EMA"),
    (dict(gradient_accumulation_steps=2), "does not support MultiSteps"),
    (dict(offload_grad_splits=0), "grad_splits must be >= 1, got 0")]


@pytest.mark.parametrize("kw,msg", REFUSALS, ids=[
    "distill", "lora", "ema", "accumulation", "grad_splits_0"])
def test_offload_refuses_what_the_jax_trainer_refuses(kw, msg):
    with pytest.raises(ValueError, match=msg):
        check_train_config(TrainConfig(offload_optimizer=True, **kw))
    with pytest.raises(ValueError, match=msg):
        Trainer(ModelConfig.tiny(), TrainConfig(offload_optimizer=True,
                                                **kw), None, device="cpu")


def test_offload_refuses_a_mesh():
    cfg = TrainConfig(offload_optimizer=True)
    with pytest.raises(ValueError, match="use ZeRO over the mesh"):
        Trainer(ModelConfig.tiny(), cfg, None, device="cpu",
                mesh_cfg=MeshConfig(data=2))
    with pytest.raises(ValueError, match="does not compose with a mesh"):
        ImageGenTrainer(ModelConfig.tiny(), cfg, None, None, StubTokenizer(),
                        device="cpu", mesh_cfg=MeshConfig(tensor=2))


def test_cli_offload_runs_both_trainers(tmp_path, capsys):
    videos = str(tmp_path / "videos")
    _write_videos(videos)
    cli.main(["train", "--video_dir_path", videos, "--max_steps", "1",
              "--ckpt_every", "1", "--results_dir", str(tmp_path / "video"),
              "--offload_optimizer", "--offload_grad_splits", "2", *COMMON])
    cli.main(_train_argv(tmp_path, "--max_steps", "1",
                         "--offload_optimizer"))
    out = capsys.readouterr().out
    assert out.count("step 1: loss=") == 2
    for run in ("video", "run"):
        sd = torch.load(tmp_path / run / "checkpoints" / "1" / "state.pt",
                        weights_only=True)
        assert sd["step"] == sd["optimizer"]["count"] == 1
