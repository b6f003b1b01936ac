"""LoRA and distillation runs on a mesh through ``cli train`` under
``python -m torch.distributed.run --standalone``, on the CPU: LoRA on
(tensor 2), whose ranks hold parts of two adapters, and on (data 2,
zero3), whose ranks hold ZeRO parts of every adapter; guided
distillation on (data 2, pipe 2), whose checkpoint holds the student
alone.

Each run warm-starts from one base checkpoint (random weights, the heads
too), takes two steps, writes each rank's adapters (and rank 0 the mesh's
record of them, no base entry) and resumes on its mesh for a third. Its
adapters, put together by ``load_lora_adapters`` into the one-rank
layout, equal those of the one-rank run on the same global batch at rtol
1e-4 / atol 1e-6 (slice 2's parameter bar; AdamW's epsilon 1e-3, so that a
near-zero gradient moves its adapter in proportion). ``cli generate
--checkpoint_dir --lora_checkpoint_dir`` serves them, merged, at one rank
and at ``--mesh_tensor 2``: the frames within 1 uint8 level of serving the
one-rank run's adapters (slice 1's frame bar).
"""
import os

import numpy as np
import pytest
import torch

from test_torch_cli import _save_run, _torchrun
from test_torch_training import _write_videos
from video_gpt_tpu_torch import cli
from video_gpt_tpu_torch.config import ModelConfig
from video_gpt_tpu_torch.models.video_gpt import VideoGPT
from video_gpt_tpu_torch.training.lora import is_adapter
from video_gpt_tpu_torch.utils import checkpoint

MESHES = {"tensor2": (["--mesh_tensor", "2"], 2, 1),
          "data2_zero3": (["--mesh_data", "2", "--zero3"], 2, 2)}


def _frames(path):
    from PIL import Image
    return {n: np.asarray(Image.open(path / n)).astype(np.int16)
            for n in sorted(os.listdir(path))}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_lora_run_resumes_loads_and_serves(tmp_path, mesh):
    flags, n, rows = MESHES[mesh]
    videos = str(tmp_path / "videos")
    _write_videos(videos)
    base = tmp_path / "base"
    _save_run(base, VideoGPT(ModelConfig.tiny(pos_embed_max_size=192))
              .init_random_(torch.Generator().manual_seed(0)).state_dict())
    argv = ["train", "--device", "cpu", "--tiny_model", "--video_dir_path",
            videos, "--frame_num", "4", "--target_resolution", "48", "64",
            "--mixed_precision", "no", "--lr", "1e-3", "--lr_scheduler",
            "constant", "--adam_epsilon", "1e-3", "--log_every", "1",
            "--ckpt_every", "2", "--report_to", "none", "--use_lora",
            "--init_checkpoint_dir", str(base)]
    cli.main(argv + ["--results_dir", str(tmp_path / "one"),
                     "--batch_size_per_device", str(rows), "--max_steps",
                     "2"])
    run = ["--results_dir", str(tmp_path / "run"), *flags]
    out = _torchrun(n, argv + run + ["--max_steps", "2"], tmp_path)
    assert out.count("step 2:") == 1, out  # rank 0 alone logs
    ckpt_dir = tmp_path / "run" / "checkpoints"
    assert sorted(os.listdir(ckpt_dir / "2")) == ["mesh.json"] + [
        f"rank{r}.pt" for r in range(n)]
    for r in range(n):
        stored = torch.load(ckpt_dir / "2" / f"rank{r}.pt",
                            weights_only=True)
        assert stored["model"] and all(is_adapter(k)
                                       for k in stored["model"])
    out = _torchrun(n, argv + run + ["--max_steps", "3"], tmp_path)
    assert "resumed from step 2" in out and "step 3:" in out, out

    got, step = checkpoint.load_lora_adapters(str(ckpt_dir))
    want, _ = checkpoint.load_lora_adapters(str(tmp_path / "one" /
                                                "checkpoints"))
    assert step == 2 and set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert any(float(t.abs().max()) > 0 for k, t in got.items()
               if ".lora_B." in k)

    gen = ["generate", "--video_path", os.path.join(videos, "clip0.avi"),
           "--tiny_model", "--device", "cpu", "--dtype", "fp32",
           "--clean_image_num", "2", "--gen_nums", "1",
           "--num_inference_steps", "2", "--img_guidance_scale", "1.5",
           "--max_input_image_size", "80", "--seed", "3",
           "--checkpoint_dir", str(base)]
    served = {}
    for name, lora_dir in (("one", tmp_path / "one" / "checkpoints"),
                           ("mesh_run", ckpt_dir)):
        cli.main(gen + ["--lora_checkpoint_dir", str(lora_dir),
                        "--save_dir", str(tmp_path / "served" / name)])
        served[name] = _frames(tmp_path / "served" / name)
    out = _torchrun(2, gen + ["--lora_checkpoint_dir", str(ckpt_dir),
                              "--mesh_tensor", "2", "--save_dir",
                              str(tmp_path / "served" / "tensor2")],
                   tmp_path)
    assert "merged LoRA adapters (rank 8)" in out, out
    served["tensor2"] = _frames(tmp_path / "served" / "tensor2")
    assert len(served["one"]) == 3
    for name in ("mesh_run", "tensor2"):
        assert set(served[name]) == set(served["one"])
        diff = max(int(np.abs(served[name][k] - f).max())
                   for k, f in served["one"].items())
        assert diff <= 1, (name, diff)


def test_mesh_distill_run_checkpoints_the_student_and_resumes(tmp_path):
    """``cli train --distill --distill_guidance 1.5`` on (data 2, pipe 2,
    2 microbatches) under torch.distributed.run with 4 processes: two
    steps, each rank's part of the student checkpointed (the teacher is
    the warm start and is not written), resumed on its mesh for a third;
    the student put together into the one-rank layout moved off the warm
    start."""
    import json
    videos = str(tmp_path / "videos")
    _write_videos(videos)
    base = tmp_path / "base"
    sd = VideoGPT(ModelConfig.tiny(pos_embed_max_size=192)).init_random_(
        torch.Generator().manual_seed(0)).state_dict()
    _save_run(base, sd)
    argv = ["train", "--device", "cpu", "--tiny_model", "--video_dir_path",
            videos, "--frame_num", "4", "--target_resolution", "48", "64",
            "--mixed_precision", "no", "--lr_scheduler", "constant",
            "--log_every", "1", "--ckpt_every", "2", "--report_to", "none",
            "--distill", "--distill_guidance", "1.5", "--distill_lr", "1e-3",
            "--init_checkpoint_dir", str(base), "--results_dir",
            str(tmp_path / "run"), "--mesh_data", "2", "--mesh_pipe", "2",
            "--pp_microbatches", "2", "--batch_size_per_device", "2"]
    out = _torchrun(4, argv + ["--max_steps", "2"], tmp_path)
    assert out.count("step 2:") == 1, out
    ckpt_dir = tmp_path / "run" / "checkpoints"
    record = json.loads((ckpt_dir / "2" / "mesh.json").read_text())
    assert set(record["zero_dims"]) == set(sd)  # the student's, once
    out = _torchrun(4, argv + ["--max_steps", "3"], tmp_path)
    assert "resumed from step 2" in out and "step 3:" in out, out
    student, step = checkpoint.load_train_params(str(ckpt_dir))
    assert step == 2 and set(student) == set(sd)
    assert all(not torch.equal(student[k], sd[k]) for k in sd
               if k.startswith("llm.layers."))
