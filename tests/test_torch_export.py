"""``cli export``: a training run of the port -> the reference's
safetensors, read back through the JAX package's importer.

A run's checkpoint (its parameters, its EMA, a model with the aux input
head) is exported with the port's command, loaded with the JAX
``load_reference_checkpoint`` and ``videogpt_params_from_torch`` (the path
the JAX package takes for a reference checkpoint), mapped back to torch
names with ``utils.weights.videogpt_state_dict_from_jax``, and compared bit
for bit with the run's tensors. A run whose structure does not match the
flags (the input head, the model size, a LoRA run's adapters) is refused.
"""
import os

import pytest
import torch

from video_gpt_tpu.config import ModelConfig as JModelConfig
from video_gpt_tpu.utils.torch_import import (load_reference_checkpoint,
                                              videogpt_params_from_torch)
from video_gpt_tpu_torch import cli
from video_gpt_tpu_torch.config import ModelConfig
from video_gpt_tpu_torch.models.video_gpt import VideoGPT
from video_gpt_tpu_torch.utils.weights import videogpt_state_dict_from_jax

CFG = ModelConfig.tiny(pos_embed_max_size=192)   # --tiny_model


def _run(tmp_path, input_head=False, step=4):
    """A checkpoint directory of a run (random parameters, the EMA a
    perturbed copy); returns (directory, parameters, EMA)."""
    gen = torch.Generator().manual_seed(1)
    model = VideoGPT(CFG, input_head=input_head).init_random_(gen)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    if input_head:
        sd["input_final_layer.weight"].normal_(generator=gen)
    ema = {k: v + 0.01 * torch.randn(v.shape, generator=gen)
           for k, v in sd.items()}
    ckpt_dir = tmp_path / "checkpoints"
    os.makedirs(ckpt_dir / str(step))
    torch.save({"step": step, "model": sd, "ema": ema, "optimizer": {}},
               ckpt_dir / str(step) / "state.pt")
    return ckpt_dir, sd, ema


@pytest.mark.parametrize("ema,input_head", [(False, False), (True, False),
                                            (False, True)],
                         ids=["params", "ema", "input-head"])
def test_export_reloads_through_jax_bit_equal(tmp_path, capsys, ema,
                                              input_head):
    ckpt_dir, sd, ema_sd = _run(tmp_path, input_head)
    out = tmp_path / "model.safetensors"
    cli.main(["export", "--checkpoint_dir", str(ckpt_dir), "--output",
              str(out), "--tiny_model"] + ["--ema"] * ema
             + ["--input_head"] * input_head)
    assert f"exported step 4{' (EMA)' if ema else ''}" in \
        capsys.readouterr().out
    want = ema_sd if ema else sd
    ref = load_reference_checkpoint(str(out))
    assert set(ref) == set(want)
    params = videogpt_params_from_torch(
        ref, JModelConfig.tiny(pos_embed_max_size=192), input_head=input_head)
    got = videogpt_state_dict_from_jax(params, CFG)
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name


@pytest.mark.parametrize("input_head,flags", [(True, []),
                                              (False, ["--input_head"])])
def test_export_refuses_a_mismatched_input_head(tmp_path, input_head, flags):
    ckpt_dir, _, _ = _run(tmp_path, input_head)
    with pytest.raises(SystemExit, match="--input_output_return but no "
                                         "--input_head"):
        cli.main(["export", "--checkpoint_dir", str(ckpt_dir), "--output",
                  str(tmp_path / "m.safetensors"), "--tiny_model"] + flags)
    assert not (tmp_path / "m.safetensors").exists()


def test_export_refuses_another_model_size(tmp_path):
    ckpt_dir, _, _ = _run(tmp_path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        cli.main(["export", "--checkpoint_dir", str(ckpt_dir), "--output",
                  str(tmp_path / "m.safetensors")])  # the full-width config
    assert not (tmp_path / "m.safetensors").exists()


def test_export_refuses_a_lora_run(tmp_path):
    from video_gpt_tpu_torch.utils.torch_export import \
        videogpt_state_dict_to_reference
    with pytest.raises(ValueError, match="adapters alone"):
        videogpt_state_dict_to_reference(
            {"llm.layers.0.self_attn.qkv_proj.lora_A.weight":
             torch.zeros(8, 64)})
