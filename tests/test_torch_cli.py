"""The port's ``cli`` against the JAX command's options, on the CPU.

``configs/inference.sh`` (the reference's long-rollout recipe: 56
conditioning frames, two 24-frame clips, an 80-frame window, no re-noise)
must parse with the port's parser and reach the pipeline with its window,
re-noise, image size and prediction type. With the old parser's defaults (a
16-frame window) the window slid every conditioning frame out of the
context: that regression runs here through the tiny pipeline. The command
lines of ``configs/distill_serving.sh`` (two distillation rounds and the
guided student's serving line) parse too. The frame reader (cv2) and,
where the point is the options, the pipeline are patched.
"""
import argparse
import os
import shlex

import numpy as np
import pytest
import torch

from video_gpt_tpu_torch import cli
from video_gpt_tpu_torch.config import ModelConfig
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.models.video_gpt import VideoGPT
from video_gpt_tpu_torch.sampling import pipeline
from video_gpt_tpu_torch.sampling.pipeline import VideoGPTPipeline
from video_gpt_tpu_torch.utils import checkpoint, torch_import

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script_argv(script, command, **subs):
    """The command lines of ``configs/<script>`` after ``-m
    video_gpt_tpu.cli`` whose command is ``command`` (commented-out lines
    included, their ``#`` dropped), each as an argv with the shell
    parameters named in ``subs`` filled in."""
    with open(os.path.join(REPO, "configs", script)) as f:
        lines = [ln.strip().lstrip("#") for ln in f]
    text = "\n".join(lines).replace("\\\n", " ")
    out = []
    for ln in text.splitlines():
        if "-m video_gpt_tpu.cli " + command in ln:
            argv = shlex.split(ln.split("-m video_gpt_tpu.cli", 1)[1])
            out.append([subs.get(a, a) for a in argv])
    return out


def inference_sh_argv(video="clip.mp4", model="ckpt/model.pt",
                      vae="vae.safetensors"):
    """The command line of configs/inference.sh after ``-m
    video_gpt_tpu.cli``, its three positional parameters filled in."""
    argv, = script_argv("inference.sh", "generate",
                        **{"$1": video, "$2": model, "$3": vae})
    return argv


class FakePipe:
    """Records what ``cmd_generate`` hands the pipeline."""

    def __init__(self):
        self.calls = []

    def generate(self, frames, **kw):
        self.calls.append(("generate", frames, kw))
        return []

    def generate_batch(self, inputs, **kw):
        self.calls.append(("generate_batch", inputs, kw))
        return [[] for _ in inputs]


@pytest.fixture
def fake(monkeypatch, tmp_path):
    """The pipeline, the frame reader and the checkpoint loader patched;
    returns (fake pipeline, the frames read per path)."""
    pipe = FakePipe()
    monkeypatch.setattr(VideoGPTPipeline, "build",
                        classmethod(lambda cls, *a, **k: pipe))
    read = {}

    def read_conditioning(path, n):
        read[path] = [np.full((32, 48, 3), len(read), np.uint8)] * n
        return read[path]

    monkeypatch.setattr(cli, "read_conditioning", read_conditioning)
    monkeypatch.setattr(torch_import, "load_reference_checkpoint",
                        lambda path: None)
    monkeypatch.chdir(tmp_path)
    return pipe, read


def test_inference_sh_parses_and_reaches_the_pipeline(fake):
    pipe, read = fake
    argv = inference_sh_argv()
    args = cli.build_parser().parse_args(argv)
    assert (args.cmd, args.video_path, args.clean_image_num) == (
        "generate", "clip.mp4", 56)
    args.fn(args)
    (kind, frames, kw), = pipe.calls
    assert kind == "generate" and len(frames) == 56
    assert kw["gen_nums"] == [24, 24]
    assert kw["max_frame_window"] == 80
    assert kw["clean_image_noise_level"] == 0.0
    assert kw["max_input_image_size"] == 320
    # explicit x1, though a model.pt checkpoint defaults to v
    assert kw["prediction_type"] == "x1"
    assert kw["num_inference_steps"] == 50
    assert kw["img_guidance_scale"] == 1.5
    assert kw["seed"] == 42


def test_model_pt_defaults_to_v(fake):
    pipe, _ = fake
    argv = inference_sh_argv()
    i = argv.index("--prediction_type")
    del argv[i:i + 2]
    cli.main(argv)
    assert pipe.calls[0][2]["prediction_type"] == "v"


def test_old_default_window_emptied_the_context(monkeypatch):
    """Before the repair the port's parser had no --max_frame_window, so a
    run took ``generate``'s default 16-frame window: with 56 conditioning
    frames and a 24-frame clip (56 + 24 > 16) the window slid every
    conditioning frame out, and the clip was generated with no context and
    no prefill. With inference.sh's 80-frame window all 56 stay."""
    args = cli.build_parser().parse_args(
        [a for a in inference_sh_argv() if a not in ("--max_frame_window",
                                                      "80")])
    assert args.max_frame_window == 16
    tpipe = VideoGPTPipeline.build(ModelConfig.tiny(), VAEConfig.tiny(),
                                   device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
              for _ in range(args.clean_image_num)]
    layouts = []
    orig = pipeline.frame_block_inference_layout
    monkeypatch.setattr(pipeline, "frame_block_inference_layout",
                        lambda n_clean, *a, **k: (layouts.append(n_clean),
                                                  orig(n_clean, *a, **k))[1])
    prefills = []
    orig_prefill = tpipe.model.prefill
    monkeypatch.setattr(tpipe.model, "prefill",
                        lambda *a, **k: (prefills.append(1),
                                         orig_prefill(*a, **k))[1])
    for window, n_clean, n_out in ((args.max_frame_window, 0, 24),
                                   (80, 56, 56 + 24)):
        layouts.clear()
        prefills.clear()
        out = tpipe.generate(
            frames, gen_nums=(24,), num_inference_steps=1,
            img_guidance_scale=1.5, max_frame_window=window,
            clean_image_noise_level=args.clean_image_noise_level,
            max_input_image_size=args.max_input_image_size)
        # the cond row's layout (first) and the uncond row's (0 clean)
        assert layouts == [n_clean, 0], window
        assert len(prefills) == (1 if n_clean else 0)
        assert len(out) == n_out


def test_video_path_dir_batches_same_shaped_videos(fake, tmp_path):
    pipe, read = fake
    for name in ("a.mp4", "b.mp4"):
        (tmp_path / name).write_bytes(b"")
    cli.main(["generate", "--video_path_dir", str(tmp_path), "--seed", "7",
              "--clean_image_num", "3", "--gen_nums", "2", "--save_dir",
              str(tmp_path / "out")])
    (kind, inputs, kw), = pipe.calls
    assert kind == "generate_batch" and len(inputs) == 2
    assert kw["seeds"] == [7, 8]
    assert all(x.shape == (3, 32, 48, 3) and x.dtype == np.float32
               for x in inputs)
    assert sorted(read) == sorted(str(tmp_path / n) for n in ("a.mp4",
                                                               "b.mp4"))


@pytest.mark.parametrize("flags,n", [(["--mesh_seq", "2"], 2),
                                     (["--mesh_tensor", "2"], 2)])
def test_mesh_exits_on_a_world_size_mismatch(fake, flags, n):
    """``--mesh_seq S --mesh_tensor T`` serves over S*T processes: one
    process exits with a message before anything is built."""
    with pytest.raises(SystemExit, match=f"serves over {n} processes"):
        cli.main(["generate", "--video_path", "clip.mp4", "--device", "cpu"]
                 + flags)
    assert fake[0].calls == []


def test_distill_serving_sh_parses():
    """Both distillation rounds of configs/distill_serving.sh parse with
    the port's ``train`` parser, and its serving line with ``generate``."""
    subs = {"$1": "videos", "$2": "teacher/checkpoints", "$STEPS": "20000"}
    rounds = [cli.build_parser().parse_args(argv) for argv in
              script_argv("distill_serving.sh", "train", **subs)]
    assert [(a.distill, a.distill_student_steps, a.distill_substeps,
             a.distill_guidance, a.distill_lr, a.init_checkpoint_dir)
            for a in rounds] == [
        (True, 5, 2, 1.5, 1e-4, "teacher/checkpoints"),
        (True, 3, 2, None, 1e-4, "results/distill5g/checkpoints")]
    serve, = script_argv("distill_serving.sh", "generate")
    args = cli.build_parser().parse_args(serve)
    assert (args.checkpoint_dir, args.num_inference_steps,
            args.img_guidance_scale) == ("results/distill5g/checkpoints", 5,
                                         1.0)


def test_lora_without_base_weights_exits(fake):
    with pytest.raises(SystemExit, match="needs base weights"):
        cli.main(["generate", "--video_path", "clip.mp4",
                  "--lora_checkpoint_dir", "lora"])
    assert fake[0].calls == []


def test_checkpoint_dir_loads_a_training_run(monkeypatch, tmp_path):
    """``--checkpoint_dir`` serves the weights of a ``train`` run of the
    port (its latest step, through ``load_train_params``)."""
    cfg = ModelConfig.tiny(pos_embed_max_size=192)
    model = VideoGPT(cfg).init_random_(torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    ckpt_dir = tmp_path / "checkpoints"
    for step in (3, 9):
        os.makedirs(ckpt_dir / str(step))
        torch.save({"step": step, "model": sd, "ema": None},
                   ckpt_dir / str(step) / "state.pt")
    loads, served = [], []
    orig_load = checkpoint.load_train_params
    monkeypatch.setattr(checkpoint, "load_train_params",
                        lambda *a, **k: (loads.append((a, k)),
                                         orig_load(*a, **k))[1])
    monkeypatch.setattr(cli, "read_conditioning",
                        lambda path, n: [np.zeros((32, 48, 3), np.uint8)] * n)
    monkeypatch.setattr(VideoGPTPipeline, "generate",
                        lambda self, frames, **kw: (served.append(self),
                                                    [])[1])
    cli.main(["generate", "--video_path", "clip.mp4", "--checkpoint_dir",
              str(ckpt_dir), "--tiny_model", "--device", "cpu", "--dtype",
              "fp32", "--save_dir", str(tmp_path / "out")])
    assert loads == [((str(ckpt_dir),), dict(step=None, ema=False,
                                             input_head=False))]
    got = served[0].model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    with pytest.raises(ValueError, match="no EMA"):
        cli.main(["generate", "--video_path", "clip.mp4", "--checkpoint_dir",
                  str(ckpt_dir), "--ema", "--tiny_model", "--device", "cpu",
                  "--save_dir", str(tmp_path / "out")])


def _save_run(ckpt_dir, sd, step=1):
    os.makedirs(ckpt_dir / str(step))
    torch.save({"step": step, "model": sd, "ema": None},
               ckpt_dir / str(step) / "state.pt")


def test_generate_serves_an_input_head_run(monkeypatch, tmp_path):
    """``generate --input_head`` serves the weights of a ``train
    --input_output_return`` run, its aux head included; without the flag
    the run is refused with the JAX command's message, as is the flag for
    a run without the head."""
    cfg = ModelConfig.tiny(pos_embed_max_size=192)
    model = VideoGPT(cfg, input_head=True).init_random_(
        torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.input_final_layer.weight.normal_()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    _save_run(tmp_path / "head", sd)
    _save_run(tmp_path / "plain", {k: v for k, v in sd.items()
                                   if not k.startswith("input_final")})
    served = []
    monkeypatch.setattr(cli, "read_conditioning",
                        lambda path, n: [np.zeros((32, 48, 3), np.uint8)] * n)
    monkeypatch.setattr(VideoGPTPipeline, "generate",
                        lambda self, frames, **kw: (served.append(self),
                                                    [])[1])
    argv = ["generate", "--video_path", "clip.mp4", "--tiny_model",
            "--device", "cpu", "--dtype", "fp32", "--save_dir",
            str(tmp_path / "out"), "--checkpoint_dir"]
    cli.main(argv + [str(tmp_path / "head"), "--input_head"])
    got = served[0].model.state_dict()
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    for run, flags in (("head", []), ("plain", ["--input_head"])):
        with pytest.raises(ValueError, match="--input_output_return but no "
                                             "--input_head"):
            cli.main(argv + [str(tmp_path / run)] + flags)
    assert len(served) == 1


@pytest.mark.parametrize("command", ["generate-image", "train-image",
                                     "export"])
def test_image_and_export_parsers_take_every_jax_option(command):
    """Every option of the JAX command parses with the port's (which adds
    ``--device`` to the commands that run a model)."""
    from video_gpt_tpu.cli import build_parser as jax_parser

    def options(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        cmd = sub.choices[command]
        return {a.dest: (a.default, a.nargs, tuple(a.choices or ()))
                for a in cmd._actions if a.dest != "help"}

    port, ref = options(cli.build_parser()), options(jax_parser())
    assert set(ref) <= set(port), set(ref) - set(port)
    assert {k: port[k] for k in ref} == ref
    assert set(port) - set(ref) <= {"device", "fn"}
