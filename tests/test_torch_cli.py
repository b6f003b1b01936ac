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
import subprocess
import sys

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


def test_train_parser_takes_every_jax_option():
    """Every option of the JAX ``train`` command parses with the port's,
    with the JAX default, nargs and choices (the port adds ``--device``),
    so every line of ``configs/pretrain_multichip_examples.sh`` reaches
    the trainer or its refusal."""
    from video_gpt_tpu.cli import build_parser as jax_parser

    def options(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {a.dest: (a.default, a.nargs, tuple(a.choices or ()))
                for a in sub.choices["train"]._actions if a.dest != "help"}

    port, ref = options(cli.build_parser()), options(jax_parser())
    assert set(ref) <= set(port), set(ref) - set(port)
    assert {k: port[k] for k in ref} == ref
    assert set(port) - set(ref) <= {"device", "fn"}
    recipes = [[a for a in argv if a != ";;"] for argv in script_argv(
        "pretrain_multichip_examples.sh", "train",
        **{"$VIDEOS": "videos", "$STEPS": "100"})]
    parsed = list(map(cli.build_parser().parse_args, recipes))
    meshes = [(a.mesh_data, a.mesh_seq, a.mesh_tensor, a.mesh_pipe, a.zero3)
              for a in parsed]
    # dp_sp, dp_tp_zero3, dp_sp_tp, dp_pp: every recipe runs
    assert meshes == [(2, 4, 1, 1, False), (2, 1, 4, 1, True),
                      (2, 2, 2, 1, False), (2, 1, 1, 4, False)]
    # no option of the command refuses as not ported any more
    import inspect
    assert not hasattr(cli, "NOT_PORTED")
    assert "not ported" not in inspect.getsource(cli)


def test_dp_pp_recipe_reaches_the_trainer(monkeypatch):
    """The ``dp_pp`` recipe of ``configs/pretrain_multichip_examples.sh``
    (data 2 x pipe 4, 4 microbatches, 4 rows a rank) builds the trainer
    of a (data 2, pipe 4) mesh with its recipe; the ring's line too."""
    from video_gpt_tpu_torch.config import MeshConfig
    from video_gpt_tpu_torch.training import trainer as trainer_mod
    made = []

    class Recorder:
        def __init__(self, model_cfg, cfg, *a, mesh_cfg=None, **kw):
            made.append((cfg, mesh_cfg))

    monkeypatch.setattr(trainer_mod, "Trainer", Recorder)
    recipes = [[a for a in argv if a != ";;"] for argv in script_argv(
        "pretrain_multichip_examples.sh", "train",
        **{"$VIDEOS": "videos", "$STEPS": "100"})]
    args = cli.build_parser().parse_args(recipes[3] + ["--device", "cpu"])
    cli.make_trainer(args, MeshConfig(data=2, pipe=4))
    args = cli.build_parser().parse_args(
        recipes[0] + ["--device", "cpu", "--sp_attention", "ring"])
    cli.make_trainer(args, MeshConfig(data=2, seq=4))
    (pp_cfg, pp_mesh), (ring_cfg, _) = made
    assert (pp_cfg.pp_microbatches, pp_cfg.batch_size_per_device,
            pp_mesh.pipe, pp_mesh.data, pp_mesh.num_devices) == (4, 4, 4, 2,
                                                                 8)
    assert ring_cfg.sp_attention == "ring"


@pytest.mark.parametrize("flags,match", [
    (["--mesh_data", "2"], "trains over 2 processes"),
    (["--mesh_seq", "2", "--mesh_tensor", "2"], "trains over 4 processes"),
    (["--mesh_pipe", "2"], "--mesh_pipe 2 trains over 2 processes"),
    (["--mesh_seq", "2", "--sp_attention", "ring"],
     "trains over 2 processes"),
    (["--mesh_data", "2", "--mesh_pipe", "2", "--pp_microbatches", "2"],
     "trains over 4 processes"),
    (["--offload_grad_splits", "0"], "grad_splits must be >= 1")])
def test_train_exits_on_what_it_cannot_run(tmp_path, flags, match):
    """A mesh larger than the launch (one process here) exits with the
    launch it needs (data x seq x tensor x pipe), as ``generate`` does; a
    value the JAX trainer refuses exits with its message; before anything
    is built."""
    with pytest.raises(SystemExit, match=match):
        cli.main(["train", "--video_dir_path", str(tmp_path), "--device",
                  "cpu", "--tiny_model"] + flags)


def test_report_to_tensorboard_writes_results_dir_log(monkeypatch, tmp_path):
    """``--report_to tensorboard`` (the JAX default) hands the trainer a
    ``tensorboardX.SummaryWriter`` of ``results_dir/tensorboard_log`` when
    tensorboardX imports, else no writer; ``none`` never one."""
    import sys
    import types
    made = []
    fake = types.ModuleType("tensorboardX")
    fake.SummaryWriter = lambda path: made.append(path) or ("writer", path)
    args = argparse.Namespace(report_to="tensorboard",
                              results_dir=str(tmp_path / "run"))
    monkeypatch.setitem(sys.modules, "tensorboardX", fake)
    assert cli._log_writer(args) == ("writer", str(tmp_path / "run" /
                                                   "tensorboard_log"))
    args.report_to = "none"
    assert cli._log_writer(args) is None
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # not installed
    args.report_to = "tensorboard"
    assert cli._log_writer(args) is None
    assert made == [str(tmp_path / "run" / "tensorboard_log")]


def _torchrun(n, argv, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), "-m", "video_gpt_tpu_torch.cli",
         *argv], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def test_train_on_a_zero3_tensor_mesh_resumes_serves_and_warm_starts(
        tmp_path, monkeypatch):
    """``cli train --mesh_data 2 --mesh_tensor 2 --zero3`` under
    ``torch.distributed.run`` with 4 CPU processes: two steps, each rank's
    part checkpointed (and rank 0 the mesh's record and train_args.json
    with ``tensor_parallel``), resumed on the same mesh for a third step;
    its checkpoint put together into the one-rank layout (each rank's
    stored part is that layout's part), served by ``cli generate`` on one
    process, and warm-started by a (tensor 2) run."""
    import json
    from test_torch_training import _write_videos
    from video_gpt_tpu_torch.config import MeshConfig
    from video_gpt_tpu_torch.parallel.mesh import Mesh, shard_params_
    from video_gpt_tpu_torch.training.trainer import shard_state_dict
    videos = str(tmp_path / "videos")
    _write_videos(videos)
    run = tmp_path / "run"
    argv = ["train", "--device", "cpu", "--tiny_model", "--video_dir_path",
            videos, "--results_dir", str(run), "--frame_num", "4",
            "--target_resolution", "48", "64", "--mixed_precision", "no",
            "--lr_scheduler", "constant", "--log_every", "1",
            "--ckpt_every", "2", "--report_to", "none"]
    mesh_flags = ["--mesh_data", "2", "--mesh_tensor", "2", "--zero3"]
    out = _torchrun(4, argv + mesh_flags + ["--max_steps", "2"], tmp_path)
    assert out.count("step 2:") == 1, out  # rank 0 alone logs
    ckpt_dir = run / "checkpoints"
    assert sorted(os.listdir(ckpt_dir / "2")) == [
        "mesh.json", "rank0.pt", "rank1.pt", "rank2.pt", "rank3.pt"]
    args_json = json.loads((run / "train_args.json").read_text())
    assert args_json["model"]["tensor_parallel"] == "2"
    out = _torchrun(4, argv + mesh_flags + ["--max_steps", "3"], tmp_path)
    assert "resumed from step 2" in out and "step 3:" in out, out
    # a resume on another mesh is refused, not loaded part for whole
    with pytest.raises(ValueError, match="resume it on its mesh"):
        checkpoint.restore_checkpoint(str(ckpt_dir), None)

    sd, step = checkpoint.load_train_params(str(ckpt_dir))
    assert step == 2  # ckpt_every 2: step 3 wrote none
    cfg = ModelConfig.tiny(pos_embed_max_size=192)
    VideoGPT(cfg, device="meta", train_init=True).load_state_dict(
        sd, strict=True, assign=True)
    for rank in range(4):
        mesh = Mesh(MeshConfig(2, 1, 2, True), rank, {})
        model = shard_params_(VideoGPT(cfg, device="meta", train_init=True,
                                       mesh=mesh), mesh, "cpu")
        stored = torch.load(ckpt_dir / "2" / f"rank{rank}.pt",
                            weights_only=True)["model"]
        for name, part in shard_state_dict(sd, model, mesh).items():
            assert torch.equal(part, stored[name]), (rank, name)

    served = []
    monkeypatch.setattr(cli, "read_conditioning",
                        lambda path, n: [np.zeros((48, 64, 3), np.uint8)] * n)
    monkeypatch.setattr(VideoGPTPipeline, "generate",
                        lambda self, frames, **kw: (served.append(self),
                                                    [])[1])
    cli.main(["generate", "--video_path", "clip.mp4", "--checkpoint_dir",
              str(ckpt_dir), "--tiny_model", "--device", "cpu", "--dtype",
              "fp32", "--save_dir", str(tmp_path / "out")])
    got = served[0].model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items())

    out = _torchrun(2, ["train", "--device", "cpu", "--tiny_model",
                        "--video_dir_path", videos, "--results_dir",
                        str(tmp_path / "warm"), "--frame_num", "4",
                        "--target_resolution", "48", "64",
                        "--mixed_precision", "no", "--lr_scheduler",
                        "constant", "--log_every", "1", "--report_to",
                        "none", "--max_steps", "1", "--init_checkpoint_dir",
                        str(ckpt_dir), "--mesh_tensor", "2"], tmp_path)
    assert "warm-start from" in out and "step 1:" in out, out


def _jax_refusal(make) -> str:
    with pytest.raises(ValueError) as e:
        make()
    return str(e.value)


@pytest.mark.parametrize("case", ["pipe_seq", "pipe_tensor", "pipe_lora",
                                  "layers", "microbatches"])
def test_pipe_refusals_match_jax(tmp_path, case):
    """Each pipe mesh the JAX Trainer refuses, the port's refuses with the
    same message: pipe with seq or with tensor, pipe with LoRA, layers
    the stages do not divide (at construction), rows per rank that the
    microbatches do not divide (the JAX Trainer's build)."""
    from test_torch_training import _write_videos
    from video_gpt_tpu.config import MeshConfig as JMeshConfig
    from video_gpt_tpu.config import ModelConfig as JModelConfig
    from video_gpt_tpu.config import TrainConfig as JTrainConfig
    from video_gpt_tpu.models.vae import VAEConfig as JVAEConfig
    from video_gpt_tpu.training.trainer import Trainer as JTrainer
    from video_gpt_tpu_torch.config import MeshConfig, TrainConfig
    from video_gpt_tpu_torch.models.vae import VAEConfig
    from video_gpt_tpu_torch.training.trainer import Trainer
    videos = str(tmp_path / "videos")
    _write_videos(videos, n=1)
    mesh, train, layers = dict(pipe=2), dict(frame_num=4), 2
    if case == "pipe_seq":
        mesh["seq"] = 2
    elif case == "pipe_tensor":
        mesh["tensor"] = 2
    elif case == "pipe_lora":
        train["use_lora"] = True
    elif case == "layers":
        layers = 3
    else:
        train.update(batch_size_per_device=1, pp_microbatches=2)
    res = (48, 64)

    def jax_trainer():
        return JTrainer(JModelConfig.tiny(num_layers=layers),
                        JTrainConfig(**train), videos,
                        vae_cfg=JVAEConfig.tiny(), target_resolution=res,
                        mesh_cfg=JMeshConfig(**mesh))

    if case == "microbatches":
        jt = jax_trainer()
        want = _jax_refusal(lambda: jt._build(jt._example_batch()))
    else:
        want = _jax_refusal(jax_trainer)
    with pytest.raises(ValueError) as got:
        Trainer(ModelConfig.tiny(num_layers=layers), TrainConfig(**train),
                videos, vae_cfg=VAEConfig.tiny(), target_resolution=res,
                device="cpu", mesh_cfg=MeshConfig(**mesh))
    assert str(got.value) == want


def test_train_image_refuses_a_pipe_as_jax_does(tmp_path):
    """``ImageGenTrainer`` on a pipe mesh: the JAX image trainer's
    message (the JAX ``train-image`` command has no pipe option)."""
    from video_gpt_tpu.config import MeshConfig as JMeshConfig
    from video_gpt_tpu.config import ModelConfig as JModelConfig
    from video_gpt_tpu.config import TrainConfig as JTrainConfig
    from video_gpt_tpu.training.image_trainer import \
        ImageGenTrainer as JImageTrainer
    from video_gpt_tpu_torch.config import MeshConfig, TrainConfig
    from video_gpt_tpu_torch.image_gen import StubTokenizer
    from video_gpt_tpu_torch.training.image_trainer import ImageGenTrainer
    want = _jax_refusal(lambda: JImageTrainer(
        JModelConfig.tiny(), JTrainConfig(), str(tmp_path / "none.json"),
        None, None, mesh_cfg=JMeshConfig(data=2, pipe=2)))
    with pytest.raises(ValueError) as got:
        ImageGenTrainer(ModelConfig.tiny(), TrainConfig(), None, None,
                        StubTokenizer(), device="cpu",
                        mesh_cfg=MeshConfig(data=2, pipe=2))
    assert str(got.value) == want


def _run_mesh_train(tmp_path, n, mesh_flags, extra=()):
    """Two steps of ``cli train`` on a tiny model under torch.distributed.run
    with ``n`` CPU processes, then a third resumed on the same mesh: the
    checkpoint directory (step 2) and the run's output."""
    from test_torch_training import _write_videos
    videos = str(tmp_path / "videos")
    _write_videos(videos)
    run = tmp_path / "run"
    argv = ["train", "--device", "cpu", "--tiny_model", "--video_dir_path",
            videos, "--results_dir", str(run), "--frame_num", "4",
            "--target_resolution", "48", "64", "--mixed_precision", "no",
            "--lr_scheduler", "constant", "--log_every", "1",
            "--ckpt_every", "2", "--report_to", "none", *mesh_flags, *extra]
    out = _torchrun(n, argv + ["--max_steps", "2"], tmp_path)
    assert out.count("step 2:") == 1, out  # rank 0 alone logs
    ckpt_dir = run / "checkpoints"
    assert sorted(os.listdir(ckpt_dir / "2")) == ["mesh.json"] + [
        f"rank{r}.pt" for r in range(n)]
    out = _torchrun(n, argv + ["--max_steps", "3"], tmp_path)
    assert "resumed from step 2" in out and "step 3:" in out, out
    return ckpt_dir


def _check_parts(ckpt_dir, mesh_cfg, n):
    """The checkpoint put together into the one-rank layout (every
    parameter of the model, once) holds each rank's stored parameters."""
    from video_gpt_tpu_torch.parallel.mesh import Mesh
    from video_gpt_tpu_torch.training.trainer import shard_state_dict
    sd, step = checkpoint.load_train_params(str(ckpt_dir))
    assert step == 2
    cfg = ModelConfig.tiny(pos_embed_max_size=192)
    VideoGPT(cfg, device="meta", train_init=True).load_state_dict(
        sd, strict=True, assign=True)
    for rank in range(n):
        mesh = Mesh(mesh_cfg, rank, {})
        model = VideoGPT(cfg, device="meta", train_init=True, mesh=mesh)
        stored = torch.load(ckpt_dir / "2" / f"rank{rank}.pt",
                            weights_only=True)["model"]
        mine = shard_state_dict(sd, model, mesh)
        assert set(mine) == set(stored), rank
        for name, part in mine.items():
            assert torch.equal(part, stored[name]), (rank, name)


def test_train_on_a_data_pipe_mesh_resumes_and_loads(tmp_path):
    """``cli train --mesh_data 2 --mesh_pipe 2 --pp_microbatches 2`` (2
    rows a rank) under torch.distributed.run with 4 CPU processes: two
    steps, each rank's stage checkpointed, resumed on the same mesh; the
    checkpoint put together by ``load_train_params`` into the one-rank
    layout, equal to every rank's parameters."""
    from video_gpt_tpu_torch.config import MeshConfig
    ckpt_dir = _run_mesh_train(
        tmp_path, 4, ["--mesh_data", "2", "--mesh_pipe", "2",
                      "--pp_microbatches", "2"],
        ["--batch_size_per_device", "2"])
    _check_parts(ckpt_dir, MeshConfig(data=2, pipe=2), 4)


def test_train_with_the_ring_resumes_and_loads(tmp_path):
    """``cli train --mesh_seq 2 --sp_attention ring`` under
    torch.distributed.run with 2 CPU processes: two steps, resumed on the
    same mesh, the checkpoint loaded into one rank equal to the ranks'
    parameters."""
    from video_gpt_tpu_torch.config import MeshConfig
    ckpt_dir = _run_mesh_train(tmp_path, 2, ["--mesh_seq", "2",
                                             "--sp_attention", "ring"])
    _check_parts(ckpt_dir, MeshConfig(seq=2), 2)
