"""The port's progressive step- and guidance distillation
(``training.distill``, ``collate(uncond=True)``) against the JAX package on
the CPU.

- ``collate(uncond=True)``: the unconditional branch's batch bit-equal to
  the JAX ``batch_uncond``, also at stage 4's 80 frames.
- ``teacher_rollout`` with the model as the teacher: rtol 1e-5 / atol 1e-6
  (an Euler update of fp32 latents by predictions that agree at the model
  bar).
- ``distillation_loss`` with the JAX loss's own draws (its
  ``jax.random.split`` of the step key replayed into a ``DistillDraws``),
  a teacher that differs from the student: loss at rtol 1e-5; student
  gradients vs ``jax.grad`` at rtol 1e-4 / atol 1e-6 (the training tests'
  bar), the teacher without a gradient. Uniform and endpoint weights,
  m = 1 and 2, guided and not, ``input_noise`` 1 and 0.9, on the bias
  route (plain K3 / K9), and one guided case on the inline route
  (``precompute_bias_limit=0``: plain K6 / K7).
- The Trainer's guided step pays each layout's bias once: two biases, 6
  plain K3 forwards and 1 K9 backward per layer; the unguided step one
  bias, 4 and 1.
- The refusals of the JAX trainer, the warning for a random teacher,
  ``distill_lr`` in the optimizer, a bf16 teacher equal to the fp32 one
  under autocast, and ``Trainer.run`` with guidance on videos written
  with cv2, resumed.
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_training import (BLOCKS, C, F, HL, N_IMG, WL, _count_calls,
                                 _pixels, _write_videos)
from video_gpt_tpu.config import ModelConfig as JModelConfig
from video_gpt_tpu.data.video import ClipSample as JClipSample
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.sampling.scheduler import sigma_schedule as jsigmas
from video_gpt_tpu.training import distill as jdistill
from video_gpt_tpu.training.data import collate as jcollate
from video_gpt_tpu_torch import cli
from video_gpt_tpu_torch.config import (ModelConfig, TrainConfig,
                                        check_train_config, stage_config)
from video_gpt_tpu_torch.data.video import ClipSample, random_block_partition
from video_gpt_tpu_torch.models import video_gpt
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.models.video_gpt import VideoGPT
from video_gpt_tpu_torch.training import trainer as trainer_mod
from video_gpt_tpu_torch.training.data import collate
from video_gpt_tpu_torch.training.distill import (DistillDraws,
                                                  distillation_loss,
                                                  teacher_rollout)
from video_gpt_tpu_torch.training.trainer import Trainer
from video_gpt_tpu_torch.utils.weights import videogpt_state_dict_from_jax

S = 3  # the student's steps
TINY = dict(pos_embed_max_size=8)
STAGE4_BLOCKS = (random_block_partition(80, random.Random(0)),)


def _batches(blocks=BLOCKS):
    frames = sum(blocks[0])

    def samples(cls):
        return [cls(_pixels(i, frames), b) for i, b in enumerate(blocks)]

    return (jcollate(samples(JClipSample), N_IMG, uncond=True),
            collate(samples(ClipSample), N_IMG, uncond=True))


@pytest.mark.parametrize("blocks", [BLOCKS, STAGE4_BLOCKS],
                         ids=["stage1", "stage4-80-frames"])
def test_collate_uncond_matches_jax(blocks):
    jt, tt = _batches(blocks)
    jb, tb = jt.inputs.batch_uncond, tt.inputs.batch_uncond
    F_ = sum(blocks[0])
    assert tb.input_ids.shape == (len(blocks), F_ * (N_IMG + 2))
    pairs = [(getattr(jb, n), getattr(tb, n)) for n in tb._fields
             if n != "meta"] + list(zip(jb.meta, tb.meta))
    for want, got in pairs:
        want = np.array(want)
        assert got.dtype == torch.from_numpy(want).dtype, (got.dtype, want)
        np.testing.assert_array_equal(got.numpy(), want)
    assert collate([ClipSample(_pixels(0), BLOCKS[0])],
                   N_IMG).inputs.batch_uncond is None


@pytest.fixture(scope="module")
def models():
    """(JAX model, student params, teacher params): every leaf perturbed,
    the teacher off the student by another draw."""
    jm = JVideoGPT(JModelConfig.tiny(**TINY), dtype=jnp.float32,
                   train_init=True)
    jt, _ = _batches()
    nn_, nc = int(jt.noisy_sel.shape[0]), int(jt.clean_sel.shape[0])
    params = jm.init(jax.random.PRNGKey(1), jt.inputs.batch,
                     jnp.zeros((nn_, HL, WL, C)), jnp.zeros((nn_,)),
                     jnp.zeros((nc, HL, WL, C)))
    rng = np.random.default_rng(0)
    student = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32), params)
    teacher = jax.tree.map(
        lambda x: x + 0.02 * rng.standard_normal(x.shape).astype(np.float32),
        student)
    return jm, student, teacher


def _pair(student_steps=S):
    """(JAX inputs, port inputs, step key, the JAX loss's draws)."""
    jt, tt = _batches()
    lat = np.random.default_rng(5).standard_normal(
        (len(BLOCKS) * F, HL, WL, C)).astype(np.float32)
    jin = jt.inputs._replace(x1=jnp.take(lat, jt.noisy_sel, axis=0),
                             clean_latents=jnp.take(lat, jt.clean_sel,
                                                    axis=0))
    tl = torch.from_numpy(lat)
    tin = tt.inputs._replace(x1=tl[tt.noisy_sel.long()],
                             clean_latents=tl[tt.clean_sel.long()])
    key = jax.random.PRNGKey(7)
    r_x0, r_i, r_x0c, r_tc = jax.random.split(key, 4)
    nc = jin.clean_latents.shape[0]
    draws = DistillDraws(*(torch.from_numpy(np.array(x)) for x in (
        jax.random.normal(r_x0, jin.x1.shape, jnp.float32),
        jax.random.randint(r_i, (len(BLOCKS), F), 0, student_steps),
        jax.random.normal(r_x0c, jin.clean_latents.shape),
        jax.random.uniform(r_tc, (nc,)))))
    return jin, tin, key, draws._replace(index=draws.index.long())


def _port(params, **cfg):
    tm = VideoGPT(ModelConfig.tiny(**TINY, **cfg), train_init=True)
    tm.load_state_dict(videogpt_state_dict_from_jax(params, tm.cfg),
                       strict=True)
    return tm


def test_teacher_rollout_matches_jax(models):
    jm, _, teacher = models
    jin, tin, _, _ = _pair()
    m = 2
    sig = jsigmas(S * m)
    start = np.array([0, 2, 4, 2, 0, 4], np.int32)
    zt = np.random.default_rng(3).standard_normal(jin.x1.shape).astype(
        np.float32)
    want = jdistill.teacher_rollout(jm.apply, teacher, jin.batch,
                                    jnp.asarray(zt), jin.clean_latents,
                                    jnp.asarray(sig), jnp.asarray(start), m)
    tm = _port(teacher)
    got = teacher_rollout(
        lambda z, t, cl: tm(tin.batch, z, t, cl), torch.from_numpy(zt),
        tin.clean_latents, torch.from_numpy(sig),
        torch.from_numpy(start).long(), m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert float((got - torch.from_numpy(zt)).abs().max()) > 1e-2


def _check_loss_and_grads(models, loss_weight, m, guidance, input_noise,
                          **cfg):
    jm, student, teacher = models
    jin, tin, key, draws = _pair()
    kw = dict(student_steps=S, substeps=m, input_noise=input_noise,
              loss_weight=loss_weight, cfg_scale=guidance)

    def loss_fn(p):
        return jdistill.distillation_loss(jm, {"params": p}, teacher, key,
                                          jin, max_blocks=F, **kw)

    (want, jaux), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        student["params"])
    want_g = videogpt_state_dict_from_jax(jax.device_get(jgrads),
                                          ModelConfig.tiny(**TINY))
    tm = _port(student, **cfg)
    tt = _port(teacher, **cfg).requires_grad_(False)
    loss, aux = distillation_loss(tm, tt, tin, draws, **kw)
    loss.backward()
    np.testing.assert_allclose(aux["per_frame_loss"].detach().numpy(),
                               np.asarray(jaux["per_frame_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert float(tm.llm.layers[0].self_attn.qkv_proj.weight.grad.abs()
                 .max()) > 0
    assert all(p.grad is None for p in tt.parameters())


@pytest.mark.parametrize("loss_weight,m,guidance,input_noise", [
    ("uniform", 1, None, 1.0), ("uniform", 2, 1.5, 1.0),
    ("endpoint", 2, None, 0.9), ("endpoint", 1, 1.5, 0.9)])
def test_distillation_loss_matches_jax(models, loss_weight, m, guidance,
                                       input_noise):
    _check_loss_and_grads(models, loss_weight, m, guidance, input_noise)


def test_guided_distillation_on_the_inline_route(models, monkeypatch):
    """With no bias precomputed every forward runs the plain K6 and the
    student's backward the plain K7: 2 substeps x (cond, uncond) teacher
    forwards + the student's forward per layer, one backward."""
    calls = _count_calls(monkeypatch, "inline_attention_reference",
                         "inline_attention_backward_reference",
                         "bias_attention_reference")
    _check_loss_and_grads(models, "uniform", 2, 1.5, 1.0,
                          precompute_bias_limit=0)
    nl = ModelConfig.tiny().num_layers
    assert calls == {"inline_attention_reference": 5 * nl,
                     "inline_attention_backward_reference": nl,
                     "bias_attention_reference": 0}


def _frames(res=(32, 48), frames=4):
    return np.random.default_rng(0).uniform(
        -1, 1, (frames, *res, 3)).astype(np.float32)


def _tiny_trainer(res=(32, 48), frames=4, **kw):
    cfg = stage_config(1, frame_num=frames, lr=1e-3, lr_scheduler="constant",
                       distill=True, **kw)
    init = VideoGPT(ModelConfig.tiny()).init_random_(
        torch.Generator().manual_seed(2)).state_dict()
    return Trainer(ModelConfig.tiny(), cfg, None, vae_cfg=VAEConfig.tiny(),
                   target_resolution=res, device="cpu", seed=1,
                   init_state_dict=init)


@pytest.mark.parametrize("guidance,k3,builds", [(1.5, 6, 2), (None, 4, 1)])
def test_step_pays_each_bias_once(monkeypatch, guidance, k3, builds):
    """The Trainer's distillation step (per-layer recompute on): the
    conditional batch's bias feeds the teacher's conditional calls and the
    student's forward, recompute and backward; the unconditional batch's
    the teacher's unconditional calls."""
    trainer = _tiny_trainer(distill_guidance=guidance)
    state = trainer.build()
    tb = collate([ClipSample(_frames(), (1, 1, 1, 1))], trainer.n_img,
                 uncond=guidance is not None)
    calls = _count_calls(monkeypatch, "bias_attention_reference",
                         "bias_attention_backward_reference",
                         "inline_attention_reference")
    built = []
    orig = video_gpt.precompute_bias
    monkeypatch.setattr(video_gpt, "precompute_bias",
                        lambda *a: (built.append(1), orig(*a))[1])
    metrics = trainer.train_step(state, tb, 0)
    nl = trainer.model_cfg.num_layers
    assert calls == {"bias_attention_reference": k3 * nl,
                     "bias_attention_backward_reference": nl,
                     "inline_attention_reference": 0}
    assert len(built) == builds
    assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0


def test_refusals_and_the_random_teacher_warning(capsys):
    check_train_config(TrainConfig(distill=True, distill_guidance=1.5))
    for kw, msg in (
            (dict(distill_guidance=1.5), "distillation knob; pass --distill"),
            (dict(distill=True, use_lora=True), "does not compose with "
                                                "--use_lora"),
            (dict(distill=True, input_output_return=True),
             "denoise head only")):
        with pytest.raises(ValueError, match=msg):
            check_train_config(TrainConfig(**kw))
    trainer = Trainer(ModelConfig.tiny(), stage_config(1, frame_num=4,
                                                       distill=True),
                      None, vae_cfg=VAEConfig.tiny(),
                      target_resolution=(32, 48), device="cpu")
    trainer.build()
    assert "RANDOMLY INITIALIZED" in capsys.readouterr().out
    _tiny_trainer().build()
    assert "RANDOMLY" not in capsys.readouterr().out


def test_distill_lr_feeds_the_optimizer():
    for distill_lr, want in ((3e-5, 3e-5), (None, 1e-3)):
        state = _tiny_trainer(distill_lr=distill_lr).build()
        assert state.optimizer.cfg.lr == want
        assert state.optimizer.schedule(5) == want
    args = cli.build_parser().parse_args(
        ["train", "--video_dir_path", "v", "--distill", "--distill_lr",
         "-1"])
    assert args.distill_lr == -1.0


def test_teacher_is_a_frozen_copy_in_bf16():
    """The teacher holds the student's weights in bf16 (not aliased, no
    gradient) and computes under autocast exactly what the fp32 weights
    compute, on the conditional and the unconditional layout."""
    trainer = _tiny_trainer(distill_guidance=1.5)
    trainer.build()
    student, teacher = trainer.model, trainer.teacher
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in teacher.parameters())
    sd = student.state_dict()
    for name, t in teacher.state_dict().items():
        assert torch.equal(t, sd[name].to(torch.bfloat16)), name
        assert t.data_ptr() != sd[name].data_ptr()
    tb = collate([ClipSample(_frames(), (1, 2, 1))], trainer.n_img,
                 uncond=True)
    g = torch.Generator().manual_seed(1)
    hl, wl = 4, 6
    for batch, nc in ((tb.inputs.batch, 3), (tb.inputs.batch_uncond, 0)):
        z = torch.randn(4, hl, wl, 4, generator=g).to(torch.bfloat16)
        cl = torch.randn(nc, hl, wl, 4, generator=g).to(torch.bfloat16)
        t = torch.rand(4, generator=g).to(torch.bfloat16)
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                             cache_enabled=False):
            assert torch.equal(teacher(batch, z, t, cl),
                               student(batch, z, t, cl))


def test_guided_distillation_run_resumes(tmp_path, capsys):
    """``Trainer.run`` with ``distill`` and ``distill_guidance`` 1.5 on
    videos: finite losses, the student moves, the teacher stays
    the warm start, and the run resumes from its checkpoint."""
    videos = str(tmp_path / "videos")
    _write_videos(videos)

    def trainer():
        cfg = stage_config(1, frame_num=4, lr_scheduler="constant",
                           log_every=1, ckpt_every=2, distill=True,
                           distill_guidance=1.5, distill_lr=1e-3,
                           results_dir=str(tmp_path / "run"))
        init = VideoGPT(ModelConfig.tiny()).init_random_(
            torch.Generator().manual_seed(2)).state_dict()
        return Trainer(ModelConfig.tiny(), cfg, videos,
                       vae_cfg=VAEConfig.tiny(), target_resolution=(48, 64),
                       device="cpu", init_state_dict=init), init

    t, init = trainer()
    state = t.run(2)
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    for name, p in t.teacher.state_dict().items():
        assert torch.equal(p, init[name].to(torch.bfloat16)), name
    moved = [not torch.equal(p.detach(), init[n])
             for n, p in state.model.named_parameters()]
    assert all(moved)
    t2, _ = trainer()
    resumed = t2.run(3)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.step == 3 and resumed.optimizer.count == 3


def test_distill_serving_lines_reach_the_trainer(monkeypatch):
    """Both ``train`` lines of configs/distill_serving.sh give the port's
    Trainer their recipe (the warm start and the dataset stubbed)."""
    from test_torch_cli import script_argv
    monkeypatch.setattr(cli, "_init_state_dict", lambda args: None)
    monkeypatch.setattr(trainer_mod, "VideoClipDataset",
                        lambda *a, **k: None)
    cfgs = [cli.make_trainer(cli.build_parser().parse_args(
        argv + ["--device", "cpu"])).cfg for argv in script_argv("distill_serving.sh", "train",
                                    **{"$STEPS": "20000"})]
    assert [c.distill_guidance for c in cfgs] == [1.5, None]
    assert [c.distill_student_steps for c in cfgs] == [5, 3]
    for c in cfgs:
        assert (c.distill, c.distill_substeps, c.distill_lr, c.lr_scheduler,
                c.adam_epsilon, c.frame_num, c.num_workers) == (
            True, 2, 1e-4, "constant", 1e-5, 16, 2)
