"""The port's stage-1 training stack (video_gpt_tpu_torch.training) against
the JAX package on the CPU.

- ``collate``: every array bit-equal to the JAX collate's from the same
  ClipSamples, also at stage 4's 80 frames with a ``random_block_partition``
  draw.
- ``training_loss`` with the JAX loss's own draws injected (the test replays
  its ``jax.random.split`` of the step key): loss and per-frame loss at
  rtol 1e-5.
- Parameter gradients of the loss against ``jax.grad`` at fp32 on a tiny
  model with every parameter perturbed (a train-init model's zero head
  would make the trunk's gradient exactly zero), the JAX gradient tree
  mapped through ``videogpt_state_dict_from_jax``: rtol 1e-4 / atol 1e-6,
  the model bar (two fp32 programs summing in other orders). JAX runs its
  dense CPU attention (``maybe_bias`` is None off the TPU); the port runs
  ``flash_mha``'s autograd Function, so plain K3 forward and plain K9
  backward; at ``precompute_bias_limit=0`` it runs ``flash_mha_inline``'s,
  so plain K6 forward and plain K7 backward (the stage-2-4 route).
- The optimizer fed the same gradients as optax for a few steps (clip
  active; warmup, cosine and accumulation): parameters and moments within
  rtol 1e-6 (float32 rounding of the same formulas). Shared gradients, not
  full steps: Adam's sign-like first step would amplify ulp differences of
  near-zero gradients.
- ``Trainer.run`` end to end on a tiny model from short synthetic videos
  written with cv2, and its resume from the checkpoint; stage chaining:
  ``cli train --stage 4 --init_checkpoint_dir`` warm-starts from a stage-1
  run's checkpoint with its parameters and a fresh optimizer.
"""
import dataclasses
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from video_gpt_tpu.config import ModelConfig as JModelConfig
from video_gpt_tpu.config import TrainConfig as JTrainConfig
from video_gpt_tpu.data.video import ClipSample as JClipSample
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.training import loss as jloss
from video_gpt_tpu.training.data import collate as jcollate
from video_gpt_tpu.training.train_state import make_optimizer as jmake_opt
from video_gpt_tpu_torch.config import (ModelConfig, TrainConfig,
                                        check_train_config, stage_config)
from video_gpt_tpu_torch import cli
from video_gpt_tpu_torch.data.video import ClipSample, random_block_partition
from video_gpt_tpu_torch.ops import flash_attention as fa
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.models.video_gpt import VideoGPT
from video_gpt_tpu_torch.training.data import collate
from video_gpt_tpu_torch.training.loss import LossDraws, training_loss
from video_gpt_tpu_torch.training.train_state import (AdamW, TrainState,
                                                      ema_update_gated,
                                                      lr_schedule)
from video_gpt_tpu_torch.training.trainer import Trainer
from video_gpt_tpu_torch.utils.weights import videogpt_state_dict_from_jax

F, HL, WL, C = 3, 4, 4, 4
N_IMG = (HL // 2) * (WL // 2)
BLOCKS = ((1, 2), (1, 1, 1))   # two rows: frame-block and interleaved


def _pixels(seed, frames=F):
    return np.random.default_rng(seed).uniform(
        -1, 1, (frames, 8 * HL, 8 * WL, 3)).astype(np.float32)


def _batches(cls_weight=None, blocks=BLOCKS):
    frames = sum(blocks[0])

    def samples(cls):
        return [cls(_pixels(i, frames), b) for i, b in enumerate(blocks)]

    jt = jcollate(samples(JClipSample), N_IMG, cls_weight=cls_weight)
    tt = collate(samples(ClipSample), N_IMG, cls_weight=cls_weight)
    return jt, tt


# stage 4: one clip of 80 frames in the blocks of one seeded draw
STAGE4_BLOCKS = (random_block_partition(80, random.Random(0)),)


@pytest.mark.parametrize("cls_weight,blocks", [
    pytest.param(None, BLOCKS, id="None"), pytest.param(2.0, BLOCKS, id="2.0"),
    pytest.param(None, STAGE4_BLOCKS, id="stage4-80-frames")])
def test_collate_matches_jax(cls_weight, blocks):
    jt, tt = _batches(cls_weight, blocks)
    pairs = [(jt.pixels, tt.pixels), (jt.noisy_sel, tt.noisy_sel),
             (jt.clean_sel, tt.clean_sel), (jt.clean_valid, tt.clean_valid)]
    ji, ti = jt.inputs, tt.inputs
    pairs += [(getattr(ji, n), getattr(ti, n)) for n in (
        "noisy_frame_row", "noisy_frame_block", "frame_weights")]
    jb, tb = ji.batch, ti.batch
    pairs += [(getattr(jb, n), getattr(tb, n)) for n in tb._fields
              if n != "meta"]
    pairs += list(zip(jb.meta, tb.meta))
    for want, got in pairs:
        if want is None:
            assert got is None
            continue
        want = np.array(want)
        assert got.dtype == torch.from_numpy(want).dtype, (got.dtype, want)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def models():
    jcfg = JModelConfig.tiny(pos_embed_max_size=8)
    jm = JVideoGPT(jcfg, dtype=jnp.float32, train_init=True)
    jt, _ = _batches()
    nn_, nc = int(jt.noisy_sel.shape[0]), int(jt.clean_sel.shape[0])
    params = jm.init(jax.random.PRNGKey(1), jt.inputs.batch,
                     jnp.zeros((nn_, HL, WL, C)), jnp.zeros((nn_,)),
                     jnp.zeros((nc, HL, WL, C)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32), params)
    return jm, params


def _loss_pair(order=2, cls_weight=None):
    """(JAX inputs, port inputs, the step key, the JAX loss's draws)."""
    jt, tt = _batches(cls_weight)
    lat = np.random.default_rng(5).standard_normal(
        (len(BLOCKS) * F, HL, WL, C)).astype(np.float32)
    jin = jt.inputs._replace(x1=jnp.take(lat, jt.noisy_sel, axis=0),
                             clean_latents=jnp.take(lat, jt.clean_sel,
                                                    axis=0))
    tl = torch.from_numpy(lat)
    tin = tt.inputs._replace(x1=tl[tt.noisy_sel.long()],
                             clean_latents=tl[tt.clean_sel.long()])
    key = jax.random.PRNGKey(7)
    r_x0, r_t, r_x0c, r_tc = jax.random.split(key, 4)
    draws = LossDraws(*(torch.from_numpy(np.asarray(x)) for x in (
        jax.random.normal(r_x0, jin.x1.shape, jin.x1.dtype),
        jax.random.uniform(r_t, (len(BLOCKS), F)),
        jax.random.normal(r_x0c, jin.clean_latents.shape),
        jax.random.uniform(r_tc, (jin.clean_latents.shape[0],)))))
    return jin, tin, key, draws


def _port_model(params, **cfg):
    tm = VideoGPT(ModelConfig.tiny(pos_embed_max_size=8, **cfg),
                  device="cpu", train_init=True)
    tm.load_state_dict(videogpt_state_dict_from_jax(params, tm.cfg),
                       strict=True)
    return tm


@pytest.mark.parametrize("order,cls_weight", [(2, None), (4, 2.0)])
def test_training_loss_matches_jax(models, order, cls_weight):
    jm, params = models
    jin, tin, key, draws = _loss_pair(order, cls_weight)
    want, jaux = jloss.training_loss(jm, params, key, jin, max_blocks=F,
                                     order=order)
    with torch.no_grad():
        got, aux = training_loss(_port_model(params), tin, draws,
                                 order=order)
    np.testing.assert_allclose(aux["per_frame_loss"].numpy(),
                               np.asarray(jaux["per_frame_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _port_grads(params, draws, tin, **cfg):
    tm = _port_model(params, **cfg)
    loss, _ = training_loss(tm, tin, draws)
    loss.backward()
    return ({n: p.grad for n, p in tm.named_parameters()},
            float(loss.detach()))


def _check_model_gradients(models, **cfg):
    jm, params = models
    jin, tin, key, draws = _loss_pair()

    def loss_fn(p):
        return jloss.training_loss(jm, {"params": p}, key, jin,
                                   max_blocks=F)[0]

    jgrads = jax.grad(loss_fn)(params["params"])
    want = videogpt_state_dict_from_jax(jax.device_get(jgrads),
                                        ModelConfig.tiny(pos_embed_max_size=8))
    got, _ = _port_grads(params, draws, tin, **cfg)
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    # the trunk's first attention gets a gradient through the backward
    assert float(got["llm.layers.0.self_attn.qkv_proj.weight"].abs().max()) \
        > 0


def test_model_gradients_match_jax_grad(models):
    _check_model_gradients(models)


def _count_calls(monkeypatch, *names):
    """Count the calls of the plain versions ``names`` of
    ``ops.flash_attention`` (the wrappers look them up at call time)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(fa, name)

        def counted(*a, name=name, fn=fn, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(fa, name, counted)
    return calls


def test_model_gradients_match_jax_grad_inline(models, monkeypatch):
    """The same gradients on the route of stages 2-4: with no bias
    precomputed, every layer runs ``flash_mha_inline``, whose plain
    versions (K6 forward, K7 backward) run on the CPU."""
    calls = _count_calls(monkeypatch, "inline_attention_reference",
                         "inline_attention_backward_reference",
                         "bias_attention_reference")
    _check_model_gradients(models, precompute_bias_limit=0)
    layers = ModelConfig.tiny().num_layers
    assert calls == {"inline_attention_reference": layers,
                     "inline_attention_backward_reference": layers,
                     "bias_attention_reference": 0}


def test_remat_gives_the_same_gradients(models):
    _, params = models
    _, tin, _, draws = _loss_pair()
    plain, loss0 = _port_grads(params, draws, tin)
    remat, loss1 = _port_grads(params, draws, tin, remat=True)
    assert loss0 == loss1
    for name, g in plain.items():
        np.testing.assert_allclose(remat[name].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=name)


def test_tiny_fp32_trainer_step_matches_jax(models):
    """``train --tiny_model --mixed_precision no`` at stage 1, a recipe
    that trains on CUDA too (the fp32 kernels at head_dim 16): one
    ``Trainer`` step in fp32 (loss, backward through plain K3 / K9, clip,
    AdamW) on the tiny model equals the JAX trainer's step from the same
    parameters, batch and draws: loss rtol 1e-5, gradient norm rtol 1e-4,
    every updated parameter rtol 1e-4 / atol 1e-6. AdamW's epsilon is
    1e-3, as in the mesh step tests: at 1e-8 Adam's first step is
    sign-like and amplifies ulp differences of near-zero gradients."""
    from video_gpt_tpu.config import stage_config as jstage_config
    from video_gpt_tpu.training.train_state import \
        init_train_state as jinit_state
    from video_gpt_tpu.training.train_state import \
        make_train_step as jmake_step
    jm, params = models
    jin, tin, key, draws = _loss_pair()
    kw = dict(frame_num=F, lr=1e-3, lr_scheduler="constant",
              mixed_precision="no", adam_epsilon=1e-3)
    jcfg = jstage_config(1, **kw)
    jstate, jmetrics = jax.jit(jmake_step(jm, jcfg, max_blocks=F))(
        jax.jit(lambda p: jinit_state(jm, p, jcfg))(params), key, jin)
    cfg = ModelConfig.tiny(pos_embed_max_size=8)
    assert cfg.head_dim == 16
    trainer = Trainer(cfg, stage_config(1, **kw), None,
                      vae_cfg=VAEConfig.tiny(),
                      init_state_dict=_port_model(params).state_dict(),
                      device="cpu")
    state = trainer.build()
    metrics = trainer._step_fn(state, tin, draws)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    want = videogpt_state_dict_from_jax(
        jax.device_get(jstate.params["params"]), cfg)
    got = dict(state.model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert p.dtype == torch.float32, name
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_train_init_zeroes_head_and_patch_embedder():
    tm = VideoGPT(ModelConfig.tiny(), train_init=True).init_random_(
        torch.Generator().manual_seed(0))
    for mod in (tm.x_embedder, tm.final_layer):
        assert all(bool((p == 0).all()) for p in mod.parameters())
    assert float(tm.input_x_embedder.proj.weight.abs().max()) > 0


OPT_CASES = [  # (scheduler, accumulation steps, micro-steps)
    ("constant_with_warmup", 1, 3), ("cosine", 1, 3), ("constant", 2, 4)]


@pytest.mark.parametrize("scheduler,accum,steps", OPT_CASES)
def test_optimizer_matches_optax(scheduler, accum, steps):
    kw = dict(lr=1e-2, lr_scheduler=scheduler, lr_warmup_steps=2,
              max_steps=5, adam_epsilon=1e-5, gradient_accumulation_steps=accum,
              use_ema=True, ema_decay=0.5)
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 5), "b": (5,), "norm": (3,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    # norms 3-6: the clip at max_grad_norm 1 is active every step
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(steps)]
    tx = jmake_opt(JTrainConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jp)

    model = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in init.items()})
    cfg = TrainConfig(**kw)
    opt = AdamW(model.values(), cfg)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    jema = dict(jp)
    for g in grads:
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jp)
        jp = optax.apply_updates(jp, updates)
        if accum == 1 or tx.has_updated(jstate):
            jema = {k: jema[k] * 0.5 + jp[k] * 0.5 for k in jp}
        for k, p in model.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        ema_update_gated(ema, model, cfg, opt)
        for k in model:
            np.testing.assert_allclose(model[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-8, err_msg=k)
            np.testing.assert_allclose(ema[k].numpy(), np.asarray(jema[k]),
                                       rtol=1e-6, atol=1e-8, err_msg=k)
    adam = jstate.inner_opt_state if accum > 1 else jstate
    adam = adam[1][0]  # chain(clip, adamw) -> adamw's ScaleByAdamState
    assert opt.count == int(adam.count)
    for i, k in enumerate(model):
        np.testing.assert_allclose(opt.mu[i].numpy(), np.asarray(adam.mu[k]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(opt.nu[i].numpy(), np.asarray(adam.nu[k]),
                                   rtol=1e-6, atol=1e-9)


def test_lr_schedules_match_optax():
    from video_gpt_tpu.training.train_state import lr_schedule as jsched
    for name in ("constant", "constant_with_warmup", "cosine"):
        kw = dict(lr=3e-4, lr_scheduler=name, lr_warmup_steps=4, max_steps=11)
        port, ref = lr_schedule(TrainConfig(**kw)), jsched(JTrainConfig(**kw))
        for count in range(14):
            assert port(count) == pytest.approx(float(ref(count)), rel=1e-6,
                                                abs=1e-12), (name, count)


def test_unported_fields_raise():
    """Every field is ported: the offload optimizer passes, and only its
    combinations that the JAX trainer refuses raise."""
    check_train_config(stage_config(1))
    check_train_config(TrainConfig(input_output_return=True))
    check_train_config(TrainConfig(offload_optimizer=True,
                                   offload_grad_splits=2))
    with pytest.raises(ValueError, match="does not support EMA"):
        check_train_config(TrainConfig(offload_optimizer=True, use_ema=True))


def _write_videos(root, n=2, frames=20, h=128, w=160):
    import cv2
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w]
    for i in range(n):
        out = cv2.VideoWriter(os.path.join(root, f"clip{i}.avi"),
                              cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
        for f in range(frames):
            img = np.stack([(x + 4 * f) % 256, (y + 7 * i) % 256,
                            (x + y + f) % 256], -1).astype(np.float32)
            img += rng.normal(0, 8, img.shape)
            out.write(np.clip(img, 0, 255).astype(np.uint8))
        out.release()


def test_trainer_runs_and_resumes(tmp_path, capsys):
    videos = str(tmp_path / "videos")
    _write_videos(videos)

    def trainer():
        cfg = stage_config(1, frame_num=4, lr=1e-3, lr_scheduler="constant",
                           log_every=1, ckpt_every=2,
                           results_dir=str(tmp_path / "run"))
        return Trainer(ModelConfig.tiny(), cfg, videos,
                       vae_cfg=VAEConfig.tiny(), target_resolution=(48, 64),
                       device="cpu")

    t = trainer()
    assert t.model_cfg.remat  # gradient_checkpointing is on by default
    sample = t.dataset.sample(0)
    assert sample.pixels.shape == (4, 48, 64, 3)
    assert sample.frame_blocks == (1, 1, 1, 1)
    state = t.run(2)
    assert isinstance(state, TrainState) and state.step == 2
    assert os.path.exists(tmp_path / "run" / "checkpoints" / "2" / "state.pt")
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    resumed = trainer().run(3)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.step == 3 and resumed.optimizer.count == 3


def test_dataset_draws_match_jax(tmp_path):
    """Same clip windows, strides and block partitions as the JAX dataset
    (both pure functions of seed and index): the raw frames each sample
    reads are bit-equal."""
    from video_gpt_tpu.data.video import VideoClipDataset as JDataset
    from video_gpt_tpu_torch.data.video import VideoClipDataset
    videos = str(tmp_path / "videos")
    _write_videos(videos, n=3)
    kw = dict(frame_num=4, frame_interval=2, flexible_interval=True,
              interval_bound=4, target_resolution=(48, 64),
              scheme="frame_block", seed=3)
    jds, tds = JDataset(videos, **kw), VideoClipDataset(videos, **kw)
    assert tds.data == jds.data
    for index in range(5):
        epoch, vid = divmod(index, len(tds))
        jrng, trng = jds._sample_rng(epoch, vid, 0), tds._sample_rng(
            epoch, vid, 0)
        np.testing.assert_array_equal(tds._read_clip(tds.data[vid], trng),
                                      jds._read_clip(jds.data[vid], jrng))
        assert tds.sample(index).frame_blocks == \
            jds.sample(index).frame_blocks


@pytest.mark.parametrize("size", [(144, 256), (352, 640), (480, 854),
                                  (176, 320)],
                         ids=["enlarge", "shrink-2x", "shrink-fractional",
                              "same-size"])
def test_dataset_pixels_match_jax(tmp_path, size):
    """The training pixels: the port's ``sample(i).pixels`` against the JAX
    dataset's, which takes the native frame library whenever it loads
    (fractional box filter to shrink, bilinear to enlarge, a fractional
    crop, floats), within 1e-5 (float32 rounding of one arithmetic, the
    port's in numpy)."""
    from video_gpt_tpu.data import native
    from video_gpt_tpu.data.video import VideoClipDataset as JDataset
    from video_gpt_tpu_torch.data.video import VideoClipDataset
    if not native.available():
        pytest.skip("the JAX package's native frame library does not load")
    videos = str(tmp_path / "videos")
    _write_videos(videos, n=1, frames=6, h=size[0], w=size[1])
    kw = dict(frame_num=2, frame_interval=2, target_resolution=(176, 320),
              seed=1)
    jds, tds = JDataset(videos, **kw), VideoClipDataset(videos, **kw)
    for index in range(2):
        got, want = tds.sample(index).pixels, jds.sample(index).pixels
        assert got.dtype == np.float32 and got.shape == (2, 176, 320, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("ema", [False, True])
def test_warm_start_reads_only_the_parameters(tmp_path, monkeypatch, ema):
    """``load_train_params`` memory-maps the checkpoint and copies out the
    one sub-dict it returns: the optimizer state is never read into host
    memory, and what it returns shares no storage with the file."""
    from video_gpt_tpu_torch.utils import checkpoint
    g = torch.Generator().manual_seed(0)
    model = {f"w{i}": torch.randn(4, 3, generator=g) for i in range(3)}
    copy = {k: torch.randn(v.shape, generator=g) for k, v in model.items()}
    opt = {"count": 2, "mini_step": 0, "acc": None,
           "mu": [torch.randn(4, 3, generator=g) for _ in range(3)],
           "nu": [torch.randn(4, 3, generator=g) for _ in range(3)]}
    os.makedirs(tmp_path / "7")
    torch.save({"step": 7, "model": model, "optimizer": opt,
                "ema": copy}, tmp_path / "7" / "state.pt")
    loads = []
    orig = torch.load
    monkeypatch.setattr(torch, "load", lambda *a, **k: (
        loads.append((k, orig(*a, **k))), loads[-1][1])[1])
    sd, step = checkpoint.load_train_params(str(tmp_path), ema=ema)
    assert step == 7 and len(loads) == 1
    kwargs, loaded = loads[0]
    assert kwargs["mmap"] and kwargs["weights_only"]
    want = copy if ema else model
    assert set(sd) == set(want)
    for name, t in sd.items():
        assert torch.equal(t, want[name])
    file_storages = {t.untyped_storage().data_ptr()
                     for part in ("model", "ema") for t in loaded[part].values()}
    file_storages |= {t.untyped_storage().data_ptr()
                      for t in loaded["optimizer"]["mu"]
                      + loaded["optimizer"]["nu"]}
    assert not file_storages & {t.untyped_storage().data_ptr()
                                for t in sd.values()}


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_later_stages_train_on_the_inline_route(stage, monkeypatch):
    """One step of each later stage's recipe (frame-block partitions, a
    tiny model with no bias precomputed, as at their full lengths) through
    the Trainer's own step: every layer's backward is the plain K7, the
    loss is finite and AdamW steps once."""
    res = (32, 48)
    trainer = Trainer(ModelConfig.tiny(precompute_bias_limit=0),
                      stage_config(stage, frame_num=5, lr=1e-3,
                                   lr_scheduler="constant"),
                      None, vae_cfg=VAEConfig.tiny(), target_resolution=res,
                      device="cpu", seed=stage)
    state = trainer.build()
    blocks = random_block_partition(5, random.Random(stage))
    pixels = np.random.default_rng(stage).uniform(
        -1, 1, (5, *res, 3)).astype(np.float32)
    tb = collate([ClipSample(pixels, blocks)], trainer.n_img)
    calls = _count_calls(monkeypatch, "inline_attention_backward_reference",
                         "bias_attention_backward_reference")
    metrics = trainer.train_step(state, tb, 0)
    assert np.isfinite(float(metrics["loss"]))
    assert state.optimizer.count == 1
    assert calls == {"inline_attention_backward_reference":
                     trainer.model_cfg.num_layers,
                     "bias_attention_backward_reference": 0}


def test_warm_start_from_an_earlier_stage(tmp_path, monkeypatch):
    """Stage chaining: ``cli train --stage 1`` for 2 steps, then a stage-4
    trainer from its checkpoint (``--init_checkpoint_dir``) starts with
    exactly those parameters and a fresh AdamW, and trains on the inline
    route (no bias precomputed, as at stage 4's full length)."""
    videos = str(tmp_path / "videos")
    _write_videos(videos)
    common = ["--video_dir_path", videos, "--tiny_model", "--device", "cpu",
              "--frame_num", "4", "--target_resolution", "48", "64",
              "--lr", "1e-3", "--lr_scheduler", "constant", "--log_every",
              "1"]
    cli.main(["train", "--stage", "1", "--max_steps", "2", "--ckpt_every",
              "2", "--results_dir", str(tmp_path / "stage1"), *common])
    ckpt_dir = tmp_path / "stage1" / "checkpoints"
    saved = torch.load(ckpt_dir / "2" / "state.pt", weights_only=True)
    args = cli.build_parser().parse_args([
        "train", "--stage", "4", "--max_steps", "1", "--results_dir",
        str(tmp_path / "stage4"), "--init_checkpoint_dir", str(ckpt_dir),
        *common])
    trainer = cli.make_trainer(args)
    assert trainer.cfg.frame_block_scheme == "frame_block"
    state = trainer.build()
    assert state.step == 0 and state.optimizer.count == 0
    model_sd = state.model.state_dict()
    assert set(model_sd) == set(saved["model"])
    for name, p in model_sd.items():
        torch.testing.assert_close(p, saved["model"][name], rtol=0, atol=0)
    # the stage-1 run moved its moments; the warm start does not take them
    assert any(float(m.abs().max()) > 0 for m in saved["optimizer"]["mu"])
    assert all(float(m.abs().max()) == 0 for m in state.optimizer.mu)
    assert all(float(m.abs().max()) == 0 for m in state.optimizer.nu)

    trainer.model_cfg = dataclasses.replace(trainer.model_cfg,
                                            precompute_bias_limit=0)
    calls = _count_calls(monkeypatch, "inline_attention_backward_reference")
    end = trainer.run(1)
    assert end.step == 1 and end.optimizer.count == 1
    assert calls["inline_attention_backward_reference"] == \
        trainer.model_cfg.num_layers
