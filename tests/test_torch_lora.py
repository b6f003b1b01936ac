"""The port's LoRA fine-tuning (``models.phi3.LoraLinear``,
``training.lora``, ``make_lora_train_step``) against the JAX package on
the CPU.

A tiny JAX VideoGPT at ``lora_rank`` 8 with every parameter perturbed
(B != 0, so the adapters act and dA is not trivially 0; the head nonzero,
so gradients reach the trunk) is carried across by ``utils.weights``
(``lora_state_dict_from_jax`` for the adapters). Bars:

- the rank-8 forward: rtol 1e-4 / atol 1e-5, the model tests' bar (two fp32
  programs that sum in other orders);
- adapter gradients vs ``jax.grad`` of ``make_lora_train_step``'s loss
  (the loss through ``graft_lora``), and that step's loss and gradient
  norm: rtol 1e-4 / atol 1e-6, the training tests' gradient bar;
- ``merge_lora`` vs the JAX ``merge_lora``: atol 1e-6 (one fp32 rank-8
  product and an add); the merged rank-0 model against the rank-8 model's
  in-model adapters: rtol = atol = 1e-5 (the same math in another order).

The JAX step returns the EMA unchanged; the port keeps that: the EMA
adapters stay at their initial values. A LoRA checkpoint holds the
adapters alone, a run resumes from it, and ``cli generate
--lora_checkpoint_dir`` serves it merged into a ``--checkpoint_dir``.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_training import C, F, HL, WL, _batches, _loss_pair, \
    _write_videos
from video_gpt_tpu.config import ModelConfig as JModelConfig
from video_gpt_tpu.config import TrainConfig as JTrainConfig
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.training import loss as jloss
from video_gpt_tpu.training.lora import graft_lora, merge_lora as jmerge
from video_gpt_tpu.training.train_state import TrainState as JTrainState
from video_gpt_tpu.training.train_state import make_lora_train_step as \
    jmake_lora_step
from video_gpt_tpu.training.train_state import make_optimizer as jmake_opt
from video_gpt_tpu_torch import cli
from video_gpt_tpu_torch.config import ModelConfig, TrainConfig
from video_gpt_tpu_torch.models.phi3 import LoraLinear
from video_gpt_tpu_torch.models.video_gpt import VideoGPT
from video_gpt_tpu_torch.sampling.pipeline import VideoGPTPipeline
from video_gpt_tpu_torch.training.lora import (freeze_base_, init_lora_,
                                               is_adapter, lora_state_dict,
                                               merge_lora)
from video_gpt_tpu_torch.training.loss import training_loss
from video_gpt_tpu_torch.training.train_state import (init_lora_train_state,
                                                      make_lora_train_step)
from video_gpt_tpu_torch.utils import checkpoint
from video_gpt_tpu_torch.utils.weights import (lora_state_dict_from_jax,
                                               videogpt_state_dict_from_jax)

RANK = 8
TINY = dict(pos_embed_max_size=8)


@pytest.fixture(scope="module")
def lora_models():
    """(JAX rank-8 model, its params with every leaf perturbed)."""
    jm = JVideoGPT(JModelConfig.tiny(lora_rank=RANK, **TINY),
                   dtype=jnp.float32, train_init=True)
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


def _adapter_tree(params):
    """The JAX adapter tree (``init_lora``'s structure) of grafted params."""
    attn = params["params"]["llm"]["layers"]["self_attn"]
    return {"llm": {"layers": {"self_attn": {
        name: {k: attn[name][k] for k in ("lora_a", "lora_b")}
        for name in ("qkv_proj", "o_proj")}}}}


def _port_sd(params, cfg):
    return {**videogpt_state_dict_from_jax(params, cfg),
            **lora_state_dict_from_jax(params, cfg)}


def _port_model(params, rank=RANK):
    tm = VideoGPT(ModelConfig.tiny(lora_rank=rank, **TINY), train_init=True)
    tm.load_state_dict(_port_sd(params, tm.cfg), strict=True)
    return tm


def test_lora_forward_matches_jax(lora_models):
    jm, params = lora_models
    jin, tin, _, _ = _loss_pair()
    t = np.linspace(0.2, 0.9, jin.x1.shape[0]).astype(np.float32)
    want = jm.apply(params, jin.batch, jin.x1, jnp.asarray(t),
                    jin.clean_latents)
    tm = _port_model(params)
    with torch.no_grad():
        got = tm(tin.batch, tin.x1, torch.from_numpy(t), tin.clean_latents)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    # the adapters act: the same base without them differs
    base = VideoGPT(ModelConfig.tiny(**TINY), train_init=True)
    base.load_state_dict(videogpt_state_dict_from_jax(params, base.cfg))
    with torch.no_grad():
        plain = base(tin.batch, tin.x1, torch.from_numpy(t),
                     tin.clean_latents)
    assert float((plain - got).abs().max()) > 1e-3


def _jax_lora_loss(jm, params, key, jin):
    inner = params["params"]

    def loss_fn(lora):
        return jloss.training_loss(jm, {"params": graft_lora(inner, lora)},
                                   key, jin, max_blocks=F)[0]
    return loss_fn


def test_adapter_gradients_match_jax_grad(lora_models):
    jm, params = lora_models
    jin, tin, key, draws = _loss_pair()
    jgrads = jax.grad(_jax_lora_loss(jm, params, key, jin))(
        _adapter_tree(params))
    want = lora_state_dict_from_jax(jax.device_get(jgrads),
                                    ModelConfig.tiny(**TINY))
    tm = freeze_base_(_port_model(params))
    loss, _ = training_loss(tm, tin, draws)
    loss.backward()
    got = {n: p.grad for n, p in tm.named_parameters() if is_adapter(n)}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    # dA reaches every layer (B != 0), and the base gets no gradient
    assert float(got["llm.layers.0.self_attn.qkv_proj.lora_A.weight"]
                 .abs().max()) > 0
    assert all(p.grad is None for n, p in tm.named_parameters()
               if not is_adapter(n))


def test_lora_step_matches_jax_and_keeps_the_ema(lora_models):
    """One step of each package's ``make_lora_train_step`` from the same
    adapters with ``use_ema``: the loss and gradient norm agree, the
    adapters move, and the EMA adapters are those of the initial state in
    both (the JAX step returns ``state.ema_params`` unchanged)."""
    jm, params = lora_models
    jin, tin, key, draws = _loss_pair()
    kw = dict(lr=1e-3, lr_scheduler="constant", use_lora=True, use_ema=True,
              ema_decay=0.5, mixed_precision="no")
    lora = _adapter_tree(params)
    tx = jmake_opt(JTrainConfig(**kw))
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=lora,
                         opt_state=tx.init(lora),
                         ema_params=jax.tree.map(jnp.copy, lora))
    jstep = jmake_lora_step(jm, JTrainConfig(**kw), max_blocks=F)
    jnew, jmetrics = jstep(jstate, params, key, jin)

    cfg = TrainConfig(**kw)
    tm = freeze_base_(_port_model(params))
    state = init_lora_train_state(tm, cfg)
    init = {n: t.clone() for n, t in lora_state_dict(tm).items()}
    metrics = make_lora_train_step(tm, cfg)(state, tin, draws)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    assert state.step == 1 and state.optimizer.count == 1
    jema = lora_state_dict_from_jax(jax.device_get(jnew.ema_params),
                                    tm.cfg)
    assert set(state.ema) == set(init) == set(jema)
    for name, t in state.ema.items():
        assert torch.equal(t, init[name]), name
        assert torch.equal(jema[name], init[name]), name
        assert not torch.equal(lora_state_dict(tm)[name], init[name]), name


def test_merge_lora_matches_jax(lora_models):
    jm, params = lora_models
    cfg = ModelConfig.tiny(**TINY)
    merged = jmerge(params["params"], _adapter_tree(params))
    want = videogpt_state_dict_from_jax({"params": merged}, cfg)
    got = merge_lora(videogpt_state_dict_from_jax(params, cfg),
                     lora_state_dict_from_jax(params, cfg),
                     alpha=cfg.lora_alpha)
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    # the merged rank-0 model computes what the in-model adapters compute
    _, tin, _, _ = _loss_pair()
    t = torch.linspace(0.2, 0.9, tin.x1.shape[0])
    rank0 = VideoGPT(cfg, train_init=True)
    rank0.load_state_dict(got, strict=True)
    with torch.no_grad():
        a = rank0(tin.batch, tin.x1, t, tin.clean_latents)
        b = _port_model(params)(tin.batch, tin.x1, t, tin.clean_latents)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_rank0_keeps_the_state_dict_names(lora_models):
    """At rank 0 qkv_proj / o_proj are nn.Linear name for name: the
    reference's names load with strict=True, and a rank-8 model adds the
    adapters alone, in peft's layout."""
    _, params = lora_models
    cfg = ModelConfig.tiny(**TINY)
    rank0 = VideoGPT(cfg)
    ref = videogpt_state_dict_from_jax(params, cfg)
    assert set(rank0.state_dict()) == set(ref)
    rank0.load_state_dict(ref, strict=True)
    attn = rank0.llm.layers[0].self_attn
    assert isinstance(attn.qkv_proj, torch.nn.Linear)
    assert isinstance(attn.qkv_proj, LoraLinear)
    assert list(dict(attn.qkv_proj.named_parameters())) == ["weight"]
    rank8 = VideoGPT(dataclasses.replace(cfg, lora_rank=RANK)).state_dict()
    extra = {n: tuple(t.shape) for n, t in rank8.items() if n not in ref}
    assert set(rank8) >= set(ref) and all(is_adapter(n) for n in extra)
    d, h = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    for i in range(cfg.num_layers):
        base = f"llm.layers.{i}.self_attn."
        assert extra.pop(base + "qkv_proj.lora_A.weight") == (RANK, d)
        assert extra.pop(base + "qkv_proj.lora_B.weight") == (qkv, RANK)
        assert extra.pop(base + "o_proj.lora_A.weight") == (RANK, h)
        assert extra.pop(base + "o_proj.lora_B.weight") == (d, RANK)
    assert not extra


def test_init_lora_starts_at_the_base():
    """A ~ N(0, 1) / sqrt(fan_in), B = 0: the adapted model is its base."""
    cfg = ModelConfig.tiny(lora_rank=RANK)
    tm = VideoGPT(cfg).init_random_(torch.Generator().manual_seed(0))
    init_lora_(tm, torch.Generator().manual_seed(4))
    a = torch.cat([t.flatten() for n, t in lora_state_dict(tm).items()
                   if "qkv_proj.lora_A" in n]) * cfg.hidden_size ** 0.5
    assert abs(float(a.std()) - 1.0) < 0.1 and abs(float(a.mean())) < 0.1
    assert all(float(t.abs().max()) == 0 for n, t in
               lora_state_dict(tm).items() if ".lora_B." in n)
    freeze_base_(tm)
    assert {n for n, p in tm.named_parameters() if p.requires_grad} == set(
        lora_state_dict(tm))


def test_lora_checkpoint_holds_adapters_only(tmp_path, lora_models):
    _, params = lora_models
    cfg = TrainConfig(use_lora=True, use_ema=True)
    tm = freeze_base_(_port_model(params))
    state = init_lora_train_state(tm, cfg)
    adapters = lora_state_dict(tm)
    with checkpoint.CheckpointWriter(str(tmp_path)) as w:
        w.save(3, state)
    saved = torch.load(tmp_path / "3" / "state.pt", weights_only=True)
    assert set(saved["model"]) == set(adapters) == set(saved["ema"])
    assert len(saved["optimizer"]["mu"]) == len(adapters)
    got, step = checkpoint.load_lora_adapters(str(tmp_path))
    assert step == 3 and all(torch.equal(got[n], adapters[n])
                             for n in adapters)
    # a checkpoint with base weights is not a LoRA run's
    torch.save({"step": 1, "model": tm.state_dict(), "ema": None},
               tmp_path / "state.pt")
    os.makedirs(tmp_path / "full" / "1")
    os.replace(tmp_path / "state.pt", tmp_path / "full" / "1" / "state.pt")
    with pytest.raises(ValueError, match="not a LoRA run"):
        checkpoint.load_lora_adapters(str(tmp_path / "full"))


TRAIN_ARGS = ["--tiny_model", "--device", "cpu", "--frame_num", "4",
              "--target_resolution", "48", "64", "--lr", "1e-3",
              "--lr_scheduler", "constant", "--log_every", "1"]


def test_lora_run_resumes_and_serves_merged(tmp_path, monkeypatch, capsys):
    """``cli train --use_lora`` warm-started from a stage-1 run: the base
    stays that run's weights, the adapters train, the checkpoints hold them
    alone and the run resumes. ``cli generate --checkpoint_dir
    --lora_checkpoint_dir`` then serves the base with them merged."""
    videos = str(tmp_path / "videos")
    _write_videos(videos)
    common = ["--video_dir_path", videos, *TRAIN_ARGS]
    cli.main(["train", "--max_steps", "1", "--ckpt_every", "1",
              "--results_dir", str(tmp_path / "base"), *common])
    base_dir = str(tmp_path / "base" / "checkpoints")
    base, _ = checkpoint.load_train_params(base_dir)
    lora_args = ["train", "--use_lora", "--lora_rank", "4", "--ckpt_every",
                 "2", "--results_dir", str(tmp_path / "lora"),
                 "--init_checkpoint_dir", base_dir, *common]
    state = cli.make_trainer(cli.build_parser().parse_args(
        lora_args + ["--max_steps", "2"])).run(2)
    lora_dir = tmp_path / "lora" / "checkpoints"
    saved = torch.load(lora_dir / "2" / "state.pt", weights_only=True)
    assert set(saved["model"]) == set(lora_state_dict(state.model))
    assert all(t.shape[0] == 4 for n, t in saved["model"].items()
               if ".lora_A." in n)
    model_sd = state.model.state_dict()
    for name, t in base.items():  # the frozen base is untouched
        assert torch.equal(model_sd[name], t), name
    assert any(float(t.abs().max()) > 0 for n, t in saved["model"].items()
               if ".lora_B." in n)
    capsys.readouterr()
    resumed = cli.make_trainer(cli.build_parser().parse_args(
        lora_args + ["--max_steps", "3"])).run(3)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.step == 3 and resumed.optimizer.count == 3

    served = []
    monkeypatch.setattr(cli, "read_conditioning",
                        lambda path, n: [np.zeros((32, 48, 3), np.uint8)] * n)
    monkeypatch.setattr(VideoGPTPipeline, "generate",
                        lambda self, frames, **kw: (served.append(self),
                                                    [])[1])
    gen = ["generate", "--video_path", "clip.mp4", "--tiny_model",
           "--device", "cpu", "--dtype", "fp32", "--save_dir",
           str(tmp_path / "out"), "--checkpoint_dir", base_dir,
           "--lora_checkpoint_dir", str(lora_dir)]
    cli.main(gen + ["--lora_rank", "4"])
    adapters, step = checkpoint.load_lora_adapters(str(lora_dir))
    assert step == 2
    want = merge_lora(base, adapters)
    got = served[0].model.state_dict()
    assert set(got) == set(want)
    assert any(not torch.equal(want[n], base[n]) for n in base)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    with pytest.raises(SystemExit, match="rank 4"):
        cli.main(gen)  # --lora_rank defaults to 8


def test_lora_warm_start_needs_the_base():
    """A LoRA run's base is its warm start: a state dict of adapters alone
    (another LoRA run's checkpoint) is refused, and a rank-0 one loads with
    fresh adapters."""
    from video_gpt_tpu_torch.config import stage_config
    from video_gpt_tpu_torch.models.vae import VAEConfig
    from video_gpt_tpu_torch.training.trainer import Trainer

    base = VideoGPT(ModelConfig.tiny()).init_random_(
        torch.Generator().manual_seed(0)).state_dict()

    def build(sd):
        return Trainer(ModelConfig.tiny(), stage_config(1, use_lora=True),
                       None, vae_cfg=VAEConfig.tiny(), device="cpu",
                       target_resolution=(32, 48), init_state_dict=sd).build()

    state = build(base)
    sd = state.model.state_dict()
    assert all(torch.equal(sd[n], t) for n, t in base.items())
    assert all(float(t.abs().max()) == 0 for n, t in
               lora_state_dict(state.model).items() if ".lora_B." in n)
    with pytest.raises(ValueError, match="must hold the base model"):
        build(lora_state_dict(state.model))
