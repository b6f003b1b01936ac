"""The offload optimizer's state carried across from the JAX package, and
the image family's offload step, on the CPU at ``ModelConfig.tiny()`` in
fp32 (the bars of ``tests/test_torch_offload.py``, the JAX test's own).

- A JAX offload run after 2 steps, its parameters carried by
  ``videogpt_state_dict_from_jax`` and its ``OffloadState`` by
  ``offload_state_from_jax``, then one more step on both sides: the loss,
  the gradient norm, the parameters, the master, mu and nu agree.
- ``ImageGenTrainer``'s offload step (velocity target, one block per row)
  equals the JAX ``make_offload_train_step(prediction_target='velocity',
  max_blocks=1)`` over two steps.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from video_gpt_tpu.config import ModelConfig as JModelConfig
from video_gpt_tpu.config import TrainConfig as JTrainConfig
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.training import offload as joffload
from video_gpt_tpu_torch.config import ModelConfig, TrainConfig
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.training.image_trainer import ImageGenTrainer
from video_gpt_tpu_torch.utils.weights import (offload_state_from_jax,
                                               videogpt_state_dict_from_jax)

from test_torch_image_training import CharTokenizer
from test_torch_image_training import _loss_pair as image_pair
from test_torch_offload import (F, METRIC_RTOL, STEP_KW, assert_params_close,
                                inputs_pair, jax_draws, jax_model_and_params,
                                offload_run)


def _close_metrics(m, jm_):
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm_[k]),
                                   rtol=METRIC_RTOL, err_msg=k)


def test_a_jax_offload_state_carries_across():
    jm, params = jax_model_and_params(seed=4)
    jin, tin = inputs_pair()
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = joffload.init_offload_state(jparams)
    jstep = joffload.make_offload_train_step(jm, JTrainConfig(**STEP_KW),
                                             max_blocks=F)
    for i in range(2):
        jparams, jstate, _ = jstep(jparams, jstate,
                                   jax.random.PRNGKey(200 + i), jin)
    mid = jax.device_get(jparams)
    state, step = offload_run(mid, STEP_KW)
    cfg = state.model.cfg
    state.optimizer.load_state_dict(offload_state_from_jax(
        jax.device_get(jstate), cfg))
    assert state.optimizer.count == 2
    for name, t in state.optimizer.master.items():
        assert torch.equal(t, dict(state.model.named_parameters())[name]
                           .detach()), name
    key = jax.random.PRNGKey(202)
    jparams, jstate, jm_ = jstep(jparams, jstate, key, jin)
    m = step(state, tin, jax_draws(key, jin, tin.batch.input_ids.shape[0],
                                   F))
    _close_metrics(m, jm_)
    assert state.optimizer.count == int(jstate.count) == 3
    assert_params_close(state.model, videogpt_state_dict_from_jax(
        jax.device_get(jparams), cfg))
    want = offload_state_from_jax(jax.device_get(jstate), cfg)
    for field in ("master", "mu", "nu"):
        got = getattr(state.optimizer, field)
        scale = max(float(t.abs().max()) for t in want[field].values())
        for name, t in want[field].items():
            np.testing.assert_allclose(got[name].numpy(), t.numpy(),
                                       rtol=2e-4, atol=2e-6 * scale,
                                       err_msg=f"{field} {name}")


def test_train_image_offload_step_matches_jax():
    jin, tin, _, _ = image_pair()
    jm = JVideoGPT(JModelConfig.tiny(pos_embed_max_size=8), dtype=jnp.float32,
                   train_init=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jin.batch, jin.x1,
                              jnp.zeros((2,)), jin.clean_latents)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32), params)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = joffload.init_offload_state(jparams)
    jstep = joffload.make_offload_train_step(
        jm, JTrainConfig(**STEP_KW), max_blocks=1,
        prediction_target="velocity")
    cfg = ModelConfig.tiny(pos_embed_max_size=8)
    trainer = ImageGenTrainer(
        cfg, TrainConfig(offload_optimizer=True, **STEP_KW), None, None,
        CharTokenizer(), output_size=(32, 32), vae_cfg=VAEConfig.tiny(),
        init_state_dict=videogpt_state_dict_from_jax(params, cfg),
        device="cpu")
    state = trainer.build()
    for i in range(2):
        key = jax.random.PRNGKey(300 + i)
        jparams, jstate, jm_ = jstep(jparams, jstate, key, jin)
        m = trainer._step_fn(state, tin, jax_draws(key, jin, 2, 1))
        _close_metrics(m, jm_)
    assert state.step == state.optimizer.count == 2
    assert_params_close(state.model, videogpt_state_dict_from_jax(
        jax.device_get(jparams), cfg))
