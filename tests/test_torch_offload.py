"""The port's host-offloaded AdamW (``video_gpt_tpu_torch.training.offload``)
against the JAX package's (``video_gpt_tpu/training/offload.py``) on the CPU,
at ``ModelConfig.tiny()`` in fp32, the weights carried by
``videogpt_state_dict_from_jax`` and the JAX step's draws injected.

- ``chunk_sizes`` equals the JAX function over scalars, vectors, leaves
  under and over the bound, rows over the bound and uneven splits.
- Three offload steps at ``grad_splits`` 1 (the bias route, plain K3 / K9)
  and 2 (the inline route of stages 2-4, plain K6 / K7) equal the JAX
  ``make_offload_train_step``'s at the JAX test's own bars (loss and
  gradient norm rtol 1e-5; parameters rtol 2e-4 / atol 2e-6), and the
  port's on-device ``AdamW`` step at the same bars. The recipes' AdamW
  epsilon (1e-5) is used: see ``STEP_KW``.
- With ``CHUNK_BYTES_F32`` forced small the chunked update is bit-equal to
  the whole-tensor update.
- bf16: the master is fp32 and starts at f32(bf16(init)), mu and nu at
  zero, and after a step every parameter is bf16(master) exactly; and
  three steps of the bf16 path (bf16 parameters, autocast) against the
  JAX offload step on bf16 parameters (the JAX trainer's: a bf16 model,
  its parameters cast before the master is built), within twice the JAX
  bf16 run's own distance from the fp32 trajectory.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_gpt_tpu.config import ModelConfig as JModelConfig
from video_gpt_tpu.config import TrainConfig as JTrainConfig
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.training import offload as joffload
from video_gpt_tpu_torch.config import ModelConfig, TrainConfig
from video_gpt_tpu_torch.models.video_gpt import VideoGPT
from video_gpt_tpu_torch.training import offload
from video_gpt_tpu_torch.training.loss import LossDraws
from video_gpt_tpu_torch.training.train_state import (init_train_state,
                                                      make_train_step)
from video_gpt_tpu_torch.utils.weights import (offload_state_from_jax,
                                               videogpt_state_dict_from_jax)

from test_torch_training import BLOCKS, C, F, HL, WL, _batches

# the recipes' AdamW epsilon (configs/pretrain_stage1.sh): at optax's
# default 1e-8 Adam's sign-like update of a gradient near 0 turns an fp32
# reordering of the two packages' gradients into a step of ~lr
STEP_KW = dict(lr=1e-3, lr_scheduler="constant", max_grad_norm=1.0,
               adam_epsilon=1e-5, mixed_precision="no")
# the JAX test's bars (tests/test_offload.py)
METRIC_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-4, 2e-6


def jax_model_and_params(seed=1):
    """A tiny JAX training model and its parameters, every one perturbed
    (a train-init model's zero head gives the trunk no gradient)."""
    jm = JVideoGPT(JModelConfig.tiny(pos_embed_max_size=8), dtype=jnp.float32,
                   train_init=True)
    jt, _ = _batches()
    nn_, nc = int(jt.noisy_sel.shape[0]), int(jt.clean_sel.shape[0])
    # jitted: the eager init of even the tiny model takes ~12 s on the CPU
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jt.inputs.batch,
                              jnp.zeros((nn_, HL, WL, C)), jnp.zeros((nn_,)),
                              jnp.zeros((nc, HL, WL, C)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32), params)
    return jm, params


def inputs_pair(seed=5):
    """(JAX inputs, port inputs) of the two-row batch with seeded latents."""
    jt, tt = _batches()
    lat = np.random.default_rng(seed).standard_normal(
        (len(BLOCKS) * F, HL, WL, C)).astype(np.float32)
    jin = jt.inputs._replace(x1=jnp.take(lat, jt.noisy_sel, axis=0),
                             clean_latents=jnp.take(lat, jt.clean_sel,
                                                    axis=0))
    tl = torch.from_numpy(lat)
    tin = tt.inputs._replace(x1=tl[tt.noisy_sel.long()],
                             clean_latents=tl[tt.clean_sel.long()])
    return jin, tin


def jax_draws(key, jin, rows, blocks) -> LossDraws:
    """The draws the JAX ``training_loss`` makes from ``key``."""
    r_x0, r_t, r_x0c, r_tc = jax.random.split(key, 4)
    return LossDraws(*(torch.from_numpy(np.array(x)) for x in (
        jax.random.normal(r_x0, jin.x1.shape, jin.x1.dtype),
        jax.random.uniform(r_t, (rows, blocks)),
        jax.random.normal(r_x0c, jin.clean_latents.shape),
        jax.random.uniform(r_tc, (jin.clean_latents.shape[0],)))))


def port_model(params, **cfg) -> VideoGPT:
    tm = VideoGPT(ModelConfig.tiny(pos_embed_max_size=8, **cfg),
                  device="cpu", train_init=True)
    tm.load_state_dict(videogpt_state_dict_from_jax(params, tm.cfg),
                       strict=True)
    return tm


def offload_run(params, cfg, grad_splits=1, **model_cfg):
    """(the port's offload train state of ``params``, its step)."""
    tm = port_model(params, **model_cfg)
    return offload.init_offload_training(
        tm, TrainConfig(**dict(cfg, offload_grad_splits=grad_splits)))


def assert_params_close(tm, want: dict, rtol=PARAM_RTOL, atol=PARAM_ATOL):
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(want[name], np.float32),
                                   rtol=rtol, atol=atol, err_msg=name)


CHUNK_SHAPES = [(), (7,), (32, 8, 8), ((384 << 20) // 4 + 1,),
                (3, (200 << 20) // 4), (2, (500 << 20) // 4),
                (32, 8192, 3072), (7, 4096, 4096), (33, 3072, 1024)]


@pytest.mark.parametrize("shape", CHUNK_SHAPES, ids=str)
def test_chunk_sizes_match_jax(shape):
    got = offload.chunk_sizes(shape)
    assert got == joffload.chunk_sizes(shape)
    if shape:
        assert sum(got) == shape[0]


@pytest.mark.parametrize("grad_splits,route", [(1, "bias"), (2, "inline")])
def test_offload_steps_match_jax_and_adamw(grad_splits, route, monkeypatch):
    """Three steps against the JAX offload step and the port's AdamW step;
    at ``grad_splits`` 2 each pass differentiates half the parameters with
    the same draws, and the trajectory is one pass's. That case runs the
    inline route of stages 2-4 (no bias precomputed: plain K6 / K7)."""
    from video_gpt_tpu_torch.ops import flash_attention as fa
    route_cfg = {} if route == "bias" else dict(precompute_bias_limit=0)
    calls = []
    for name in ("bias_attention_backward_reference",
                 "inline_attention_backward_reference"):
        fn = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    jm, params = jax_model_and_params()
    jin, tin = inputs_pair()
    jstate = joffload.init_offload_state(jax.tree.map(jnp.asarray, params))
    jstep = joffload.make_offload_train_step(
        jm, JTrainConfig(**STEP_KW), max_blocks=F, grad_splits=grad_splits)
    jparams = jax.tree.map(jnp.asarray, params)
    state, step = offload_run(params, STEP_KW, grad_splits, **route_cfg)
    ref = port_model(params, **route_cfg)
    ref_state = init_train_state(ref, TrainConfig(**STEP_KW))
    ref_step = make_train_step(ref, TrainConfig(**STEP_KW))
    rows = tin.batch.input_ids.shape[0]
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        jparams, jstate, jm_ = jstep(jparams, jstate, key, jin)
        draws = jax_draws(key, jin, rows, F)
        m = step(state, tin, draws)
        rm = ref_step(ref_state, tin, draws)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]),
                                       rtol=METRIC_RTOL, err_msg=k)
            np.testing.assert_allclose(float(m[k]), float(rm[k]),
                                       rtol=METRIC_RTOL, err_msg=k)
    assert state.step == 3 and state.optimizer.count == 3
    assert int(jstate.count) == 3 and len(step.groups) == grad_splits
    assert set(calls) == {f"{route}_attention_backward_reference"}
    assert_params_close(state.model, videogpt_state_dict_from_jax(
        jax.device_get(jparams), state.model.cfg))
    assert_params_close(state.model, {n: p.detach() for n, p in
                                      ref.named_parameters()})
    # the step's phases were timed, and the parameters are grad-ready
    assert set(step.split) == set(offload.PHASES)
    assert all(p.requires_grad for p in state.model.parameters())


def test_chunked_update_is_bit_equal(monkeypatch):
    _, params = jax_model_and_params(seed=2)
    jin, tin = inputs_pair()
    draws = jax_draws(jax.random.PRNGKey(7), jin,
                      tin.batch.input_ids.shape[0], F)
    runs = []
    for bound in (offload.CHUNK_BYTES_F32, 2048):
        monkeypatch.setattr(offload, "CHUNK_BYTES_F32", bound)
        state, step = offload_run(params, STEP_KW)
        for _ in range(2):
            step(state, tin, draws)
        runs.append(state)
    assert any(len(offload.chunk_sizes(tuple(t.shape))) > 1
               for t in runs[1].optimizer.master.values())
    whole, chunked = runs
    for field in ("master", "mu", "nu"):
        for name, t in getattr(whole.optimizer, field).items():
            assert torch.equal(getattr(chunked.optimizer, field)[name], t), \
                (field, name)
    for (name, p), q in zip(whole.model.named_parameters(),
                            chunked.model.parameters()):
        assert torch.equal(p, q), name


def test_bf16_parameters_round_through_the_fp32_master():
    _, params = jax_model_and_params(seed=3)
    jin, tin = inputs_pair()
    init = videogpt_state_dict_from_jax(params, ModelConfig.tiny(
        pos_embed_max_size=8))
    state, step = offload_run(params, dict(STEP_KW, mixed_precision="bf16"))
    ost = state.optimizer
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.bfloat16, name
        m = ost.master[name]
        assert m.dtype == torch.float32 and m.device.type == "cpu"
        assert torch.equal(m, init[name].to(torch.bfloat16).float()), name
        assert not ost.mu[name].any() and not ost.nu[name].any()
    m = step(state, tin, jax_draws(jax.random.PRNGKey(0), jin,
                                   tin.batch.input_ids.shape[0], F))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    moved = 0
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p.detach(), ost.master[name].to(torch.bfloat16)), \
            name
        moved += not torch.equal(ost.master[name],
                                 init[name].to(torch.bfloat16).float())
    assert moved == len(ost.master)


def test_bf16_offload_steps_match_the_jax_bf16_step():
    """Three bf16 steps from one fp32 init against the JAX bf16 offload
    step with the same draws. The two packages round in bf16 in different
    places, so they agree only to bf16 error: the bar is twice the JAX bf16
    run's own distance from the fp32 trajectory (the port's fp32 offload
    run from bf16(init), which the fp32 tests hold to the JAX fp32 step)
    for the master, mu and nu after the steps and for the loss and
    gradient-norm sequences; the first loss (both from bf16(init)) within
    2^-8. A master built from the unrounded init, or parameters left in
    fp32, lands at 6.3-6.6x the JAX bf16 run's distance in the master."""
    jm, params = jax_model_and_params(seed=3)
    jin, tin = inputs_pair()
    jm16 = JVideoGPT(jm.cfg, dtype=jnp.bfloat16, train_init=True)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    jstate = joffload.init_offload_state(jparams)
    jstep = joffload.make_offload_train_step(
        jm16, JTrainConfig(**dict(STEP_KW, mixed_precision="bf16")),
        max_blocks=F)
    rounded = jax.tree.map(
        lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32),
        params)
    runs = [offload_run(params, dict(STEP_KW, mixed_precision="bf16")),
            offload_run(rounded, STEP_KW)]
    rows = tin.batch.input_ids.shape[0]
    jax_m, port_m, fp32_m = [], [], []
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        jparams, jstate, m = jstep(jparams, jstate, key, jin)
        jax_m.append([float(m["loss"]), float(m["grad_norm"])])
        draws = jax_draws(key, jin, rows, F)
        for (state, step), out in zip(runs, (port_m, fp32_m)):
            m = step(state, tin, draws)
            out.append([float(m["loss"]), float(m["grad_norm"])])
    jax_m, port_m, fp32_m = map(np.asarray, (jax_m, port_m, fp32_m))
    assert abs(port_m[0, 0] - jax_m[0, 0]) <= 2 ** -8 * abs(jax_m[0, 0])
    for k, name in enumerate(("loss", "grad_norm")):
        got = np.linalg.norm(port_m[:, k] - jax_m[:, k])
        assert got <= 2 * np.linalg.norm(jax_m[:, k] - fp32_m[:, k]), name
    want = offload_state_from_jax(jax.device_get(jstate),
                                  runs[0][0].model.cfg)
    (port, _), (fp32, _) = runs
    for field in ("master", "mu", "nu"):
        got, ref = (getattr(s.optimizer, field) for s in (port, fp32))

        def dist(a):
            return sum(float((a[n] - want[field][n]).square().sum())
                       for n in a) ** 0.5
        assert dist(got) <= 2 * dist(ref), field
    for name, p in port.model.named_parameters():
        assert p.dtype == torch.bfloat16, name


def test_grad_groups_balance_bytes():
    sizes = [100, 7, 60, 40, 1, 50]
    params = [torch.empty(n) for n in sizes]
    groups = offload.grad_groups(params, 2)
    assert sorted(i for g in groups for i in g) == list(range(len(sizes)))
    # largest first into the lightest: 100 | 60, 50 | 40 | 7, 1
    assert [sorted(sizes[i] for i in g) for g in groups] == [
        [40, 100], [1, 7, 50, 60]]
    assert offload.grad_groups(params, 1) == [list(range(len(sizes)))]
    assert len(offload.grad_groups(params[:1], 3)) == 1
