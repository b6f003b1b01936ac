"""One training step on a mesh, the slice as a whole, against the JAX step
under the same JAX mesh and against the port's one-rank step, on the CPU.

Each mesh's ranks are spawned gloo processes (``torch_mesh_ranks.
train_step_case``, with a timeout); the JAX step is ``make_train_step`` on
``place_train_state`` under ``make_mesh`` of the same grid on
``conftest.py``'s 8 CPU devices (the model built as the JAX Trainer builds
it for the mesh: Ulysses over seq, ``tensor_parallel`` over tensor, per-
layer recompute). Both sides get the same global batch (two rows of
different frame blocks, so the data ranks hold different numbers of clean
frames), the same latents and the JAX loss's own draws (the test replays
its split of the step key); each rank takes its rows and its slices of the
draws. The port's one-rank reference runs the same two ways, and the
Trainer's own step (VAE encode and draws from the step's generator,
sliced to the rank) on the mesh is held to the Trainer's one-rank step.

Bars (slice 2's): loss rtol 1e-5; every gradient (the embedders, the
norms and the heads included) and every updated parameter rtol 1e-4 /
atol 1e-6, each rank's part against the same part of the whole. AdamW's
epsilon is 1e-3 so that a gradient near zero moves its parameter in
proportion (at 1e-8 Adam's first step is sign-like and amplifies ulp
differences of near-zero gradients).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_ranks as ranks
from video_gpt_tpu.config import MeshConfig as JMeshConfig
from video_gpt_tpu.config import ModelConfig as JConfig
from video_gpt_tpu.config import TrainConfig as JTrainConfig
from video_gpt_tpu.data.video import ClipSample as JClipSample
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.parallel.mesh import make_mesh as jmake_mesh
from video_gpt_tpu.parallel.mesh import place_train_state
from video_gpt_tpu.parallel.pipeline import pp_apply as jpp_apply
from video_gpt_tpu.parallel.tensor import tp_regroup_params as jtp_regroup
from video_gpt_tpu.training import loss as jloss
from video_gpt_tpu.training.data import collate as jcollate
from video_gpt_tpu.training.train_state import \
    init_train_state as jinit_state
from video_gpt_tpu.training.train_state import make_train_step
from video_gpt_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from video_gpt_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
from video_gpt_tpu_torch.parallel.mesh import zero_dim
from video_gpt_tpu_torch.utils.weights import (tp_shard,
                                               videogpt_state_dict_from_jax)

F, PX, N_IMG = 3, 32, 4
BLOCKS = ((1, 2), (1, 1, 1))
H, HKV = 8, 4
JCFG = JConfig.tiny(num_heads=H, num_kv_heads=HKV, hidden_size=128,
                    pos_embed_max_size=8)
CFG = ModelConfig.tiny(num_heads=H, num_kv_heads=HKV, hidden_size=128,
                       pos_embed_max_size=8)
# (data, seq, tensor, zero3)
MESHES = {"data2": (2, 1, 1, False), "seq2": (1, 2, 1, False),
          "tensor2": (1, 1, 2, False), "data2_zero3": (2, 1, 1, True),
          "data2_seq2": (2, 2, 1, False),
          "data2_tensor2_zero3": (2, 1, 2, True),
          "seq2_tensor2": (1, 2, 2, False)}
BAR = dict(rtol=1e-4, atol=1e-6)


def _tcfg(accum=1, **extra):
    """(JAX, port) TrainConfigs of the step; ``extra``: further fields of
    both (the ring, GPipe's microbatches and rows per rank)."""
    kw = dict(lr_scheduler="constant", mixed_precision="no",
              adam_epsilon=1e-3, gradient_accumulation_steps=accum, **extra)
    return JTrainConfig(**kw), TrainConfig(**kw)


@functools.lru_cache(maxsize=None)
def _setup(blocks=BLOCKS):
    """(JAX params, the port's state dict of them, the VAE's, the global
    batch's samples: one row per frame-block partition of ``blocks``)."""
    rng = np.random.default_rng(0)
    samples = [(rng.uniform(-1, 1, (F, PX, PX, 3)).astype(np.float32), b)
               for b in blocks]
    jt = jcollate([JClipSample(p, b) for p, b in samples], N_IMG)
    nn_, nc = int(jt.noisy_sel.shape[0]), int(jt.clean_sel.shape[0])
    params = JVideoGPT(JCFG, dtype=jnp.float32, train_init=True).init(
        jax.random.PRNGKey(1), jt.inputs.batch, jnp.zeros((nn_, 4, 4, 4)),
        jnp.zeros((nn_,)), jnp.zeros((nc, 4, 4, 4)))
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
        x.shape).astype(np.float32), params)
    vae_sd = AutoencoderKL(VAEConfig.tiny()).init_random_(
        torch.Generator().manual_seed(2)).state_dict()
    return params, videogpt_state_dict_from_jax(params, CFG), vae_sd, samples


def _injected(seq, seeds, blocks=BLOCKS):
    """(JAX inputs, [(latents, the JAX loss's draws of the key)], keys)."""
    _, _, _, samples = _setup(blocks)
    jt = jcollate([JClipSample(p, b) for p, b in samples], N_IMG,
                  sp_multiple=seq)
    out, keys = [], []
    for seed in seeds:
        lat = np.random.default_rng(seed).standard_normal(
            (len(blocks) * F, 4, 4, 4)).astype(np.float32)
        jin = jt.inputs._replace(x1=jnp.take(lat, jt.noisy_sel, axis=0),
                                 clean_latents=jnp.take(lat, jt.clean_sel,
                                                        axis=0))
        key = jax.random.PRNGKey(seed)
        r_x0, r_t, r_x0c, r_tc = jax.random.split(key, 4)
        draws = tuple(np.asarray(x) for x in (
            jax.random.normal(r_x0, jin.x1.shape),
            jax.random.uniform(r_t, (len(blocks), F)),
            jax.random.normal(r_x0c, jin.clean_latents.shape),
            jax.random.uniform(r_tc, (jin.clean_latents.shape[0],))))
        out.append((jin, (lat, draws), key))
    return out


def _jax_step(mesh_dims, accum, seeds, sp="ulysses", num_micro=0,
              blocks=BLOCKS):
    """The JAX mesh's (losses, mean gradient, parameters after), the
    gradient and parameters in the port's standard layout. ``mesh_dims``
    (data, seq, tensor, zero3[, pipe]); ``sp`` the attention over seq;
    ``num_micro`` GPipe's microbatches (0: one per stage)."""
    data, seq, tensor, zero3 = mesh_dims[:4]
    pipe = mesh_dims[4] if len(mesh_dims) > 4 else 1
    params, _, _, _ = _setup(blocks)
    jtcfg, _ = _tcfg(accum)
    over = dict(remat=True, tensor_parallel=tensor)
    if seq > 1:
        over.update(seq_shard=True, sp_attention=sp)
    cfg = dataclasses.replace(JCFG, **over)
    model = JVideoGPT(cfg, dtype=jnp.float32, train_init=True)
    apply_fn = None
    if pipe > 1:
        apply_fn = functools.partial(jpp_apply, model,
                                     num_micro=num_micro or pipe)
    p = params["params"] if tensor == 1 else jtp_regroup(params["params"],
                                                          cfg)
    mesh = jmake_mesh(JMeshConfig(data=data, seq=seq, tensor=tensor,
                                  pipe=pipe, zero_params=zero3))

    def standard(tree):
        tree = jax.device_get(tree)
        if tensor > 1:
            tree = jtp_regroup(tree, cfg, inverse=True)
        return videogpt_state_dict_from_jax(tree, CFG)

    with jax.sharding.set_mesh(mesh):
        state = place_train_state(jinit_state(model, {"params": p}, jtcfg),
                                  mesh, zero_params=zero3, tp=tensor > 1,
                                  pp=pipe > 1)
        step = jax.jit(make_train_step(model, jtcfg, max_blocks=F,
                                       apply_fn=apply_fn))
        losses, grads = [], []
        for jin, _, key in _injected(seq, seeds, blocks):
            grads.append(jax.jit(jax.grad(lambda q: jloss.training_loss(
                model, {"params": q}, key, jin, max_blocks=F,
                apply_fn=apply_fn)[0]))(state.params["params"]))
            state, metrics = step(state, key, jin)
            losses.append(float(metrics["loss"]))
        mean = jax.tree.map(lambda *g: sum(g) / len(g), *grads)
        return losses, standard(mean), standard(state.params["params"])


def _part(name, whole, mesh_dims, coords, zero_part):
    """This rank's part of the whole entry: its tensor part, and along the
    ZeRO dimension its data part when ``zero_part``."""
    data, tensor = mesh_dims[0], mesh_dims[2]
    w = tp_shard(name, whole, CFG, tensor, coords["tensor"])
    d = zero_dim(w.shape, data)
    if zero_part and d is not None:
        w = w.chunk(data, dim=d)[coords["data"]]
    return w


def _held(names, mesh_dims, coords):
    """The entries of ``names`` that a rank at ``coords`` holds: all of
    them, but on a pipe mesh only its stage's layers."""
    pipe = mesh_dims[4] if len(mesh_dims) > 4 else 1
    if pipe == 1:
        return set(names)
    per = CFG.num_layers // pipe
    return {n for n in names if not n.startswith("llm.layers.")
            or int(n.split(".")[2]) // per == coords["pipe"]}


def _compare(rec, want_grads, want_params, mesh_dims, coords, what):
    zero3 = mesh_dims[3]
    assert set(rec["grads"]) == _held(want_grads, mesh_dims, coords)
    for name, g in rec["grads"].items():
        want = _part(name, want_grads[name], mesh_dims, coords, True)
        np.testing.assert_allclose(g.numpy(), want.numpy(), **BAR,
                                   err_msg=f"{what}: gradient {name}")
    for name, p in rec["params"].items():
        want = _part(name, want_params[name], mesh_dims, coords, zero3)
        np.testing.assert_allclose(p.numpy(), want.numpy(), **BAR,
                                   err_msg=f"{what}: parameter {name}")


def _run(tmp_path, mesh_dims, accum=1, seeds=(7,), blocks=BLOCKS,
         **extra):
    """The one-rank and the mesh's ranks' ``train_step_case``;
    ``extra``: TrainConfig fields of both."""
    _, sd, vae_sd, samples = _setup(blocks)
    _, tcfg = _tcfg(accum, **extra)
    seq = mesh_dims[1]
    injected = [x[1] for x in _injected(seq, seeds, blocks)]
    args = (CFG, tcfg, VAEConfig.tiny(), sd, vae_sd, samples, (PX, PX),
            injected, len(seeds))
    one = ranks.train_step_case(None, *args)
    mesh_cfg = MeshConfig(*mesh_dims)
    res = spawn_ranks(ranks.train_step_case, (mesh_cfg,) + args,
                      mesh_cfg.num_devices, str(tmp_path), threads=1,
                      timeout=300)
    return one, res


def _whole_record(rec):
    """A one-rank record's gradients and parameters (its own layout)."""
    return rec["grads"], rec["params"]


def check_mesh_step(tmp_path, mesh_name, mesh_dims=None, sp="ulysses",
                    num_micro=0, blocks=BLOCKS, accum=1, seeds=(7,)):
    """The mesh's step (the injected one; under ``accum`` the last of
    ``seeds``' micro-steps) against the JAX mesh's and the one-rank step;
    the Trainer's own step against the one-rank Trainer's. ``mesh_dims``
    (data, seq, tensor, zero3[, pipe]) defaults to ``MESHES[mesh_name]``;
    ``sp`` is the attention over seq, ``num_micro`` GPipe's microbatches,
    ``blocks`` the global batch's rows."""
    mesh_dims = mesh_dims or MESHES[mesh_name]
    extra = {}
    if sp != "ulysses":
        extra["sp_attention"] = sp
    if len(mesh_dims) > 4:
        extra.update(pp_microbatches=num_micro,
                     batch_size_per_device=len(blocks) // mesh_dims[0])
    one, res = _run(tmp_path, mesh_dims, accum, seeds, blocks, **extra)
    losses, jgrads, jparams = _jax_step(mesh_dims, accum, seeds, sp,
                                        num_micro, blocks)
    assert all(r["ring"] == (sp == "ring") for r in res)
    for r in res:
        inj = r["injected"]
        np.testing.assert_allclose(inj["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(inj["losses"], one["injected"]["losses"],
                                   rtol=1e-5)
        _compare(inj, jgrads, jparams, mesh_dims, r["coords"], "vs JAX")
        _compare(inj, *_whole_record(one["injected"]), mesh_dims,
                 r["coords"], "vs one rank")
        # the Trainer's own step: generator draws sliced to the rank
        np.testing.assert_allclose(r["trainer"]["loss"],
                                   one["trainer"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["trainer"]["grad_norm"],
                                   one["trainer"]["grad_norm"], rtol=1e-5)
        _compare(r["trainer"], *_whole_record(one["trainer"]), mesh_dims,
                 r["coords"], "Trainer step vs one rank")


@pytest.mark.parametrize("mesh_name", ["data2", "tensor2", "data2_zero3",
                                       "data2_tensor2_zero3"])
def test_mesh_step_matches_jax_and_one_rank(tmp_path, mesh_name):
    """The meshes without a seq axis (K3/K9's route on the card); those
    with one are in ``test_torch_mesh_train_step_seq.py``."""
    check_mesh_step(tmp_path, mesh_name)


def check_gradient_accumulation(tmp_path):
    """Two micro-steps of ``gradient_accumulation_steps=2`` on (data 2)
    against the JAX mesh's two steps and the one-rank Trainer's."""
    mesh_dims = MESHES["data2"]
    one, res = _run(tmp_path, mesh_dims, accum=2, seeds=(7, 8))
    losses, jgrads, jparams = _jax_step(mesh_dims, 2, (7, 8))
    for r in res:
        np.testing.assert_allclose(r["injected"]["losses"], losses,
                                   rtol=1e-5)
        _compare(r["injected"], jgrads, jparams, mesh_dims, r["coords"],
                 "vs JAX")
        _compare(r["trainer"], *_whole_record(one["trainer"]), mesh_dims,
                 r["coords"], "Trainer steps vs one rank")


def test_image_trainer_step_on_a_mesh(tmp_path):
    """One ``ImageGenTrainer`` step on (data 2, tensor 2): a row with an
    input image and a row without (the data ranks hold different numbers
    of clean slots). The train step on injected latents and the JAX
    loss's draws against the JAX velocity step under the same JAX mesh
    and the one-rank step; the trainer's own step (the VAE's posterior
    draws and the loss's draws made for the global batch and sliced)
    against the one-rank trainer's."""
    from video_gpt_tpu.data import image_text as jdata
    from video_gpt_tpu.image_gen import TextRow as JTextRow
    from video_gpt_tpu_torch.data import image_text as tdata
    from video_gpt_tpu_torch.image_gen import TextRow
    params, sd, vae_sd, _ = _setup()
    rng = np.random.default_rng(3)
    pixels = [rng.uniform(-1, 1, (PX, PX, 3)).astype(np.float32)
              for _ in range(3)]

    def samples(mod, row):
        return [mod.ImageGenSample(row([5, 6] + [0] * 4 + [7], [(2, 6)]),
                                   [pixels[0]], pixels[1]),
                mod.ImageGenSample(row([8, 9, 10], []), [], pixels[2])]

    jt = jdata.collate_image_gen(samples(jdata, JTextRow), 40, 2)
    lat = np.random.default_rng(4).standard_normal(
        (2 + 4, 4, 4, 4)).astype(np.float32)
    x1, clean = lat[:2], lat[2:]
    jin = jt.inputs._replace(x1=jnp.asarray(x1),
                             clean_latents=jnp.asarray(clean))
    key = jax.random.PRNGKey(9)
    r_x0, r_t, r_x0c, r_tc = jax.random.split(key, 4)
    draws = tuple(np.asarray(x) for x in (
        jax.random.normal(r_x0, x1.shape), jax.random.uniform(r_t, (2, 1)),
        jax.random.normal(r_x0c, clean.shape),
        jax.random.uniform(r_tc, (clean.shape[0],))))
    jtcfg, tcfg = _tcfg()
    args = (CFG, tcfg, sd, vae_sd, samples(tdata, TextRow), PX, 40,
            (x1, clean, draws))
    one = ranks.image_step_case(None, *args)
    mesh_dims = (2, 1, 2, False)
    res = spawn_ranks(ranks.image_step_case, (MeshConfig(*mesh_dims),)
                      + args, 4, str(tmp_path), threads=1, timeout=300)

    cfg = dataclasses.replace(JCFG, remat=True, tensor_parallel=2)
    model = JVideoGPT(cfg, dtype=jnp.float32, train_init=True)
    mesh = jmake_mesh(JMeshConfig(data=2, tensor=2))
    with jax.sharding.set_mesh(mesh):
        state = place_train_state(jinit_state(
            model, {"params": jtp_regroup(params["params"], cfg)}, jtcfg),
            mesh, tp=True)
        grads = jax.jit(jax.grad(lambda q: jloss.training_loss(
            model, {"params": q}, key, jin, max_blocks=1,
            prediction_target="velocity")[0]))(state.params["params"])
        state, metrics = jax.jit(make_train_step(
            model, jtcfg, max_blocks=1, prediction_target="velocity"))(
                state, key, jin)

    def standard(tree):
        return videogpt_state_dict_from_jax(jtp_regroup(
            jax.device_get(tree), cfg, inverse=True), CFG)

    jgrads, jparams = standard(grads), standard(state.params["params"])
    for r in res:
        inj = r["injected"]
        np.testing.assert_allclose(inj["loss"], float(metrics["loss"]),
                                   rtol=1e-5)
        _compare(inj, jgrads, jparams, mesh_dims, r["coords"],
                 "image step vs JAX")
        _compare(inj, one["injected"]["grads"], one["injected"]["params"],
                 mesh_dims, r["coords"], "image step vs one rank")
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], one["grad_norm"],
                                   rtol=1e-5)
        _compare(r, one["grads"], one["params"], mesh_dims, r["coords"],
                 "image Trainer step vs one rank")
