"""One distillation step on a mesh, unguided and guided (w 1.5), against
the JAX step under the same JAX mesh and against the port's one-rank
step, on the CPU: (data 2), (tensor 2) and (data 2, zero3) here; the seq
meshes (Ulysses and the ring) and GPipe's (pipe 2, nm 2) in
``test_torch_mesh_distill_seq.py``.

The JAX side is ``make_distill_train_step`` on ``place_train_state`` (the
student) with the frozen teacher placed by ``param_specs`` as the JAX
Trainer places it (its tensor part, ZeRO-3 part and pipe stage), and
``apply_fn=pp_apply`` on a pipe mesh; the port's ranks are spawned gloo
processes (``torch_mesh_ranks.train_step_case``). The teacher is the
warm start and the student a copy of it perturbed by another draw, so the
regression has a target; both sides take the same global batch (its
'uncond' layout under guidance), the same latents and the JAX loss's own
draws (its ``jax.random.split`` of the step key), each rank its rows and
its slices of them. The Trainer's own step (the teacher equal to the
student; the step generator's draws made for the global batch and sliced)
is held to the one-rank Trainer's.

Bars (slice 2's): loss rtol 1e-5; every gradient of the student and
every parameter after rtol 1e-4 / atol 1e-6, each rank's part against the
same part of the whole; the teacher bit-equal after the step on every
rank. ``draw_distill_noise(part=)`` is bit-equal to the rows of the
global batch's draws.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_ranks as ranks
from test_torch_mesh_train_step import (BLOCKS, CFG, F, JCFG, N_IMG, PX,
                                        _compare, _setup, _tcfg)
from video_gpt_tpu.config import MeshConfig as JMeshConfig
from video_gpt_tpu.data.video import ClipSample as JClipSample
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.parallel.mesh import make_mesh as jmake_mesh
from video_gpt_tpu.parallel.mesh import param_specs, place_train_state
from video_gpt_tpu.parallel.pipeline import pp_apply as jpp_apply
from video_gpt_tpu.parallel.tensor import tp_regroup_params as jtp_regroup
from video_gpt_tpu.training import distill as jdistill
from video_gpt_tpu.training.data import collate as jcollate
from video_gpt_tpu.training.train_state import \
    init_train_state as jinit_state
from video_gpt_tpu_torch.config import MeshConfig
from video_gpt_tpu_torch.data.video import ClipSample
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
from video_gpt_tpu_torch.training.data import collate
from video_gpt_tpu_torch.training.distill import draw_distill_noise
from video_gpt_tpu_torch.training.loss import DrawPart
from video_gpt_tpu_torch.utils.weights import videogpt_state_dict_from_jax

S = 3  # the student's steps
BLOCKS4 = ((1, 2), (1, 1, 1), (2, 1), (3,))


def _dcfg(guidance, **extra):
    """(JAX, port) TrainConfigs of a distillation step."""
    return _tcfg(distill=True, distill_student_steps=S, distill_substeps=2,
                 distill_lr=1e-3, distill_guidance=guidance, **extra)


@functools.lru_cache(maxsize=None)
def _student(blocks=BLOCKS):
    """The student's JAX params: the teacher's (``_setup``'s) perturbed by
    another draw."""
    params = _setup(blocks)[0]
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda x: x + 0.02 * rng.standard_normal(
        x.shape).astype(np.float32), params)


def _injected(seq, guided, blocks=BLOCKS, seed=7):
    """(JAX inputs, (latents, the JAX distillation loss's draws of the
    key), the key)."""
    samples = _setup(blocks)[3]
    jt = jcollate([JClipSample(p, b) for p, b in samples], N_IMG,
                  sp_multiple=seq, uncond=guided)
    lat = np.random.default_rng(seed).standard_normal(
        (len(blocks) * F, 4, 4, 4)).astype(np.float32)
    jin = jt.inputs._replace(x1=jnp.take(lat, jt.noisy_sel, axis=0),
                             clean_latents=jnp.take(lat, jt.clean_sel,
                                                    axis=0))
    key = jax.random.PRNGKey(seed)
    r_x0, r_i, r_x0c, r_tc = jax.random.split(key, 4)
    nc = jin.clean_latents.shape[0]
    draws = (np.asarray(jax.random.normal(r_x0, jin.x1.shape, jnp.float32)),
             np.asarray(jax.random.randint(r_i, (len(blocks), F), 0, S)
                        ).astype(np.int64),
             np.asarray(jax.random.normal(r_x0c, jin.clean_latents.shape)),
             np.asarray(jax.random.uniform(r_tc, (nc,))))
    return jin, (lat, draws), key


def _jax_step(mesh_dims, sp, guidance, num_micro, blocks):
    """The JAX mesh's (loss, student gradient, student after), in the
    port's standard layout."""
    data, seq, tensor, zero3 = mesh_dims[:4]
    pipe = mesh_dims[4] if len(mesh_dims) > 4 else 1
    teacher = _setup(blocks)[0]
    student = _student(blocks)
    jtcfg, _ = _dcfg(guidance)
    over = dict(remat=True, tensor_parallel=tensor)
    if seq > 1:
        over.update(seq_shard=True, sp_attention=sp)
    cfg = dataclasses.replace(JCFG, **over)
    model = JVideoGPT(cfg, dtype=jnp.float32, train_init=True)
    apply_fn = None
    if pipe > 1:
        apply_fn = functools.partial(jpp_apply, model,
                                     num_micro=num_micro or pipe)

    def grouped(p):
        return p["params"] if tensor == 1 else jtp_regroup(p["params"], cfg)

    def standard(tree):
        tree = jax.device_get(tree)
        if tensor > 1:
            tree = jtp_regroup(tree, cfg, inverse=True)
        return videogpt_state_dict_from_jax(tree, CFG)

    mesh = jmake_mesh(JMeshConfig(data=data, seq=seq, tensor=tensor,
                                  pipe=pipe, zero_params=zero3))
    jin, _, key = _injected(seq, guidance is not None, blocks)
    kw = dict(max_blocks=F, student_steps=S, substeps=2,
              cfg_scale=guidance, apply_fn=apply_fn)
    with jax.sharding.set_mesh(mesh):
        t = grouped(teacher)
        t = jax.device_put(t, param_specs(t, mesh, tp=tensor > 1,
                                          pp=pipe > 1, zero=zero3))
        state = place_train_state(jinit_state(
            model, {"params": grouped(student)}, jtcfg), mesh,
            zero_params=zero3, tp=tensor > 1, pp=pipe > 1)
        grads = jax.jit(jax.grad(lambda p: jdistill.distillation_loss(
            model, {"params": p}, {"params": t}, key, jin, **kw)[0]))(
                state.params["params"])
        state, metrics = jax.jit(jdistill.make_distill_train_step(
            model, jtcfg, F, apply_fn=apply_fn))(state, {"params": t}, key,
                                                 jin)
        return (float(metrics["loss"]), standard(grads),
                standard(state.params["params"]))


def check_distill_step(tmp_path, mesh_dims, guidance, sp="ulysses",
                       num_micro=0, blocks=BLOCKS):
    """The mesh's distillation step (injected) against the JAX mesh's and
    the one-rank step; the Trainer's own step against the one-rank
    Trainer's; the teacher bit-equal on every rank. ``mesh_dims`` (data,
    seq, tensor, zero3[, pipe])."""
    _, sd, vae_sd, samples = _setup(blocks)
    extra = {}
    if sp != "ulysses":
        extra["sp_attention"] = sp
    if len(mesh_dims) > 4:
        extra.update(pp_microbatches=num_micro,
                     batch_size_per_device=len(blocks) // mesh_dims[0])
    _, tcfg = _dcfg(guidance, **extra)
    _, injected, _ = _injected(mesh_dims[1], guidance is not None, blocks)
    student = videogpt_state_dict_from_jax(_student(blocks), CFG)
    args = (CFG, tcfg, VAEConfig.tiny(), sd, vae_sd, samples, (PX, PX),
            [injected], 1, {k: v.numpy() for k, v in student.items()})
    one = ranks.train_step_case(None, *args)
    mesh_cfg = MeshConfig(*mesh_dims)
    res = spawn_ranks(ranks.train_step_case, (mesh_cfg,) + args,
                      mesh_cfg.num_devices, str(tmp_path), threads=1,
                      timeout=300)
    loss, jgrads, jparams = _jax_step(mesh_dims, sp, guidance, num_micro,
                                      blocks)
    assert all(r["ring"] == (sp == "ring") for r in res)
    assert one["trainer"]["frozen_kept"] and one["injected"]["frozen_kept"]
    for r in res:
        inj = r["injected"]
        assert inj["frozen_kept"] and r["trainer"]["frozen_kept"]
        np.testing.assert_allclose(inj["losses"], [loss], rtol=1e-5)
        np.testing.assert_allclose(inj["losses"], one["injected"]["losses"],
                                   rtol=1e-5)
        _compare(inj, jgrads, jparams, mesh_dims, r["coords"], "vs JAX")
        _compare(inj, one["injected"]["grads"], one["injected"]["params"],
                 mesh_dims, r["coords"], "vs one rank")
        np.testing.assert_allclose(r["trainer"]["loss"],
                                   one["trainer"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["trainer"]["grad_norm"],
                                   one["trainer"]["grad_norm"], rtol=1e-5)
        _compare(r["trainer"], one["trainer"]["grads"],
                 one["trainer"]["params"], mesh_dims, r["coords"],
                 "Trainer step vs one rank")
    assert float(one["injected"]["loss"]) > 0


@pytest.mark.parametrize("guidance", [None, 1.5], ids=["plain", "guided"])
@pytest.mark.parametrize("mesh_dims", [(2, 1, 1, False), (1, 1, 2, False),
                                       (2, 1, 1, True)],
                         ids=["data2", "tensor2", "data2_zero3"])
def test_distill_mesh_step_matches_jax_and_one_rank(tmp_path, mesh_dims,
                                                    guidance):
    check_distill_step(tmp_path, mesh_dims, guidance)


def test_draw_distill_noise_part_is_the_global_draws_rows():
    """Each data rank of 2 draws the global batch's numbers from the
    step's generator and keeps its noisy slots, rows and clean slots: the
    rows of the one-rank draws, bit for bit. The rows hold different
    numbers of clean frames, so the ranks' clean parts differ in size."""
    samples = _setup(BLOCKS4)[3]
    tbs = [collate([ClipSample(p, b) for p, b in samples[r]], N_IMG)
           for r in (slice(0, 4), slice(0, 2), slice(2, 4))]
    lat = [torch.zeros((tb.pixels.shape[0], 4, 4, 4)) for tb in tbs]
    ins = [tb.inputs._replace(x1=x[tb.noisy_sel.long()],
                              clean_latents=x[tb.clean_sel.long()])
           for tb, x in zip(tbs, lat)]
    whole = draw_distill_noise(torch.Generator().manual_seed(5), ins[0],
                               F, S)
    counts = [int(tb.clean_valid.sum()) for tb in tbs[1:]]
    assert counts[0] != counts[1]
    for i, (tb, inp) in enumerate(zip(tbs[1:], ins[1:])):
        nn_, nc = inp.x1.shape[0], inp.clean_latents.shape[0]
        part = DrawPart(noisy=(i * nn_, 2 * nn_), rows=(i * 2, 4),
                        clean=(sum(counts[:i]), 2 * nc))
        got = draw_distill_noise(torch.Generator().manual_seed(5), inp, F,
                                 S, part=part)
        c0 = sum(counts[:i])
        want = (whole.x0[i * nn_:(i + 1) * nn_],
                whole.index[2 * i:2 * i + 2],
                whole.x0c[c0:c0 + nc], whole.t_clean[c0:c0 + nc])
        for name, g, w in zip(got._fields, got, want):
            assert g.shape == w.shape, name
            assert torch.equal(g, w), name
