"""One LoRA fine-tuning step on a mesh against the JAX step under the same
JAX mesh and against the port's one-rank step, on the CPU.

The JAX side is ``make_lora_train_step`` on ``place_train_state`` (the
adapter tree) with the frozen base placed by ``param_specs`` (its tensor
part, under ZeRO-3 its data part), as the JAX Trainer places them, under
``make_mesh`` of the same grid on ``conftest.py``'s 8 CPU devices; the
port's ranks are spawned gloo processes (``torch_mesh_ranks.
train_step_case``). Both sides start from the same base and the same
adapters, every leaf perturbed (B != 0, so every adapter's gradient is
nonzero), and take the same global batch, latents and the JAX loss's own
draws, each rank its rows and its slices. The Trainer's own step (its
adapters drawn from the step generator as one rank draws them, then kept
in part; two steps, so that A moves once B has) is held to the one-rank
Trainer's.

Bars (slice 2's): loss rtol 1e-5; the adapters' gradients and every
parameter after the step rtol 1e-4 / atol 1e-6, each rank's part against
the same part of the whole. The base is bit-equal after the step on every
rank, and the EMA adapters stay at their start in both packages (the JAX
step returns ``state.ema_params`` unchanged). A (tensor 2) case holds
the two adapters whose tensor ranks see only part of their product
(qkv_proj's lora_A, o_proj's lora_B) to ``jax.grad``; without the sum of
their rank-r intermediate over tensor each rank would hold half.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_mesh_ranks as ranks
from test_torch_mesh_train_step import (BAR, CFG, F, JCFG, PX, _held,
                                        _injected, _part, _setup, _tcfg)
from video_gpt_tpu.config import MeshConfig as JMeshConfig
from video_gpt_tpu.data.video import ClipSample as JClipSample
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.parallel.mesh import make_mesh as jmake_mesh
from video_gpt_tpu.parallel.mesh import param_specs, place_train_state
from video_gpt_tpu.parallel.tensor import tp_regroup_params as jtp_regroup
from video_gpt_tpu.training import loss as jloss
from video_gpt_tpu.training.data import collate as jcollate
from video_gpt_tpu.training.lora import graft_lora
from video_gpt_tpu.training.train_state import TrainState as JTrainState
from video_gpt_tpu.training.train_state import make_lora_train_step
from video_gpt_tpu.training.train_state import make_optimizer as jmake_opt
from video_gpt_tpu_torch.config import MeshConfig
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
from video_gpt_tpu_torch.parallel.mesh import zero_dim
from video_gpt_tpu_torch.training.lora import is_adapter
from video_gpt_tpu_torch.utils.weights import (lora_state_dict_from_jax,
                                               tp_shard,
                                               videogpt_state_dict_from_jax)

RANK = 8
LORA = dict(use_lora=True, lora_rank=RANK, use_ema=True, ema_decay=0.5)
# (data, seq, tensor, zero3), the attention over seq
MESHES = {"data2_zero3": ((2, 1, 1, True), "ulysses"),
          "tensor2": ((1, 1, 2, False), "ulysses"),
          "seq2": ((1, 2, 1, False), "ulysses"),
          "data2_seq2_tensor2_zero3": ((2, 2, 2, True), "ulysses"),
          "seq2_ring": ((1, 2, 1, False), "ring")}


def _adapter_tree(inner):
    """The JAX adapter tree (``init_lora``'s structure) of grafted
    params."""
    attn = inner["llm"]["layers"]["self_attn"]
    return {"llm": {"layers": {"self_attn": {
        name: {k: attn[name][k] for k in ("lora_a", "lora_b")}
        for name in ("qkv_proj", "o_proj")}}}}


@functools.lru_cache(maxsize=None)
def _lora_setup():
    """(JAX rank-8 params, every leaf perturbed; the port's base state
    dict and adapters of them)."""
    _, _, _, samples = _setup()
    jt = jcollate([JClipSample(p, b) for p, b in samples], 4)
    nn_, nc = int(jt.noisy_sel.shape[0]), int(jt.clean_sel.shape[0])
    jm = JVideoGPT(dataclasses.replace(JCFG, lora_rank=RANK),
                   dtype=jnp.float32, train_init=True)
    params = jm.init(jax.random.PRNGKey(1), jt.inputs.batch,
                     jnp.zeros((nn_, 4, 4, 4)), jnp.zeros((nn_,)),
                     jnp.zeros((nc, 4, 4, 4)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
        x.shape).astype(np.float32), params)
    lcfg = dataclasses.replace(CFG, lora_rank=RANK)
    return (params, videogpt_state_dict_from_jax(params, CFG),
            lora_state_dict_from_jax(params, lcfg))


def _jax_lora_step(mesh_dims, sp, seeds=(7,)):
    """The JAX mesh's (loss, adapter gradient, every parameter after, the
    EMA adapters after), in the port's standard layout."""
    data, seq, tensor, zero3 = mesh_dims
    params, _, _ = _lora_setup()
    jtcfg = _tcfg(**LORA)[0]
    over = dict(remat=True, tensor_parallel=tensor, lora_rank=RANK)
    if seq > 1:
        over.update(seq_shard=True, sp_attention=sp)
    cfg = dataclasses.replace(JCFG, **over)
    model = JVideoGPT(cfg, dtype=jnp.float32, train_init=True)
    base = (params["params"] if tensor == 1
            else jtp_regroup(params["params"], cfg))
    lora = _adapter_tree(base)
    mesh = jmake_mesh(JMeshConfig(data=data, seq=seq, tensor=tensor,
                                  zero_params=zero3))
    lcfg = dataclasses.replace(CFG, lora_rank=RANK)

    def standard(tree, adapters_only=False):
        tree = jax.device_get(tree)
        if tensor > 1:
            tree = jtp_regroup(tree, cfg, inverse=True)
        sd = lora_state_dict_from_jax(tree, lcfg)
        if not adapters_only:
            sd.update(videogpt_state_dict_from_jax(tree, CFG))
        return sd

    tx = jmake_opt(jtcfg)
    jin, _, key = _injected(seq, seeds)[0]
    with jax.sharding.set_mesh(mesh):
        state = place_train_state(JTrainState(
            step=jnp.zeros((), jnp.int32), params=lora,
            opt_state=tx.init(lora), ema_params=jax.tree.map(jnp.copy, lora)),
            mesh, zero_params=zero3, tp=tensor > 1)
        placed = jax.device_put(base, param_specs(base, mesh, tp=tensor > 1,
                                                  zero=zero3))
        grads = jax.jit(jax.grad(lambda a: jloss.training_loss(
            model, {"params": graft_lora(placed, a)}, key, jin,
            max_blocks=F)[0]))(state.params)
        state, metrics = jax.jit(make_lora_train_step(model, jtcfg, F))(
            state, {"params": placed}, key, jin)
        after = graft_lora(jax.device_get(placed), jax.device_get(
            state.params))
        return (float(metrics["loss"]), standard(grads, True),
                standard(after), standard(state.ema_params, True))


def _run(tmp_path, mesh_dims, sp, seeds=(7,)):
    """The one-rank and the mesh's ranks' LoRA ``train_step_case``: the
    Trainer's own two steps, and one step from the perturbed adapters on
    the injected latents and draws."""
    _, sd, vae_sd, samples = _setup()
    _, base, adapters = _lora_setup()
    extra = dict(LORA)
    if sp != "ulysses":
        extra["sp_attention"] = sp
    _, tcfg = _tcfg(**extra)
    injected = [x[1] for x in _injected(mesh_dims[1], seeds)]
    args = (CFG, tcfg, VAEConfig.tiny(), base, vae_sd, samples, (PX, PX),
            injected, 2, {k: v.numpy() for k, v in adapters.items()})
    one = ranks.train_step_case(None, *args)
    mesh_cfg = MeshConfig(*mesh_dims)
    res = spawn_ranks(ranks.train_step_case, (mesh_cfg,) + args,
                      mesh_cfg.num_devices, str(tmp_path), threads=1,
                      timeout=300)
    return one, res


def _compare(rec, want_grads, want_params, mesh_dims, coords, what):
    """Each adapter gradient (the rank's part, ZeRO part included) and
    every parameter after (the ZeRO part under ZeRO-3) against the
    whole's same part."""
    zero3 = mesh_dims[3]
    assert set(rec["grads"]) == _held(want_grads, mesh_dims, coords)
    assert all(is_adapter(n) for n in rec["grads"])
    for name, g in rec["grads"].items():
        want = _part(name, want_grads[name], mesh_dims, coords, True)
        np.testing.assert_allclose(g.numpy(), want.numpy(), **BAR,
                                   err_msg=f"{what}: gradient {name}")
    assert set(rec["params"]) == set(want_params)
    for name, p in rec["params"].items():
        want = _part(name, want_params[name], mesh_dims, coords, zero3)
        np.testing.assert_allclose(p.numpy(), want.numpy(), **BAR,
                                   err_msg=f"{what}: parameter {name}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_lora_mesh_step_matches_jax_and_one_rank(tmp_path, mesh_name):
    mesh_dims, sp = MESHES[mesh_name]
    one, res = _run(tmp_path, mesh_dims, sp)
    loss, jgrads, jparams, jema = _jax_lora_step(mesh_dims, sp)
    _, _, adapters = _lora_setup()
    # the JAX step leaves its EMA adapters at the state's start
    for name, t in jema.items():
        np.testing.assert_array_equal(t.numpy(), adapters[name].numpy(),
                                      err_msg=name)
    assert all(r["ring"] == (sp == "ring") for r in res)
    for r in res + [one]:
        data, tensor = (1, 1) if r is one else (mesh_dims[0], mesh_dims[2])
        for rec in (r["injected"], r["trainer"]):
            assert rec["frozen_kept"] and rec["ema_kept"]
        # AdamW's moments: the rank's tensor part of each adapter, in its
        # own ZeRO dimension (mesh.zero_dim of the port's shape)
        for name, shape in r["trainer"]["moment_shapes"].items():
            part = tp_shard(name, adapters[name], CFG, tensor,
                            0 if r is one else r["coords"]["tensor"])
            want = list(part.shape)
            d = zero_dim(part.shape, data)
            if d is not None:
                want[d] //= data
            assert list(shape) == want, name
    for r in res:
        inj = r["injected"]
        np.testing.assert_allclose(inj["losses"], [loss], rtol=1e-5)
        np.testing.assert_allclose(inj["losses"], one["injected"]["losses"],
                                   rtol=1e-5)
        _compare(inj, jgrads, jparams, mesh_dims, r["coords"], "vs JAX")
        _compare(inj, one["injected"]["grads"], one["injected"]["params"],
                 mesh_dims, r["coords"], "vs one rank")
        # the Trainer's own steps: the adapters drawn as one rank draws
        # them, the step's draws sliced to the rank
        np.testing.assert_allclose(r["trainer"]["losses"],
                                   one["trainer"]["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["trainer"]["grad_norm"],
                                   one["trainer"]["grad_norm"], rtol=1e-5)
        _compare(r["trainer"], one["trainer"]["grads"],
                 one["trainer"]["params"], mesh_dims, r["coords"],
                 "Trainer steps vs one rank")
    # every adapter has a gradient on the second Trainer step (A moves
    # once B has)
    assert all(float(g.abs().max()) > 0
               for g in one["trainer"]["grads"].values())


def test_lora_on_a_pipe_mesh_exits_with_the_jax_message(tmp_path):
    """``cli train --use_lora --mesh_pipe 2`` under ``torch.distributed.
    run`` with 2 processes: the JAX Trainer's message, before a step."""
    import subprocess
    import sys
    from test_torch_cli import REPO
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "video_gpt_tpu_torch.cli", "train",
         "--device", "cpu", "--tiny_model", "--use_lora", "--mesh_pipe", "2",
         "--video_dir_path", str(tmp_path), "--results_dir",
         str(tmp_path / "run")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0
    assert ("LoRA fine-tuning does not route through the pipeline trunk; "
            "use dp/ZeRO for LoRA") in res.stderr, res.stderr[-3000:]
    assert not os.path.exists(tmp_path / "run" / "checkpoints")
