"""The mesh's training half, module by module, against the JAX package on
the CPU: the autograd collectives inside ``ulysses_attend``, the
tensor-parallel decoder layer's backward, ``collate(sp_multiple=)``, the
ZeRO placement of the optimizer state, and ``row_parallel`` under
autocast.

The port's ranks run in spawned gloo processes (``spawn_ranks``, with a
timeout so that a collective issued out of order fails instead of hanging)
that load only torch and the port (``torch_mesh_ranks.py``); the JAX side
runs in this process on the 8 CPU devices of ``conftest.py`` under the
same grid. Inputs are made with numpy from seeds, in fp32. Bars:
``ulysses_attend``'s output and q/k/v gradients against ``jax.grad`` of
the JAX ``ulysses_attend`` at atol = rtol = 2e-5 (slice 1's kernel bar:
the same math in another summation order); the tensor-parallel layer's
input, weight and norm gradients against ``jax.grad`` of the JAX layer at
``tensor_parallel=2`` at rtol 1e-4 / atol 1e-6 (slice 2's gradient bar);
``collate`` bit-equal; the optimizer state's bytes per rank and leaf equal
to the JAX shardings' bytes per device; ``row_parallel``'s all-reduce in
fp32 under bf16 autocast, its output the fp32 sum rounded once to bf16.
"""
import dataclasses

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
from video_gpt_tpu.layout import frame_block_inference_layout as jlayout
from video_gpt_tpu.models.phi3 import Phi3Layer as JLayer
from video_gpt_tpu.models.phi3 import rope_tables as jrope
from video_gpt_tpu.models.video_gpt import Batch as JBatch
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.ops.attention import AttnMeta as JMeta
from video_gpt_tpu.parallel.mesh import make_mesh as jmake_mesh
from video_gpt_tpu.parallel.mesh import param_specs as jparam_specs
from video_gpt_tpu.parallel.tensor import tp_regroup_params as jtp_regroup
from video_gpt_tpu.parallel.ulysses import ulysses_attend as jattend
from video_gpt_tpu.training.data import collate as jcollate
from video_gpt_tpu.training.train_state import \
    init_train_state as jinit_state
from video_gpt_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from video_gpt_tpu_torch.data.video import ClipSample
from video_gpt_tpu_torch.models.video_gpt import VideoGPT
from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
from video_gpt_tpu_torch.parallel.mesh import Mesh, shard_params_
from video_gpt_tpu_torch.training.data import collate
from video_gpt_tpu_torch.training.train_state import init_train_state
from video_gpt_tpu_torch.utils.weights import (tp_shard_state_dict,
                                               videogpt_state_dict_from_jax)

# (n_clean, n_gen, n_img, rows): odd lengths, so the seq axis pads them;
# GQA 8:4 heads of 16 (test_torch_mesh.py's shapes)
SHAPE = (2, 1, 5, 2)
H, HKV, D = 8, 4, 16
ATOL = RTOL = 2e-5
JCFG = JConfig.tiny(num_heads=H, num_kv_heads=HKV, hidden_size=H * D,
                    attn_impl="reference")
CFG = ModelConfig.tiny(num_heads=H, num_kv_heads=HKV, hidden_size=H * D)


def _jax_mesh(data=1, seq=1, tensor=1):
    return jmake_mesh(JMeshConfig(data=data, seq=seq, tensor=tensor))


def _meta():
    return JMeta.from_layout(jlayout(*SHAPE[:3], False, rows=SHAPE[3]))


def _whole(res, name, length, seq, tensor):
    """The ranks' chunks of ``name`` put back into [B, L, H, D]."""
    rows = [torch.cat([res[s * tensor + t][name] for t in range(tensor)],
                      dim=2) for s in range(seq)]
    return torch.cat(rows, dim=1)[:, :length].numpy()


@pytest.mark.parametrize("seq,tensor", [(2, 1), (2, 2)],
                         ids=["seq2", "seq2_tensor2"])
def test_ulysses_backward_matches_jax_grad(tmp_path, seq, tensor):
    """The all_to_all pair's backward (the reverse all_to_all) gives each
    rank the gradient of its q/k/v chunk; put together they equal
    ``jax.grad`` of the JAX Ulysses attention under the same mesh. A cut
    graph (no backward) would leave them None."""
    rng = np.random.default_rng(0)
    b, l = SHAPE[3], jlayout(*SHAPE[:3], False, rows=SHAPE[3]).length
    arrays = {"q": rng.standard_normal((b, l, H, D), np.float32),
              "k": rng.standard_normal((b, l, HKV, D), np.float32),
              "v": rng.standard_normal((b, l, HKV, D), np.float32),
              "dout": rng.standard_normal((b, l, H, D), np.float32)}
    res = spawn_ranks(ranks.ulysses_grads,
                      (MeshConfig(seq=seq, tensor=tensor), arrays, SHAPE),
                      seq * tensor, str(tmp_path), threads=1, timeout=300)
    meta = _meta()

    def loss(q, k, v):
        out = jattend(q, k, v, meta, meta, impl="reference")
        return jnp.sum(out * arrays["dout"]), out

    with jax.sharding.set_mesh(_jax_mesh(seq=seq, tensor=tensor)):
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(arrays[x]) for x in "qkv"))
    np.testing.assert_allclose(_whole(res, "out", l, seq, tensor),
                               np.asarray(out), atol=ATOL, rtol=RTOL)
    for name, want in zip("qkv", grads):
        got = _whole(res, name, l, seq, tensor)
        err = float(np.abs(got - np.asarray(want)).max())
        print(f"d{name} on seq {seq} tensor {tensor}: max abs err {err:.3e}")
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    # the backward moved bytes through the collectives (reverse all_to_all)
    assert all(r["stats"][1] > 0 for r in res)


def test_tp_layer_gradients_match_jax_grad(tmp_path):
    """A decoder layer on a (tensor 2) mesh, differentiated: Megatron's
    pair (copy_to before qkv_proj / gate_up_proj, the all-reduce of
    row_parallel) gives every rank the whole input gradient and the whole
    norm-weight gradients, and each rank its part of the projections'
    gradients, against ``jax.grad`` of the JAX layer at
    ``tensor_parallel=2`` under a (tensor 2) CPU mesh. The loss is a mean,
    as in the JAX package's own TP gradient test
    (``tests/test_tensor_parallel.py::test_tp_grad_parity``)."""
    cfg2j = dataclasses.replace(JCFG, tensor_parallel=2)
    meta = _meta()
    b, l = meta.index.shape
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, l, H * D)).astype(np.float32)
    dy = rng.standard_normal((b, l, H * D)).astype(np.float32)
    cos, sin = jrope(meta.index, D, JCFG.rope_theta, jnp.float32)
    params = JLayer(JCFG).init(jax.random.PRNGKey(6), jnp.asarray(x), None,
                               cos, sin, meta, meta, None)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
        p.shape).astype(np.float32), params)
    p = params["params"]
    projections = (("self_attn", "qkv_proj"), ("self_attn", "o_proj"),
                   ("mlp", "gate_up_proj"), ("mlp", "down_proj"))
    norms = ("input_layernorm", "post_attention_layernorm")

    def standard(tree):
        sd = {f"{m}.{n}.weight": np.ascontiguousarray(
            np.asarray(tree[m][n]["kernel"]).T) for m, n in projections}
        sd.update({f"{n}.weight": np.asarray(tree[n]["weight"])
                   for n in norms})
        return sd

    params2 = {"params": jtp_regroup(p, cfg2j)}

    def loss(p_, x_):
        y, _ = JLayer(cfg2j).apply(p_, x_, None, cos, sin, meta, meta, None)
        return jnp.mean(y * dy)

    with jax.sharding.set_mesh(_jax_mesh(tensor=2)):
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params2,
                                                         jnp.asarray(x))
    want = standard(jtp_regroup(jax.device_get(gp)["params"], cfg2j,
                                inverse=True))
    res = spawn_ranks(ranks.tp_layer_grads,
                      (MeshConfig(tensor=2), CFG, standard(p), x, dy, SHAPE),
                      2, str(tmp_path), threads=1, timeout=300)
    for t, r in enumerate(res):
        np.testing.assert_allclose(r["x"].numpy(), np.asarray(gx), rtol=1e-4,
                                   atol=1e-6, err_msg="input gradient")
        shard = tp_shard_state_dict(
            {k: torch.from_numpy(v) for k, v in want.items()}, CFG, 2, t)
        assert set(r["params"]) == set(shard)
        for name, g in r["params"].items():
            err = float((g - shard[name]).abs().max())
            print(f"rank {t} {name}: max abs err {err:.3e}")
            np.testing.assert_allclose(g.numpy(), shard[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def _clips(blocks, frames=3):
    rng = np.random.default_rng(1)
    return [(rng.uniform(-1, 1, (frames, 16, 16, 3)).astype(np.float32), b)
            for b in blocks]


@pytest.mark.parametrize("sp_multiple", [2, 4])
@pytest.mark.parametrize("uncond", [False, True])
def test_collate_sp_multiple_matches_jax(sp_multiple, uncond):
    """Both token layouts (the main one and, with ``uncond``, guidance
    distillation's) padded to the seq multiple, bit-equal to the JAX
    collate."""
    clips = _clips(((1, 2), (1, 1, 1)))
    jt = jcollate([JClipSample(p, b) for p, b in clips], 4,
                  sp_multiple=sp_multiple, uncond=uncond)
    tt = collate([ClipSample(p, b) for p, b in clips], 4,
                 sp_multiple=sp_multiple, uncond=uncond)
    batches = [(jt.inputs.batch, tt.inputs.batch)]
    if uncond:
        batches.append((jt.inputs.batch_uncond, tt.inputs.batch_uncond))
    for jb, tb in batches:
        assert tb.input_ids.shape[1] % sp_multiple == 0
        for name in tb._fields:
            if name == "meta":
                for jx, tx in zip(jb.meta, tb.meta):
                    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
            else:
                np.testing.assert_array_equal(
                    getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                    err_msg=name)
    for name in ("noisy_sel", "clean_sel", "clean_valid", "pixels"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)))


ZERO_MESHES = {"data2": (2, 1, False), "data2_tensor2": (2, 2, False),
               "data2_zero3": (2, 1, True),
               "data2_tensor2_zero3": (2, 2, True)}


@pytest.mark.parametrize("mesh_name", list(ZERO_MESHES))
def test_zero_placement_matches_jax(mesh_name):
    """Each data rank's AdamW moments (and, under ZeRO-3, its parameters)
    hold per parameter the bytes that the JAX shardings
    (``param_specs(zero=True)`` of the optimizer state, ``zero=
    zero_params`` of the parameters) put on one device of the same mesh,
    leaf by leaf (a JAX leaf stacks the layers: its bytes spread over the
    port's per-layer tensors); a rank holds only its parts, never the
    whole moments."""
    data, tensor, zero3 = ZERO_MESHES[mesh_name]
    cfg2j = dataclasses.replace(JCFG, tensor_parallel=tensor)
    jm = JVideoGPT(cfg2j, dtype=jnp.float32, train_init=True)
    lay = jlayout(1, 1, 4, use_cfg=True)
    z = jnp.zeros((2, 4, 4, 4))
    params = jm.init(jax.random.PRNGKey(0), JBatch.from_layout(lay), z,
                     jnp.zeros((2,)), z[:1])
    jstate = jinit_state(jm, params, JTrainConfig())
    mesh = _jax_mesh(data=data, tensor=tensor)

    def fractions(tree, zero):
        specs = jparam_specs(tree, mesh, tp=tensor > 1, zero=zero)
        frac = jax.tree.map(
            lambda leaf, s: np.full(leaf.shape, np.prod(s.shard_shape(
                leaf.shape)) / max(leaf.size, 1), np.float32), tree, specs)
        # the port's names and layout of the fractions (each element's
        # share of its leaf on one device)
        return videogpt_state_dict_from_jax(frac, CFG)

    mu_frac = fractions(jstate.opt_state[1][0].mu, True)
    param_frac = fractions(params["params"], zero3)
    whole = videogpt_state_dict_from_jax(params, CFG)
    for rank in range(data * tensor):
        mcfg = MeshConfig(data=data, tensor=tensor, zero_params=zero3)
        pmesh = Mesh(mcfg, rank, {})
        model = VideoGPT(CFG, device="meta", train_init=True, mesh=pmesh)
        if zero3:
            shard_params_(model, pmesh, "meta")
        state = init_train_state(model, TrainConfig(), pmesh)
        names = [n for n, _ in model.named_parameters()]
        for name, p, mu in zip(names, model.parameters(),
                               state.optimizer.mu):
            full = whole[name].numel()
            want_mu = float(mu_frac[name].flatten()[0])
            assert mu.numel() == round(want_mu * full), (name, mu.shape)
            want_p = float(param_frac[name].flatten()[0])
            assert p.numel() == round(want_p * full), (name, p.shape)


def test_row_parallel_keeps_fp32_under_autocast(tmp_path):
    """Under the trainer's bf16 autocast, each tensor rank's partial
    product of ``row_parallel`` stays fp32 through the all-reduce (4 bytes
    an element) and the sum is rounded once to bf16: the output equals
    the fp32 product of the bf16 operands, rounded once."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    w = rng.standard_normal((16, 32)).astype(np.float32)
    res = spawn_ranks(ranks.row_parallel_autocast,
                      (MeshConfig(tensor=2), x, w), 2, str(tmp_path),
                      threads=1, timeout=120)
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    wb = torch.from_numpy(w).to(torch.bfloat16).float()
    parts = [xs @ ws.T for xs, ws in zip(xb.chunk(2, -1), wb.chunk(2, -1))]
    want = (parts[0] + parts[1]).to(torch.bfloat16)
    for r in res:
        assert r["bytes_per_element"] == 4.0
        assert r["y"].dtype == torch.bfloat16
        assert torch.equal(r["y"], want)


def test_autograd_collectives_match_one_rank(tmp_path):
    """Each autograd collective's forward and gradient on two gloo ranks
    against the same function on one rank (fp32 rounding of the same
    sums: atol 1e-5), their backward bytes counted."""
    for errs in spawn_ranks(ranks.collective_grads, (), 2, str(tmp_path),
                            threads=1, timeout=120):
        assert errs.pop("backward_bytes") > 0
        assert max(errs.values()) <= 1e-5, errs


def test_a_mesh_optimizer_is_freed_with_its_run():
    """AdamW on a mesh with a data and a seq axis puts a gradient hook on
    each parameter; the hooks hold the optimizer weakly, so a finished
    run's parameters and moments are freed with it (a strong reference
    closes a cycle through the tensors' hooks that ``gc`` does not see,
    and a process that runs several trainers kept every one)."""
    import gc
    import weakref
    mesh = Mesh(MeshConfig(data=2, seq=2), 0, {})
    model = torch.nn.Linear(8, 4)
    state = init_train_state(model, TrainConfig(), mesh)
    assert state.optimizer.reduced is not None  # the hooks are on
    refs = [weakref.ref(x) for x in (state.optimizer, model.weight,
                                     state.optimizer.mu[0])]
    del state, model
    gc.collect()
    assert [r() for r in refs] == [None] * 3
