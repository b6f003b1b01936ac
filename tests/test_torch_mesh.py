"""The mesh's serving half, module by module: the port's
``parallel/{mesh,tensor,ulysses}.py``, ``utils/parity.py`` and the
tensor-parallel decoder layer against the JAX package, on the CPU.

The port's ranks run in spawned gloo processes (``spawn_ranks``) that load
only torch and the port (their functions are in ``torch_mesh_ranks.py``);
the JAX functions run in this process on the 8 CPU devices that
``conftest.py`` gives JAX, under ``make_mesh`` of the same grid. Inputs are
made with numpy from a seed. Bars, in fp32: rank grids and weight layouts
bit-equal; ``ulysses_attend`` / ``ulysses_attend_cached`` against the JAX
functions at atol = rtol = 2e-5 (slice 1's kernel bar: the same math in
another summation order), and the keys each rank gathers bit-equal to its
heads of the input (the gather is a copy); the tensor-parallel layer
against the JAX layer at ``tensor_parallel=2`` at rtol 1e-4 / atol 1e-5
(slice 1's model bar); the parity probes to within fp32 rounding of the
1e-3 they must catch.
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
from video_gpt_tpu.layout import frame_block_inference_layout as jlayout
from video_gpt_tpu.models.phi3 import Phi3Layer as JLayer
from video_gpt_tpu.models.phi3 import rope_tables as jrope
from video_gpt_tpu.models.video_gpt import decode_mask as jdecode_mask
from video_gpt_tpu.ops.attention import AttnMeta as JMeta
from video_gpt_tpu.parallel.mesh import make_mesh as jmake_mesh
from video_gpt_tpu.parallel.tensor import regroup_columns as jregroup
from video_gpt_tpu.parallel.tensor import tp_regroup_params as jtp_regroup
from video_gpt_tpu.parallel.ulysses import (ulysses_attend as jattend,
                                            ulysses_attend_cached as
                                            jattend_cached)
from video_gpt_tpu.models.video_gpt import Batch as JBatch
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu_torch.config import MeshConfig, ModelConfig
from video_gpt_tpu_torch.ops.attention import AttnMeta
from video_gpt_tpu_torch.ops.flash_attention import precompute_bias
from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
from video_gpt_tpu_torch.parallel.mesh import (Mesh, SEQ_AXIS, TENSOR_AXIS,
                                               cache_heads, make_mesh,
                                               rank_grid)
from video_gpt_tpu_torch.parallel.tensor import (regroup_columns,
                                                 tp_regroup_params)
from video_gpt_tpu_torch.parallel.ulysses import pad_to_seq, ulysses_attend
from video_gpt_tpu_torch.utils.weights import (lora_state_dict_from_jax,
                                               videogpt_state_dict_from_jax)

# (n_clean, n_gen, n_img, rows): 7-token frames, so the cond row (21) and
# the tail (7) are odd and the seq axis pads them; GQA 8:4 heads of 16
SHAPE = (2, 1, 5, 2)
H, HKV, D = 8, 4, 16
MESHES = {"seq2": (2, 1), "tensor2": (1, 2), "seq2_tensor2": (2, 2)}
ATOL = RTOL = 2e-5


def _jax_mesh(seq, tensor, data=1):
    return jmake_mesh(JMeshConfig(data=data, seq=seq, tensor=tensor))


def _qkv():
    rng = np.random.default_rng(0)
    b, l = SHAPE[3], jlayout(*SHAPE[:3], False, rows=SHAPE[3]).length
    return {"q": rng.standard_normal((b, l, H, D), np.float32),
            "k": rng.standard_normal((b, l, HKV, D), np.float32),
            "v": rng.standard_normal((b, l, HKV, D), np.float32)}


@pytest.fixture(scope="module", params=list(MESHES))
def attention(request, tmp_path_factory):
    """(mesh name, the full q/k/v, each rank's results) of
    ``torch_mesh_ranks.attention_cases`` on one mesh."""
    seq, tensor = MESHES[request.param]
    arrays = _qkv()
    res = spawn_ranks(ranks.attention_cases,
                      (MeshConfig(seq=seq, tensor=tensor), arrays, SHAPE),
                      seq * tensor, str(tmp_path_factory.mktemp("ranks")),
                      threads=1, timeout=300)
    return request.param, arrays, res


def _whole(res, name, length, seq, tensor):
    """The ranks' output chunks of ``name`` put back into [B, L, H, D]."""
    rows = []
    for si in range(seq):
        rows.append(torch.cat([res[si * tensor + ti][name]
                               for ti in range(tensor)], dim=2))
    return torch.cat(rows, dim=1)[:, :length].numpy()


def _jax_meta():
    lay = jlayout(*SHAPE[:3], False, rows=SHAPE[3])
    lay_u = jlayout(0, SHAPE[1], SHAPE[2], False, rows=SHAPE[3])
    return JMeta.from_layout(lay), JMeta.from_layout(lay_u), \
        lay.noisy_tail_len()


def _lane_pad(x):
    return jnp.pad(x, ((0, 0), (0, 0), (0, 0), (0, -x.shape[-1] % 128)))


def _jax_case(name, arrays, seq, tensor):
    meta, meta_u, tail = _jax_meta()
    lc = arrays["q"].shape[1] - tail

    def fn(q, k, v):
        if name == "meta":
            return jattend(q, k, v, meta, meta, impl="reference")
        if name == "decode_mask":
            lu = meta_u.index.shape[1]
            return jattend(q[:, :lu], k[:, :lu], v[:, :lu], meta_u, meta_u,
                           impl="reference",
                           bias=jdecode_mask(meta_u, meta_u))
        q_meta = JMeta(*(x[:, lc:] for x in meta))
        bias = (jdecode_mask(q_meta, meta) if name == "cached_decode_mask"
                else None)
        kh, vh = (_lane_pad(x.transpose(0, 2, 1, 3)) for x in (k, v))
        return jattend_cached(q[:, lc:], kh[:, :, lc:], vh[:, :, lc:],
                              kh[:, :, :lc], vh[:, :, :lc], q_meta, meta,
                              impl="reference", bias=bias)

    with jax.sharding.set_mesh(_jax_mesh(seq, tensor)):
        return jax.jit(fn)(*(jnp.asarray(arrays[x]) for x in "qkv"))


@pytest.mark.parametrize("case", ["meta", "decode_mask"])
def test_ulysses_attend_matches_jax(attention, case):
    mesh_name, arrays, res = attention
    _check_case(mesh_name, arrays, res, case)


@pytest.mark.parametrize("case", ["cached_decode_mask", "cached_meta"])
def test_ulysses_attend_cached_matches_jax(attention, case):
    mesh_name, arrays, res = attention
    _check_case(mesh_name, arrays, res, case)


def _check_case(mesh_name, arrays, res, case):
    seq, tensor = MESHES[mesh_name]
    want = np.asarray(_jax_case(case, arrays, seq, tensor))
    got = _whole(res, case, want.shape[1], seq, tensor)
    err = float(np.abs(got - want).max())
    print(f"{case} on {mesh_name}: max abs err {err:.3e} vs the JAX mesh")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the keys/values each rank gathered are its heads (tensor-major,
    # seq-minor) of the input's, over the full length
    _, _, tail = _jax_meta()
    lc = arrays["k"].shape[1] - tail
    lu = jlayout(0, *SHAPE[1:3], False).length
    span = {"meta": slice(None), "decode_mask": slice(0, lu)}.get(
        case, slice(lc, None))
    for r, out in enumerate(res):
        kg, vg = out[case + "_kv"]
        heads = _rank_heads(r, seq, tensor, HKV)
        for got_x, name in ((kg, "k"), (vg, "v")):
            x = arrays[name][:, span][:, :, heads]
            np.testing.assert_array_equal(got_x[:, :x.shape[1]].numpy(), x)


def _rank_heads(rank, seq, tensor, n):
    s, t = rank // tensor, rank % tensor
    per = n // (seq * tensor)
    return slice((t * seq + s) * per, (t * seq + s + 1) * per)


def test_mesh_groups_follow_the_grid(attention):
    """Every rank sits where JAX places device r, and each of its groups
    is its line of the grid along that axis."""
    mesh_name, _, res = attention
    seq, tensor = MESHES[mesh_name]
    grid = rank_grid(MeshConfig(seq=seq, tensor=tensor))
    for r, out in enumerate(res):
        c = out["coords"]
        assert grid[c["data"], c["seq"], c["tensor"], c["pipe"]] == r
        want = {}
        if seq > 1:
            want["seq"] = [int(x) for x in grid[0, :, c["tensor"], 0]]
        if tensor > 1:
            want["tensor"] = [int(x) for x in grid[0, c["seq"], :, 0]]
        assert out["groups"] == want


@pytest.mark.parametrize("shape", [(1, 2, 1, 1), (1, 2, 2, 1),
                                   (2, 1, 2, 1), (1, 1, 1, 2),
                                   (2, 1, 1, 2), (2, 1, 1, 4)])
def test_rank_grid_matches_jax_make_mesh(shape):
    """(data, seq, tensor, pipe): rank r sits where the JAX grid places
    device r, pipe the fastest axis."""
    data, seq, tensor, pipe = shape
    jm = jmake_mesh(JMeshConfig(data=data, seq=seq, tensor=tensor,
                                pipe=pipe))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(
        rank_grid(MeshConfig(data=data, seq=seq, tensor=tensor, pipe=pipe)),
        ids)


def test_cache_heads_are_tensor_major():
    """(seq 2, tensor 2), 8 heads: rank (s, t) holds heads 2 (2t + s) and
    the next."""
    cfg = MeshConfig(seq=2, tensor=2)
    got = [cache_heads(Mesh(cfg, r, {}), 8) for r in range(4)]
    assert [(h.start, h.stop) for h in got] == [(0, 2), (4, 6), (2, 4),
                                                (6, 8)]


def test_make_mesh_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="2 ranks, the launch 1"):
        make_mesh(MeshConfig(seq=2))


def test_ulysses_refuses_what_it_cannot_pad_or_split():
    """A dense bias cannot be padded to the seq multiple; heads must divide
    by seq * tensor (checked before any collective)."""
    from video_gpt_tpu_torch.layout import frame_block_inference_layout
    mesh = Mesh(MeshConfig(seq=2), 0, {})
    lay = frame_block_inference_layout(0, 1, 5, False)
    meta = AttnMeta.from_layout(lay, "cpu")
    with pytest.raises(ValueError, match="dense bias"):
        pad_to_seq(mesh, lay.length, meta, meta, precompute_bias(meta, meta))
    pad, qm, km, _ = pad_to_seq(mesh, lay.length, meta, meta, None)
    q = torch.zeros(1, (lay.length + pad) // 2, 3, D)
    with pytest.raises(ValueError, match="not divisible"):
        ulysses_attend(q, q, q, qm, km, mesh)


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed=1):
    model = JVideoGPT(cfg, dtype=jnp.float32)
    lay = jlayout(1, 1, 6, use_cfg=True)
    z = jnp.zeros((2, 4, 6, 4))
    params = model.init(jax.random.PRNGKey(seed), JBatch.from_layout(lay), z,
                        jnp.zeros((2,)), z[:1])
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
        x.shape).astype(np.float32), params)


JCFG = JConfig.tiny(num_heads=H, num_kv_heads=HKV, hidden_size=H * D,
                    attn_impl="reference")
CFG = ModelConfig.tiny(num_heads=H, num_kv_heads=HKV, hidden_size=H * D)


@pytest.mark.parametrize("inverse", [False, True])
def test_regroup_columns_matches_jax(inverse):
    """On a [out, in] weight the port regroups dim 0 where JAX regroups
    the last axis of the [in, out] kernel."""
    sizes = (H * D, HKV * D, HKV * D)
    w = np.random.default_rng(2).standard_normal(
        (7, sum(sizes))).astype(np.float32)
    for tp in (2, 4):
        want = np.asarray(jregroup(w, sizes, tp, inverse=inverse)).T
        got = regroup_columns(torch.from_numpy(np.ascontiguousarray(w.T)),
                              sizes, tp, inverse=inverse).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("inverse", [False, True])
def test_tp_regroup_params_matches_jax(inverse):
    """The port's ``tp_regroup_params`` on the state dict the JAX params
    carry across equals the JAX regroup carried across, for the model and
    for LoRA adapters (``qkv_proj.lora_B``)."""
    from video_gpt_tpu.training.lora import init_lora
    params = _jax_params(JCFG)
    cfg2 = dataclasses.replace(JCFG, tensor_parallel=2)
    rng = np.random.default_rng(3)
    lora = jax.tree.map(
        lambda x: np.asarray(x) + rng.standard_normal(x.shape).astype(
            np.float32), init_lora(params["params"], 4,
                                   jax.random.PRNGKey(4)))
    src = params if not inverse else jtp_regroup(params, cfg2)
    src_lora = lora if not inverse else jtp_regroup(lora, cfg2)
    for carry, tree, tree_j in (
            (videogpt_state_dict_from_jax, src,
             jtp_regroup(src, cfg2, inverse=inverse)),
            (lora_state_dict_from_jax, src_lora,
             jtp_regroup(src_lora, cfg2, inverse=inverse))):
        want = carry(tree_j, CFG)
        got = tp_regroup_params(carry(tree, CFG), CFG, 2, inverse=inverse)
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(),
                                          want[name].numpy(), err_msg=name)


def test_tp_shards_put_together_equal_the_jax_tp_layout():
    """Tensor ranks' shards (``tp_shard=(2, t)``) concatenated: the
    column-parallel rows equal the JAX tp-grouped kernels carried across,
    the row-parallel columns the standard ones; the rest is replicated."""
    params = _jax_params(JCFG)
    want = videogpt_state_dict_from_jax(
        jtp_regroup(params, dataclasses.replace(JCFG, tensor_parallel=2)),
        CFG)
    shards = [videogpt_state_dict_from_jax(params, CFG, tp_shard=(2, t))
              for t in range(2)]
    for name, w in want.items():
        if name.endswith(("qkv_proj.weight", "gate_up_proj.weight")):
            got = torch.cat([s[name] for s in shards], dim=0)
        elif name.endswith(("o_proj.weight", "down_proj.weight")):
            got = torch.cat([s[name] for s in shards], dim=1)
        else:
            assert all(torch.equal(s[name], w) for s in shards), name
            continue
        np.testing.assert_array_equal(got.numpy(), w.numpy(), err_msg=name)


def test_tp_decoder_layer_matches_jax(tmp_path):
    """A decoder layer on a (tensor 2) mesh of 2 gloo ranks (each
    with its shard; all-reduce after o_proj and down_proj) against the JAX
    layer built with ``tensor_parallel=2`` under a (tensor 2) CPU mesh,
    both on the cond row's metadata (attention through the Ulysses path
    at seq 1, as the JAX layer routes it)."""
    cfg2j = dataclasses.replace(JCFG, tensor_parallel=2)
    meta, _, _ = _jax_meta()
    b, l = meta.index.shape
    x = np.random.default_rng(5).standard_normal(
        (b, l, H * D)).astype(np.float32)
    cos, sin = jrope(meta.index, D, JCFG.rope_theta, jnp.float32)
    layer = JLayer(JCFG)
    params = layer.init(jax.random.PRNGKey(6), jnp.asarray(x), None, cos,
                        sin, meta, meta, None)
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
        p.shape).astype(np.float32), params)
    p = params["params"]
    sd = {f"{mod}.{name}.weight": np.ascontiguousarray(
        np.asarray(p[mod][name]["kernel"]).T)
        for mod, name in (("self_attn", "qkv_proj"), ("self_attn", "o_proj"),
                          ("mlp", "gate_up_proj"), ("mlp", "down_proj"))}
    for name in ("input_layernorm", "post_attention_layernorm"):
        sd[f"{name}.weight"] = np.asarray(p[name]["weight"])
    params2 = {"params": jtp_regroup(params["params"], cfg2j)}
    with jax.sharding.set_mesh(_jax_mesh(1, 2)):
        want, _ = jax.jit(lambda p_, x_: JLayer(cfg2j).apply(
            p_, x_, None, cos, sin, meta, meta, None))(params2, jnp.asarray(x))
    want = np.asarray(want)
    res = spawn_ranks(ranks.tp_layer,
                      (MeshConfig(tensor=2), CFG, sd, x, SHAPE), 2, str(tmp_path), threads=1, timeout=300)
    for y in res:
        err = float(np.abs(y.numpy() - want).max())
        print(f"TP layer vs JAX tensor_parallel=2: max abs err {err:.3e}")
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    return spawn_ranks(ranks.parity_probes, (), 2,
                       str(tmp_path_factory.mktemp("parity")), threads=1,
                       timeout=120)


def test_shard_divergence_catches_one_rank_off(parity):
    for r in parity:
        assert r["same"] == 0.0
        assert abs(r["off"] - 1e-3) < 1e-6, r["off"]


def test_assert_replicated_names_the_diverging_leaf(parity):
    for r in parity:
        assert r["same_raises"] == ""
        assert "['y'][0]" in r["off_raises"] and "diverges" in r["off_raises"]


def test_max_tree_diff_walks_nested_trees():
    """The largest |a - b| over the tensor leaves of dicts, lists and
    tuples (empty leaves and non-tensors skipped)."""
    from video_gpt_tpu_torch.utils.parity import max_tree_diff
    a = {"x": torch.zeros(3), "y": [torch.ones(2, 2), (torch.zeros(0), 5)]}
    b = {"x": torch.tensor([0.0, -0.25, 0.0]),
         "y": [torch.ones(2, 2) * 1.5, (torch.zeros(0), 5)]}
    assert max_tree_diff(a, b) == 0.5
    assert max_tree_diff(a, a) == 0.0
