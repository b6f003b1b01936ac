"""GPipe over the mesh's pipe axis, module by module, against the JAX
package on the CPU: ``pp_apply``'s forward on (pipe 2) at 2 and 4
microbatches and on (pipe 4), its gradients on (pipe 2) and on (data 2,
pipe 2) (per-layer recompute on) against ``jax.grad`` of the JAX
``pp_apply`` under the same mesh, and the pipe rule of the gradients (a
stage's layers, and the embedders, final norm and heads whole on every
pipe rank) against the port's one-rank gradient.

The port's ranks run in spawned gloo processes (``spawn_ranks``, with a
timeout, so that a hop issued out of order fails instead of hanging),
which load only torch and the port (``torch_mesh_ranks.pipe_case``); the
JAX side runs in this process on ``conftest.py``'s 8 CPU devices. The
model is the tiny training model at 4 layers with perturbed weights, the
batch 4 rows of one frame-block training layout at 48x48, the latents and
timesteps numpy draws; the loss is mean(pred ** 2), as in the JAX
package's ``tests/test_pipeline_parallel.py``. A data rank differentiates
the mean over its rows, so the global gradient is the mean over the data
ranks. Bars: the JAX tests' (forward 1e-5, gradients 2e-5, atol = rtol):
pipelining reorders nothing within a microbatch.
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
from video_gpt_tpu.layout import RowSpec, build_layout, tokens_per_frame
from video_gpt_tpu.models.video_gpt import Batch as JBatch
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.parallel.mesh import make_mesh as jmake_mesh
from video_gpt_tpu.parallel.mesh import param_specs as jparam_specs
from video_gpt_tpu.parallel.pipeline import pp_apply as jpp_apply
from video_gpt_tpu_torch.config import MeshConfig, ModelConfig
from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
from video_gpt_tpu_torch.utils.weights import videogpt_state_dict_from_jax

FWD_TOL, GRAD_TOL = 1e-5, 2e-5
ROWS, LAYERS = 4, 4
JCFG = JConfig.tiny(attn_impl="reference", num_layers=LAYERS)
CFG = ModelConfig.tiny(num_layers=LAYERS)


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX params, the port's state dict of them, JAX batch, the global
    z / t / cl arrays)."""
    model = JVideoGPT(JCFG, dtype=jnp.float32, train_init=True)
    lay = build_layout([RowSpec((1, 2, 1), "training")] * ROWS,
                       tokens_per_frame(48, 48))
    batch = JBatch.from_layout(lay)
    nn_, nc = lay.num_noisy_frames, lay.num_clean_frames
    rng = np.random.default_rng(3)
    arrays = dict(z=rng.standard_normal((nn_, 6, 6, 4)).astype(np.float32),
                  t=rng.uniform(size=(nn_,)).astype(np.float32),
                  cl=rng.standard_normal((nc, 6, 6, 4)).astype(np.float32))
    params = model.init(jax.random.PRNGKey(1), batch,
                        *(jnp.asarray(arrays[k]) for k in ("z", "t", "cl")))
    params = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(
        x.shape).astype(np.float32), params)
    sd = {k: v.numpy() for k, v in
          videogpt_state_dict_from_jax(params, CFG).items()}
    return params, sd, batch, arrays


def _jax(mesh_dims, num_micro, grads=False):
    """The JAX ``pp_apply`` under a (data, pipe) mesh: the prediction, or
    with ``grads`` the gradient of mean(pred ** 2) in the port's names."""
    params, _, batch, a = _setup()
    model = JVideoGPT(JCFG, dtype=jnp.float32, train_init=True)
    data, pipe = mesh_dims
    mesh = jmake_mesh(JMeshConfig(data=data, pipe=pipe))
    args = tuple(jnp.asarray(a[k]) for k in ("z", "t", "cl"))

    def fwd(p):
        return jpp_apply(model, p, batch, *args, num_micro=num_micro)

    with jax.sharding.set_mesh(mesh):
        p = jax.device_put(params, jparam_specs(params, mesh, pp=True))
        if not grads:
            return np.asarray(jax.jit(fwd)(p))
        g = jax.jit(jax.grad(lambda p: jnp.mean(fwd(p) ** 2)))(p)
    return {k: v.numpy() for k, v in videogpt_state_dict_from_jax(
        jax.device_get(g), CFG).items()}


@functools.lru_cache(maxsize=None)
def _one_rank():
    """The port's one-rank prediction and gradients (per-layer recompute
    on)."""
    _, sd, _, a = _setup()
    return ranks.pipe_case(None, CFG, sd, ROWS, a, [(None, True, True)])[
        (None, True)]


# (data, pipe) -> the cases (num_micro, remat, grads) of its one spawn
SPAWNS = {(1, 2): [(2, False, True), (4, False, False)],
          (1, 4): [(4, False, False)],
          (2, 2): [(2, True, True)]}


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    """Each mesh's ranks, spawned once for the tests below."""
    _, sd, _, a = _setup()
    out = {}
    for (data, pipe), cases in SPAWNS.items():
        out[(data, pipe)] = spawn_ranks(
            ranks.pipe_case, (MeshConfig(data=data, pipe=pipe), CFG, sd,
                              ROWS, a, cases), data * pipe,
            str(tmp_path_factory.mktemp(f"d{data}p{pipe}")), threads=1,
            timeout=300)
    return out


def _pred(res, data, pipe, case):
    """The global prediction: each data rank's rows, from its first pipe
    rank; every pipe rank of a data rank holds the same prediction."""
    for d in range(data):
        first = res[d * pipe][case]["pred"]
        for s in range(1, pipe):
            assert torch.equal(res[d * pipe + s][case]["pred"], first)
    return torch.cat([res[d * pipe][case]["pred"] for d in range(data)])


@pytest.mark.parametrize("data,pipe,num_micro",
                         [(1, 2, 2), (1, 2, 4), (1, 4, 4)],
                         ids=["pipe2_nm2", "pipe2_nm4", "pipe4"])
def test_pp_forward_matches_jax(pipe_runs, data, pipe, num_micro):
    """Every pipe rank holds the last stage's output (the JAX psum), equal
    to the JAX pipeline's prediction under the same mesh."""
    res = pipe_runs[(data, pipe)]
    remat = next(r for nm, r, _ in SPAWNS[(data, pipe)] if nm == num_micro)
    got = _pred(res, data, pipe, (num_micro, remat))
    np.testing.assert_allclose(got.numpy(), _jax((data, pipe), num_micro),
                               atol=FWD_TOL, rtol=FWD_TOL)


def _mesh_grads(res, data, pipe, case):
    """Each pipe stage's gradients, averaged over the data ranks (equal
    rows: the global mean's gradient), by name; the names a stage holds."""
    out = {}
    for s in range(pipe):
        stage = [res[d * pipe + s][case]["grads"] for d in range(data)]
        out[s] = {k: sum(g[k] for g in stage) / data for k in stage[0]}
    return out


@pytest.mark.parametrize("data,pipe,num_micro,remat",
                         [(1, 2, 2, False), (2, 2, 2, True)],
                         ids=["pipe2", "data2_pipe2_remat"])
def test_pp_gradients_match_jax_grad(pipe_runs, data, pipe, num_micro,
                                     remat):
    """Each stage's gradients (its layers, and the parameters outside the
    trunk) against ``jax.grad`` of the JAX pipeline under the same mesh;
    on (data 2, pipe 2) with per-layer recompute."""
    want = _jax((data, pipe), num_micro, grads=True)
    for s, grads in _mesh_grads(pipe_runs[(data, pipe)], data, pipe,
                                (num_micro, remat)).items():
        for k, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want[k], atol=GRAD_TOL,
                                       rtol=GRAD_TOL,
                                       err_msg=f"stage {s}: {k}")


def test_pp_gradient_rule_against_one_rank(pipe_runs):
    """The pipe rule on (data 2, pipe 2): a stage holds exactly its block
    of layers (global names), whose gradient is whole there; the
    embedders' gradient (the input gradient summed over pipe) and the
    final norm's and the heads' (computed alike after the trunk's pipe
    sum, never summed again) are whole on every pipe rank: each against
    the one-rank gradient."""
    one = _one_rank()["grads"]
    grads = _mesh_grads(pipe_runs[(2, 2)], 2, 2, (2, True))
    per = LAYERS // 2
    groups = {"embedder": ("x_embedder.", "input_x_embedder.",
                           "time_token.", "llm.embed_tokens."),
              "final norm": ("llm.norm.",),
              "head": ("final_layer.", "t_embedder.")}
    for s, g in grads.items():
        layers = {k for k in g if k.startswith("llm.layers.")}
        assert layers == {k for k in one if k.startswith("llm.layers.")
                          and int(k.split(".")[2]) // per == s}
        assert set(g) - layers == {k for k in one
                                   if not k.startswith("llm.layers.")}
        for what, prefixes in groups.items():
            names = [k for k in g if k.startswith(prefixes)]
            assert names, what
            for k in names:
                np.testing.assert_allclose(g[k].numpy(), one[k].numpy(),
                                           atol=GRAD_TOL, rtol=GRAD_TOL,
                                           err_msg=f"stage {s} {what} {k}")
        for k in layers:
            np.testing.assert_allclose(g[k].numpy(), one[k].numpy(),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"stage {s} layer {k}")


def test_pp_hops_count_both_directions(pipe_runs):
    """On (pipe 4), every stage but the last hands its output on and every
    stage takes the summed output in, in bytes."""
    res = pipe_runs[(1, 4)]
    stats = [r[(4, False)]["stats"] for r in res]
    assert all(f > 0 for f, _ in stats) and stats[-1][0] < stats[0][0]


def test_pipe_refuses_seq_and_tensor():
    """A decoder on a pipe mesh with a seq or tensor axis is refused with
    the JAX pipeline's message."""
    from video_gpt_tpu_torch.models.phi3 import check_mesh
    from video_gpt_tpu_torch.parallel.mesh import Mesh
    for cfg in (MeshConfig(seq=2, pipe=2), MeshConfig(tensor=2, pipe=2)):
        with pytest.raises(ValueError, match="combine pp with data "
                                             "parallelism, not tp/sp"):
            check_mesh(dataclasses.replace(CFG), Mesh(cfg, 0, {}))
