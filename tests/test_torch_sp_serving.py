"""Sequence- and tensor-parallel serving end to end: ``generate`` and
``generate_batch`` of the port over (seq 2), (tensor 2) and (seq 2,
tensor 2) gloo ranks on the CPU, against the JAX package's single-device
pipeline and the port's single-rank run; ``cli generate --mesh_seq 2``
under ``torch.distributed.run``.

A tiny model (8 heads of 16, GQA 8:4) at 48x80 frames: 15 tokens a frame,
17 with its markers, so the tail, the uncond row and the extend are odd
and the seq axis pads them. ``generate`` runs two blocks without re-noise
(prefill, cached decode, uncond row, the cache extend); ``generate_batch``
runs 2 videos. The JAX pipeline's draws are recorded on the way
(``JaxChain``) and handed to the port's runs, so every run sees the same
numbers. Bars, in fp32: against JAX, final-latent relative MSE 1e-5 and
frames within 1 uint8 level (slice 1's bars); against the single-rank
port, relative MSE 1e-10 (the same math in another summation order);
final latents bit-equal across the ranks; each rank's KV cache equal to
its heads of the single-rank cache at atol = rtol = 1e-5.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_ranks as ranks
from test_torch_pipeline import JaxChain, _perturb
from video_gpt_tpu.config import ModelConfig as JConfig
from video_gpt_tpu.layout import frame_block_inference_layout as jlayout
from video_gpt_tpu.models.vae import AutoencoderKL as JVAE
from video_gpt_tpu.models.vae import VAEConfig as JVAEConfig
from video_gpt_tpu.models.video_gpt import Batch as JBatch
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.sampling.pipeline import VideoGPTPipeline as JPipeline
from video_gpt_tpu_torch.config import MeshConfig, ModelConfig
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
from video_gpt_tpu_torch.utils.weights import (vae_state_dict_from_jax,
                                               videogpt_state_dict_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 80
HEADS = dict(num_heads=8, num_kv_heads=4, hidden_size=128)
KW = dict(gen_nums=(1, 1), num_inference_steps=2, img_guidance_scale=1.5,
          clean_image_noise_level=0.0, max_input_image_size=80,
          max_frame_window=8)
BATCH_KW = dict(gen_nums=(1,), num_inference_steps=2, img_guidance_scale=1.5,
                max_input_image_size=80)
MESHES = {"seq2": (2, 1), "tensor2": (1, 2), "seq2_tensor2": (2, 2)}
JAX_BAR, RANK_BAR = 1e-5, 1e-10


class Recording(JaxChain):
    """The JAX pipeline's draws, kept for the ranks' replay."""

    def __init__(self, seed):
        super().__init__(seed)
        self.draws = []

    def __call__(self, kind, shape, dtype):
        x = super().__call__(kind, shape, dtype)
        self.draws.append((kind, x.float().numpy()))
        return x


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            for _ in range(n)]


@pytest.fixture(scope="module")
def reference():
    """The JAX pipeline's outputs, the single-rank port's (with the JAX
    draws, recorded for the ranks), and the inputs both took."""
    jcfg = JConfig.tiny(**HEADS)
    jm = JVideoGPT(jcfg, dtype=jnp.float32)
    jv = JVAE(JVAEConfig.tiny(), dtype=jnp.float32)
    lay = jlayout(2, 1, 15, use_cfg=True)
    z = jnp.zeros((2, H // 8, W // 8, 4))
    params = _perturb(jm.init(jax.random.PRNGKey(1), JBatch.from_layout(lay),
                              z, jnp.zeros((2,)), z), 0)
    vparams = _perturb(jv.init(jax.random.PRNGKey(2), jnp.zeros((1, H, W, 3)),
                               jax.random.PRNGKey(3), True), 1)
    jpipe = JPipeline(model=jm, params=params, vae=jv, vae_params=vparams)
    frames = _frames(2, 5)
    videos = [_frames(2, 6), _frames(2, 7)]
    jframes, jlat = jpipe.generate(frames, seed=7, return_latents=True, **KW)
    jbatch = jpipe.generate_batch(videos, seeds=[21, 22],
                                  return_latents=True, **BATCH_KW)
    cfg = ModelConfig.tiny(**HEADS)
    args = (cfg, VAEConfig.tiny(), videogpt_state_dict_from_jax(params, cfg),
            vae_state_dict_from_jax(vparams, VAEConfig.tiny()), frames,
            videos)
    chain, chains = Recording(7), [Recording(21), Recording(22)]
    single = ranks.serve(None, *args, chain, chains, KW, BATCH_KW)
    return dict(
        args=args, single=single,
        replay=(ranks.Replay(chain.draws),
                [ranks.Replay(c.draws) for c in chains]),
        jax=dict(frames=np.stack(jframes),
                 latents=np.stack([np.asarray(x) for x in jlat]),
                 batch_frames=[np.stack(f) for f, _ in jbatch],
                 batch_latents=[np.stack([np.asarray(x) for x in lat])
                                for _, lat in jbatch]))


@pytest.fixture(scope="module", params=list(MESHES))
def sharded(request, reference, tmp_path_factory):
    seq, tensor = MESHES[request.param]
    res = spawn_ranks(
        ranks.serve, (MeshConfig(seq=seq, tensor=tensor), *reference["args"],
                      *reference["replay"], KW, BATCH_KW),
        seq * tensor, str(tmp_path_factory.mktemp("serve")), threads=1,
        timeout=300)
    return request.param, res


def _rel_mse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def _levels(got, want):
    return int(np.abs(np.asarray(got, np.int32)
                      - np.asarray(want, np.int32)).max())


def test_generate_matches_jax(reference, sharded):
    name, res = sharded
    want = reference["jax"]
    for r, out in enumerate(res):
        rel, lv = (_rel_mse(out["latents"], want["latents"]),
                   _levels(out["frames"], want["frames"]))
        print(f"generate on {name}, rank {r} vs JAX: relative MSE "
              f"{rel:.3e}, {lv} levels")
        assert rel <= JAX_BAR and lv <= 1, (rel, lv)


def test_generate_batch_matches_jax(reference, sharded):
    name, res = sharded
    want = reference["jax"]
    for out in res:
        for got_l, want_l, got_f, want_f in zip(
                out["batch_latents"], want["batch_latents"],
                out["batch_frames"], want["batch_frames"]):
            rel, lv = _rel_mse(got_l, want_l), _levels(got_f, want_f)
            print(f"generate_batch on {name} vs JAX: relative MSE "
                  f"{rel:.3e}, {lv} levels")
            assert rel <= JAX_BAR and lv <= 1, (rel, lv)


def test_mesh_matches_the_single_rank_port(reference, sharded):
    name, res = sharded
    single = reference["single"]
    for out in res:
        rels = [_rel_mse(out["latents"], single["latents"])] + [
            _rel_mse(g, w) for g, w in zip(out["batch_latents"],
                                           single["batch_latents"])]
        print(f"{name} vs one rank: relative MSE {max(rels):.3e}")
        assert max(rels) <= RANK_BAR, rels


def test_final_latents_are_replicated(sharded):
    _, res = sharded
    assert [out["divergence"] for out in res] == [0.0] * len(res)


def test_each_rank_caches_its_heads(reference, sharded):
    """The prefill's and the extend's caches: the rank's heads (tensor
    major, seq minor) of the single-rank caches, unpadded."""
    _, res = sharded
    single = reference["single"]["caches"]
    assert [n for n, _, _ in single] == ["prefill", "extend_cache"]
    for out in res:
        start, stop = out["heads"]
        assert [n for n, _, _ in out["caches"]] == [n for n, _, _ in single]
        for (_, k, v), (_, k1, v1) in zip(out["caches"], single):
            for got, want in ((k, k1), (v, v1)):
                assert got.shape == want[:, :, start:stop].shape
                np.testing.assert_allclose(got, want[:, :, start:stop],
                                           atol=1e-5, rtol=1e-5)


def _write_video(path, n=8):
    import cv2
    rng = np.random.default_rng(0)
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                          (W, H))
    for _ in range(n):
        out.write(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    out.release()


def test_cli_generate_mesh_seq_under_torchrun(tmp_path):
    """``cli generate --mesh_seq 2`` under ``torch.distributed.run`` with 2
    processes writes its frames once (rank 0), within 1 level of the
    single-process command's."""
    from PIL import Image
    video = tmp_path / "clip.avi"
    _write_video(video)
    argv = ["-m", "video_gpt_tpu_torch.cli", "generate", "--video_path",
            str(video), "--tiny_model", "--device", "cpu", "--dtype", "fp32",
            "--clean_image_num", "2", "--gen_nums", "1",
            "--num_inference_steps", "2", "--img_guidance_scale", "1.5",
            "--max_input_image_size", "80", "--seed", "3"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    mesh = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *argv, "--mesh_seq", "2", "--save_dir",
         str(tmp_path / "mesh")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert mesh.returncode == 0, mesh.stdout[-3000:] + mesh.stderr[-3000:]
    one = subprocess.run([sys.executable, *argv, "--save_dir",
                          str(tmp_path / "one")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    assert mesh.stdout.count("saved 3 frames") == 1, mesh.stdout
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "mesh")) and len(names) == 3
    diff = max(_levels(np.asarray(Image.open(tmp_path / "mesh" / n)),
                       np.asarray(Image.open(tmp_path / "one" / n)))
               for n in names)
    print(f"cli generate --mesh_seq 2 vs one process: {diff} levels")
    assert diff <= 1
