"""The slice end to end: the port's ``VideoGPTPipeline.generate`` vs the
JAX package's, on the CPU at a tiny size.

The JAX pipeline draws its noise from a ``jax.random`` chain (encode, then
per block re-noise, z); the test walks the same chain and hands the port
those draws through ``generate(noise=...)``, so both sides see the same
numbers. Weights cross through ``utils.weights``. Bars, at fp32: final
latents within 1e-5 relative MSE (the model-level bar compounded over the
Euler steps and blocks), and uint8 frames within 1 level (a float that
lands on a rounding edge may truncate either way).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_gpt_tpu.config import ModelConfig as JConfig
from video_gpt_tpu.layout import frame_block_inference_layout
from video_gpt_tpu.models.vae import AutoencoderKL as JVAE
from video_gpt_tpu.models.vae import VAEConfig as JVAEConfig
from video_gpt_tpu.models.video_gpt import Batch as JBatch
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.sampling.pipeline import VideoGPTPipeline as JPipeline
from video_gpt_tpu_torch.config import ModelConfig
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.sampling.pipeline import VideoGPTPipeline
from video_gpt_tpu_torch.utils.weights import (vae_state_dict_from_jax,
                                               videogpt_state_dict_from_jax)

H, W = 32, 48   # 4x6 latents, 6 tokens per frame
REL_MSE_BAR = 1e-5


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def pipes():
    jm = JVideoGPT(JConfig.tiny(), dtype=jnp.float32)
    jv = JVAE(JVAEConfig.tiny(), dtype=jnp.float32)
    lay = frame_block_inference_layout(2, 1, 6, use_cfg=True)
    params = _perturb(jm.init(jax.random.PRNGKey(1), JBatch.from_layout(lay),
                              jnp.zeros((2, H // 8, W // 8, 4)),
                              jnp.zeros((2,)),
                              jnp.zeros((2, H // 8, W // 8, 4))), 0)
    vparams = _perturb(jv.init(jax.random.PRNGKey(2), jnp.zeros((1, H, W, 3)),
                               jax.random.PRNGKey(3), True), 1)
    jpipe = JPipeline(model=jm, params=params, vae=jv, vae_params=vparams)
    tpipe = VideoGPTPipeline.build(
        ModelConfig.tiny(), VAEConfig.tiny(), device="cpu",
        dtype=torch.float32,
        state_dict=videogpt_state_dict_from_jax(params, ModelConfig.tiny()),
        vae_state_dict=vae_state_dict_from_jax(vparams, VAEConfig.tiny()))
    return jpipe, tpipe


class JaxChain:
    """The JAX pipeline's noise: each draw splits the running key."""

    def __init__(self, seed):
        self.rng = jax.random.PRNGKey(seed)
        self.kinds = []

    def __call__(self, kind, shape, dtype):
        self.rng, sub = jax.random.split(self.rng)
        self.kinds.append(kind)
        return torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32))).to(dtype)


@pytest.mark.parametrize("kw,kinds", [
    # one CFG block: 2 clean -> 2 generated, 3 steps
    (dict(gen_nums=(2,), num_inference_steps=3),
     ["encode", "z"]),
    # two blocks, no re-noise: block 2 extends the KV cache
    (dict(gen_nums=(1, 1), num_inference_steps=2, clean_image_noise_level=0.0,
          max_frame_window=8),
     ["encode", "z", "z"]),
    # two blocks, each prediction re-encoded through the VAE before it is
    # recycled, re-noised by 0.1 in block 2
    (dict(gen_nums=(1, 1), num_inference_steps=2, clean_image_noise_level=0.1,
          vae_roundtrip_recycle=True, max_frame_window=8),
     ["encode", "z", "recycle_encode", "renoise", "z", "recycle_encode"]),
])
def test_generate_matches_jax(pipes, kw, kinds):
    jpipe, tpipe = pipes
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
              for _ in range(2)]
    common = dict(img_guidance_scale=1.5, max_input_image_size=64, seed=7,
                  return_latents=True, **kw)
    jframes, jlat = jpipe.generate(frames, **common)
    chain = JaxChain(7)
    tframes, tlat = tpipe.generate(frames, noise=chain, **common)
    assert chain.kinds == kinds
    assert len(tframes) == len(jframes) and len(tlat) == len(jlat)
    want = np.stack([np.asarray(b) for b in jlat])
    got = torch.stack(tlat).numpy()
    rel_mse = float(np.mean((got - want) ** 2) / np.mean(want ** 2))
    diff = max(int(np.abs(a.astype(np.int32)
                          - np.asarray(b, np.int32)).max())
               for a, b in zip(tframes, jframes))
    print(f"generate parity {kw}: final-latent relative MSE {rel_mse:.3e}, "
          f"max frame difference {diff} levels")
    assert rel_mse <= REL_MSE_BAR, rel_mse
    assert diff <= 1, diff
    assert all(a.dtype == np.uint8 and a.shape == (H, W, 3)
               for a in tframes)


def test_extend_path_runs_extend_cache(pipes, monkeypatch):
    """The two-block rollout without re-noise grows the cache through
    ``extend_cache`` (prefill once), as the JAX pipeline does."""
    _, tpipe = pipes
    calls = []
    for name in ("prefill", "extend_cache"):
        orig = getattr(tpipe.model, name)
        monkeypatch.setattr(tpipe.model, name,
                            lambda *a, _n=name, _o=orig, **k:
                            (calls.append(_n), _o(*a, **k))[1])
    frames = [np.full((H, W, 3), 100, np.uint8)] * 2
    tpipe.generate(frames, gen_nums=(1, 1, 1), num_inference_steps=1,
                   img_guidance_scale=1.5, clean_image_noise_level=0.0,
                   max_input_image_size=64, max_frame_window=8)
    assert calls == ["prefill", "extend_cache", "extend_cache"]


def test_entry_points_raise_without_a_gpu():
    """``build`` and ``cli generate`` default to CUDA and raise when there
    is none, rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoGPTPipeline.build(ModelConfig.tiny(), VAEConfig.tiny())
    from video_gpt_tpu_torch import cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["generate", "--video_path", "unread.mp4", "--tiny_model"])


@pytest.mark.parametrize("n_img", [6, 220])
def test_generate_layouts_take_the_columnar_decode(n_img):
    """Every layout ``generate`` builds (cond row with 0-8 clean frames,
    uncond row) passes ``decode_rank``, so the decode kernels cover the
    denoise rows and ``generate`` never reaches its raise."""
    from video_gpt_tpu_torch.layout import (decode_rank,
                                            frame_block_inference_layout)
    for n_gen in (1, 4, 16):
        for n_clean in range(9):
            lay = frame_block_inference_layout(n_clean, n_gen, n_img,
                                               use_cfg=False)
            assert decode_rank(lay, lay.noisy_tail_len()) is not None
        lay_u = frame_block_inference_layout(0, n_gen, n_img, use_cfg=False)
        assert decode_rank(lay_u, lay_u.length) is not None


def test_generate_raises_without_a_columnar_decode(pipes, monkeypatch):
    """A layout without a columnar decode mask has no kernel on this
    path: ``generate`` raises instead of taking another attention route."""
    from video_gpt_tpu_torch.sampling import pipeline
    _, tpipe = pipes
    monkeypatch.setattr(pipeline, "decode_rank", lambda *a: None)
    with pytest.raises(NotImplementedError, match="columnar"):
        tpipe.generate([np.zeros((H, W, 3), np.uint8)], gen_nums=(1,),
                       num_inference_steps=1, max_input_image_size=64)
