"""Long rollouts and batched serving: the port against the JAX package on
the CPU at a tiny size.

Past 8192 keys the TPU switches to k-tiled Pallas kernels: K4
(``flash_mha_decode_streaming_split``) for the cond-row decode, K5
(``flash_mha_decode_streaming``) for a tail-only row, K10
(``_flash_streaming_fwd`` / ``flash_mha_streaming``) for a biased
attention. The port's K1, K2 and K3 wrappers (their plain versions on CPU
tensors) serve those rows; each is held here against the Pallas kernel in
interpret mode with k-tiling engaged (128-key tiles), at tiny shapes and in
one case past 8192 keys (37 clean frames + 1 generated at 220 tokens per
frame: 8,436 keys). Bar: atol = rtol = 2e-5 at fp32, the JAX package's own
kernel-vs-reference bar; the two sides sum in another order, nothing else
differs. The JAX cache arrives lane-padded to 128 as its KVCache holds it,
the port's unpadded.

Then the slice: the window-sliding rollout of ``configs/inference.sh`` in
small, and ``generate_batch``, against the JAX pipeline (final-latent
relative MSE <= 1e-5 and frames within 1 uint8 level, the bars of
``tests/test_torch_pipeline.py``) and against the port's own per-video
``generate`` (relative MSE <= 1e-10: the same function at fp32, batched
matmuls summing in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_pipeline import JaxChain, _perturb
from video_gpt_tpu import layout as jlayout
from video_gpt_tpu.config import ModelConfig as JConfig
from video_gpt_tpu.models import video_gpt as jvg
from video_gpt_tpu.models.vae import AutoencoderKL as JVAE
from video_gpt_tpu.models.vae import VAEConfig as JVAEConfig
from video_gpt_tpu.ops import flash_attention as jfa
from video_gpt_tpu.ops.attention import AttnMeta as JMeta
from video_gpt_tpu.sampling.pipeline import VideoGPTPipeline as JPipeline
from video_gpt_tpu_torch import layout as tlayout
from video_gpt_tpu_torch.config import ModelConfig
from video_gpt_tpu_torch.models import video_gpt as tvg
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.ops import flash_attention as tfa
from video_gpt_tpu_torch.ops.attention import AttnMeta as TMeta
from video_gpt_tpu_torch.sampling.pipeline import VideoGPTPipeline
from video_gpt_tpu_torch.utils.weights import (vae_state_dict_from_jax,
                                               videogpt_state_dict_from_jax)

ATOL = RTOL = 2e-5
D, DP = 96, 128          # the kernels' head dim; the TPU cache's lane pad
H_PX, W_PX = 32, 48      # the pipeline tests' frames: 6 tokens per frame
REL_MSE_BAR = 1e-5
SELF_REL_MSE_BAR = 1e-10
# past 8192 keys: (n_clean, n_gen, n_img, h, hkv)
LONG = (37, 1, 220, 2, 1)


def _metas(n_clean, n_gen, n_img):
    jl = jlayout.frame_block_inference_layout(n_clean, n_gen, n_img,
                                              use_cfg=False)
    tl = tlayout.frame_block_inference_layout(n_clean, n_gen, n_img,
                                              use_cfg=False)
    return jl, JMeta.from_layout(jl), TMeta.from_layout(tl, "cpu")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _lane_pad(x):
    return jnp.pad(jnp.asarray(x), [(0, 0)] * (x.ndim - 1) + [(0, DP - D)])


def _close(port, want):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("n_clean,n_gen,n_img,h,hkv", [
    (3, 2, 6, 4, 4), (2, 2, 6, 4, 2), (5, 2, 6, 4, 4), LONG])
def test_k1_matches_pallas_k4(n_clean, n_gen, n_img, h, hkv):
    """The cond-row decode: the port's K1 against the TPU's k-tiled K4."""
    jl, jm, tm = _metas(n_clean, n_gen, n_img)
    tail, L = jl.noisy_tail_len(), jl.length
    lc = L - tail
    q = _rand(1, 1, tail, h, D)
    k, v = _rand(2, 1, hkv, L, D), _rand(3, 1, hkv, L, D)
    want = jfa.flash_mha_decode_streaming_split(
        jnp.asarray(q), _lane_pad(k[:, :, :lc]), _lane_pad(v[:, :, :lc]),
        _lane_pad(k[:, :, lc:]), _lane_pad(v[:, :, lc:]),
        jvg.decode_mask(jm.tail(tail), jm), block_q=96, block_k=128,
        interpret=True)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    # the tail as a heads-major view of tokens-major K/V, as the model's
    # attention layer passes it
    kt = tk[:, :, lc:].transpose(1, 2).contiguous().transpose(1, 2)
    vt = tv[:, :, lc:].transpose(1, 2).contiguous().transpose(1, 2)
    got = tfa.flash_mha_decode_split(
        torch.from_numpy(q), tk[:, :, :lc], tv[:, :, :lc], kt, vt,
        tvg.decode_mask(tm.tail(tail), tm))
    _close(got, want)


@pytest.mark.parametrize("heads_major", [False, True])
@pytest.mark.parametrize("n_clean,n_gen,n_img,h,hkv", [
    (0, 2, 6, 4, 2), (3, 2, 6, 4, 4), LONG])
def test_k2_matches_pallas_k5(n_clean, n_gen, n_img, h, hkv, heads_major):
    """A tail-only row (the uncond row when n_clean is 0): the port's K2
    against the TPU's k-tiled K5, keys tokens-major or heads-major."""
    jl, jm, tm = _metas(n_clean, n_gen, n_img)
    tail, L = jl.noisy_tail_len(), jl.length
    q = _rand(4, 1, tail, h, D)
    k, v = _rand(5, 1, L, hkv, D), _rand(6, 1, L, hkv, D)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if heads_major:   # the KV cache's layout, lane-padded
        jk, jv = (_lane_pad(x.transpose(0, 2, 1, 3)) for x in (k, v))
    want = jfa.flash_mha_decode_streaming(
        jnp.asarray(q), jk, jv, jvg.decode_mask(jm.tail(tail), jm),
        block_k=128, interpret=True, kv_heads_major=heads_major)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if heads_major:   # a tokens-major view of heads-major K/V
        tk, tv = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (tk, tv))
    got = tfa.flash_mha_decode(torch.from_numpy(q), tk, tv,
                               tvg.decode_mask(tm.tail(tail), tm))
    _close(got, want)


@pytest.mark.parametrize("n_clean,n_gen,n_img,h,hkv,tail_only", [
    (2, 2, 6, 4, 2, False), (5, 2, 6, 4, 4, False),
    LONG[:3] + (2, 1, True)])
def test_k3_matches_pallas_k10(n_clean, n_gen, n_img, h, hkv, tail_only):
    """Biased attention: the port's K3 against the TPU's k-tiled K10, both
    its entry points (``_flash_streaming_fwd`` at 128-key tiles and
    ``flash_mha_streaming``); past 8192 keys with a one-frame tail of
    queries."""
    jl, jm, tm = _metas(n_clean, n_gen, n_img)
    L = jl.length
    lq = jl.noisy_tail_len() if tail_only else L
    jq, tq = (jm.tail(lq), tm.tail(lq)) if tail_only else (jm, tm)
    q = _rand(7, 1, lq, h, D)
    k, v = _rand(8, 1, L, hkv, D), _rand(9, 1, L, hkv, D)
    got = tfa.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), tfa.precompute_bias(tq, tm))
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jfa.precompute_bias(jq, jm))
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    try:
        tiled = jfa._flash_streaming_fwd(*args, block_k=128)
        streaming = jfa.flash_mha_streaming(*args)
    finally:
        jfa.INTERPRET = old
    _close(got, tiled)
    _close(got, streaming)


@pytest.mark.parametrize("extra", [0, 1])
def test_key_cap_is_the_tpu_dispatch_threshold(extra):
    """``TPU_KEY_CAP``, past which the K1-K3 wrappers count a launch in
    ``long_launches`` (K4's, K5's, K10's place), is the key count where the
    JAX package leaves its resident kernels."""
    lk = tfa.TPU_KEY_CAP + extra
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    try:
        fits = jfa.flash_attention_supported(
            jnp.zeros((1, 64, 2, D)), jnp.zeros((1, lk, 1, D)), None)
    finally:
        jfa.INTERPRET = old
    assert fits == (extra == 0)


def test_plain_versions_past_the_key_cap_count_no_launches():
    """On CPU tensors past the key cap the wrappers take their plain
    versions and count nothing, in ``launches`` or ``long_launches``."""
    n_clean, n_gen, n_img, h, hkv = LONG
    jl, _, tm = _metas(n_clean, n_gen, n_img)
    tail, L = jl.noisy_tail_len(), jl.length
    assert L > tfa.TPU_KEY_CAP
    mask = tvg.decode_mask(tm.tail(tail), tm)
    q = torch.from_numpy(_rand(10, 1, tail, h, D))
    k, v = (torch.from_numpy(_rand(s, 1, L, hkv, D)) for s in (11, 12))
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    tfa.reset_launch_counts()
    tfa.flash_mha_decode_split(q, kh[:, :, :-tail], vh[:, :, :-tail],
                               kh[:, :, -tail:], vh[:, :, -tail:], mask)
    tfa.flash_mha_decode(q, k, v, mask)
    tfa.flash_mha(q, k, v, tfa.precompute_bias(tm.tail(tail), tm))
    wrappers = (tfa.flash_mha_decode_split, tfa.flash_mha_decode,
                tfa.flash_mha)
    assert [(f.launches, f.long_launches) for f in wrappers] == [(0, 0)] * 3


# ---- the slice --------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes():
    """The JAX pipeline and the port's on the same perturbed tiny weights,
    at fp32 (as ``tests/test_torch_pipeline.py``; the inits jitted)."""
    jm = jvg.VideoGPT(JConfig.tiny(), dtype=jnp.float32)
    jv = JVAE(JVAEConfig.tiny(), dtype=jnp.float32)
    lay = jlayout.frame_block_inference_layout(2, 1, 6, use_cfg=True)
    lat = jnp.zeros((2, H_PX // 8, W_PX // 8, 4))
    params = _perturb(jax.jit(jm.init)(
        jax.random.PRNGKey(1), jvg.Batch.from_layout(lay), lat,
        jnp.zeros((2,)), lat), 0)
    vparams = _perturb(jax.jit(jv.init, static_argnums=3)(
        jax.random.PRNGKey(2), jnp.zeros((1, H_PX, W_PX, 3)),
        jax.random.PRNGKey(3), True), 1)
    jpipe = JPipeline(model=jm, params=params, vae=jv, vae_params=vparams)
    tpipe = VideoGPTPipeline.build(
        ModelConfig.tiny(), VAEConfig.tiny(), device="cpu",
        dtype=torch.float32,
        state_dict=videogpt_state_dict_from_jax(params, ModelConfig.tiny()),
        vae_state_dict=vae_state_dict_from_jax(vparams, VAEConfig.tiny()))
    return jpipe, tpipe


def _frames(seed, n, h=H_PX, w=W_PX):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def _rel_mse(got, want):
    got = torch.stack(got).numpy() if isinstance(got[0], torch.Tensor) \
        else np.stack([np.asarray(x) for x in got])
    want = np.stack([np.asarray(x) for x in want])
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def _frame_diff(got, want):
    return max(int(np.abs(a.astype(np.int32) - np.asarray(b, np.int32)).max())
               for a, b in zip(got, want))


def _spy(monkeypatch, model, calls):
    for name in ("prefill", "extend_cache"):
        orig = getattr(model, name)
        monkeypatch.setattr(model, name,
                            lambda *a, _n=name, _o=orig, **k:
                            (calls.append(_n), _o(*a, **k))[1])


def test_sliding_rollout_matches_jax(pipes, monkeypatch):
    """configs/inference.sh in small: 3 clean frames, two 2-frame clips, a
    5-frame window, no re-noise, guidance 1.5. Block 2 slides 2 frames out
    of the window, so its cache is rebuilt by a second prefill (no
    extend), as in the JAX pipeline."""
    jpipe, tpipe = pipes
    frames = _frames(11, 3)
    kw = dict(gen_nums=(2, 2), num_inference_steps=2, img_guidance_scale=1.5,
              max_frame_window=5, clean_image_noise_level=0.0,
              max_input_image_size=64, seed=9, return_latents=True)
    jframes, jlat = jpipe.generate(frames, **kw)
    chain, calls = JaxChain(9), []
    _spy(monkeypatch, tpipe.model, calls)
    tframes, tlat = tpipe.generate(frames, noise=chain, **kw)
    assert chain.kinds == ["encode", "z", "z"]
    assert calls == ["prefill", "prefill"]
    assert len(tframes) == len(jframes) == 3 + 4 and len(tlat) == 4
    rel_mse, diff = _rel_mse(tlat, jlat), _frame_diff(tframes, jframes)
    print(f"sliding rollout: final-latent relative MSE {rel_mse:.3e}, max "
          f"frame difference {diff} levels")
    assert rel_mse <= REL_MSE_BAR, rel_mse
    assert diff <= 1, diff


BATCH_KW = dict(gen_nums=(1, 1), num_inference_steps=2,
                img_guidance_scale=1.5, max_frame_window=8,
                clean_image_noise_level=0.1, max_input_image_size=64,
                return_latents=True)


def test_generate_batch_matches_jax(pipes):
    """N = 2 videos, seeds 21 and 22, two blocks with re-noise 0.1: each
    video walks its own JAX chain (encode, z, renoise, z)."""
    jpipe, tpipe = pipes
    videos = [_frames(12, 2), _frames(13, 2)]
    want = jpipe.generate_batch(videos, seeds=[21, 22], **BATCH_KW)
    chains = [JaxChain(21), JaxChain(22)]
    got = tpipe.generate_batch(videos, noise=chains, **BATCH_KW)
    assert [c.kinds for c in chains] == [["encode", "z", "renoise", "z"]] * 2
    for (tframes, tlat), (jframes, jlat) in zip(got, want):
        assert len(tframes) == len(jframes) == 4 and len(tlat) == 2
        rel_mse, diff = _rel_mse(tlat, jlat), _frame_diff(tframes, jframes)
        print(f"generate_batch vs JAX: final-latent relative MSE "
              f"{rel_mse:.3e}, max frame difference {diff} levels")
        assert rel_mse <= REL_MSE_BAR, rel_mse
        assert diff <= 1, diff


def test_generate_batch_matches_generate_per_video(pipes):
    """The batch rows are the videos: each matches its own ``generate``
    with its seed, up to batched-reduction order at fp32."""
    _, tpipe = pipes
    videos = [_frames(14, 2), _frames(15, 2)]
    got = tpipe.generate_batch(videos, seeds=[5, 6], **BATCH_KW)
    for (frames, lat), video, seed in zip(got, videos, (5, 6)):
        frames1, lat1 = tpipe.generate(video, seed=seed, **BATCH_KW)
        rel_mse = _rel_mse(lat, lat1)
        print(f"generate_batch vs generate: relative MSE {rel_mse:.3e}")
        assert rel_mse <= SELF_REL_MSE_BAR, rel_mse
        assert _frame_diff(frames, frames1) <= 1


def test_generate_batch_rejects_mixed_shapes(pipes):
    _, tpipe = pipes
    with pytest.raises(ValueError, match="same-shaped"):
        tpipe.generate_batch([_frames(16, 2), _frames(17, 2, h=48, w=32)],
                             gen_nums=(1,), num_inference_steps=1,
                             max_input_image_size=64)


def test_generate_batch_takes_the_inline_route(pipes, monkeypatch):
    """A batch whose B*L^2 exceeds ``precompute_bias_limit`` prefills
    through K6 (here its plain version), as the card's batched rollout
    does at B 2 x 12,432^2, and gives what the bias route gives."""
    _, tpipe = pipes
    videos = [_frames(18, 3), _frames(19, 3)]
    kw = dict(gen_nums=(1,), num_inference_steps=1, img_guidance_scale=1.5,
              max_frame_window=8, max_input_image_size=64, seeds=[1, 2],
              return_latents=True)
    lay = tlayout.frame_block_inference_layout(3, 1, 6, use_cfg=False)
    prefix = lay.length - lay.noisy_tail_len()
    want = tpipe.generate_batch(videos, **kw)     # B*L^2 within the limit
    calls = {"flash_mha": 0, "flash_mha_inline": 0}
    for name in calls:
        orig = getattr(tfa, name)

        def counted(*a, _n=name, _o=orig, **k):
            calls[_n] += 1
            return _o(*a, **k)

        monkeypatch.setattr(tfa, name, counted)
    monkeypatch.setattr(tpipe.model, "cfg", dataclasses.replace(
        tpipe.model.cfg, precompute_bias_limit=prefix ** 2))
    got = tpipe.generate_batch(videos, **kw)      # 2 * prefix^2 is above it
    assert calls == {"flash_mha": 0,
                     "flash_mha_inline": tpipe.model.cfg.num_layers}
    for (_, lat), (_, lat_bias) in zip(got, want):
        assert _rel_mse(lat, lat_bias) <= REL_MSE_BAR


def test_generate_rollout_layouts_take_the_columnar_decode():
    """The long rollout's layouts (56 clean + 24 generated frames, the
    uncond row) and the batched ones (rows=2) pass ``decode_rank``, so
    their decode rows take K1 and K2."""
    for rows in (1, 2):
        lay = tlayout.frame_block_inference_layout(56, 24, 220, use_cfg=False,
                                                   rows=rows)
        assert tlayout.decode_rank(lay, lay.noisy_tail_len()) is not None
        lay_u = tlayout.frame_block_inference_layout(0, 24, 220,
                                                     use_cfg=False, rows=rows)
        assert tlayout.decode_rank(lay_u, lay_u.length) is not None


def test_rollout_is_generate_for_one_video(pipes):
    """``generate_batch`` of one video without seeds is ``generate``."""
    _, tpipe = pipes
    video = _frames(20, 2)
    kw = dict(gen_nums=(1,), num_inference_steps=1, max_input_image_size=64,
              return_latents=True)
    (frames, lat), = tpipe.generate_batch([video], seed=3, **kw)
    frames1, lat1 = tpipe.generate(video, seed=3, **kw)
    assert all((a == b).all() for a, b in zip(frames, frames1))
    assert all(torch.equal(a, b) for a, b in zip(lat, lat1))

