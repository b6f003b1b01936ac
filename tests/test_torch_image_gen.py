"""The image-generation family's serving path: the port's ``image_gen``
against the JAX package's, on the CPU at a tiny size.

- ``single_shot_layout`` (uniform regions, regions of two sizes, a fixed
  ``pad_to``) and ``ImageGenProcessor.row`` bit-equal to the JAX ones;
  ``TokenIds.from_tokenizer`` equal on a fake tokenizer.
- K3 as the image path runs it: the tail's queries over the heads-major
  concatenation of a cache and the tail, with the rectangular bias, plain
  version vs the Pallas ``_bias_kernel`` in interpret mode
  (``kv_heads_major=True``) at atol = rtol = 2e-5 (the slice-1 kernel bar).
- ``VideoGPT.decode`` with the precomputed bias of the tail's rows (a
  ``BiasMap``: plain K3 over the concatenation) and at
  ``precompute_bias_limit=0`` (no bias: plain K6) vs the JAX decode (its
  dense CPU attention) at rtol 1e-4, the model bar.
- ``ImageGenPipeline`` vs the JAX pipeline: 2-way and 3-way guidance, each
  context separately or as the padded batch, input images of two sizes,
  ``cfg_interval`` with ``uncond_refresh``, a prompt list, ``output_type
  ="pt"``. The JAX pipeline draws from ``jax.random``; the test replays its
  key splits and hands the port the draws (``noise=``). Bars, at fp32:
  final latents within 1e-5 relative MSE and uint8 pixels within 1 level
  (slice 1's bars). The padded batch refuses the serving schedules.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_gpt_tpu.config import ModelConfig as JConfig
from video_gpt_tpu.image_gen import ImageGenPipeline as JPipeline
from video_gpt_tpu.image_gen import ImageGenProcessor as JProcessor
from video_gpt_tpu.image_gen import TextRow as JTextRow
from video_gpt_tpu.image_gen import single_shot_layout as jlayout
from video_gpt_tpu.models import video_gpt as jvg
from video_gpt_tpu.models.vae import AutoencoderKL as JVAE
from video_gpt_tpu.models.vae import VAEConfig as JVAEConfig
from video_gpt_tpu.ops import flash_attention as jfa
from video_gpt_tpu.ops.attention import AttnMeta as JMeta
from video_gpt_tpu.tokens import TokenIds as JTokenIds
from video_gpt_tpu_torch.config import ModelConfig
from video_gpt_tpu_torch.image_gen import (ImageGenPipeline,
                                           ImageGenProcessor, TextRow,
                                           single_shot_layout)
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.models.video_gpt import Batch, VideoGPT, maybe_bias
from video_gpt_tpu_torch.ops import flash_attention as fa
from video_gpt_tpu_torch.ops.attention import AttnMeta, attend_cached
from video_gpt_tpu_torch.tokens import TokenIds
from video_gpt_tpu_torch.utils.weights import (vae_state_dict_from_jax,
                                               videogpt_state_dict_from_jax)

PX = 64                  # 64x64 images: 8x8 latents, 16 tokens
REL_MSE_BAR = 1e-5
KERNEL_TOL = 2e-5
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5


class BosTokenizer:
    """Word-hash tokenizer with a BOS id 1 (the processor drops it)."""

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Out([1] + [100 + (hash(w) % 1000) for w in text.split()])


def _image(seed, h=PX, w=PX):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _pil(a):
    from PIL import Image
    return Image.fromarray(a)


def _rows(cls, sizes):
    """A row of text around image regions of ``sizes`` tokens, and a row
    of text alone."""
    ids, regions = [11, 12], []
    for n in sizes:
        regions.append((len(ids), len(ids) + n))
        ids += [0] * n + [13]
    return [cls(ids, regions), cls([21, 22, 23, 24, 25], [])]


@pytest.mark.parametrize("sizes,n_region,pad_to", [
    ((4,), 4, None), ((4, 4), 4, 64), ((4, 2), None, None)],
    ids=["uniform", "uniform-pad_to", "two-sizes"])
def test_single_shot_layout_bit_equal(sizes, n_region, pad_to):
    want = jlayout(_rows(JTextRow, sizes), 16, n_region, pad_to=pad_to)
    got = single_shot_layout(_rows(TextRow, sizes), 16, n_region,
                             pad_to=pad_to)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name


def test_processor_row_bit_equal():
    prompt = "paint <img><|image_2|></img> over <img><|image_1|></img> now"
    images = [_image(0), _image(1, 32, 64)]
    jrow, jpx = JProcessor(BosTokenizer()).row(prompt,
                                               [_pil(a) for a in images])
    for imgs in ([_pil(a) for a in images], images):  # PIL or uint8 arrays
        row, px = ImageGenProcessor(BosTokenizer()).row(prompt, imgs)
        assert row.input_ids == jrow.input_ids
        assert row.image_regions == jrow.image_regions
        assert len(px) == len(jpx)
        for a, b in zip(px, jpx):
            np.testing.assert_array_equal(a, b)


def test_token_ids_from_tokenizer():
    class Fake:
        pad_token_id = 32000
        unk_token_id = 0
        ids = {"<img>": 32011, "</img>": 0}  # </img> unknown: the default

        def convert_tokens_to_ids(self, tok):
            if tok == "<|diffusion|>":
                raise KeyError(tok)
            return self.ids[tok]

    got, want = TokenIds.from_tokenizer(Fake()), \
        JTokenIds.from_tokenizer(Fake())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.pad, got.img_open, got.img_close, got.diffusion) == (
        32000, 32011, TokenIds.img_close, TokenIds.diffusion)


def _image_layout(lib_layout, cls, n_out=16):
    """One prompt with a 16-token input region: the cond context."""
    return lib_layout([cls([11, 12] + [0] * 16 + [13, 14, 15], [(2, 18)])],
                      n_out, 16)


def test_k3_over_the_cache_matches_pallas():
    """K3 as the image decode runs it: heads-major cache and tail
    concatenated, the bias of the tail's rows over every key."""
    jl = _image_layout(jlayout, JTextRow)
    tl = _image_layout(single_shot_layout, TextRow)
    tail = tl.noisy_tail_len()
    lc = tl.length - tail
    jm, tm = JMeta.from_layout(jl), AttnMeta.from_layout(tl, "cpu")
    h, hkv, d = 4, 2, 16
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, tail, h, d), np.float32)
    k, v = (rng.standard_normal((1, hkv, tl.length, d), np.float32)
            for _ in range(2))
    jq = JMeta(*(x[:, -tail:] for x in jm))
    want = jfa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jq,
                         jm, bias=jfa.precompute_bias(jq, jm), interpret=True,
                         kv_heads_major=True)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    bias = maybe_bias(ModelConfig.tiny(), tm.tail(tail), tm)
    assert bias.bias.shape == (1, tail, tl.length)
    got = attend_cached(torch.from_numpy(q), tk[:, :, :lc], tv[:, :, :lc],
                        tk[:, :, lc:], tv[:, :, lc:], tm.tail(tail), tm,
                        bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32), tree)


@pytest.fixture(scope="module")
def weights():
    """JAX params of the tiny model (every submodule, the input embedder
    too) and of the tiny VAE, perturbed so no head is zero."""
    jm = jvg.VideoGPT(JConfig.tiny(pos_embed_max_size=16), dtype=jnp.float32)
    lay = _image_layout(jlayout, JTextRow)
    z = jnp.zeros((1, 8, 8, 4))
    params = _perturb(jm.init(jax.random.PRNGKey(0),
                              jvg.Batch.from_layout(lay), z,
                              jnp.zeros((1,)), z), 0)
    jv = JVAE(JVAEConfig.tiny(), dtype=jnp.float32)
    vparams = _perturb(jv.init(jax.random.PRNGKey(1), jnp.zeros((1, PX, PX,
                                                                 3)),
                               jax.random.PRNGKey(2), True), 1)
    return jm, params, jv, vparams


def _port_model(params, **kw):
    cfg = ModelConfig.tiny(pos_embed_max_size=16, **kw)
    tm = VideoGPT(cfg)
    tm.load_state_dict(videogpt_state_dict_from_jax(params, cfg),
                       strict=True)
    return tm.eval()


def _count(monkeypatch, *names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(fa, name)

        def counted(*a, name=name, fn=fn, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(fa, name, counted)
    return calls


@torch.no_grad()
@pytest.mark.parametrize("limit,route", [
    (None, "bias_attention_reference"), (0, "inline_attention_reference")])
def test_decode_with_a_bias_matches_jax(weights, monkeypatch, limit, route):
    jm, params, _, _ = weights
    tm = _port_model(params, **({} if limit is None else dict(
        precompute_bias_limit=limit)))
    jl = _image_layout(jlayout, JTextRow)
    tl = _image_layout(single_shot_layout, TextRow)
    jb, tb = jvg.Batch.from_layout(jl), Batch.from_layout(tl, "cpu")
    tail = tl.noisy_tail_len()
    prefix = tl.length - tail
    rng = np.random.default_rng(4)
    cl, z = (rng.standard_normal((1, 8, 8, 4), np.float32)
             for _ in range(2))
    t = np.full((1,), 0.3, np.float32)
    jcache = jm.apply(params, jb, jnp.asarray(cl), prefix,
                      method=jvg.VideoGPT.prefill)
    want = jm.apply(params, jb, jnp.asarray(z), jnp.asarray(t), jcache, tail,
                    None, method=jvg.VideoGPT.decode)
    tcache = tm.prefill(tb, torch.from_numpy(cl), prefix)
    calls = _count(monkeypatch, "bias_attention_reference",
                   "inline_attention_reference", "rank_attention_reference")
    bias = maybe_bias(tm.cfg, tb.meta.tail(tail), tb.meta)
    assert (bias is None) == (limit == 0)
    got = tm.decode(tb, torch.from_numpy(z), torch.from_numpy(t), tcache,
                    tail, bias=bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)
    layers = tm.cfg.num_layers
    assert calls == {n: layers if n == route else 0 for n in calls}


class JaxDraws:
    """The JAX pipeline's draws for one prompt: PRNGKey(seed) split into
    (_, encode key, z key); a uniform encode draws from the encode key, an
    encode per image (inputs of several sizes) from its split."""

    def __init__(self, seed, per_image=0):
        _, self.erng, self.zrng = jax.random.split(jax.random.PRNGKey(seed),
                                                   3)
        self.keys = list(jax.random.split(self.erng, per_image)) \
            if per_image else [self.erng]
        self.kinds = []

    def __call__(self, kind, shape, dtype):
        self.kinds.append(kind)
        key = self.zrng if kind == "z" else self.keys.pop(0)
        return torch.from_numpy(np.array(
            jax.random.normal(key, shape, jnp.float32))).to(dtype)


class DecodeRecorder:
    """The JAX VAE with the latents of each decode recorded: the JAX
    pipeline returns images only."""

    def __init__(self, vae):
        self.vae, self.latents = vae, []

    @property
    def cfg(self):
        return self.vae.cfg

    def apply(self, params, x, *a, method=None, **kw):
        if method is JVAE.decode:
            self.latents.append(np.asarray(x))
        return self.vae.apply(params, x, *a, method=method, **kw)


@pytest.fixture(scope="module")
def pipes(weights):
    jm, params, jv, vparams = weights
    rec = DecodeRecorder(jv)
    jpipe = JPipeline(model=jm, params=params, vae=rec, vae_params=vparams,
                      processor=JProcessor(BosTokenizer()))
    tpipe = ImageGenPipeline.build(
        ImageGenProcessor(BosTokenizer()),
        ModelConfig.tiny(pos_embed_max_size=16), VAEConfig.tiny(),
        device="cpu", dtype=torch.float32,
        state_dict=videogpt_state_dict_from_jax(
            params, ModelConfig.tiny(pos_embed_max_size=16)),
        vae_state_dict=vae_state_dict_from_jax(vparams, VAEConfig.tiny()))
    return jpipe, rec, tpipe


def _compare(got_lat, want_lat, got_px, want_px):
    rel = float(np.mean((got_lat - want_lat) ** 2) / np.mean(want_lat ** 2))
    diff = int(np.abs(got_px.astype(np.int32)
                      - want_px.astype(np.int32)).max())
    print(f"final-latent relative MSE {rel:.3e}, max pixel difference "
          f"{diff} levels")
    assert rel <= REL_MSE_BAR, rel
    assert diff <= 1, diff


EDIT = "make it red <img><|image_1|></img>"
CASES = {
    "2-way-separate": dict(prompt="a red bird"),
    "3-way-separate": dict(prompt=EDIT, images=[0]),
    "2-way-padded": dict(prompt="a red bird", separate_cfg_infer=False),
    "3-way-padded": dict(prompt=EDIT, images=[0], separate_cfg_infer=False),
    "two-input-sizes": dict(
        prompt="<img><|image_1|></img> beside <img><|image_2|></img>",
        images=[0, (1, 32, 64)]),
    "schedules": dict(prompt=EDIT, images=[0], num_inference_steps=4,
                      cfg_interval=(0.2, 0.8), uncond_refresh=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_jax(pipes, case):
    jpipe, rec, tpipe = pipes
    kw = dict(CASES[case])
    prompt = kw.pop("prompt")
    specs = kw.pop("images", [])
    arrays = [_image(s) if isinstance(s, int) else _image(*s)
              for s in specs]
    common = dict(height=PX, width=PX, num_inference_steps=3,
                  guidance_scale=2.5, img_guidance_scale=1.5,
                  max_input_image_size=PX, seed=5)
    common.update(kw)
    rec.latents.clear()
    want = jpipe(prompt, input_images=[_pil(a) for a in arrays] or None,
                 **common)
    per_image = len(arrays) if len({a.shape for a in arrays}) > 1 else 0
    draws = JaxDraws(5, per_image)
    got, lat = tpipe(prompt, input_images=arrays or None, output_type="np",
                     noise=draws, return_latents=True, **common)
    n_encode = (len(arrays) if per_image else 1) if arrays else 0
    assert draws.kinds == ["encode"] * n_encode + ["z"]
    assert len(got) == len(want) == 1 and got[0].shape == (PX, PX, 3)
    _compare(lat.numpy(), rec.latents[0], got[0], np.asarray(want[0]))


def test_prompt_list_and_pt_output_match_jax(pipes):
    jpipe, rec, tpipe = pipes
    common = dict(height=PX, width=PX, num_inference_steps=2,
                  guidance_scale=2.5, max_input_image_size=PX, seed=3)
    rec.latents.clear()
    want = jpipe(["a dog", "a bird"], **common)
    got, lat = tpipe(["a dog", "a bird"], output_type="np",
                     noise=[JaxDraws(3), JaxDraws(4)], return_latents=True,
                     **common)
    assert len(got) == len(want) == 2
    for i in range(2):
        _compare(lat[i:i + 1].numpy(), rec.latents[i], got[i],
                 np.asarray(want[i]))
    want_pt = jpipe("a dog", output_type="pt", **common)
    got_pt = tpipe("a dog", output_type="pt", noise=JaxDraws(3), **common)
    assert got_pt.shape == want_pt.shape == (1, PX, PX, 3)
    assert got_pt.dtype == np.float32
    np.testing.assert_allclose(got_pt, want_pt, atol=2.0 / 255)


def test_padded_batch_refuses_the_schedules(pipes):
    _, _, tpipe = pipes
    for kw in (dict(cfg_interval=(0.2, 0.8)), dict(uncond_refresh=2)):
        with pytest.raises(ValueError, match="separate_cfg_infer"):
            tpipe("a dog", height=PX, width=PX, num_inference_steps=2,
                  separate_cfg_infer=False, **kw)


def test_prompt_list_needs_image_lists(pipes):
    _, _, tpipe = pipes
    with pytest.raises(ValueError, match="per-prompt image lists"):
        tpipe(["a", "b"], input_images=[_image(0)], height=PX, width=PX)
