"""The image-generation family's training path and the aux input head: the
port against the JAX package on the CPU at a tiny size.

- ``resize_center_crop`` (PIL, and the numpy path of an array already at
  the size), the json dataset with its condition dropout, and
  ``collate_image_gen``: bit-equal to the JAX ones.
- ``training_loss`` on the velocity target, with and without the aux
  input head (and the head on the video path's x1 target), with the JAX
  loss's own draws injected: loss and per-frame losses at rtol 1e-5,
  parameter gradients against ``jax.grad`` at rtol 1e-4 / atol 1e-6 (the
  model bar), the shape-padding clean slots masked by ``clean_weights``.
- One step of the image trainer's train step against the JAX
  ``make_train_step(prediction_target='velocity')``: loss and gradient
  norm.
- ``cli train-image`` on a json of PNGs, resumed, then served by ``cli
  generate-image --checkpoint_dir``; the training commands refuse a mesh
  larger than the launch and the offload values the JAX trainer refuses.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_gpt_tpu.config import ModelConfig as JModelConfig
from video_gpt_tpu.config import TrainConfig as JTrainConfig
from video_gpt_tpu.data import image_text as jdata
from video_gpt_tpu.image_gen import ImageGenProcessor as JProcessor
from video_gpt_tpu.image_gen import TextRow as JTextRow
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.training import loss as jloss
from video_gpt_tpu.training.train_state import init_train_state as jinit
from video_gpt_tpu.training.train_state import make_train_step as jstep
from video_gpt_tpu_torch import cli
from video_gpt_tpu_torch.config import ModelConfig, TrainConfig
from video_gpt_tpu_torch.data import image_text as tdata
from video_gpt_tpu_torch.image_gen import ImageGenProcessor, TextRow
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.models.video_gpt import VideoGPT
from video_gpt_tpu_torch.training.image_trainer import ImageGenTrainer
from video_gpt_tpu_torch.training.loss import LossDraws, training_loss
from video_gpt_tpu_torch.utils.weights import videogpt_state_dict_from_jax

C = 4


class CharTokenizer:
    """Deterministic tokenizer (ids from characters; BOS id 1)."""

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Out([1] + [ord(c) % 97 + 3 for c in text][:24])


@pytest.mark.parametrize("src,size", [((100, 30), (32, 48)),
                                      ((40, 56), (32, 32)),
                                      ((48, 32), (32, 48))])
def test_resize_center_crop_bit_equal(src, size):
    from PIL import Image
    a = np.random.default_rng(0).integers(0, 256, src[::-1] + (3,),
                                          dtype=np.uint8)
    want = jdata.resize_center_crop(Image.fromarray(a), size)
    np.testing.assert_array_equal(
        tdata.resize_center_crop(Image.fromarray(a), size), want)
    # an array goes through PIL unless it has exactly the size
    np.testing.assert_array_equal(tdata.resize_center_crop(a, size), want)


def _write_dataset(root):
    from PIL import Image
    rng = np.random.default_rng(1)
    os.makedirs(root, exist_ok=True)
    for name, (w, h) in (("a.png", (40, 56)), ("b.png", (32, 32)),
                         ("out1.png", (48, 40)), ("out2.png", (32, 32))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(os.path.join(root, name))
    records = [
        {"instruction": "make it shiny <img><|image_1|></img> please",
         "input_images": ["a.png"], "output_image": "out1.png"},
        {"instruction": "just draw a cat", "input_images": None,
         "output_image": "out2.png"},
        {"instruction": "<img><|image_1|></img> and <img><|image_2|></img>",
         "input_images": ["b.png", "a.png"], "output_image": "out2.png"},
    ]
    path = os.path.join(root, "data.jsonl")
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return path


def _datasets(tmp_path, prob=0.5):
    jf = _write_dataset(str(tmp_path))
    kw = dict(output_size=(32, 32), input_size=(32, 32),
              condition_dropout_prob=prob, seed=3)
    return (jdata.ImageTextDataset(jf, str(tmp_path),
                                   JProcessor(CharTokenizer()), **kw),
            tdata.ImageTextDataset(jf, str(tmp_path),
                                   ImageGenProcessor(CharTokenizer()), **kw))


def test_dataset_and_dropout_bit_equal(tmp_path):
    jd, td = _datasets(tmp_path)
    dropped = 0
    for epoch in range(3):
        for i in range(len(td)):
            want, got = jd.sample(i, epoch), td.sample(i, epoch)
            assert got.row.input_ids == want.row.input_ids
            assert got.row.image_regions == want.row.image_regions
            np.testing.assert_array_equal(got.output_pixels,
                                          want.output_pixels)
            assert len(got.input_pixels) == len(want.input_pixels)
            for a, b in zip(got.input_pixels, want.input_pixels):
                np.testing.assert_array_equal(a, b)
            dropped += not got.row.image_regions and i != 1
    assert 0 < dropped < 6  # the dropout both fires and spares


def _compare_collate(want, got):
    pairs = [(want.out_pixels, got.out_pixels),
             (want.in_pixels, got.in_pixels),
             (want.clean_valid, got.clean_valid)]
    ji, ti = want.inputs, got.inputs
    pairs += [(getattr(ji, n), getattr(ti, n)) for n in (
        "noisy_frame_row", "noisy_frame_block", "clean_weights")]
    pairs += [(getattr(ji.batch, n), getattr(ti.batch, n))
              for n in ti.batch._fields if n != "meta"]
    pairs += list(zip(ji.batch.meta, ti.batch.meta))
    for w, g in pairs:
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)


def test_collate_bit_equal(tmp_path):
    jd, td = _datasets(tmp_path, prob=0.0)
    for idx in ((0, 1), (2, 0)):
        want = jdata.collate_image_gen([jd.sample(i) for i in idx], 200, 2)
        got = tdata.collate_image_gen([td.sample(i) for i in idx], 200, 2)
        _compare_collate(want, got)


def _samples(mod, row_cls):
    """Two samples at 32x32 (4 output tokens, 4-token regions): one with an
    input image, one without; max_input_images 2 leaves three clean
    slots of padding."""
    rng = np.random.default_rng(2)

    def px():
        return rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32)

    a, b, c = px(), px(), px()
    return [mod.ImageGenSample(row_cls([5, 6] + [0] * 4 + [7], [(2, 6)]),
                               [a], b),
            mod.ImageGenSample(row_cls([8, 9, 10], []), [], c)]


def _loss_pair():
    """(JAX inputs, port inputs, the step key, the JAX loss's draws)."""
    want = jdata.collate_image_gen(_samples(jdata, JTextRow), 40, 2)
    got = tdata.collate_image_gen(_samples(tdata, TextRow), 40, 2)
    _compare_collate(want, got)
    rng = np.random.default_rng(5)
    x1 = rng.standard_normal((2, 4, 4, C)).astype(np.float32)
    clean = rng.standard_normal((4, 4, 4, C)).astype(np.float32)
    jin = want.inputs._replace(x1=jnp.asarray(x1),
                               clean_latents=jnp.asarray(clean))
    tin = got.inputs._replace(x1=torch.from_numpy(x1),
                              clean_latents=torch.from_numpy(clean))
    key = jax.random.PRNGKey(7)
    r_x0, r_t, r_x0c, r_tc = jax.random.split(key, 4)
    draws = LossDraws(*(torch.from_numpy(np.array(x)) for x in (
        jax.random.normal(r_x0, x1.shape, jnp.float32),
        jax.random.uniform(r_t, (2, 1)),
        jax.random.normal(r_x0c, clean.shape),
        jax.random.uniform(r_tc, (clean.shape[0],)))))
    return jin, tin, key, draws


@pytest.fixture(scope="module")
def head_params():
    """Perturbed JAX params of a tiny model with the aux input head."""
    jm = JVideoGPT(JModelConfig.tiny(pos_embed_max_size=8), dtype=jnp.float32,
                   train_init=True, input_head=True)
    jin, _, _, _ = _loss_pair()
    params = jm.init(jax.random.PRNGKey(1), jin.batch, jin.x1,
                     jnp.zeros((2,)), jin.clean_latents,
                     input_output_return=True)
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32), params)


def _port_model(params, input_head):
    cfg = ModelConfig.tiny(pos_embed_max_size=8)
    tm = VideoGPT(cfg, train_init=True, input_head=input_head)
    sd = videogpt_state_dict_from_jax(params, cfg)
    if not input_head:
        sd = {k: v for k, v in sd.items()
              if not k.startswith("input_final_layer.")}
    tm.load_state_dict(sd, strict=True)
    return tm


def _jax_params(params, input_head):
    p = dict(params["params"])
    if not input_head:
        p.pop("input_final_layer")
    return {"params": p}


LOSS_CASES = [("velocity", False), ("velocity", True), ("x1", True)]


@pytest.mark.parametrize("target,head", LOSS_CASES)
def test_loss_and_gradients_match_jax(head_params, target, head):
    jin, tin, key, draws = _loss_pair()
    jm = JVideoGPT(JModelConfig.tiny(pos_embed_max_size=8), dtype=jnp.float32,
                   train_init=True, input_head=head)
    params = _jax_params(head_params, head)

    def loss_fn(p):
        return jloss.training_loss(jm, {"params": p}, key, jin, max_blocks=1,
                                   input_output_return=head,
                                   prediction_target=target)

    (want, jaux), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params["params"])
    tm = _port_model(head_params, head)
    got, aux = training_loss(tm, tin, draws, prediction_target=target,
                             input_output_return=head)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(aux["per_frame_loss"].detach().numpy(),
                               np.asarray(jaux["per_frame_loss"]), rtol=1e-5)
    if head:
        per_clean = aux["input_loss"].detach().numpy()
        np.testing.assert_allclose(per_clean, np.asarray(jaux["input_loss"]),
                                   rtol=1e-5)
        assert (per_clean[1:] == 0).all() and per_clean[0] > 0  # padding
    want_g = videogpt_state_dict_from_jax(jax.device_get(jgrads), tm.cfg)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(want_g)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    if head:
        assert float(grads["input_final_layer.weight"].abs().max()) > 0


def test_trainer_step_matches_jax(head_params):
    jin, tin, key, draws = _loss_pair()
    kw = dict(lr=1e-3, lr_scheduler="constant", mixed_precision="no")
    jm = JVideoGPT(JModelConfig.tiny(pos_embed_max_size=8), dtype=jnp.float32,
                   train_init=True)
    jparams = _jax_params(head_params, False)
    jstate = jinit(jm, jparams, JTrainConfig(**kw))
    _, jmetrics = jstep(jm, JTrainConfig(**kw), max_blocks=1,
                        prediction_target="velocity")(jstate, key, jin)
    trainer = ImageGenTrainer(
        ModelConfig.tiny(pos_embed_max_size=8), TrainConfig(**kw), None,
        None, CharTokenizer(), output_size=(32, 32), vae_cfg=VAEConfig.tiny(),
        init_state_dict=_port_model(head_params, False).state_dict(),
        device="cpu")
    state = trainer.build()
    metrics = trainer._step_fn(state, tin, draws)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    assert state.step == 1 and state.optimizer.count == 1


def _train_argv(tmp_path, *extra):
    jf = _write_dataset(str(tmp_path / "data"))
    return ["train-image", "--json_file", jf, "--image_root",
            str(tmp_path / "data"), "--tiny_model", "--device", "cpu",
            "--mixed_precision", "no", "--height", "32", "--width", "32",
            "--max_input_images", "2", "--results_dir",
            str(tmp_path / "run"), "--ckpt_every", "1", "--log_every", "1",
            "--condition_dropout_prob", "0.3", *extra]


def test_cli_train_image_resumes_and_serves(tmp_path, capsys):
    cli.main(_train_argv(tmp_path, "--max_steps", "2", "--use_ema"))
    ckpt_dir = tmp_path / "run" / "checkpoints"
    assert sorted(os.listdir(ckpt_dir)) == ["1", "2"]
    cli.main(_train_argv(tmp_path, "--max_steps", "3", "--use_ema"))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step 3: loss=" in out
    sd = torch.load(ckpt_dir / "3" / "state.pt", weights_only=True)
    assert sd["step"] == 3 and sd["optimizer"]["count"] == 3
    png = tmp_path / "img.png"
    cli.main(["generate-image", "--prompt", "a cat <img><|image_1|></img>",
              "--input_images", str(tmp_path / "data" / "b.png"),
              "--checkpoint_dir", str(ckpt_dir), "--ema", "--tiny_model",
              "--device", "cpu", "--dtype", "fp32", "--height", "32",
              "--width", "32", "--num_inference_steps", "2",
              "--max_input_image_size", "32", "--seed", "1",
              "--output", str(png)])
    from PIL import Image
    with Image.open(png) as im:
        assert im.size == (32, 32) and im.mode == "RGB"
    assert "weights of" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--mesh_data", "2"], ["--mesh_seq", "2"], ["--mesh_tensor", "2"],
    ["--zero3", "--mesh_data", "2"], ["--offload_grad_splits", "0"],
    ["--report_to", "tensorboard", "--mesh_tensor", "4"]])
def test_train_image_refuses_what_is_not_ported(tmp_path, flags):
    """A value the JAX trainer refuses exits with its message; a mesh
    larger than the launch (one process here) exits with the launch it
    needs."""
    with pytest.raises(SystemExit, match="grad_splits must be >= 1|trains "
                                         r"over \d processes"):
        cli.main(_train_argv(tmp_path, "--max_steps", "1", *flags))


def test_train_image_refuses_the_offload_optimizer(tmp_path):
    """The offload optimizer with EMA exits with the JAX message
    (``video_gpt_tpu/training/image_trainer.py:203``)."""
    with pytest.raises(SystemExit, match="offload_optimizer does not "
                                         "support EMA"):
        cli.main(_train_argv(tmp_path, "--max_steps", "1",
                             "--offload_optimizer", "--use_ema"))


def _video_pair():
    """A stage-1-style video batch (two rows of 3 frames, 4x4 latents) in
    both packages, random latents and the JAX loss's draws."""
    from video_gpt_tpu.data.video import ClipSample as JClipSample
    from video_gpt_tpu.training.data import collate as jcollate
    from video_gpt_tpu_torch.data.video import ClipSample
    from video_gpt_tpu_torch.training.data import collate

    blocks = ((1, 2), (1, 1, 1))
    rng = np.random.default_rng(6)
    pixels = [rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
              for _ in blocks]
    jt = jcollate([JClipSample(p, b) for p, b in zip(pixels, blocks)], 4)
    tt = collate([ClipSample(p, b) for p, b in zip(pixels, blocks)], 4)
    np.testing.assert_array_equal(tt.inputs.clean_weights.numpy(),
                                  np.asarray(jt.inputs.clean_weights))
    lat = rng.standard_normal((6, 4, 4, C)).astype(np.float32)
    jin = jt.inputs._replace(x1=jnp.take(lat, jt.noisy_sel, axis=0),
                             clean_latents=jnp.take(lat, jt.clean_sel,
                                                    axis=0))
    tl = torch.from_numpy(lat)
    tin = tt.inputs._replace(x1=tl[tt.noisy_sel.long()],
                             clean_latents=tl[tt.clean_sel.long()])
    key = jax.random.PRNGKey(9)
    r_x0, r_t, r_x0c, r_tc = jax.random.split(key, 4)
    draws = LossDraws(*(torch.from_numpy(np.array(x)) for x in (
        jax.random.normal(r_x0, jin.x1.shape, jnp.float32),
        jax.random.uniform(r_t, (2, 3)),
        jax.random.normal(r_x0c, jin.clean_latents.shape),
        jax.random.uniform(r_tc, (jin.clean_latents.shape[0],)))))
    return jin, tin, key, draws, tt


def test_video_input_head_loss_matches_jax(head_params):
    """The aux head on the video path (``train --input_output_return``):
    the collate's clean_weights mask its padded clean slots."""
    jin, tin, key, draws, _ = _video_pair()
    jm = JVideoGPT(JModelConfig.tiny(pos_embed_max_size=8), dtype=jnp.float32,
                   train_init=True, input_head=True)

    def loss_fn(p):
        return jloss.training_loss(jm, {"params": p}, key, jin, max_blocks=3,
                                   input_output_return=True)[0]

    want, jgrads = jax.value_and_grad(loss_fn)(head_params["params"])
    tm = _port_model(head_params, True)
    got, aux = training_loss(tm, tin, draws, input_output_return=True)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = videogpt_state_dict_from_jax(jax.device_get(jgrads), tm.cfg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_trainer_builds_and_trains_the_input_head():
    from video_gpt_tpu_torch.training.trainer import Trainer
    _, _, _, _, tt = _video_pair()
    cfg = TrainConfig(frame_num=3, mixed_precision="no", lr=1e-3,
                      lr_scheduler="constant", input_output_return=True)
    trainer = Trainer(ModelConfig.tiny(pos_embed_max_size=8), cfg, None,
                      vae_cfg=VAEConfig.tiny(), target_resolution=(32, 32),
                      device="cpu")
    state = trainer.build()
    head = trainer.model.input_final_layer.weight
    assert float(head.detach().abs().max()) == 0  # zero at init
    metrics = trainer.train_step(state, tt, 0)
    assert np.isfinite(float(metrics["loss"]))
    assert float(head.detach().abs().max()) > 0
    assert "input_final_layer.weight" in state.state_dict()["model"]
