"""Video-GPT on the AFMoE trunk (``models/afmoe.py``) against the plain
reference of the benchmark (``bench_port/reference/afmoe.py``), seeded and
in fp32 on the CPU: the prediction, the loss and every gradient, on the
bias route and on the inline route; the router, the grouped expert
products, one ``Trainer.train_step``, and the refusals.

The tiny model: hidden 64, 4 query heads of 32 (so head_dim is not hidden /
heads) over 2 KV heads, 8 experts top-2 plus a shared one, a dense layer and
four expert layers of which one attends in full, and a window of about two
frames' positions, so that it hides keys."""
import dataclasses

import numpy as np
import pytest
import torch

from bench_port.harness import weights
from bench_port.reference import afmoe as ref
from bench_port.reference.model import Precision
from video_gpt_tpu_torch.config import MeshConfig, ModelConfig, stage_config
from video_gpt_tpu_torch.layout import RowSpec, build_layout
from video_gpt_tpu_torch.models import afmoe
from video_gpt_tpu_torch.models.video_gpt import Batch, VideoGPT

TYPES = ("sliding_attention",) * 3 + ("full_attention", "sliding_attention")
ARCH = dict(hidden_size=64, num_hidden_layers=5, num_attention_heads=4,
            num_key_value_heads=2, head_dim=32, intermediate_size=96,
            moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2,
            num_shared_experts=1, num_dense_layers=1, route_scale=2.826,
            sliding_window=16, layer_types=list(TYPES), mup_enabled=True,
            vocab_size=32064, rope_theta=10000.0, rms_norm_eps=1e-5,
            patch_size=2, in_channels=4, pos_embed_max_size=16,
            freq_embed_size=256, pe_interpolation=1.0)
N_IMG, HL, WL = 6, 4, 6  # 32 x 48 pixels: 2 x 3 patches a frame
SEED = 3000000041
REL = 1e-5


def model_config(**kw) -> ModelConfig:
    a = ARCH
    cfg = ModelConfig(
        trunk="afmoe", hidden_size=a["hidden_size"],
        num_layers=a["num_hidden_layers"],
        num_heads=a["num_attention_heads"],
        num_kv_heads=a["num_key_value_heads"], attn_head_dim=a["head_dim"],
        intermediate_size=a["intermediate_size"],
        vocab_size=a["vocab_size"], rope_theta=a["rope_theta"],
        rms_norm_eps=a["rms_norm_eps"], pos_embed_max_size=16,
        num_dense_layers=a["num_dense_layers"],
        moe_intermediate_size=a["moe_intermediate_size"],
        num_experts=a["num_experts"],
        num_experts_per_tok=a["num_experts_per_tok"],
        num_shared_experts=a["num_shared_experts"],
        route_scale=a["route_scale"], sliding_window=a["sliding_window"],
        layer_types=TYPES, mup_enabled=True)
    return dataclasses.replace(cfg, **kw)


def weights_of(seed=SEED):
    specs = ref.param_specs(ARCH) + ref.buffer_specs(ARCH)
    return weights.draw(specs, seed, "model", torch.device("cpu"),
                        torch.float32)


def port_model(P, **kw) -> VideoGPT:
    model = VideoGPT(model_config(**kw))
    model.load_state_dict(P, strict=True)
    return model


def layout_inputs(seed=5):
    lay = build_layout([RowSpec((1, 2, 1), "training")], N_IMG)
    g = torch.Generator().manual_seed(seed)
    noisy = torch.randn((lay.num_noisy_frames, HL, WL, 4), generator=g)
    clean = torch.randn((lay.num_clean_frames, HL, WL, 4), generator=g)
    t = torch.rand((lay.num_noisy_frames,), generator=g)
    return lay, noisy, clean, t


def test_window_hides_keys_at_this_size():
    lay, *_ = layout_inputs()
    pos = torch.as_tensor(lay.pos_ids[0]).long()
    span = pos[:, None] - pos[None, :]
    assert bool((span >= ARCH["sliding_window"]).any())


@pytest.mark.parametrize("limit", [256_000_000, 0], ids=["bias", "inline"])
def test_forward_loss_and_grads_match_reference(limit):
    P = weights_of()
    model = port_model(P, precompute_bias_limit=limit)
    lay, noisy, clean, t = layout_inputs()
    batch = Batch.from_layout(lay, torch.device("cpu"))
    target = torch.randn(noisy.shape, generator=torch.Generator()
                         .manual_seed(9))

    pred = model(batch, noisy, t, clean)
    loss = ((target - pred) ** 2).mean()
    loss.backward()

    names = [s.name for s in ref.param_specs(ARCH)]
    leaves = {n: P[n].clone().requires_grad_(True) for n in names}
    R = dict(P, **leaves)
    want = ref.forward(R, ARCH, Precision("fp32"), lay, noisy, t, (clean,))
    want_loss = ((target - want) ** 2).mean()
    grads = torch.autograd.grad(want_loss, [leaves[n] for n in names])

    scale = want.abs().max()
    assert float((pred - want).abs().max().detach() / scale) < REL
    assert abs(float(loss) - float(want_loss)) < REL * float(want_loss)
    got = dict(model.named_parameters())
    for n, g in zip(names, grads):
        gn = float(g.norm())
        assert gn > 0, n
        assert float((got[n].grad - g).norm()) <= REL * gn, n


def test_router_matches_reference():
    P = weights_of()
    model = port_model(P)
    moe = model.llm.layers[1].mlp
    m = torch.randn(50, 64, generator=torch.Generator().manual_seed(3))
    w, idx = moe.route(m)
    w_ref, idx_ref = ref.route(P, ARCH, "llm.layers.1.mlp", m)
    assert torch.equal(idx, idx_ref)
    assert torch.allclose(w, w_ref, rtol=1e-6, atol=0)
    # normalised, then scaled
    assert torch.allclose(w.sum(-1), torch.full((50,), 2.826), rtol=1e-6)
    # the bias steers the choice, the scores weigh it
    moe.expert_bias[0] = 10.0
    w_b, idx_b = moe.route(m)
    assert bool((idx_b == 0).any(-1).all())
    s = torch.sigmoid(m @ P["llm.layers.1.mlp.router.weight"].t())
    top = s.gather(-1, idx_b)
    assert torch.allclose(w_b, top / top.sum(-1, keepdim=True) * 2.826,
                          rtol=1e-6)


def test_grouped_products_match_loop():
    g = torch.Generator().manual_seed(4)
    counts = torch.tensor([3, 0, 5, 2])
    offs = counts.cumsum(0).to(torch.int32)
    a = torch.randn(10, 16, generator=g)
    b = torch.randn(4, 16, 8, generator=g)
    c = torch.randn(10, 8, generator=g)
    got = afmoe.grouped_mm(a, b, offs)
    got_t = afmoe.grouped_mm_t(a, c, offs)
    start = 0
    for e, n in enumerate(counts.tolist()):
        rows = slice(start, start + n)
        assert torch.allclose(got[rows], a[rows] @ b[e])
        assert torch.allclose(got_t[e], a[rows].t() @ c[rows])
        start += n
    assert not got_t[1].any()


def test_routed_experts_grad_matches_autograd():
    """The written-out backward of the routed part against autograd
    through the reference's loop."""
    P = weights_of()
    pre = "llm.layers.2.mlp"
    g = torch.Generator().manual_seed(6)
    m = torch.randn(40, 64, generator=g, requires_grad=True)
    wg = P[f"{pre}.experts.gate_up_proj"].clone().requires_grad_(True)
    wd = P[f"{pre}.experts.down_proj"].clone().requires_grad_(True)
    w, idx = ref.route(P, ARCH, pre, m.detach())
    w = w.clone().requires_grad_(True)
    counts = torch.zeros(8, dtype=torch.int64)
    out = afmoe.RoutedExperts.apply(m, w, idx, wg, wd, counts)
    r = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad((out * r).sum(), (m, w, wg, wd))
    assert torch.equal(counts, torch.bincount(idx.flatten(), minlength=8))

    def loop(m, w, wg, wd):
        y = torch.zeros_like(m)
        for e in range(8):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            gate, up = (m[tok] @ wg[e].t()).chunk(2, -1)
            y = y.index_add(0, tok, (torch.nn.functional.silu(gate) * up)
                            @ wd[e].t() * w[tok, slot][:, None])
        return y

    want_out = loop(m, w, wg, wd)
    want = torch.autograd.grad((want_out * r).sum(), (m, w, wg, wd))
    assert torch.allclose(out, want_out, rtol=1e-5, atol=1e-6)
    for a, b in zip(got, want):
        assert float((a - b).norm()) <= REL * float(b.norm())


def test_one_train_step(tmp_path):
    from video_gpt_tpu_torch.data.video import ClipSample
    from video_gpt_tpu_torch.models.vae import VAEConfig
    from video_gpt_tpu_torch.training.data import collate
    from video_gpt_tpu_torch.training.trainer import Trainer
    vae = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                    norm_num_groups=4)
    tcfg = stage_config(1, frame_num=4, mixed_precision="no",
                        lr_scheduler="constant", results_dir=str(tmp_path))
    trainer = Trainer(model_config(), tcfg, None, vae,
                      target_resolution=(32, 48), device="cpu", seed=11)
    state = trainer.build()
    assert all(not b.any() for n, b in trainer.model.named_buffers()
               if n.endswith("expert_bias"))
    names = [n for n, _ in trainer.model.named_parameters()]
    assert not any("expert_bias" in n for n in names)
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    pix = np.random.default_rng(0).uniform(-1, 1, (4, 32, 48, 3)).astype(
        np.float32)
    tb = collate([ClipSample(pix, (1, 2, 1))], N_IMG)
    out = trainer.train_step(state, tb, 0)
    assert np.isfinite(float(out["loss"]))
    moved = [n for n, p in trainer.model.named_parameters()
             if not torch.equal(p, before[n])]
    assert "llm.layers.1.mlp.experts.gate_up_proj" in moved
    assert "llm.layers.1.mlp.router.weight" in moved
    loads = afmoe.expert_loads(trainer.model)
    assert len(loads) == 4 and all(float(x) >= 1.0 for x in loads)


def test_refusals():
    cfg = model_config()
    with pytest.raises(ValueError, match="one device"):
        afmoe.check_afmoe(cfg, mesh=object())
    with pytest.raises(ValueError, match="LoRA"):
        VideoGPT(dataclasses.replace(cfg, lora_rank=4), device="meta")
    with pytest.raises(ValueError, match="layer_types"):
        VideoGPT(dataclasses.replace(cfg, layer_types=TYPES[:4]),
                 device="meta")
    P = weights_of()
    model = port_model(P)
    lay, noisy, clean, t = layout_inputs()
    batch = Batch.from_layout(lay, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not serve"):
        model.prefill(batch, clean, lay.length // 2)
    from video_gpt_tpu_torch.training.trainer import Trainer
    from video_gpt_tpu_torch.models.vae import VAEConfig
    with pytest.raises(ValueError, match="AFMoE trunk trains on one"):
        Trainer(cfg, stage_config(1, frame_num=4), None, VAEConfig(),
                target_resolution=(32, 48), device="cpu",
                mesh_cfg=MeshConfig(data=2))
    from video_gpt_tpu_torch.ops.attention import Window
    from video_gpt_tpu_torch.ops.flash_attention import _check_window, \
        KernelChoice
    with pytest.raises(ValueError, match="fp32"):
        _check_window(KernelChoice("fp32", 128),
                      Window(16, torch.zeros(1, 1), torch.zeros(1, 1)))
