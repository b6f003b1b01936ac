"""Rank-side functions of the port's mesh tests (``test_torch_mesh.py``,
``test_torch_sp_serving.py``, ``test_torch_mesh_training.py``,
``test_torch_mesh_train_step*.py``, ``test_torch_ring.py``,
``test_torch_pipeline.py``, ``test_torch_shutdown.py``), run in
spawned gloo processes by
``video_gpt_tpu_torch.parallel.distributed.spawn_ranks``. This module
imports only torch, numpy and the port: the ranks never load JAX."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from video_gpt_tpu_torch.config import MeshConfig, ModelConfig
from video_gpt_tpu_torch.layout import frame_block_inference_layout
from video_gpt_tpu_torch.models.phi3 import Phi3Layer, rope_tables
from video_gpt_tpu_torch.models.vae import VAEConfig
from video_gpt_tpu_torch.models.video_gpt import decode_mask
from video_gpt_tpu_torch.ops.attention import AttnMeta
from video_gpt_tpu_torch.parallel.mesh import (SEQ_AXIS, TENSOR_AXIS,
                                               cache_heads, make_mesh)
from video_gpt_tpu_torch.parallel.ulysses import (pad_to_seq,
                                                  ulysses_attend,
                                                  ulysses_attend_cached)
from video_gpt_tpu_torch.sampling.pipeline import VideoGPTPipeline
from video_gpt_tpu_torch.utils.parity import (assert_replicated,
                                              shard_divergence)
from video_gpt_tpu_torch.utils.weights import tp_shard_state_dict
from video_gpt_tpu_torch.config import TrainConfig
from video_gpt_tpu_torch.data.video import ClipSample
from video_gpt_tpu_torch.parallel.mesh import batch_rows
from video_gpt_tpu_torch.training.data import collate
from video_gpt_tpu_torch.training.loss import LossDraws, take_part
from video_gpt_tpu_torch.training.trainer import Trainer, draw_part


def metas(n_clean: int, n_gen: int, n_img: int, rows: int,
          device: str = "cpu"):
    """(metadata of the cond row, of the uncond row, the tail length)."""
    lay = frame_block_inference_layout(n_clean, n_gen, n_img, False,
                                       rows=rows)
    lay_u = frame_block_inference_layout(0, n_gen, n_img, False, rows=rows)
    return (AttnMeta.from_layout(lay, device),
            AttnMeta.from_layout(lay_u, device), lay.noisy_tail_len())


def _chunk(x: torch.Tensor, mesh, pad: int, head_dim: int = 2):
    """This rank's part of a tokens-major [B, L, H, D]: its seq chunk of
    the padded length, its tensor block of the heads."""
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    x = x.chunk(mesh.size(SEQ_AXIS), 1)[mesh.index(SEQ_AXIS)]
    return x.chunk(mesh.size(TENSOR_AXIS), head_dim)[mesh.index(TENSOR_AXIS)]


def attention_cases(mesh_cfg: MeshConfig, arrays: dict, shape: tuple,
                    device: str = "cpu"):
    """``ulysses_attend`` (metadata over the cond row; a DecodeMask over the
    uncond row) and ``ulysses_attend_cached`` (a DecodeMask; metadata) on
    this rank's chunks of the full q/k/v in ``arrays`` (fp32 on the CPU,
    bf16 on a CUDA ``device``: the kernels); returns each output chunk
    with the rank's heads of the keys it gathered, on the host."""
    mesh = make_mesh(mesh_cfg)
    meta, meta_u, tail = metas(*shape, device=device)
    dtype = torch.float32 if device == "cpu" else torch.bfloat16
    t = {k: torch.from_numpy(v).to(device, dtype) for k, v in arrays.items()}
    hkv = t["k"].shape[2]
    heads = cache_heads(mesh, hkv)
    out = {"coords": mesh.coords,
           "groups": {a: dist.get_process_group_ranks(g)
                      for a, g in mesh.groups.items()}}

    def run(name, q, k, v, q_meta, k_meta, bias):
        pad, qm, km, bias = pad_to_seq(mesh, q.shape[1], q_meta, k_meta, bias)
        o, (kg, vg) = ulysses_attend(
            _chunk(q, mesh, pad), _chunk(k, mesh, pad), _chunk(v, mesh, pad),
            qm, km, mesh, bias)
        out[name] = o.cpu()
        out[name + "_kv"] = (kg.cpu(), vg.cpu())

    run("meta", t["q"], t["k"], t["v"], meta, meta, None)
    lu = meta_u.index.shape[1]
    run("decode_mask", t["q"][:, :lu], t["k"][:, :lu], t["v"][:, :lu],
        meta_u, meta_u, decode_mask(meta_u, meta_u))
    lc = meta.index.shape[1] - tail
    q_meta = meta.tail(tail)
    for name, bias in (("cached_decode_mask", decode_mask(q_meta, meta)),
                       ("cached_meta", None)):
        pad, qm, km, bias = pad_to_seq(mesh, tail, q_meta, meta, bias)
        kn, vn = (_chunk(t[x][:, lc:], mesh, pad).transpose(1, 2)
                  for x in ("k", "v"))
        ck, cv = (t[x][:, :lc].transpose(1, 2)[:, heads].contiguous()
                  for x in ("k", "v"))
        o, (kg, vg) = ulysses_attend_cached(
            _chunk(t["q"][:, lc:], mesh, pad), kn, vn, ck, cv, qm, km, mesh,
            bias)
        out[name] = o.cpu()
        out[name + "_kv"] = (kg.cpu(), vg.cpu())
    return out


def tp_layer(mesh_cfg: MeshConfig, cfg: ModelConfig, sd: dict,
             x: np.ndarray, shape: tuple):
    """A ``Phi3Layer`` on a (tensor T) mesh holding this rank's shard
    of ``sd`` (the standard layout) on the full input ``x``."""
    mesh = make_mesh(mesh_cfg)
    tp = mesh.size(TENSOR_AXIS)
    layer = Phi3Layer(cfg, mesh=mesh)
    layer.load_state_dict(tp_shard_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg, tp,
        mesh.index(TENSOR_AXIS)))
    meta, _, _ = metas(*shape)
    xt = torch.from_numpy(x)
    cos, sin = rope_tables(meta.index, cfg.head_dim, cfg.rope_theta,
                           xt.dtype)
    with torch.no_grad():
        y, _ = layer(xt, cos, sin, meta, meta, None, None)
    return y


def parity_probes():
    """``shard_divergence`` / ``assert_replicated`` of a tensor held alike
    by every rank, and of one whose rank 1 is 1e-3 off in one element."""
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7
    off = x.clone()
    if dist.get_rank() == 1:
        off[1, 2] += 1e-3

    def raises(tree):
        try:
            assert_replicated(tree)
        except AssertionError as e:
            return str(e)
        return ""

    return dict(same=shard_divergence(x), off=shard_divergence(off),
                same_raises=raises({"x": x}),
                off_raises=raises({"x": x, "y": [off]}))


class Replay:
    """The noise draws of another run, handed back in order (kind checked)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, kind, shape, dtype):
        want, x = self.draws.pop(0)
        if want != kind or tuple(x.shape) != tuple(shape):
            raise ValueError(f"draw {kind}{tuple(shape)} where the recorded "
                             f"run drew {want}{tuple(x.shape)}")
        return torch.from_numpy(x).to(dtype)


def record_caches(pipe):
    """Wrap ``pipe.model``'s prefill and extend_cache so that the caches
    they return are kept (a list of (call, KVCache))."""
    caches = []
    for name in ("prefill", "extend_cache"):
        fn = getattr(pipe.model, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            cache = _fn(*a, **k)
            caches.append((_name, cache))
            return cache
        setattr(pipe.model, name, wrapped)
    return caches


def serve(mesh_cfg, cfg: ModelConfig, vae_cfg: VAEConfig, sd, vae_sd,
          frames, videos, noise, batch_noise, kw, batch_kw):
    """``generate`` (drawing from ``noise``) and ``generate_batch`` (from
    ``batch_noise``, one per video) on this rank's pipeline (``mesh_cfg``
    None: one process, no mesh); returns their frames and final latents,
    the caches they built, and the latents' divergence across the ranks."""
    mesh = None if mesh_cfg is None else make_mesh(mesh_cfg)
    pipe = VideoGPTPipeline.build(cfg, vae_cfg, device="cpu",
                                  dtype=torch.float32, state_dict=sd,
                                  vae_state_dict=vae_sd, mesh=mesh)
    caches = record_caches(pipe)
    frames_g, lat_g = pipe.generate(frames, noise=noise, return_latents=True,
                                    **kw)
    gen_caches = [(n, c.k, c.v) for n, c in caches]
    outs = pipe.generate_batch(videos, noise=batch_noise,
                               return_latents=True, **batch_kw)
    lat_g = torch.stack(lat_g)
    lat_b = [torch.stack(lat) for _, lat in outs]
    heads = cache_heads(mesh, cfg.num_kv_heads)
    return dict(frames=torch.from_numpy(np.stack(frames_g)), latents=lat_g,
                caches=gen_caches,
                batch_frames=[torch.from_numpy(np.stack(f)) for f, _ in outs],
                batch_latents=lat_b, heads=(heads.start, heads.stop),
                divergence=max([shard_divergence(lat_g)]
                               + [shard_divergence(x) for x in lat_b]))


def record_updates(optimizer) -> list:
    """The gradients (this rank's parts, reduced, before the clip) that
    each optimizer update of ``optimizer`` receives, in order."""
    seen = []
    update = optimizer._update

    def recording(grads, norm):
        seen.append([g.clone() for g in grads])
        return update(grads, norm)
    optimizer._update = recording
    return seen


def _step_record(state, metrics, grads) -> dict:
    """The step's loss and gradient norm, the gradients of the trained
    parameters (a LoRA run's adapters) and the shapes of their AdamW
    moments, and every parameter after."""
    names = [n for n, p in state.model.named_parameters()
             if p.requires_grad]
    return dict(loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]),
                grads=dict(zip(names, grads)),
                moment_shapes={n: tuple(m.shape) for n, m in zip(
                    names, state.optimizer.mu)},
                params={n: p.detach().clone()
                        for n, p in state.model.named_parameters()})


def _frozen(trainer) -> dict:
    """Copies of what a recipe's step must leave alone: a LoRA run's base,
    a distillation run's teacher."""
    if trainer.teacher is not None:
        return {n: t.clone() for n, t in trainer.teacher.state_dict()
                .items()}
    return {n: p.detach().clone() for n, p in trainer.model
            .named_parameters() if not p.requires_grad}


def _kept(trainer, frozen: dict) -> bool:
    """Whether what :func:`_frozen` copied is bit-equal now."""
    now = (trainer.teacher.state_dict() if trainer.teacher is not None
           else dict(trainer.model.named_parameters()))
    return all(torch.equal(now[n].detach(), t) for n, t in frozen.items())


def _load_parts(trainer, whole: dict) -> None:
    """This rank's parts of the one-rank entries ``whole`` into the
    trainer's model (its pipe stage's, its tensor part, under ZeRO-3 its
    data part)."""
    from video_gpt_tpu_torch.training.trainer import part_of
    params = dict(trainer.model.named_parameters())
    with torch.no_grad():
        for name, w in whole.items():
            if name in params:
                params[name].copy_(part_of(name, torch.from_numpy(w),
                                           trainer.model, trainer.mesh))


def _runs_the_ring(model) -> bool:
    """Whether every attention layer of ``model`` takes the ring."""
    from video_gpt_tpu_torch.models.phi3 import Phi3Attention
    return all(m.ring for m in model.modules()
               if isinstance(m, Phi3Attention))


def train_step_case(mesh_cfg, cfg: ModelConfig, tcfg: TrainConfig,
                    vae_cfg: VAEConfig, sd: dict, vae_sd: dict,
                    samples: list, res: tuple, injected=None,
                    steps: int = 1, start: dict = None) -> dict:
    """This rank's training steps on its rows of the global batch
    ``samples`` ((pixels, frame blocks) pairs), from the one-rank weights
    ``sd``: "trainer", ``steps`` steps of ``Trainer.train_step`` (VAE
    encode and draws from the step's generator, sliced to the rank);
    with ``injected`` = (global latents, global draws: ``LossDraws``, or
    ``DistillDraws`` under ``tcfg.distill``), "injected", one step of the
    train step on them (the rank's slices), from the trained parameters
    ``start`` (one-rank entries, numpy: a LoRA run's adapters, a
    distillation run's student) when given. Each: loss, gradient norm,
    the last update's gradients and the parameters after, as this rank
    holds them, and whether the step left the LoRA base or the teacher
    bit-equal ("frozen_kept") and the EMA at its start ("ema_kept");
    ``injected`` may be a list of such pairs, one step each (gradient
    accumulation). ``mesh_cfg`` None: one process, no mesh."""
    from video_gpt_tpu_torch.training.distill import DistillDraws
    trainer = Trainer(cfg, tcfg, None, vae_cfg=vae_cfg, vae_state_dict=vae_sd,
                      init_state_dict=sd, target_resolution=res,
                      device="cpu", seed=0, mesh_cfg=mesh_cfg)
    mesh = trainer.mesh
    rows = batch_rows(mesh, len(samples))
    tb = collate([ClipSample(p, b) for p, b in samples[rows]], trainer.n_img,
                 sp_multiple=mesh_cfg.seq if mesh_cfg else 1,
                 uncond=tcfg.distill_guidance is not None)
    out = {"coords": None if mesh is None else mesh.coords}

    def run(step_fn, n, load_start):
        state = trainer.build()
        if load_start and start is not None:
            _load_parts(trainer, start)
        frozen = _frozen(trainer)
        ema = None if state.ema is None else {
            k: t.clone() for k, t in state.ema.items()}
        seen = record_updates(state.optimizer)
        metrics = [step_fn(state, i) for i in range(n)]
        rec = _step_record(state, metrics[-1], seen[-1])
        rec.update(losses=[float(m["loss"]) for m in metrics],
                   frozen_kept=_kept(trainer, frozen),
                   ema_kept=ema is not None and all(
                       torch.equal(state.ema[k], t) for k, t in ema.items()))
        return rec

    out["trainer"] = run(lambda state, i: trainer.train_step(state, tb, i),
                         steps, False)
    out["ring"] = _runs_the_ring(trainer.model)
    if mesh is not None:
        out["collective_bytes"] = (mesh.stats.moved,
                                   mesh.stats.backward_moved)
    if injected is not None:
        if not isinstance(injected, list):
            injected = [injected]
        f = samples[0][0].shape[0]
        part, den = draw_part(mesh, tb.inputs, tb.clean_valid,
                              tcfg.input_output_return)
        kind = DistillDraws if tcfg.distill else LossDraws

        def injected_step(state, i):
            lat, draws = injected[i]
            lat = torch.from_numpy(lat)[rows.start * f:rows.stop * f]
            inputs = tb.inputs._replace(
                x1=lat[tb.noisy_sel.long()],
                clean_latents=lat[tb.clean_sel.long()])
            draws = take_part(kind(*(torch.from_numpy(x) for x in draws)),
                              part, inputs)
            if tcfg.distill:
                return trainer._step_fn(state, inputs, draws)
            return trainer._step_fn(state, inputs, draws, denominator=den)

        out["injected"] = run(injected_step, len(injected), True)
    return out


def ulysses_grads(mesh_cfg: MeshConfig, arrays: dict, shape: tuple) -> dict:
    """``ulysses_attend`` over the metadata on this rank's chunks of the
    full q/k/v, differentiated: the loss sum(out * dout) (``dout`` in
    ``arrays``), the gradients of the rank's q/k/v chunks, the bytes its
    collectives took in (forward, backward)."""
    mesh = make_mesh(mesh_cfg)
    meta, _, _ = metas(*shape)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    pad, qm, km, _ = pad_to_seq(mesh, t["q"].shape[1], meta, meta, None)
    q, k, v = (_chunk(t[x], mesh, pad).clone().requires_grad_()
               for x in "qkv")
    out, _ = ulysses_attend(q, k, v, qm, km, mesh)
    (out * _chunk(t["dout"], mesh, pad)).sum().backward()
    return dict(out=out.detach(), q=q.grad, k=k.grad, v=v.grad,
                stats=(mesh.stats.moved, mesh.stats.backward_moved))


def tp_layer_grads(mesh_cfg: MeshConfig, cfg: ModelConfig, sd: dict,
                   x: np.ndarray, dy: np.ndarray, shape: tuple) -> dict:
    """A ``Phi3Layer`` on a (tensor T) mesh holding this rank's shard of
    ``sd``, differentiated: the loss mean(y * dy) on the full input ``x``;
    its output, the input's gradient and each parameter's (the rank's
    part)."""
    mesh = make_mesh(mesh_cfg)
    layer = Phi3Layer(cfg, mesh=mesh)
    layer.load_state_dict(tp_shard_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg,
        mesh.size(TENSOR_AXIS), mesh.index(TENSOR_AXIS)))
    meta, _, _ = metas(*shape)
    xt = torch.from_numpy(x).requires_grad_()
    cos, sin = rope_tables(meta.index, cfg.head_dim, cfg.rope_theta,
                           xt.dtype)
    y, _ = layer(xt, cos, sin, meta, meta, None, None)
    (y * torch.from_numpy(dy)).mean().backward()
    return dict(y=y.detach(), x=xt.grad,
                params={n: p.grad for n, p in layer.named_parameters()})


def row_parallel_autocast(mesh_cfg: MeshConfig, x: np.ndarray,
                          w: np.ndarray) -> dict:
    """``row_parallel`` of this rank's feature chunk of bf16 ``x`` and
    column chunk of fp32 ``w`` under bf16 autocast: the output, and the
    bytes per element of what the all-reduce took in."""
    from video_gpt_tpu_torch.models.phi3 import row_parallel
    mesh = make_mesh(mesh_cfg)
    t, n = mesh.index(TENSOR_AXIS), mesh.size(TENSOR_AXIS)
    xs = torch.from_numpy(x).to(torch.bfloat16).chunk(n, -1)[t]
    ws = torch.from_numpy(w).chunk(n, -1)[t]
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = row_parallel(xs, ws, mesh)
    numel = x.shape[0] * w.shape[0]
    return dict(y=y, bytes_per_element=mesh.stats.moved / numel)


def image_step_case(mesh_cfg, cfg: ModelConfig, tcfg: TrainConfig,
                    sd: dict, vae_sd: dict, samples: list, px: int,
                    pad_to: int, injected=None) -> dict:
    """One ``ImageGenTrainer`` step (VAE encodes and draws from the step's
    generator, sliced to the rank) on this rank's rows of the global
    batch ``samples`` (``ImageGenSample``s, ``px`` square images), from
    the one-rank weights ``sd``: loss, gradient norm, the update's
    gradients and the parameters after, as the rank holds them; with
    ``injected`` = (global output latents, global input-image latents,
    global ``LossDraws``), also "injected": the train step on the rank's
    slices of them."""
    from video_gpt_tpu_torch.data.image_text import collate_image_gen
    from video_gpt_tpu_torch.image_gen import StubTokenizer
    from video_gpt_tpu_torch.training.image_trainer import ImageGenTrainer
    trainer = ImageGenTrainer(
        cfg, tcfg, None, None, StubTokenizer(), output_size=(px, px),
        input_size=(px, px), max_input_images=2, pad_to=pad_to,
        vae_cfg=VAEConfig.tiny(), vae_state_dict=vae_sd, init_state_dict=sd,
        device="cpu", seed=0, mesh_cfg=mesh_cfg)
    state = trainer.build()
    seen = record_updates(state.optimizer)
    rows = batch_rows(trainer.mesh, len(samples))
    tb = collate_image_gen(samples[rows], trainer.pad_to, 2,
                           token_ids=cfg.token_ids)
    metrics = trainer.train_step(state, tb, 0)
    out = _step_record(state, metrics, seen[-1])
    out["coords"] = None if trainer.mesh is None else trainer.mesh.coords
    out["ring"] = _runs_the_ring(trainer.model)
    if injected is not None:
        x1, clean, draws = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                            else x for x in injected)
        state = trainer.build()
        seen = record_updates(state.optimizer)
        part, den = draw_part(trainer.mesh, tb.inputs,
                              tb.inputs.clean_weights, False)
        first = 0 if part is None else part.clean[0]
        inputs = tb.inputs._replace(
            x1=x1[rows], clean_latents=clean[first:first + len(
                tb.inputs.clean_weights)])
        draws = take_part(LossDraws(*(torch.from_numpy(x) for x in draws)),
                          part, inputs)
        metrics = trainer._step_fn(state, inputs, draws, denominator=den)
        out["injected"] = _step_record(state, metrics, seen[-1])
    return out


def sigterm_run(videos: str, results: str, mesh_cfg: MeshConfig,
                at_step: int) -> dict:
    """``Trainer.run`` of a tiny model on ``mesh_cfg`` in which rank 1
    alone receives SIGTERM after its step ``at_step``: the step each rank
    stopped at."""
    import os
    import signal
    from video_gpt_tpu_torch.config import stage_config
    cfg = stage_config(1, frame_num=4, lr_scheduler="constant", log_every=1,
                       ckpt_every=1000, results_dir=results,
                       mixed_precision="no")
    trainer = Trainer(ModelConfig.tiny(), cfg, videos,
                      vae_cfg=VAEConfig.tiny(), target_resolution=(48, 64),
                      device="cpu", mesh_cfg=mesh_cfg)
    train_step = trainer.train_step

    def step(state, tb, i):
        metrics = train_step(state, tb, i)
        if i + 1 == at_step and dist.get_rank() == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics
    trainer.train_step = step
    return dict(step=trainer.run(200).step)


def collective_grads(device: str = "cpu") -> dict:
    """The autograd collectives on two ranks (a (seq 2) mesh; the seq
    group serves every pair) on ``device``, each against the same function
    computed on one rank (errors, max abs): ``own_chunk`` then
    ``all_gather`` (x -> x * W, rows split over the ranks), ``copy_to``
    then ``reduce_from`` (x -> x * (v_0 + v_1)), ``all_to_all`` (its
    gradient: the reverse all_to_all of the upstream gradient), and
    ``reduce_scatter`` (this rank's chunk of the sum)."""
    mesh = make_mesh(MeshConfig(seq=2))
    r = mesh.index(SEQ_AXIS)

    def rand(seed, *shape):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g).to(device)

    errs = {}
    x = rand(0, 4, 6).requires_grad_()
    w, c = rand(1, 4, 6), rand(2, 4, 6)
    y = mesh.all_gather(mesh.own_chunk(x, SEQ_AXIS, 0) * w.chunk(2)[r],
                        SEQ_AXIS, 0)
    (y * c).sum().backward()
    errs["gather_chunk"] = float((y - x * w).abs().max())
    errs["gather_chunk_grad"] = float((x.grad - w * c).abs().max())

    x.grad = None
    v = [rand(3 + i, 4, 6) for i in range(2)]
    y = mesh.reduce_from(mesh.copy_to(x, SEQ_AXIS) * v[r], SEQ_AXIS)
    (y * c).sum().backward()
    errs["copy_reduce"] = float((y - x * (v[0] + v[1])).abs().max())
    errs["copy_reduce_grad"] = float(
        (x.grad - (v[0] + v[1]) * c).abs().max())

    a = rand(10 + r, 2, 4).requires_grad_()
    b = mesh.all_to_all(a, SEQ_AXIS, split_dim=1, concat_dim=0)
    cb = rand(20 + r, 4, 2)
    (b * cb).sum().backward()
    whole = [rand(10 + i, 2, 4) for i in range(2)]
    errs["all_to_all"] = float((b - torch.cat(
        [p.chunk(2, 1)[r] for p in whole], 0)).abs().max())
    with torch.no_grad():
        back = mesh.all_to_all(cb, SEQ_AXIS, split_dim=0, concat_dim=1)
    errs["all_to_all_grad"] = float((a.grad - back).abs().max())

    s = mesh.reduce_scatter(rand(30 + r, 6, 4), SEQ_AXIS, 0)
    want = (rand(30, 6, 4) + rand(31, 6, 4)).chunk(2)[r]
    errs["reduce_scatter"] = float((s - want).abs().max())
    errs["backward_bytes"] = mesh.stats.backward_moved
    return errs


def ppermute_case() -> dict:
    """``ppermute`` on four ranks, over the seq group of (seq 4) and of
    (data 2, seq 2), shifts +1 and -1: each rank's output (rank r's input
    is r + its group rank / 10 in every element) and the gradient of
    sum(out * c) for c = 1 + the rank, with the bytes each hop counted."""
    from video_gpt_tpu_torch.parallel.distributed import ppermute
    out = {}
    for name, cfg in (("group4", MeshConfig(seq=4)),
                      ("group2", MeshConfig(data=2, seq=2))):
        mesh = make_mesh(cfg)
        i = mesh.index(SEQ_AXIS)
        for shift in (1, -1):
            mesh.stats.reset()
            x = torch.full((3, 2), float(dist.get_rank()) + i / 10
                           ).requires_grad_()
            y = ppermute(x, mesh.groups[SEQ_AXIS], shift, mesh.stats)
            (y * (1.0 + dist.get_rank())).sum().backward()
            out[f"{name}_{shift}"] = dict(
                y=y.detach(), grad=x.grad, seq_index=i,
                stats=(mesh.stats.moved, mesh.stats.backward_moved))
    return out


def _meta_from(arrays: dict) -> AttnMeta:
    return AttnMeta(*(torch.from_numpy(arrays[f]) for f in AttnMeta._fields))


def ring_grads(mesh_cfg: MeshConfig, arrays: dict, meta: dict) -> dict:
    """``ring_attend`` on this rank's chunks of the full q/k/v in
    ``arrays`` over the whole metadata ``meta`` (numpy, per field; its
    length a multiple of the seq axis), differentiated: the loss
    sum(out * dout); the output chunk, the gradients of the rank's q/k/v
    chunks, the bytes its hops took in (forward, backward)."""
    from video_gpt_tpu_torch.parallel.ring import ring_attend
    mesh = make_mesh(mesh_cfg)
    m = _meta_from(meta)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    q, k, v = (_chunk(t[x], mesh, 0).clone().requires_grad_()
               for x in "qkv")
    out = ring_attend(q, k, v, m, m, mesh)
    (out * _chunk(t["dout"], mesh, 0)).sum().backward()
    return dict(out=out.detach(), q=q.grad, k=k.grad, v=v.grad,
                stats=(mesh.stats.moved, mesh.stats.backward_moved))


def pipe_case(mesh_cfg, cfg: ModelConfig, sd: dict, rows: int,
              arrays: dict, cases: list) -> dict:
    """``pp_apply`` of a training ``VideoGPT`` holding this rank's part of
    ``sd`` on this data rank's rows of a ``rows``-row batch (every row the
    layout of ``RowSpec((1, 2, 1))`` at 48x48; ``arrays`` the global
    noisy latents ``z``, timesteps ``t`` and clean latents ``cl``), per
    case (num_micro, remat, grads): the prediction and, with ``grads``,
    each parameter's gradient of mean(pred ** 2) over the rank's rows.
    ``mesh_cfg`` None: one process, no mesh."""
    from video_gpt_tpu_torch.layout import (RowSpec, build_layout,
                                            tokens_per_frame)
    from video_gpt_tpu_torch.models.video_gpt import Batch, VideoGPT
    from video_gpt_tpu_torch.parallel.pipeline import pp_apply
    from video_gpt_tpu_torch.training.trainer import shard_state_dict
    import dataclasses
    mesh = None if mesh_cfg is None else make_mesh(mesh_cfg)
    mine = batch_rows(mesh, rows)
    n = mine.stop - mine.start
    lay = build_layout([RowSpec((1, 2, 1), "training")] * n,
                       tokens_per_frame(48, 48))
    batch = Batch.from_layout(lay, "cpu")
    per = {k: v.shape[0] // rows for k, v in arrays.items()}
    z, t, cl = (torch.from_numpy(arrays[k][mine.start * per[k]:
                                           mine.stop * per[k]])
                for k in ("z", "t", "cl"))
    out = {"coords": None if mesh is None else mesh.coords}
    for nm, remat, grads in cases:
        model = VideoGPT(dataclasses.replace(cfg, remat=remat),
                         train_init=True, mesh=mesh)
        model.load_state_dict(shard_state_dict(
            {k: torch.from_numpy(v) for k, v in sd.items()}, model, mesh))
        with torch.set_grad_enabled(grads):
            pred = pp_apply(model, batch, z, t, cl, num_micro=nm)
            if grads:
                (pred ** 2).mean().backward()
        out[(nm, remat)] = dict(
            pred=pred.detach(),
            grads={k: p.grad for k, p in model.named_parameters()}
            if grads else None,
            stats=None if mesh is None else (mesh.stats.moved,
                                             mesh.stats.backward_moved))
        if mesh is not None:
            mesh.stats.reset()
    return out
