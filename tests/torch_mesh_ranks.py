"""Rank-side functions of the port's mesh tests (``test_torch_mesh.py``,
``test_torch_sp_serving.py``), run in spawned gloo processes by
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
