"""VideoGPT: DiT-over-Phi3 next-clip diffusion model.

Port of ``video_gpt_tpu/models/video_gpt.py``. The embedding sequence is
assembled with the layout's precomputed gather maps; forward variants:

- ``forward`` (``__call__``): full-sequence forward;
- ``prefill``: run the clean-context prefix once, return the KV cache;
- ``extend_cache``: grow that cache by new clean frames;
- ``decode``: one denoise evaluation over the noisy tail against the cache.

Each variant is a span (``utils.profiling.annotate``): ``vgt.model.forward``,
``vgt.model.prefill``, ``vgt.model.extend`` and ``vgt.model.decode``.

Clean conditions are one [N, hl, wl, C] tensor (the video path) or a tuple
of such groups of different sizes (an image prompt's input images, each at
its own token length), embedded as one flat patch stream in group order.
With ``input_head`` the model carries the aux input-reconstruction head
``input_final_layer`` (zero at init), read by
``forward(..., input_output_return=True)``.

Module names follow the reference's torch model, so its state dict (and
``utils.weights.videogpt_state_dict_from_jax``) loads with ``strict=True``.

Built with ``mesh=`` (``parallel/mesh.py``), every rank assembles the
token stream whole; the trunk splits it over the seq axis and gathers it
before the heads (the embedders and the heads, the aux input head too, get
their whole gradient on every seq rank), and the KV cache that ``prefill``
/ ``extend_cache`` return holds the rank's heads (``mesh.cache_heads``).
On a ZeRO-3 mesh the parameters rest as this data rank's parts
(``mesh.shard_params_``): ``forward`` gathers the embedders', the heads',
the token embedding's and the final norm's once per call, and the trunk
each layer's at its use. On a pipe mesh every rank assembles the tokens and
runs the heads; the trunk between them is a GPipe pipeline over the pipe
ranks' stages (``parallel.pipeline``), whose output every pipe rank gets.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..config import ModelConfig
from ..ops.attention import AttnMeta
from ..ops.flash_attention import DecodeMask, bias_map, precompute_bias
from ..parallel.mesh import (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, axis_size,
                             gather_params)
from ..utils.profiling import annotate
from .afmoe import AfmoeDecoder, afmoe_biases
from .embedders import (FinalLayer, PatchEmbed, TimestepEmbedder,
                        crop_pos_embed, sincos_2d_pos_embed, unpatchify)
from .phi3 import KVCache, Phi3Decoder


class Batch(NamedTuple):
    """Device-side view of a SequenceLayout (int32 tensors)."""

    input_ids: torch.Tensor     # [B, L]
    pos_ids: torch.Tensor       # [B, L]
    noisy_src: torch.Tensor     # [B, L] -> [Nn*n] or -1
    clean_src: torch.Tensor     # [B, L] -> [Nc*n] or -1
    time_src: torch.Tensor      # [B, L] -> [Nn] or -1
    noisy_gather: torch.Tensor  # [Nn, n] flat b*L+pos
    clean_gather: torch.Tensor  # [Nc, n]
    meta: AttnMeta

    @classmethod
    def from_layout(cls, layout, device) -> "Batch":
        def t(x):
            return torch.as_tensor(x, dtype=torch.int32).to(device)

        return cls(input_ids=t(layout.input_ids), pos_ids=t(layout.pos_ids),
                   noisy_src=t(layout.noisy_src),
                   clean_src=t(layout.clean_src), time_src=t(layout.time_src),
                   noisy_gather=t(layout.noisy_gather),
                   clean_gather=t(layout.clean_gather),
                   meta=AttnMeta.from_layout(layout, device))


def maybe_bias(cfg: ModelConfig, q_meta: AttnMeta, k_meta: AttnMeta,
               mesh=None):
    """The layer- and step-invariant attention bias (the bias kernel's
    operand) with its tile map, built once here and read by every layer's
    K3 and K9 (a :class:`BiasMap`; on the CPU it holds no map), or None
    when B*Lq*Lk exceeds ``cfg.precompute_bias_limit``.
    The JAX package precomputes it only on the TPU and under an 8192-key
    VMEM cap as well; the port does on every device, so the prefill and the
    training forward run the bias kernel's function everywhere (the kernel
    on CUDA, its plain version on the CPU). Above the limit ``attend``
    runs the metadata-inline kernel K6 (backward K7), which evaluates the
    rule per tile and needs no [Lq, Lk] tensor: stages 2-4, and stage 1 at
    B >= 6. On a ``mesh`` with a seq axis it is None, as under the JAX
    package's Ulysses: the seq-sharded trunk pads its sequences to the seq
    multiple, which a dense bias cannot follow, so its prefill runs K6
    (and so does the ring). On a pipe mesh it is None too: the JAX pipeline
    trunk takes no dense bias (it would replicate [Lq, Lk] onto every
    stage), so a stage runs K6 forward and K7 backward."""
    if axis_size(mesh, SEQ_AXIS) > 1 or axis_size(mesh, PIPE_AXIS) > 1:
        return None
    b, lq = q_meta.index.shape
    if b * lq * k_meta.vis_start.shape[1] > cfg.precompute_bias_limit:
        return None
    return bias_map(precompute_bias(q_meta, k_meta))


def decode_mask(q_meta: AttnMeta, k_meta: AttnMeta) -> DecodeMask:
    """Columnar decode mask (the mirror of ``layout.decode_rank``, which
    must have validated the layout first): O(L) metadata evaluated as
    ``q_offset >= rank`` per element."""
    first_q = k_meta.vis_start.shape[1] - q_meta.q_offset.shape[1]
    g = q_meta.q_block[:, -1:]
    nb = k_meta.noisy_block
    rank = torch.where((nb >= 0) & (nb == g), k_meta.noisy_role,
                       torch.where(k_meta.vis_start <= first_q, -1, 2 ** 30))
    return DecodeMask(rank=rank.to(torch.int32), q_off=q_meta.q_offset)


def extend_mask(q_meta: AttnMeta, k_meta: AttnMeta) -> DecodeMask:
    """Columnar mask of the cache-extend step. Extend queries are CLEAN
    tokens (q_block = -1), so the noisy term of the visibility rule is
    false and the rule collapses exactly to ``q_index >= vis_start[k]``."""
    return DecodeMask(rank=k_meta.vis_start.to(torch.int32),
                      q_off=q_meta.index.to(torch.int32))


def _has_frames(clean) -> bool:
    if clean is None:
        return False
    if isinstance(clean, (tuple, list)):
        return any(g.shape[0] > 0 for g in clean)
    return clean.shape[0] > 0


def _scatter(emb: torch.Tensor, src: torch.Tensor, values: torch.Tensor
             ) -> torch.Tensor:
    """Replace emb[b, l] with values[src[b, l]] where src >= 0. ``values``
    may be [N, n, D] (flattened here) or flat [M, D]."""
    flat = values.reshape(-1, values.shape[-1])
    taken = flat[src.clamp(min=0).long()]
    return torch.where((src >= 0)[..., None], taken.to(emb.dtype), emb)


class VideoGPT(nn.Module):
    """``train_init`` builds the training model: :meth:`init_random_`
    zeroes the noisy-patch embedder and the head, as the JAX package's
    ``VideoGPT(train_init=True)`` initialises them, so a fresh model
    predicts 0.

    Mixed precision: under ``torch.autocast`` the residual stream is cast
    to autocast's dtype at the embedding, so with fp32 parameters every
    activation, and every attention kernel's operand, is bf16 (the JAX
    package's flax ``dtype=bf16`` over fp32 parameters)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32,
                 train_init: bool = False, input_head: bool = False,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.train_init = train_init
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.x_embedder = PatchEmbed(d, cfg.patch_size, cfg.in_channels,
                                     zero_init=train_init, **kw)
        self.input_x_embedder = PatchEmbed(d, cfg.patch_size, cfg.in_channels,
                                           **kw)
        self.time_token = TimestepEmbedder(d, cfg.freq_embed_size, **kw)
        self.t_embedder = TimestepEmbedder(d, cfg.freq_embed_size, **kw)
        self.final_layer = FinalLayer(d, cfg.patch_size, cfg.in_channels,
                                      zero_init=train_init, **kw)
        if input_head:
            # zero at init in both packages, whatever train_init says
            self.input_final_layer = nn.Linear(
                d, cfg.patch_size ** 2 * cfg.in_channels, **kw)
            self.input_final_layer.zero_init = True
        trunk = AfmoeDecoder if cfg.trunk == "afmoe" else Phi3Decoder
        self.llm = trunk(cfg, mesh=mesh, **kw)
        self._pos_tables: Dict[tuple, torch.Tensor] = {}
        self._whole_params = False

    @property
    def dtype(self) -> torch.dtype:
        return self.llm.embed_tokens.weight.dtype

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator, std: float = 0.02,
                     whole: "VideoGPT" = None, part=None):
        """Random weights drawn on the parameters' device: normal(std) for
        matrices and embeddings, zero biases, unit norms. The head and the
        adaLN modulation are random too, so the model does not predict
        zeros (a zero-init head makes any parity or smoke run vacuous),
        unless the model is built with ``train_init``: then the modules
        marked ``zero_init`` (the head and the noisy-patch embedder) are
        zero. The aux input head is always zero, as the JAX package
        initialises it.

        A model on a mesh holding parts of the parameters passes ``whole``
        (the unsharded model, on the meta device) and ``part(name,
        tensor)`` (this rank's part of a whole parameter): the whole model's
        draws are made one parameter at a time and each rank keeps its
        part, so every mesh holds the one-rank model of ``generator``."""
        src = self if whole is None else whole
        zero = {f"{m_name}.{n}" for m_name, m in src.named_modules()
                if getattr(m, "zero_init", False)
                for n, _ in m.named_parameters()}
        mine = dict(self.named_parameters())
        dev, dtype = self.llm.norm.weight.device, self.llm.norm.weight.dtype
        for name, p in src.named_parameters():
            # a pipe rank draws every parameter and keeps its stage's
            dst = mine.get(name)
            t = p if whole is None else torch.empty(
                p.shape, device=dev, dtype=dtype)
            if name.endswith("norm.weight"):
                t.fill_(1.0)
            elif name.endswith(".bias"):
                t.zero_()
            else:
                t.normal_(0.0, std, generator=generator)
            if name in zero:
                t.zero_()
            if whole is not None and dst is not None:
                dst.copy_(part(name, t))
        for name, buf in self.named_buffers():
            if name.endswith("expert_bias"):  # held at zero, untrained
                buf.zero_()
        return self

    # ---- embedding assembly ------------------------------------------------

    def _embed_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings in the residual stream's dtype: autocast's on
        this device when it is on, else the parameters'."""
        emb = self.llm.embed_tokens(ids.long())
        if torch.is_autocast_enabled(emb.device.type):
            return emb.to(torch.get_autocast_dtype(emb.device.type))
        return emb

    def _pos_embed(self, hl: int, wl: int) -> torch.Tensor:
        p = self.cfg.patch_size
        device = self.llm.norm.weight.device
        key = (hl // p, wl // p, device, self.dtype)
        if key not in self._pos_tables:
            table = sincos_2d_pos_embed(
                self.cfg.hidden_size, self.cfg.pos_embed_max_size,
                interpolation_scale=self.cfg.pe_interpolation, base_size=64)
            crop = crop_pos_embed(table, self.cfg.pos_embed_max_size,
                                  hl // p, wl // p)
            self._pos_tables[key] = torch.from_numpy(crop).to(device,
                                                              self.dtype)
        return self._pos_tables[key]

    def _embed_frames(self, latents: torch.Tensor, is_input: bool
                      ) -> torch.Tensor:
        """[N, hl, wl, C] -> [N, n_img, D] plus the 2D sincos table."""
        embedder = self.input_x_embedder if is_input else self.x_embedder
        tok = embedder(latents)
        pos = self._pos_embed(latents.shape[1], latents.shape[2])
        return tok + pos.to(tok.dtype)[None]

    def _embed_clean_flat(self, clean) -> torch.Tensor:
        """Clean conditions as a flat [sum_i N_i n_i, D] patch stream: one
        [N, hl, wl, C] tensor or a tuple/list of such groups (each group at
        its own size), in group order, the order ``clean_src`` indexes."""
        groups = clean if isinstance(clean, (tuple, list)) else (clean,)
        flat = [self._embed_frames(g, is_input=True).flatten(0, 1)
                for g in groups if g.shape[0] > 0]
        return flat[0] if len(flat) == 1 else torch.cat(flat, dim=0)

    def _assemble(self, batch: Batch, noisy_latents, t, clean_latents):
        emb = self._embed_ids(batch.input_ids)
        if noisy_latents is not None and noisy_latents.shape[0] > 0:
            emb = _scatter(emb, batch.noisy_src,
                           self._embed_frames(noisy_latents, is_input=False))
            emb = _scatter(emb, batch.time_src, self.time_token(t))
        if _has_frames(clean_latents):
            emb = _scatter(emb, batch.clean_src,
                           self._embed_clean_flat(clean_latents))
        return emb

    def _heads(self, hidden, gather, t, shape, aux: bool = False):
        """Per-frame head: gather patch states, adaLN head (or, with
        ``aux``, the input-reconstruction head), unpatchify."""
        n_frames, hl, wl = shape
        flat = hidden.reshape(-1, hidden.shape[-1])
        img = flat[gather.reshape(-1).long()].reshape(n_frames, -1,
                                                      hidden.shape[-1])
        if aux:
            out = self.input_final_layer(img)
        else:
            out = self.final_layer(img, self.t_embedder(t))
        return unpatchify(out, hl, wl, self.cfg.patch_size,
                          self.cfg.in_channels)

    # ---- forward variants --------------------------------------------------

    def forward(self, batch: Batch, noisy_latents: torch.Tensor,
                t: torch.Tensor, clean_latents=None,
                input_output_return: bool = False, bias=None,
                num_micro: int = None):
        """Full-sequence forward: x1-prediction per noisy frame
        [Nn, hl, wl, C]; with ``input_output_return`` also the aux head's
        reconstruction of each clean frame [Nc, hl, wl, C] (the model must
        carry ``input_head``). ``bias`` (a precomputed bias or a
        DecodeMask) lets loop callers pay the step-invariant mask once.
        ``num_micro``: the GPipe microbatches of a pipe mesh (one per stage
        by default; ``parallel.pipeline.pp_apply``)."""
        with annotate("vgt.model.forward"):
            mesh = self.llm.mesh
            if (mesh is not None and mesh.cfg.zero_params
                    and axis_size(mesh, DATA_AXIS) > 1
                    and not self._whole_params):
                # ZeRO-3: this call on the parameters outside the trunk's
                # layers gathered whole (the layers gather their own)
                self._whole_params = True
                try:
                    return functional_call(
                        self, gather_params(self, mesh, skip="llm.layers."),
                        (batch, noisy_latents, t, clean_latents),
                        dict(input_output_return=input_output_return,
                             bias=bias, num_micro=num_micro))
                finally:
                    self._whole_params = False
            emb = self._assemble(batch, noisy_latents, t, clean_latents)
            if bias is None and self.cfg.trunk == "afmoe":
                bias = afmoe_biases(self.cfg, batch.meta, batch.pos_ids)
            elif bias is None:
                bias = maybe_bias(self.cfg, batch.meta, batch.meta,
                                  self.llm.mesh)
            hidden, _ = self.llm(emb, batch.pos_ids, batch.meta, batch.meta,
                                 bias=bias, num_micro=num_micro)
            nn_, hl, wl, _ = noisy_latents.shape
            pred = self._heads(hidden, batch.noisy_gather, t, (nn_, hl, wl))
            if input_output_return:
                nc, hc, wc = clean_latents.shape[:3]
                aux = self._heads(hidden, batch.clean_gather, None,
                                  (nc, hc, wc), aux=True)
                return pred, aux
            return pred

    def prefill(self, batch: Batch, clean_latents, prefix_len: int
                ) -> KVCache:
        """Run the clean-context prefix once; return per-layer K/V."""
        with annotate("vgt.model.prefill"):
            lp = prefix_len
            emb = self._embed_ids(batch.input_ids[:, :lp])
            if _has_frames(clean_latents):
                emb = _scatter(emb, batch.clean_src[:, :lp],
                               self._embed_clean_flat(clean_latents))
            meta_p = batch.meta.cols(slice(0, lp))
            _, cache = self.llm(emb, batch.pos_ids[:, :lp], meta_p, meta_p,
                                bias=maybe_bias(self.cfg, meta_p, meta_p,
                                                self.llm.mesh),
                                return_kv=True)
            return cache

    def extend_cache(self, batch: Batch, new_latents: torch.Tensor,
                     cache: KVCache, new_len: int,
                     n_prev_clean: int) -> KVCache:
        """Grow a clean-prefix cache by the segment tokens
        ``batch.input_ids[:, old:old+new_len]`` (the clean copies of the
        previous block's predictions) instead of re-prefilling the prefix.
        ``new_latents`` holds only the appended frames; ``n_prev_clean`` is
        how many clean frames the cache already covers. Equal to a fresh
        prefill because clean positions start at 0 and the row is pad-free.
        """
        with annotate("vgt.model.extend"):
            old = cache.length
            sl = slice(old, old + new_len)
            emb = self._embed_ids(batch.input_ids[:, sl])
            c = self._embed_frames(new_latents, is_input=True)
            p = self.cfg.patch_size
            offset = n_prev_clean * ((new_latents.shape[1] // p)
                                     * (new_latents.shape[2] // p))
            src = batch.clean_src[:, sl]
            emb = _scatter(emb, torch.where(src >= offset, src - offset, -1),
                           c)
            q_meta = batch.meta.cols(sl)
            k_meta = batch.meta.cols(slice(0, old + new_len))
            _, new_kv = self.llm(emb, batch.pos_ids[:, sl], q_meta, k_meta,
                                 cache=cache,
                                 bias=extend_mask(q_meta, k_meta),
                                 return_kv=True)
            # heads-major [layers, B, H_kv, L, D]: append along L
            return KVCache(torch.cat([cache.k, new_kv.k], dim=3),
                           torch.cat([cache.v, new_kv.v], dim=3))

    def decode(self, batch: Batch, noisy_latents: torch.Tensor,
               t: torch.Tensor, cache: KVCache, tail_len: int,
               bias=None) -> torch.Tensor:
        """One denoise evaluation over the noisy tail against the cache.
        ``bias`` selects the cached attention: a columnar
        :class:`DecodeMask` (the video path, whose layouts pass
        ``layout.decode_rank``) runs K1 over the cache and the tail as
        separate operands; a :class:`BiasMap` of the tail's rows over every
        key (the image path's rectangular bias, built once per context)
        runs K3, and None K6, over their concatenation. By default the
        bias is built here, as :func:`maybe_bias` builds it."""
        with annotate("vgt.model.decode"):
            lt = tail_len
            full_l = batch.input_ids.shape[1]
            emb = self._embed_ids(batch.input_ids[:, -lt:])
            emb = _scatter(emb, batch.noisy_src[:, -lt:],
                           self._embed_frames(noisy_latents, is_input=False))
            emb = _scatter(emb, batch.time_src[:, -lt:], self.time_token(t))
            q_meta = batch.meta.tail(lt)
            if bias is None:
                bias = maybe_bias(self.cfg, q_meta, batch.meta,
                                  self.llm.mesh)
            hidden, _ = self.llm(emb, batch.pos_ids[:, -lt:], q_meta,
                                 batch.meta, cache=cache, bias=bias)
            # remap full-sequence gather indices onto the tail
            g = batch.noisy_gather
            g_tail = (g // full_l) * lt + (g % full_l - (full_l - lt))
            nn_, hl, wl, _ = noisy_latents.shape
            return self._heads(hidden, g_tail, t, (nn_, hl, wl))
