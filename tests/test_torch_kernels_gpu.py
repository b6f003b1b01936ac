"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided in the
fixture, never at import, so every worker collects the same tests). On a
machine with a card and no JAX, run them without the repo's conftest:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

Shapes are small but cover GQA, ragged tile edges (lengths that are not
multiples of the 64-row tiles) and batch 2 (the CFG layout).
Inputs are bf16; the plain version computes in fp32 from the same bf16
values. Bar per element, its bf16 rounding bound:
|got - want| <= 1e-4 + 1e-2 |want| + 2^-8 mass, with mass = sum p|v| / sum p
(the plain version run on |V|). The kernels round the probabilities before
P.V to bf16 (unit roundoff 2^-8), which moves an output by at most 2^-8
mass, and round the output, by at most 2^-8 |want|; 1e-4 covers fp32
summation order. For the backward (K9, K7) the mass of each gradient element
is the plain version's product over absolute values (|ds| |K| for dq,
|ds|^T |Q| for dk, p^T |dO| for dv): the kernels round ds and p to bf16
before those products.

K3, K9, K6 and K7 compute only the tiles that their tile map
(``csrc/tile_map.cuh``) does not call empty: the maps the kernels build are
held equal to the plain classifiers; K3 and K9 are checked on a bias row
that sees no key (its softmax is uniform, so its query tile is never
skipped), and read one map, built once per bias, across a forward, its
recompute and the backward, and across the four forwards of a guided
distillation step (whose Trainer step builds one map per layout); K6 on a
layout with pad rows and on a small
batched prefill (``index`` with batch stride 0); K7 on a layout whose key
tile no query sees (its dK/dV are exactly 0). K6 runs at every block shape
it chooses (64 to 256 query rows a block, by head width and grid), with a
short last group, rows that see no key and lq != lk; its group order and
K7's orders are held to the plain versions.

The mutation checks build a copy of ``csrc/`` with one fault in a
temporary directory and show that the bar catches it (worst error / bar
above 1, printed; run with ``-s`` to read it): K6 without the last key
tile of the map, K6's second consumer warpgroup's rows unstored (a
192-row block), K7's dK/dV without its last listed query tile, K7's dQ
and K3 without their last listed key tile, K3 treating a partial tile as
full, one non-empty tile (the first query tile against the first key
tile) classed empty in K6's and in the bias's map, the pipelined overlap
probe without its last subtile and the serial one without its last tile,
the fp32 backward's dQ without its last key tile, the fp32 kernels'
split products cut to their hh piece product (the forward's S = Q.K^T,
the backward's dQ += dS.K: one bf16 product in place of six), the padded
head dims of a bf16 backward instance not zero-filled (K9 on 40-wide
views of 64-wide rows), and the Dp-128 dK/dV kernels of K9 and K7
reading the wrong 16 rows of their MN-major operand (a descriptor off by
one K-step).

Every kernel also runs at every dtype and head width its wrapper takes
(``test_k*_at_every_width``: bf16 and fp32 at head_dim 16, 40, 64, 96,
104 and 128); the fp32 backward (K9 and K7 in ``fp32_attention_bwd.cu``)
is held to |got - want| <= 2e-5 + 2e-5 |want| + 2^-18 mass, the bf16
bar's backward mass with fp32's rounding in place of bf16's.

Past 8192 keys the TPU runs k-tiled kernels (K4, K5, K10); here K1, K2 and
K3 serve those rows, and are held against their plain versions at those
shapes (32 heads of 96, 176x320 frames), as are K1 and K6 at the batched
rollout's B 2.

The image path's cached decode runs K3 over the heads-major concatenation
of a prompt's cache and the tail (``attend_cached``) with a rectangular
bias (the tail's rows over every key): held at odd lengths, a cache
shorter than one key tile, and the padded batch's 3 rows; a mutation drops
the key tile that holds the cache's last key.
"""
import os
import shutil

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from video_gpt_tpu_torch import layout
from video_gpt_tpu_torch.config import ModelConfig
from video_gpt_tpu_torch.image_gen import TextRow, single_shot_layout
from video_gpt_tpu_torch.models.video_gpt import (decode_mask, extend_mask,
                                                  maybe_bias)
from video_gpt_tpu_torch.ops import _cuda
from video_gpt_tpu_torch.ops import flash_attention as fa
from video_gpt_tpu_torch.ops.attention import AttnMeta, Window, attend_cached
from video_gpt_tpu_torch.probes import overlap_probe

pytestmark = pytest.mark.gpu
ATOL, RTOL, BF16_U = 1e-4, 1e-2, 2.0 ** -8
# the flagship's head width, the tests' default
D = ModelConfig().head_dim


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16(dev, seed, *shape):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


def _err(got, want, mass):
    """The worst element's error over its bar (passes at <= 1); a value
    that is not finite counts as an infinite error."""
    got, want, mass = (x.float().cpu() for x in (got, want, mass))
    bar = ATOL + RTOL * want.abs() + BF16_U * mass
    return float(torch.nan_to_num((got - want).abs() / bar,
                                  nan=float("inf")).max())


@pytest.mark.parametrize("h,hkv,n_img", [(4, 2, 30), (8, 8, 17)])
def test_k1_k2_match_plain(dev, h, hkv, n_img):
    d = D
    lay = layout.frame_block_inference_layout(3, 2, n_img, use_cfg=False)
    meta = AttnMeta.from_layout(lay, dev)
    tail, L = lay.noisy_tail_len(), lay.length
    lc = L - tail
    mask = decode_mask(meta.tail(tail), meta)
    q = _bf16(dev, 0, 1, tail, h, d)
    kv = _bf16(dev, 1, 1, L, 2, hkv, d)   # tokens-major, fused k|v
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    kc, vc = k[:, :, :lc].contiguous(), v[:, :, :lc].contiguous()
    fa.reset_launch_counts()
    got1 = fa.flash_mha_decode_split(q, kc, vc, k[:, :, lc:], v[:, :, lc:],
                                     mask)
    cpu_mask = fa.DecodeMask(*(x.cpu() for x in mask))

    def plain(vf):
        return fa.flash_mha_decode_split(
            q.cpu().float(), kc.cpu().float(), vf(vc.cpu().float()),
            k[:, :, lc:].cpu().float(), vf(v[:, :, lc:].cpu().float()),
            cpu_mask)

    want1, mass1 = plain(lambda x: x), plain(torch.abs)
    got2 = fa.flash_mha_decode(q, kv[:, :, 0], kv[:, :, 1], mask)
    torch.cuda.synchronize()
    assert fa.flash_mha_decode_split.launches == 1
    assert fa.flash_mha_decode.launches == 1
    # within the TPU's key cap: no launch in K4's or K5's place
    assert fa.flash_mha_decode_split.long_launches == 0
    assert fa.flash_mha_decode.long_launches == 0
    assert _err(got1, want1, mass1) <= 1.0
    assert _err(got2, want1, mass1) <= 1.0


def test_k1_extend_matches_plain(dev):
    lay = layout.frame_block_inference_layout(4, 1, 30, use_cfg=False)
    meta = AttnMeta.from_layout(lay, dev)
    seg = 32
    old, new = 3 * seg, seg
    sl = slice(old, old + new)
    mask = extend_mask(meta.cols(sl), meta.cols(slice(0, old + new)))
    q = _bf16(dev, 2, 1, new, 4, 96)
    k, v = _bf16(dev, 3, 1, 4, old + new, 96), _bf16(dev, 4, 1, 4, old + new,
                                                     96)
    got = fa.flash_mha_decode_split(q, k[:, :, :old], v[:, :, :old],
                                    k[:, :, old:], v[:, :, old:], mask)
    def plain(vf):
        return fa.rank_attention_reference(
            q.float(), (k[:, :, :old].float(), k[:, :, old:].float()),
            (vf(v[:, :, :old].float()), vf(v[:, :, old:].float())),
            (mask.rank[:, :old], mask.rank[:, old:]), mask.q_off)

    assert _err(got, plain(lambda x: x), plain(torch.abs)) <= 1.0


def _rank_mask(dev, seed, b, lq, lk, never_tile=None):
    """A random columnar mask: q_off in {0, 1, 2}, ranks in {-1, 0, 1, 2,
    NEVER}; with ``never_tile`` the keys of that 64-key tile are NEVER (a
    key tile that no query sees)."""
    g = torch.Generator().manual_seed(seed)
    choices = torch.tensor([-1, 0, 1, 2, fa.NEVER], dtype=torch.int32)
    rank = choices[torch.randint(0, 5, (b, lk), generator=g)]
    if never_tile is not None:
        rank[:, 64 * never_tile:64 * (never_tile + 1)] = fa.NEVER
    q_off = torch.randint(0, 3, (b, lq), generator=g, dtype=torch.int32)
    return fa.DecodeMask(rank.to(dev), q_off.to(dev))


def _k1_error(dev, b, lq, lc, lt, seed=0, heads=(4, 2)):
    """K1 over a random mask against its plain version: the cache
    heads-major [B, Hkv, Lc, D], the tail a view of tokens-major K/V (its
    key tile past 64 of the cache unseen when Lc >= 128). The kernel writes
    into an output filled with NaN, so that a row it leaves unstored fails
    the bar."""
    h, hkv = heads
    d = D
    q = _bf16(dev, seed, b, lq, h, d)
    kc, vc = _bf16(dev, seed + 1, b, hkv, lc, d), _bf16(dev, seed + 2, b,
                                                       hkv, lc, d)
    kv = _bf16(dev, seed + 3, b, lt, 2, hkv, d)
    kt, vt = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    mask = _rank_mask(dev, seed + 4, b, lq, lc + lt,
                      never_tile=1 if lc >= 128 else None)
    fill = q.new_full((b, lq, h, d), float("nan"))
    launch = fa._launch_rank
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "_launch_rank",
                   lambda *args: launch(*args, out=fill))
        got = fa.flash_mha_decode_split(q, kc, vc, kt, vt, mask)
    assert got is fill

    def plain(vf):
        return fa.rank_attention_reference(
            q.float(), (kc.float(), kt.float()), (vf(vc.float()),
                                                  vf(vt.float())),
            (mask.rank[:, :lc], mask.rank[:, lc:]), mask.q_off)

    return _err(got, plain(lambda x: x), plain(torch.abs))


@pytest.mark.parametrize("b,lq,lc,lt", [
    (1, 1, 70, 1), (1, 63, 1, 129), (2, 64, 9, 57), (1, 127, 200, 64),
    (2, 129, 13, 3), (1, 129, 0, 77)])
def test_k1_at_odd_lengths(dev, b, lq, lc, lt):
    """K1 at query rows and operand lengths off its tiles: 1, 63, 64, 127
    and 129 rows (one or two consumer warpgroups of a block, the second
    one partly filled), operands of 1 key, lengths no multiple of 8 or 64,
    an empty cache (Lc 0), B 2 with a heads-major cache, and a cache key
    tile that no query sees."""
    fa.reset_launch_counts()
    assert _k1_error(dev, b, lq, lc, lt) <= 1.0
    assert fa.flash_mha_decode_split.launches == 1


@pytest.mark.parametrize("b,lq,lk", [
    (1, 1, 1), (1, 63, 65), (2, 127, 7), (1, 129, 129), (1, 64, 200)])
def test_k2_at_odd_lengths(dev, b, lq, lk):
    """K2 over one tokens-major operand at the K1 case's lengths; at Lk 200
    the second key tile is seen by no query."""
    d = D
    q = _bf16(dev, 5, b, lq, 4, d)
    k, v = _bf16(dev, 6, b, lk, 2, d), _bf16(dev, 7, b, lk, 2, d)
    mask = _rank_mask(dev, 8, b, lq, lk, never_tile=1 if lk >= 128 else None)
    fa.reset_launch_counts()
    got = fa.flash_mha_decode(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.flash_mha_decode.launches == 1

    def plain(vf):
        return fa.rank_attention_reference(
            q.float(), (k.float().transpose(1, 2),),
            (vf(v.float()).transpose(1, 2),), (mask.rank,), mask.q_off)

    assert _err(got, plain(lambda x: x), plain(torch.abs)) <= 1.0


def test_k1_k2_on_a_key_tile_that_no_query_sees(dev):
    """A tile that neither consumer sees is never loaded: the output is the
    plain version's, and the tile's K/V may hold anything (here NaN)."""
    d = D
    b, lq, lk = 1, 100, 300
    q = _bf16(dev, 9, b, lq, 4, d)
    k, v = _bf16(dev, 10, b, lk, 2, d), _bf16(dev, 11, b, lk, 2, d)
    mask = _rank_mask(dev, 12, b, lq, lk, never_tile=2)
    k[:, 128:192], v[:, 128:192] = float("nan"), float("nan")
    got = fa.flash_mha_decode(q, k, v, mask)
    keep = torch.ones(lk, dtype=torch.bool, device=dev)
    keep[128:192] = False

    def plain(vf):
        return fa.rank_attention_reference(
            q.float(), (k[:, keep].float().transpose(1, 2),),
            (vf(v[:, keep].float()).transpose(1, 2),),
            (mask.rank[:, keep],), mask.q_off)

    assert _err(got, plain(lambda x: x), plain(torch.abs)) <= 1.0


@pytest.mark.parametrize("lk", [600, 2000])
def test_k2_on_a_causal_mask(dev, lk):
    """q_off = row, rank = key: each consumer warpgroup of a block sees a
    prefix of the key tiles, so one meets many tiles that only the others
    see while it holds a stage of the ring (the ring must not wrap around
    it)."""
    d = D
    lq = 600
    q = _bf16(dev, 14, 1, lq, 4, d)
    k, v = _bf16(dev, 15, 1, lk, 2, d), _bf16(dev, 16, 1, lk, 2, d)
    mask = fa.DecodeMask(
        torch.arange(lk, dtype=torch.int32, device=dev)[None],
        torch.arange(lq, dtype=torch.int32, device=dev)[None])
    got = fa.flash_mha_decode(q, k, v, mask)

    def plain(vf):
        return fa.rank_attention_reference(
            q.float(), (k.float().transpose(1, 2),),
            (vf(v.float()).transpose(1, 2),), (mask.rank,), mask.q_off)

    assert _err(got, plain(lambda x: x), plain(torch.abs)) <= 1.0


def test_k1_at_the_extend_shape(dev):
    """The serving extend at full width: 4 generated frames (888 clean
    queries) grow the 8-frame cache (1,776 keys) with their own 888 keys,
    under extend_mask (frame-causal, so the blocks' consumers see
    different prefixes of the key tiles)."""
    d = D
    n_img = layout.tokens_per_frame(176, 320)
    lay = layout.frame_block_inference_layout(12, 4, n_img, use_cfg=False)
    meta = AttnMeta.from_layout(lay, dev)
    seg = n_img + 2
    old, new = 8 * seg, 4 * seg
    mask = extend_mask(meta.cols(slice(old, old + new)),
                       meta.cols(slice(0, old + new)))
    q = _bf16(dev, 17, 1, new, H_FULL, d)
    k = _bf16(dev, 18, 1, HKV_FULL, old + new, d)
    v = _bf16(dev, 19, 1, HKV_FULL, old + new, d)
    got = fa.flash_mha_decode_split(q, k[:, :, :old], v[:, :, :old],
                                    k[:, :, old:], v[:, :, old:], mask)

    def plain(vf):
        return fa.rank_attention_reference(
            q.float(), (k[:, :, :old].float(), k[:, :, old:].float()),
            (vf(v[:, :, :old].float()), vf(v[:, :, old:].float())),
            (mask.rank[:, :old], mask.rank[:, old:]), mask.q_off)

    assert _err(got, plain(lambda x: x), plain(torch.abs)) <= 1.0


@pytest.mark.parametrize("n_clean,use_cfg,h,hkv", [
    (3, False, 4, 2), (2, True, 8, 8)])
def test_k3_matches_plain(dev, n_clean, use_cfg, h, hkv):
    d = D
    lay = layout.frame_block_inference_layout(n_clean, 2, 30,
                                              use_cfg=use_cfg)
    meta = AttnMeta.from_layout(lay, dev)
    b, L = lay.batch, lay.length
    bias = fa.precompute_bias(meta, meta)
    # as in the attention layer: q and k are new tensors (RoPE), v a view
    # of the fused qkv projection, with strides of its own
    qkv = _bf16(dev, 5, b, L, h + 2 * hkv, d)
    q, k = qkv[:, :, :h].contiguous(), qkv[:, :, h:h + hkv].contiguous()
    v = qkv[:, :, h + hkv:]
    fa.reset_launch_counts()
    got = fa.flash_mha(q, k, v, bias)
    want = fa.bias_attention_reference(q.float(), k.float(), v.float(), bias)
    mass = fa.bias_attention_reference(q.float(), k.float(), v.float().abs(),
                                       bias)
    torch.cuda.synchronize()
    assert fa.flash_mha.launches == 1
    assert fa.flash_mha.long_launches == 0
    assert _err(got, want, mass) <= 1.0


def _image_layout(rows, n_out):
    """A single-shot layout of one row per (text tokens, input-image region
    tokens) pair, the region (if any) after the third token; rows of other
    lengths are left-padded, as in the padded guidance batch."""
    trows = []
    for i, (n_text, n_region) in enumerate(rows):
        ids = list(range(100 + i, 100 + i + n_text))
        regions = [(3, 3 + n_region)] if n_region else []
        trows.append(TextRow(ids[:3] + [0] * n_region + ids[3:], regions))
    return single_shot_layout(trows, n_out)


def _k3_cached_error(dev, rows, n_out, h=4, hkv=2):
    """K3 as the image decode runs it (``attend_cached``: the heads-major
    cache and the tail's K/V views of the fused projection concatenated,
    the decode's BiasMap) against the plain version: worst error / bar."""
    d = D
    lay = _image_layout(rows, n_out)
    meta = AttnMeta.from_layout(lay, dev)
    b, tail = lay.batch, lay.noisy_tail_len()
    lc = lay.length - tail
    q = _bf16(dev, 1, b, tail, h, d)
    kc, vc = _bf16(dev, 2, b, hkv, lc, d), _bf16(dev, 3, b, hkv, lc, d)
    qkv = _bf16(dev, 4, b, tail, h + 2 * hkv, d)
    kt, vt = qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
    qm = meta.tail(tail)
    fa.reset_launch_counts()
    bm = maybe_bias(ModelConfig(), qm, meta)
    assert bm.bias.shape == (b, tail, lay.length)
    got = attend_cached(q, kc, vc, kt.transpose(1, 2), vt.transpose(1, 2),
                        qm, meta, bm)
    k = torch.cat([kc, kt.transpose(1, 2)], 2).transpose(1, 2).float()
    v = torch.cat([vc, vt.transpose(1, 2)], 2).transpose(1, 2).float()
    want = fa.bias_attention_reference(q.float(), k, v, bm.bias)
    mass = fa.bias_attention_reference(q.float(), k, v.abs(), bm.bias)
    torch.cuda.synchronize()
    assert fa.flash_mha.launches == 1 and fa.flash_mha.bias_map_builds == 1
    assert fa.flash_mha_decode_split.launches == 0
    return _err(got, want, mass)


@pytest.mark.parametrize("rows,n_out", [
    (((37, 70),), 100),            # text around one region, odd lengths
    (((13, 0),), 150),             # a cache shorter than one key tile
    (((29, 300),), 260),           # a longer region and tail
    (((40, 70), (57, 0), (5, 70)), 100)],  # the padded batch's 3 rows
    ids=["region", "short-cache", "long", "padded-3-rows"])
def test_k3_over_a_heads_major_cache(dev, rows, n_out):
    assert _k3_cached_error(dev, rows, n_out) <= 1.0


def _training_layout(blocks, n_img):
    """A training layout of one row, or of one row per tuple of blocks
    (B 2: the shorter row left-padded)."""
    rows = blocks if isinstance(blocks[0], tuple) else (blocks,)
    return layout.build_layout([layout.RowSpec(r, "training") for r in rows],
                               n_img)


def _training_operands(dev, h, hkv, blocks, n_img, requires_grad=False):
    """q/k/v as the attention layer makes them (q, k new tensors, v a view
    of the fused projection) over a training layout, and its bias."""
    d = D
    lay = _training_layout(blocks, n_img)
    meta = AttnMeta.from_layout(lay, dev)
    qkv = _bf16(dev, 7, lay.batch, lay.length, h + 2 * hkv, d)
    q, k = qkv[:, :, :h].contiguous(), qkv[:, :, h:h + hkv].contiguous()
    v = qkv[:, :, h + hkv:]
    if requires_grad:
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    return q, k, v, fa.precompute_bias(meta, meta)


def _k3_error(q, k, v, bias):
    """K3 against the plain version: worst error / bar."""
    fa.reset_launch_counts()
    with torch.no_grad():
        got = fa.flash_mha(q, k, v, bias)
    want = fa.bias_attention_reference(q.float(), k.float(), v.float(), bias)
    mass = fa.bias_attention_reference(q.float(), k.float(), v.float().abs(),
                                       bias)
    torch.cuda.synchronize()
    assert fa.flash_mha.launches == 1 and fa.flash_mha.bias_map_builds == 1
    return _err(got, want, mass)


def _k9_errors(dev, q, k, v, bias):
    """K3 forward (keeping the lse) and K9 against the plain backward:
    {grad: worst error / bar}."""
    fa.reset_launch_counts()
    bm = fa.bias_map(bias)
    out, lse = fa._bias_forward(q, k, v, bm, with_lse=True)
    do = _bf16(dev, 8, *out.shape)
    got = fa.flash_mha_bwd(q, k, v, bm, out, do, lse)
    args = [x.float() for x in (q, k, v)] + [bias, out.float(), do.float()]
    want = fa.bias_attention_backward_reference(*args)
    mass = fa.bias_attention_backward_reference(*args, magnitude=True)
    torch.cuda.synchronize()
    assert fa.flash_mha.launches == 1 and fa.flash_mha_bwd.launches == 1
    assert fa.flash_mha.bias_map_builds == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
    return {name: _err(g, w, m)
            for name, g, w, m in zip(("dq", "dk", "dv"), got, want, mass)}


@pytest.mark.parametrize("h,hkv,blocks,n_img", [
    (4, 2, (1, 2, 1), 30), (8, 8, (2, 1, 1, 1), 17),
    (4, 2, ((1, 2, 1), (2, 2)), 30)])
def test_k9_matches_plain(dev, h, hkv, blocks, n_img):
    q, k, v, bias = _training_operands(dev, h, hkv, blocks, n_img)
    errs = _k9_errors(dev, q, k, v, bias)
    assert max(errs.values()) <= 1.0, errs


@pytest.mark.parametrize("row", [0, 70, 223])
def test_k9_with_a_row_that_sees_no_key(dev, row):
    """A bias row of BF16_NEG everywhere: every logit of it is BF16_NEG in
    fp32, so K3's softmax of it is uniform and its gradient is not 0; K9
    must not skip its query tile, nor take the lse (which lost the key
    count) as the softmax's reference."""
    q, k, v, bias = _training_operands(dev, 4, 2, (1, 2, 1), 30)
    bias[:, row] = fa.BF16_NEG
    errs = _k9_errors(dev, q, k, v, bias)
    assert max(errs.values()) <= 1.0, errs


@pytest.mark.parametrize("row", [0, 70, 223])
def test_k3_with_a_row_that_sees_no_key(dev, row):
    """A bias row of BF16_NEG everywhere: K3's softmax of it is uniform
    over every key (the map keeps every tile of its query tile), as the
    plain version's is."""
    q, k, v, bias = _training_operands(dev, 4, 2, (1, 2, 1), 30)
    bias[:, row] = fa.BF16_NEG
    assert _k3_error(q, k, v, bias) <= 1.0


def test_bias_map_is_built_once_for_k3_and_k9(dev):
    """The bias's map, built once (``bias_map``), serves a checkpointed
    forward, its recompute and the backward: two K3 launches and one K9
    over one build, with gradients that agree with the plain backward."""
    q, k, v, bias = _training_operands(dev, 4, 2, (1, 2, 1), 30,
                                       requires_grad=True)
    w = _bf16(dev, 9, *q.shape)
    fa.reset_launch_counts()
    bm = fa.bias_map(bias)
    out = checkpoint(fa.flash_mha, q, k, v, bm, use_reentrant=False)
    (out.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_mha.bias_map_builds == 1
    assert fa.flash_mha.launches == 2 and fa.flash_mha_bwd.launches == 1
    args = [x.detach().float() for x in (q, k, v)] + [
        bias, out.detach().float(), w.float()]
    want = fa.bias_attention_backward_reference(*args)
    mass = fa.bias_attention_backward_reference(*args, magnitude=True)
    for name, x, wt, m in zip("qkv", (q, k, v), want, mass):
        assert _err(x.grad, wt, m) <= 1.0, name


def test_one_bias_map_serves_four_forwards(dev):
    """A guided distillation step reads one map of the conditional bias in
    four forwards (two teacher substeps, the student's forward and its
    recompute) and the student's backward: K3 and K9 over that one map give
    exactly what they give over a map built per call, and one build is
    made."""
    _, _, _, bias = _training_operands(dev, 4, 2, (1, 2, 1), 30)
    d = D
    b, lq, lk = bias.shape
    fa.reset_launch_counts()
    bm = fa.bias_map(bias)
    for i in range(4):
        q = _bf16(dev, 20 + i, b, lq, 4, d)
        k, v = _bf16(dev, 30 + i, b, lk, 2, d), _bf16(dev, 40 + i, b, lk, 2, d)
        builds = fa.flash_mha.bias_map_builds
        out, lse = fa._bias_forward(q, k, v, bm, with_lse=True)
        do = _bf16(dev, 50 + i, *out.shape)
        grads = fa.flash_mha_bwd(q, k, v, bm, out, do, lse)
        assert fa.flash_mha.bias_map_builds == builds
        own = fa.bias_map(bias)
        out2, lse2 = fa._bias_forward(q, k, v, own, with_lse=True)
        assert torch.equal(out, out2) and torch.equal(lse, lse2)
        for g, g2 in zip(grads, fa.flash_mha_bwd(q, k, v, own, out2, do,
                                                 lse2)):
            assert torch.equal(g, g2)
    torch.cuda.synchronize()
    assert fa.flash_mha.bias_map_builds == 1 + 4
    assert fa.flash_mha.launches == 8 and fa.flash_mha_bwd.launches == 8


@pytest.mark.parametrize("guidance,k3,builds", [(1.5, 6, 2), (None, 4, 1)])
def test_distill_step_builds_each_map_once(dev, guidance, k3, builds):
    """The Trainer's distillation step on the card (a tiny model of head_dim
    96, per-layer recompute): per layer 6 K3 launches with guidance (two
    teacher substeps of a cond and an uncond forward, the student's forward
    and recompute), 4 without, 1 K9; one map build per layout, 2 and 1."""
    import numpy as np

    from video_gpt_tpu_torch.config import ModelConfig, stage_config
    from video_gpt_tpu_torch.data.video import ClipSample
    from video_gpt_tpu_torch.models.vae import VAEConfig
    from video_gpt_tpu_torch.models.video_gpt import VideoGPT
    from video_gpt_tpu_torch.training.data import collate
    from video_gpt_tpu_torch.training.trainer import Trainer

    mcfg = ModelConfig.tiny(hidden_size=192, num_heads=2, num_kv_heads=1,
                            pos_embed_max_size=64)
    res = (64, 96)
    init = VideoGPT(mcfg).init_random_(
        torch.Generator().manual_seed(2)).state_dict()
    trainer = Trainer(mcfg, stage_config(1, frame_num=4, distill=True,
                                         distill_guidance=guidance),
                      None, vae_cfg=VAEConfig.tiny(), target_resolution=res,
                      device=dev, init_state_dict=init)
    state = trainer.build()
    pixels = np.random.default_rng(0).uniform(
        -1, 1, (4, *res, 3)).astype(np.float32)
    tb = collate([ClipSample(pixels, (1, 1, 1, 1))], trainer.n_img,
                 uncond=guidance is not None).to(dev)
    fa.reset_launch_counts()
    metrics = trainer.train_step(state, tb, 0)
    torch.cuda.synchronize()
    nl = mcfg.num_layers
    assert fa.flash_mha.launches == k3 * nl
    assert fa.flash_mha_bwd.launches == nl
    assert fa.flash_mha.bias_map_builds == builds
    assert fa.flash_mha_inline.launches == 0
    assert bool(torch.isfinite(metrics["loss"]))


def test_flash_mha_gradients_reach_q_k_v(dev):
    """The repaired fault: through ``flash_mha`` on CUDA, q, k and v get
    gradients (K9), and they agree with the plain backward."""
    q, k, v, bias = _training_operands(dev, 4, 2, (1, 2, 1), 30,
                                       requires_grad=True)
    w = _bf16(dev, 9, *q.shape)
    fa.reset_launch_counts()
    out = fa.flash_mha(q, k, v, bias)
    assert out.grad_fn is not None
    (out.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_mha.launches == 1 and fa.flash_mha_bwd.launches == 1
    args = [x.detach().float() for x in (q, k, v)] + [
        bias, out.detach().float(), w.float()]
    want = fa.bias_attention_backward_reference(*args)
    mass = fa.bias_attention_backward_reference(*args, magnitude=True)
    for name, x, wt, m in zip("qkv", (q, k, v), want, mass):
        assert x.grad is not None, name
        assert float(x.grad.float().abs().max()) > 0, name
        assert _err(x.grad, wt, m) <= 1.0, name


def _inline_operands(dev, h, hkv, blocks, n_img, requires_grad=False):
    """q/k/v as the attention layer makes them over a training layout, and
    its metadata (``index`` an expanded view with batch stride 0)."""
    d = D
    lay = _training_layout(blocks, n_img)
    meta = AttnMeta.from_layout(lay, dev)
    qkv = _bf16(dev, 17, lay.batch, lay.length, h + 2 * hkv, d)
    q, k = qkv[:, :, :h].contiguous(), qkv[:, :, h:h + hkv].contiguous()
    v = qkv[:, :, h + hkv:]
    if requires_grad:
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    return q, k, v, meta


def _k6_error(dev, h, hkv, blocks, n_img):
    q, k, v, meta = _inline_operands(dev, h, hkv, blocks, n_img)
    fa.reset_launch_counts()
    got = fa.flash_mha_inline(q, k, v, meta, meta)
    want, _ = fa.inline_attention_reference(q.float(), k.float(), v.float(),
                                            meta, meta)
    mass, _ = fa.inline_attention_reference(q.float(), k.float(),
                                            v.float().abs(), meta, meta)
    torch.cuda.synchronize()
    assert fa.flash_mha_inline.launches == 1
    return _err(got, want, mass)


def _k7_errors(dev, h, hkv, blocks, n_img):
    return _k7_case_errors(dev, *_inline_operands(dev, h, hkv, blocks,
                                                  n_img))[0]


def _k7_case_errors(dev, q, k, v, meta):
    """K6 forward (keeping the lse) and K7 against the plain backward:
    ({grad: worst error / bar}, K7's (dq, dk, dv))."""
    fa.reset_launch_counts()
    out, lse = fa._inline_forward(q, k, v, meta, meta, with_lse=True)
    do = _bf16(dev, 18, *out.shape)
    got = fa.flash_mha_inline_bwd(q, k, v, meta, meta, out, do, lse)
    args = [x.float() for x in (q, k, v)] + [meta, meta, out.float(),
                                             do.float()]
    want = fa.inline_attention_backward_reference(*args)
    mass = fa.inline_attention_backward_reference(*args, magnitude=True)
    torch.cuda.synchronize()
    assert fa.flash_mha_inline.launches == 1
    assert fa.flash_mha_inline_bwd.launches == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
    return {name: _err(g, w, m)
            for name, g, w, m in zip(("dq", "dk", "dv"), got, want, mass)}, got


INLINE_CASES = [(4, 2, (1, 2, 1), 30), (8, 8, (2, 1, 1, 1), 17),
                (4, 2, ((1, 2, 1), (2, 2)), 30)]


@pytest.mark.parametrize("h,hkv,blocks,n_img", INLINE_CASES)
def test_k6_matches_plain(dev, h, hkv, blocks, n_img):
    assert _k6_error(dev, h, hkv, blocks, n_img) <= 1.0


def test_k6_on_the_inference_layout(dev):
    """K6 as a prefill above the bias limit would run it: the CFG pair
    (B 2), the noisy tail against the whole row, keys heads-major views."""
    d = D
    lay = layout.frame_block_inference_layout(3, 2, 30, use_cfg=True)
    meta = AttnMeta.from_layout(lay, dev)
    tail = lay.noisy_tail_len()
    q = _bf16(dev, 19, lay.batch, tail, 4, d)
    kh = _bf16(dev, 20, lay.batch, 2, lay.length, d)   # [B, Hkv, L, D]
    vh = _bf16(dev, 21, lay.batch, 2, lay.length, d)
    qm = meta.tail(tail)
    got = fa.flash_mha_inline(q, kh.transpose(1, 2), vh.transpose(1, 2), qm,
                              meta)
    k, v = kh.transpose(1, 2).float(), vh.transpose(1, 2).float()
    want, _ = fa.inline_attention_reference(q.float(), k, v, qm, meta)
    mass, _ = fa.inline_attention_reference(q.float(), k, v.abs(), qm, meta)
    assert _err(got, want, mass) <= 1.0


def _k6_case_error(q, k, v, qm, km):
    """K6 against the plain version on the given operands and metadata."""
    fa.reset_launch_counts()
    with torch.no_grad():
        got = fa.flash_mha_inline(q, k, v, qm, km)
    want, _ = fa.inline_attention_reference(q.float(), k.float(), v.float(),
                                            qm, km)
    mass, _ = fa.inline_attention_reference(q.float(), k.float(),
                                            v.float().abs(), qm, km)
    torch.cuda.synchronize()
    assert fa.flash_mha_inline.launches == 1
    return _err(got, want, mass)


def test_k6_with_pad_rows(dev):
    """A training row as ``collate`` pads it: the pad rows (first in the
    row) see every key, so their tiles are never empty."""
    d = D
    blocks, n_img = (2, 1, 2), 30
    f = sum(blocks)
    lay = layout.build_layout([layout.RowSpec(blocks, "training")], n_img,
                              pad_to=2 * f * (n_img + 2))
    meta = AttnMeta.from_layout(lay, dev)
    assert int(meta.is_pad.sum()) > 0
    qkv = _bf16(dev, 23, 1, lay.length, 8, d)
    q, k, v = qkv[:, :, :4].contiguous(), qkv[:, :, 4:6].contiguous(), \
        qkv[:, :, 6:]
    assert _k6_case_error(q, k, v, meta, meta) <= 1.0


def test_k6_at_a_small_batched_prefill(dev):
    """The batched rollout's prefill at a small size: B 2, the clean prefix
    against itself, ``index`` an expanded view with batch stride 0."""
    d = D
    lay = layout.frame_block_inference_layout(6, 2, 30, use_cfg=False,
                                              rows=2)
    mp = AttnMeta.from_layout(lay, dev).cols(
        slice(0, lay.length - lay.noisy_tail_len()))
    assert mp.index.stride(0) == 0
    lp = mp.index.shape[1]
    q = _bf16(dev, 24, 2, lp, 4, d)
    k, v = _bf16(dev, 25, 2, lp, 2, d), _bf16(dev, 26, 2, lp, 2, d)
    assert _k6_case_error(q, k, v, mp, mp) <= 1.0


# K6's block shapes (csrc/inline_attention.cu): (head_dim, heads, kv
# heads, the rows a block covers on a card of 132 SMs). A training row of
# 17 frames in 8 blocks, 961 tokens left-padded to 1,180 (19 query tiles,
# the last of 28 rows): four consumers (Dp 32 only) need 5 groups x heads
# >= 264 blocks, three 7 x heads, two 10 x heads; the padded head widths
# 16 and 104 zero-filled by TMA; Dp 128 takes at most two consumers.
K6_BLOCK_CASES = [(96, 8, 4, 64), (96, 32, 8, 128), (96, 48, 16, 192),
                  (16, 48, 48, 192), (16, 64, 16, 256), (32, 64, 64, 256),
                  (64, 48, 24, 192), (104, 48, 12, 128), (128, 32, 32, 128),
                  (128, 8, 8, 64)]
K6_BLOCKS, K6_N_IMG, K6_PAD_TO = (2, 1, 3, 1, 2, 4, 1, 3), 29, 1180


def _k6_block_meta(dev):
    lay = layout.build_layout([layout.RowSpec(K6_BLOCKS, "training")],
                              K6_N_IMG, pad_to=K6_PAD_TO)
    meta = AttnMeta.from_layout(lay, dev)
    assert int(meta.is_pad.sum()) > 0 and lay.length % 64
    return meta


def _k6_block_error(dev, d, h, hkv, qm, km, lq, lk, seed=50):
    """K6 (with its lse) at heads h of width d over the metadata (lq
    queries, lk keys) against the plain version: (worst error / bar of out
    and lse, out, lse, the rows a block covered)."""
    q = _operand(dev, seed, torch.bfloat16, 1, lq, h, d)
    kv = _operand(dev, seed + 1, torch.bfloat16, 1, lk, 2 * hkv, d)
    k, v = kv[:, :, :hkv].contiguous(), kv[:, :, hkv:]
    fa.reset_launch_counts()
    got, lse = fa._inline_forward(q, k, v, qm, km, with_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_mha_inline.launches == 1
    (rows, n), = fa.flash_mha_inline.launches_by_rows.items()
    assert n == 1
    want, want_lse = fa.inline_attention_reference(q.float(), k.float(),
                                                   v.float(), qm, km)
    mass, _ = fa.inline_attention_reference(q.float(), k.float(),
                                            v.float().abs(), qm, km)
    ratio = _err(got, want, mass)
    lse, want_lse = lse.cpu(), want_lse.cpu()
    dead = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), dead)
    # the lse in fp32 from the same products: fp32 summation order alone
    live = ~dead
    bar = 1e-4 + 1e-4 * want_lse[live].abs()
    ratio = max(ratio, float(((lse[live] - want_lse[live]).abs()
                              / bar).max()))
    return ratio, got, lse, rows


@pytest.mark.parametrize("d,h,hkv,rows", K6_BLOCK_CASES)
def test_k6_at_every_block_shape(dev, d, h, hkv, rows):
    """K6 at each block shape the wrapper chooses (64, 128, 192, 256 query
    rows a block) and padded head width, with pad rows, GQA, a last group of
    fewer tiles than the block's consumers, and key tiles that are empty
    for one query tile of a group and partial for another."""
    meta = _k6_block_meta(dev)
    L = meta.index.shape[1]
    tiles = fa.inline_tile_classes(meta, meta).cpu()   # the kernel's map
    groups = fa.inline_groups_reference(tiles, rows // 64)
    if rows > 64:
        c, nq = rows // 64, tiles.shape[1]
        ng = -(-nq // c)
        assert ng * c != nq   # a last group of fewer query tiles
        t = tiles[:, :(ng - 1) * c].view(1, ng - 1, c, tiles.shape[2])
        assert ((t == fa.TILE_EMPTY).any(2)
                & (t == fa.TILE_PARTIAL).any(2)).any()
        assert (groups.shared != groups.tiles).any()
    assert fa.inline_block_rows(1, L, h, d, dev) == rows
    ratio, *_, got_rows = _k6_block_error(dev, d, h, hkv, meta, meta, L, L)
    assert got_rows == rows
    assert ratio <= 1.0


def test_k6_rows_that_see_no_key(dev):
    """Rows that see no key, inside a 192-row block whose other rows do:
    out exactly 0 and lse -inf, the rest as the plain version."""
    meta = _k6_block_meta(dev)
    L = meta.index.shape[1]
    dead = slice(330, 350)   # the second block's third consumer
    index, blk = meta.index.clone(), meta.q_block.clone()
    index[:, dead], blk[:, dead] = -fa.NEVER, -1
    pad = meta.is_pad.clone()
    pad[:, dead] = 0
    qm = meta._replace(index=index, q_block=blk, is_pad=pad)
    ratio, got, lse, rows = _k6_block_error(dev, 96, 48, 16, qm, meta, L, L)
    assert rows == 192 and ratio <= 1.0
    assert not got[:, dead].any()
    assert torch.isinf(lse[:, :, dead]).all() and (lse[:, :, dead] < 0).all()
    assert torch.isfinite(lse[:, :, :dead.start]).all()


def test_k6_at_a_ring_hop_shape(dev):
    """lq != lk as a ring hop runs it: query chunk 1 over key chunk 0 of a
    training row, at 192 rows a block (72 heads of 96, 24 kv heads)."""
    meta = _k6_block_meta(dev)
    L = meta.index.shape[1]
    c = L // 2
    qm, km = meta.cols(slice(c, L)), meta.cols(slice(0, c))
    assert fa.inline_block_rows(1, L - c, 72, 96, dev) == 192
    ratio, *_, rows = _k6_block_error(dev, 96, 72, 24, qm, km, L - c, c)
    assert rows == 192 and ratio <= 1.0


def test_k6_is_deterministic(dev):
    """Two launches on the same inputs give the same bits (no atomics)."""
    meta = _k6_block_meta(dev)
    L = meta.index.shape[1]
    q = _operand(dev, 52, torch.bfloat16, 1, L, 48, 96)
    k = _operand(dev, 53, torch.bfloat16, 1, L, 16, 96)
    v = _operand(dev, 54, torch.bfloat16, 1, L, 16, 96)
    a = fa._inline_forward(q, k, v, meta, meta, with_lse=True)
    b = fa._inline_forward(q, k, v, meta, meta, with_lse=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_k6_block_rows_at_the_path_shapes(dev):
    """The stage-4 training forward (B 1, L 35,520, 32 heads of 96) takes
    192-row blocks; a seq-mesh rank's prefill (8 heads, L 1,776: 28 query
    tiles, 224 blocks of 64 rows) keeps 64 rows. The latter launched too."""
    assert fa.inline_block_rows(1, 35520, 32, 96, dev) == 192
    assert fa.inline_block_rows(1, 1776, 8, 96, dev) == 64
    lay = layout.frame_block_inference_layout(8, 16, 220, use_cfg=False)
    mp = AttnMeta.from_layout(lay, dev).cols(
        slice(0, lay.length - lay.noisy_tail_len()))
    assert mp.index.shape[1] == 1776
    q, k, v = (_bf16(dev, 55 + i, 1, 1776, 8, D) for i in range(3))
    assert _k6_case_error(q, k, v, mp, mp) <= 1.0
    assert fa.flash_mha_inline.launches_by_rows == {64: 1}


def _map_scratch(meta, backward, heads=0, head_dim=0):
    """(the map, the scratch) of K6's (``backward``: K7's) map-only
    launch; with heads and head_dim K6 orders its blocks as a launch of
    that shape would."""
    a, tile_map, scratch = fa._inline_map_args(meta, meta, backward)
    a.map_only, a.heads, a.head_dim = 1, heads, head_dim
    lib = "inline_attention_bwd" if backward else "inline_attention"
    fa._launch(lib, f"vgt_{lib}", a, meta.index.device)
    torch.cuda.synchronize()
    return tile_map.cpu(), scratch.cpu().long()


def _assert_order(counts, order, want_counts):
    assert torch.equal(counts, want_counts)
    assert sorted(order.tolist()) == list(range(len(order)))
    assert (counts[order][:-1] >= counts[order][1:]).all()


@pytest.mark.parametrize("heads", [8, 32, 48])
def test_k6_group_order_matches_plain(dev, heads):
    """K6's blocks of the launch shape: each group's count of loaded key
    tiles and the launch order, most first, against the plain version."""
    meta = _k6_block_meta(dev)
    b, L = meta.index.shape
    tile_map, scratch = _map_scratch(meta, False, heads, 96)
    # the map of the metadata's summaries: the order's input
    assert torch.equal(tile_map, _map_scratch(meta, False)[0])
    group = fa.inline_block_rows(b, L, heads, 96, dev) // 64
    plain = fa.inline_groups_reference(tile_map, group)
    nq, nk = tile_map.shape[1:]
    ng = len(plain.counts)
    base = b * (nq + nk) * 8
    _assert_order(scratch[base:base + ng],
                  scratch[base + b * nq:base + b * nq + ng], plain.counts)


def test_k7_map_and_order_unchanged(dev):
    """K7's map (K6's, from the same summaries) and its two launch
    orders: the query tiles by their count of non-empty key tiles and the
    key tiles by theirs, most first."""
    meta = _k6_block_meta(dev)
    tile_map, scratch = _map_scratch(meta, True)
    assert torch.equal(tile_map, _map_scratch(meta, False)[0])
    b, nq, nk = tile_map.shape
    seen = tile_map != fa.TILE_EMPTY
    base = b * (nq + nk) * 8
    rc, cc = scratch[base:base + b * nq], scratch[base + b * nq:
                                                  base + b * (nq + nk)]
    rows = scratch[base + b * (nq + nk):base + b * (2 * nq + nk)]
    cols = scratch[base + b * (2 * nq + nk):base + 2 * b * (nq + nk)]
    _assert_order(rc, rows, seen.sum(-1).flatten())
    _assert_order(cc, cols, seen.sum(1).flatten())


def _map_cases(dev):
    """(name, query meta, key meta) of the map checks."""
    def training(blocks, n_img, pad=False):
        f = sum(blocks)
        lay = layout.build_layout([layout.RowSpec(blocks, "training")],
                                  n_img,
                                  pad_to=2 * f * (n_img + 2) if pad else None)
        return AttnMeta.from_layout(lay, dev)

    inf = layout.frame_block_inference_layout(3, 2, 30, use_cfg=True)
    mi = AttnMeta.from_layout(inf, dev)
    lay, mb = _rollout_meta(dev, 56, 24, rows=2)
    mb = mb.cols(slice(0, lay.length - lay.noisy_tail_len()))
    return [("training, pad rows", training((2, 1, 2), 30, True), None),
            ("training, unaligned rows", training((2, 1, 1, 1), 17), None),
            ("inference CFG pair", mi, None),
            ("inference tail", mi.tail(inf.noisy_tail_len()), mi),
            ("batched rollout prefill", mb, None)]


def test_tile_maps_match_plain(dev):
    """The maps that K6 and K7 (from the metadata's summaries) and K3/K9
    (from one pass over the bias) build equal their plain versions, the
    dense rule reduced tile by tile; the bias map also with a row that
    sees no key (never an empty tile in its query tile) and with bias rows
    that are not 16-byte aligned (the pass's scalar loads)."""
    for name, qm, km in _map_cases(dev):
        km = qm if km is None else km
        want = fa.inline_tile_classes_reference(qm, km)
        for backward in (False, True):
            got = fa.inline_tile_classes(qm, km, backward=backward)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, backward)
        bias = fa.precompute_bias(qm, km)
        if name.startswith("training"):
            bias[0, 40] = fa.BF16_NEG
        if name == "training, unaligned rows":
            assert bias.stride(1) % 8, bias.shape
        got = fa.bias_tile_classes(bias)
        want = fa.bias_tile_classes_reference(bias)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        if name == "batched rollout prefill":
            assert (want == fa.TILE_EMPTY).any() and (want == fa.TILE_FULL).any()


@pytest.mark.parametrize("h,hkv,blocks,n_img", INLINE_CASES)
def test_k7_matches_plain(dev, h, hkv, blocks, n_img):
    errs = _k7_errors(dev, h, hkv, blocks, n_img)
    assert max(errs.values()) <= 1.0, errs


def test_k7_with_an_empty_key_tile_column(dev):
    """Keys 64..127 visible to no query (vis_start past every index, no
    noisy block, no pad row): the second column of K7's map is empty, its
    dK/dV blocks list no query tile and must store exactly 0; the rest
    agrees with the plain version."""
    q, k, v, meta = _inline_operands(dev, 4, 2, (1, 2, 1), 30)
    assert meta.index.shape[1] > 128 and int(meta.is_pad.sum()) == 0
    vis, blk = meta.vis_start.clone(), meta.noisy_block.clone()
    vis[:, 64:128], blk[:, 64:128] = fa.NEVER, -1
    meta = meta._replace(vis_start=vis, noisy_block=blk)
    tiles = fa.inline_tile_classes(meta, meta, backward=True)
    assert (tiles[:, :, 1] == fa.TILE_EMPTY).all()
    assert (tiles[:, :, 0] != fa.TILE_EMPTY).any()
    errs, (dq, dk, dv) = _k7_case_errors(dev, q, k, v, meta)
    assert max(errs.values()) <= 1.0, errs
    assert not dk[:, 64:128].any() and not dv[:, 64:128].any()
    assert dk[:, :64].any() and dv[:, :64].any()


def test_flash_mha_inline_gradients_reach_q_k_v(dev):
    """Through ``flash_mha_inline`` on CUDA, q, k and v get gradients (K7),
    and they agree with the plain backward."""
    q, k, v, meta = _inline_operands(dev, 4, 2, (1, 2, 1), 30,
                                     requires_grad=True)
    w = _bf16(dev, 22, *q.shape)
    fa.reset_launch_counts()
    out = fa.flash_mha_inline(q, k, v, meta, meta)
    assert out.grad_fn is not None
    (out.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_mha_inline.launches == 1
    assert fa.flash_mha_inline_bwd.launches == 1
    assert fa.flash_mha.launches == 0 and fa.flash_mha_bwd.launches == 0
    args = [x.detach().float() for x in (q, k, v)] + [
        meta, meta, out.detach().float(), w.float()]
    want = fa.inline_attention_backward_reference(*args)
    mass = fa.inline_attention_backward_reference(*args, magnitude=True)
    for name, x, wt, m in zip("qkv", (q, k, v), want, mass):
        assert x.grad is not None, name
        assert float(x.grad.float().abs().max()) > 0, name
        assert _err(x.grad, wt, m) <= 1.0, name


# (source, the text as written, the text with one fault, the kernel whose
# bar must catch it)
MUTATIONS = {
    "k6_without_last_key_tile": (
        "inline_attention.cu",
        "    if (kt < nk)\n",
        "    if (kt < nk - 1)\n", "K6"),
    "k6_second_consumer_rows_unstored": (
        "inline_attention.cu",
        "  bf16* out = static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh;",
        "  if (w == 1) return;\n"
        "  bf16* out = static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh;",
        "K6-c3"),
    "k6_map_one_tile_empty": (
        "tile_map.cuh",
        "    row[kt] = c;",
        "    row[kt] = (qt == 0 && kt == 0) ? kTileEmpty : c;", "K6"),
    "k7_dkdv_without_last_query_tile": (
        "inline_attention_bwd.cu",
        "for (int i = 0; i < pairs; ++i) {",
        "for (int i = 0; i < pairs - 1; ++i) {", "K7"),
    "k7_dq_without_last_key_tile": (
        "inline_attention_bwd.cu",
        "for (int i = 0; i < n; ++i) {",
        "for (int i = 0; i < n - 1; ++i) {", "K7"),
    "k3_without_last_key_tile": (
        "bias_attention.cu",
        "for (int i = 0; i < n; ++i) {",
        "for (int i = 0; i < n - 1; ++i) {", "K3"),
    "k3_without_the_cache_last_key_tile": (
        "bias_attention.cu",
        "    const bf16* bs = kt + 2 * kTile;",
        "    const bf16* bs = kt + 2 * kTile;\n"
        "    if (k0 / kBlockK == (a.lk - a.lq - 1) / kBlockK) {\n"
        "      __syncthreads();\n"
        "      continue;\n"
        "    }", "K3-cache"),
    "k3_partial_tile_reads_no_bias": (
        "bias_attention.cu",
        "const bool partial = (e & 3) == kTilePartial;",
        "const bool partial = false;", "K3"),
    "k9_map_one_tile_empty": (
        "tile_map.cuh",
        "    out[kt] = (any_dead && c == kTileEmpty) ? kTilePartial : c;",
        "    out[kt] = (qt == 0 && kt == 0) ? kTileEmpty\n"
        "              : (any_dead && c == kTileEmpty) ? kTilePartial : c;",
        "K9"),
    "k1_tail_without_last_key_tile": (
        "rank_attention.cu",
        "    while (op < 2 && k0 >= a.len[op]) {",
        "    while (op < 2 && k0 >= a.len[op] - (op == 1 ? kRankTile : 0)) {",
        "K1"),
    "k1_partial_tile_as_full": (
        "rank_attention.cu",
        "    if (cls == kTileFull) {",
        "    if (cls != kTileEmpty) {", "K1"),
    "k1_second_consumer_rows_unstored": (
        "rank_attention.cu",
        "  bf16* out = static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh;",
        "  if (wg == 1) return;\n"
        "  bf16* out = static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh;",
        "K1"),
    "fp32_without_last_key_tile": (
        "fp32_attention.cu",
        "for (int it = 0; it < items; ++it) {",
        "for (int it = 0; it < items - 2; ++it) {", "K6-fp32"),
    "fp32_partial_tile_as_full": (
        "fp32_attention.cu",
        "const bool partial = (list[it >> 1] & 3) == kTilePartial;",
        "const bool partial = false;", "K3-fp32"),
    "padded_head_dims_not_zero_filled": (
        "attention_common.cuh",
        "const bool ok = r < rows_valid && (!kPadded || c < cols);",
        "const bool ok = r < rows_valid;", "K3-d40"),
    "fp32_bwd_without_last_key_tile": (
        "fp32_attention_bwd.cu",
        "for (int it = 0; it < items; ++it) {",
        "for (int it = 0; it < items - SUB; ++it) {", "K9-fp32"),
    "fp32_scores_without_split_corrections": (
        "fp32_attention.cu",
        "      split_product_rs_k<DP>(s, qf, kp);",
        "      for (int kk = 0; kk < DP / 16; ++kk)\n"
        "        wgmma_64x32_rs(s, qf[0][kk], desc_k_major_dp<DP>(kp, kk));",
        "K3-fp32"),
    "fp32_bwd_dq_without_split_corrections": (
        "fp32_attention_bwd.cu",
        "    split_product_rs<DP, R>(gt, fa, kvp);",
        "#pragma unroll\n"
        "    for (int j = 0; j < R; ++j)\n"
        "      wgmma_pv<DP>(gt, fa[0][j], desc_mn_major_dp<DP>(kvp, j));",
        "K9-fp32"),
    "padded_bwd_head_dims_not_zero_filled": (
        "attention_common.cuh",
        "const bool ok = r < rows_valid && (!kPadded || c < cols);",
        "const bool ok = r < rows_valid;", "K9-d40"),
    "k9_dkdv_dp128_wrong_descriptor": (
        "bias_attention_bwd.cu",
        "wgmma_pv<DP>(dv, fa[j], desc_mn_major_dp<DP>(bt, j));",
        "wgmma_pv<DP>(dv, fa[j], desc_mn_major_dp<DP>(bt, j ^ 1));",
        "K9-d128"),
    "k7_dkdv_dp128_wrong_descriptor": (
        "inline_attention_bwd.cu",
        "wgmma_pv<DP>(dv, fa[j], desc_mn_major_dp<DP>(bt, j));",
        "wgmma_pv<DP>(dv, fa[j], desc_mn_major_dp<DP>(bt, j ^ 1));",
        "K7-d128"),
    # the window term dropped from the map that K6 and K7 read: a full tile
    # that reaches past the window is taken as full, its mask skipped
    "k7_map_without_window": (
        "tile_map.cuh",
        "  if (c == kTileFull && static_cast<long long>(qr.hi) - kr.lo >= "
        "window)\n    return kTilePartial;\n",
        "", "K7-window"),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_inline_mutation_fails_the_bar(dev, tmp_path, monkeypatch,
                                       mutation):
    src, text, fault, kernel = MUTATIONS[mutation]
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    source = (csrc / src).read_text()
    assert source.count(text) == 1, mutation
    (csrc / src).write_text(source.replace(text, fault))
    libs = _cuda.build(str(csrc), os.path.join(tmp_path, "_build"))
    monkeypatch.setattr(_cuda, "libraries", lambda: libs)
    case = (4, 2, (1, 2, 1), 30)
    if kernel == "K1":
        # two consumer warpgroups, partial tiles, a tail of 100 keys
        ratio = _k1_error(dev, 1, 129, 70, 100)
    elif kernel == "K6":
        ratio = _k6_error(dev, *case)
    elif kernel == "K6-c3":
        meta = _k6_block_meta(dev)
        L = meta.index.shape[1]
        ratio = _k6_block_error(dev, 96, 48, 16, meta, meta, L, L)[0]
    elif kernel == "K7":
        ratio = max(_k7_errors(dev, *case).values())
    elif kernel == "K3":
        ratio = _k3_error(*_training_operands(dev, *case))
    elif kernel == "K3-cache":
        ratio = _k3_cached_error(dev, ((37, 70),), 100)
    elif kernel == "K3-fp32":
        ratio = _k3_width_error(dev, torch.float32, 96)
    elif kernel == "K3-d40":
        # q, k, v views of 64-wide rows: a copy that reads past head_dim
        # reads their random dims 40..63, in bounds
        ratio = _k3_width_error(dev, torch.bfloat16, 40, sliced=True)
    elif kernel == "K6-fp32":
        ratio = _k6_width_error(dev, torch.float32, 96)
    elif kernel == "K9-fp32":
        ratio = max(_k9_width_errors(dev, torch.float32, 96).values())
    elif kernel == "K9-d40":
        ratio = max(_k9_width_errors(dev, torch.bfloat16, 40,
                                     sliced=True).values())
    elif kernel == "K9-d128":
        ratio = max(_k9_width_errors(dev, torch.bfloat16, 128).values())
    elif kernel == "K7-d128":
        ratio = max(_k7_width_errors(dev, torch.bfloat16, 128).values())
    elif kernel == "K7-window":
        ratio = max(_window_errors(dev, *_window_operands(
            dev, 8, 1, (1, 2, 1, 3), 30, 40))[0].values())
    else:
        ratio = max(_k9_errors(dev, *_training_operands(dev, *case))
                    .values())
    print(f"mutation {mutation}: worst error / bar {ratio:.2f}")
    assert ratio > 1.0


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 8, 2, 96, device=dev, dtype=torch.float16)
    k = torch.zeros(1, 8, 2, 96, device=dev, dtype=torch.float16)
    mask = fa.DecodeMask(torch.zeros(1, 8, dtype=torch.int32, device=dev),
                         torch.zeros(1, 8, dtype=torch.int32, device=dev))
    with pytest.raises(TypeError, match="bf16 or fp32"):       # fp16
        fa.flash_mha_decode(q, k, k, mask)
    qb, kb = q.bfloat16(), k.bfloat16()
    with pytest.raises(TypeError, match="one dtype"):          # mixed
        fa.flash_mha_decode(qb, kb.float(), kb, mask)
    for d in (20, 136):                   # not a multiple of 8; above 128
        qd = torch.zeros(1, 8, 2, d, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_mha_decode(qd, qd, qd, mask)
    with pytest.raises(ValueError):                   # bias on the CPU
        fa.flash_mha(qb, kb, kb, torch.zeros(1, 8, 8, dtype=torch.bfloat16))
    # the backward kernels take what the forward takes: bf16 and fp32 at
    # head_dim 64 too, fp16 not
    bias = fa.precompute_bias(*(AttnMeta.from_layout(
        layout.frame_block_inference_layout(0, 1, 6, use_cfg=False),
        dev),) * 2)
    lse = torch.zeros(1, 2, 8, device=dev)
    fa.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        q64 = torch.zeros(1, 8, 2, 64, device=dev, dtype=dtype)
        grads = fa.flash_mha_bwd(q64, q64, q64, bias, q64, q64, lse)
        assert [g.shape for g in grads] == [q64.shape] * 3
        assert all(g.dtype == dtype for g in grads)
    torch.cuda.synchronize()
    assert fa.flash_mha_bwd.launches == fa.flash_mha_bwd.fp32_launches == 1
    with pytest.raises(TypeError, match="bf16 or fp32"):       # fp16
        fa.flash_mha_bwd(q, k, k, bias, q, q, lse)


# ---- past 8192 keys: the TPU's k-tiled K4/K5/K10 are K1/K2/K3 here --------

# 176x320 frames: 220 image tokens (222 per frame segment)
N_IMG_FLAGSHIP = layout.tokens_per_frame(176, 320)
H_FULL, HKV_FULL = 32, 32


def _rollout_meta(dev, n_clean, n_gen, rows=1):
    lay = layout.frame_block_inference_layout(n_clean, n_gen, N_IMG_FLAGSHIP,
                                              use_cfg=False, rows=rows)
    return lay, AttnMeta.from_layout(lay, dev)


@pytest.mark.parametrize("batch", [1, 2])
def test_k1_at_the_long_rollout_cond_row(dev, batch):
    """K4's shape: 5,328 queries against 12,432 cached + 5,328 new keys,
    the cache heads-major as the KV cache holds it (at B 2 as the batched
    rollout's cond row), the tail views of tokens-major K/V."""
    d = D
    lay, meta = _rollout_meta(dev, 56, 24, rows=batch)
    tail, L = lay.noisy_tail_len(), lay.length
    lc = L - tail
    assert lc + tail > 8192
    mask = decode_mask(meta.tail(tail), meta)
    q = _bf16(dev, 30, batch, tail, H_FULL, d)
    kc = _bf16(dev, 31, batch, HKV_FULL, lc, d)
    vc = _bf16(dev, 32, batch, HKV_FULL, lc, d)
    kv = _bf16(dev, 33, batch, tail, 2, HKV_FULL, d)
    kt, vt = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    fa.reset_launch_counts()
    got = fa.flash_mha_decode_split(q, kc, vc, kt, vt, mask)
    torch.cuda.synchronize()
    assert fa.flash_mha_decode_split.launches == 1
    assert fa.flash_mha_decode_split.long_launches == 1

    def plain(vf):
        return fa.rank_attention_reference(
            q.float(), (kc.float(), kt.float()), (vf(vc.float()),
                                                  vf(vt.float())),
            (mask.rank[:, :lc], mask.rank[:, lc:]), mask.q_off)

    assert _err(got, plain(lambda x: x), plain(torch.abs)) <= 1.0


def test_k2_at_the_k5_shape(dev):
    """K5's shape: the uncond row of a 40-frame clip, Lq = Lk = 8,880."""
    d = D
    lay, meta = _rollout_meta(dev, 0, 40)
    L = lay.length
    assert L > 8192
    mask = decode_mask(meta, meta)
    q = _bf16(dev, 34, 1, L, H_FULL, d)
    k, v = _bf16(dev, 35, 1, L, HKV_FULL, d), _bf16(dev, 36, 1, L, HKV_FULL, d)
    fa.reset_launch_counts()
    got = fa.flash_mha_decode(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.flash_mha_decode.launches == 1
    assert fa.flash_mha_decode.long_launches == 1

    def plain(vf):
        return fa.rank_attention_reference(
            q.float(), (k.float().transpose(1, 2),),
            (vf(v.float()).transpose(1, 2),), (mask.rank,), mask.q_off)

    assert _err(got, plain(lambda x: x), plain(torch.abs)) <= 1.0


def test_k3_at_the_k10_shape(dev):
    """K10's shape: the long rollout's prefill at B 1, 12,432^2 with its
    309 MB bf16 bias."""
    d = D
    lay, meta = _rollout_meta(dev, 56, 24)
    lp = lay.length - lay.noisy_tail_len()
    mp = meta.cols(slice(0, lp))
    bias = fa.precompute_bias(mp, mp)
    q = _bf16(dev, 37, 1, lp, H_FULL, d)
    k = _bf16(dev, 38, 1, lp, HKV_FULL, d)
    v = _bf16(dev, 39, 1, lp, HKV_FULL, d)
    fa.reset_launch_counts()
    got = fa.flash_mha(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.flash_mha.launches == 1
    assert fa.flash_mha.long_launches == 1
    want = fa.bias_attention_reference(q.float(), k.float(), v.float(), bias)
    mass = fa.bias_attention_reference(q.float(), k.float(), v.float().abs(),
                                       bias)
    assert _err(got, want, mass) <= 1.0


def test_k6_at_the_batched_prefill(dev):
    """The batched rollout's prefill: B 2 x 12,432^2 (above the bias
    limit), ``index`` an expanded view with batch stride 0."""
    d = D
    lay, meta = _rollout_meta(dev, 56, 24, rows=2)
    lp = lay.length - lay.noisy_tail_len()
    mp = meta.cols(slice(0, lp))
    assert mp.index.stride(0) == 0
    qkv = _bf16(dev, 40, 2, lp, H_FULL + 2 * HKV_FULL, d)
    q = qkv[:, :, :H_FULL].contiguous()
    k = qkv[:, :, H_FULL:H_FULL + HKV_FULL].contiguous()
    v = qkv[:, :, H_FULL + HKV_FULL:]
    fa.reset_launch_counts()
    with torch.no_grad():
        got = fa.flash_mha_inline(q, k, v, mp, mp)
    torch.cuda.synchronize()
    assert fa.flash_mha_inline.launches == 1
    want, _ = fa.inline_attention_reference(q.float(), k.float(), v.float(),
                                            mp, mp)
    mass, _ = fa.inline_attention_reference(q.float(), k.float(),
                                            v.float().abs(), mp, mp)
    assert _err(got, want, mass) <= 1.0


# ---- P1, the overlap probe --------------------------------------------------

def _probe_error(dev, nsub, lk=overlap_probe.LK):
    """Worst error / bar of the serial body (``nsub`` None) or the
    pipelined one against the plain version, at the probe's BQ and D for
    2 problems over ``lk`` keys."""
    q, k, v = overlap_probe.probe_inputs(2, dev, lk=lk)
    overlap_probe.overlap_serial.launches = 0
    overlap_probe.overlap_pipelined.launches = 0
    got = (overlap_probe.overlap_serial(q, k, v) if nsub is None else
           overlap_probe.overlap_pipelined(q, k, v, nsub))
    torch.cuda.synchronize()
    assert (overlap_probe.overlap_serial.launches
            + overlap_probe.overlap_pipelined.launches) == 1
    want = overlap_probe.overlap_reference(q.float(), k.float(), v.float())
    mass = overlap_probe.overlap_reference(q.float(), k.float(),
                                           v.float().abs())
    return _err(got, want, mass)


@pytest.mark.parametrize("nsub", [None] + list(overlap_probe.NSUBS))
def test_overlap_probe_matches_plain(dev, nsub):
    assert _probe_error(dev, nsub) <= 1.0


def test_overlap_probe_raises_on_what_it_does_not_take(dev):
    """The wrappers refuse, before any launch: an nsub outside NSUBS, a
    dtype other than bf16, LK not a multiple of 256, and an operand that
    does not start on a 16-byte boundary (TMA reads it)."""
    q, k, v = overlap_probe.probe_inputs(1, dev, lk=256)
    overlap_probe.overlap_serial.launches = 0
    overlap_probe.overlap_pipelined.launches = 0
    with pytest.raises(ValueError, match="nsub"):
        overlap_probe.overlap_pipelined(q, k, v, 3)
    with pytest.raises(ValueError, match="contiguous bf16"):
        overlap_probe.overlap_serial(q.half(), k, v)
    with pytest.raises(ValueError, match="LK a multiple of 256"):
        overlap_probe.overlap_serial(q, k[:, :192].contiguous(),
                                     v[:, :192].contiguous())
    shifted = torch.empty(q.numel() + 1, device=dev,
                          dtype=torch.bfloat16)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte boundary"):
        overlap_probe.overlap_pipelined(shifted, k, v, 4)
    assert (overlap_probe.overlap_serial.launches
            + overlap_probe.overlap_pipelined.launches) == 0


def _probe_mutant_error(dev, tmp_path, monkeypatch, line, mutant, nsub):
    """Worst error / bar over 512 keys of the probe built from a copy of
    ``csrc/`` whose ``overlap_probe.cu`` has ``line`` (found once) replaced
    by ``mutant``."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    text = (csrc / "overlap_probe.cu").read_text()
    assert text.count(line) == 1
    (csrc / "overlap_probe.cu").write_text(text.replace(line, mutant))
    libs = _cuda.build(str(csrc), os.path.join(tmp_path, "_build"))
    monkeypatch.setattr(_cuda, "libraries", lambda: libs)
    return _probe_error(dev, nsub, lk=512)


def test_overlap_probe_mutation_fails_the_bar(dev, tmp_path, monkeypatch):
    """The pipelined body without its last subtile (its probabilities
    zeroed, its keys out of the row sums) fails the bar: over 512 keys at
    nsub 2 it drops 128 of them."""
    ratio = _probe_mutant_error(
        dev, tmp_path, monkeypatch,
        "  exp2_pass<W>(sb, l0, l1);  // the last subtile's exp2 pass",
        "  for (int e = 0; e < W / 2; ++e) sb[e] = 0.f;", 2)
    print(f"mutation overlap_pipelined_without_last_subtile: worst error / "
          f"bar {ratio:.2f}")
    assert ratio > 1.0


def test_overlap_probe_serial_mutation_fails_the_bar(dev, tmp_path,
                                                     monkeypatch):
    """The serial body without its last tile (its probabilities zeroed, its
    keys out of the row sums) fails the bar: over 512 keys it drops 64 of
    them."""
    ratio = _probe_mutant_error(
        dev, tmp_path, monkeypatch,
        "    exp2_pass<W>(s, l0, l1);  // the serial body's exp2 pass",
        "    if (i + 1 < n) exp2_pass<W>(s, l0, l1);\n"
        "    else for (int e = 0; e < W / 2; ++e) s[e] = 0.f;", None)
    print(f"mutation overlap_serial_without_last_tile: worst error / bar "
          f"{ratio:.2f}")
    assert ratio > 1.0


def test_ulysses_attend_cached_on_two_gloo_ranks(dev, tmp_path):
    """Two gloo ranks sharing the card, (seq 2): ``ulysses_attend_cached``
    (each rank's K1 over its half of the heads, on its cache slice and the
    gathered tail, whose 7 tokens the seq axis pads to 8) against the
    single-rank K1 over every head (``attend_cached``). Both are bf16
    kernel outputs of the same per-head work: bar per element 1e-4 +
    1e-2 |want|, the output's bf16 rounding."""
    import numpy as np
    import torch_mesh_ranks as ranks
    from video_gpt_tpu_torch.config import MeshConfig
    from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
    shape = (2, 1, 5, 2)  # 7-token frames: the cond row 21, the tail 7
    h, hkv, d = 8, 4, D
    meta, _, tail = ranks.metas(*shape, device=dev)
    b, length = meta.index.shape
    rng = np.random.default_rng(0)
    arrays = {n: torch.from_numpy(rng.standard_normal(
        (b, length, heads, d), np.float32)).to(torch.bfloat16).float().numpy()
        for n, heads in (("q", h), ("k", hkv), ("v", hkv))}
    res = spawn_ranks(ranks.attention_cases,
                      (MeshConfig(seq=2), arrays, shape, "cuda"), 2,
                      str(tmp_path), timeout=300)
    got = torch.cat([r["cached_decode_mask"] for r in res], dim=1)[:, :tail]
    lc = length - tail
    q, k, v = (torch.from_numpy(arrays[n]).to(dev, torch.bfloat16)
               for n in "qkv")
    q_meta = meta.tail(tail)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    fa.reset_launch_counts()
    want = attend_cached(q[:, lc:].contiguous(), kh[:, :, :lc].contiguous(),
                         vh[:, :, :lc].contiguous(),
                         kh[:, :, lc:].contiguous(),
                         vh[:, :, lc:].contiguous(), q_meta, meta,
                         decode_mask(q_meta, meta)).float().cpu()
    assert fa.flash_mha_decode_split.launches == 1
    err = (got.float() - want).abs()
    ratio = float((err / (ATOL + RTOL * want.abs())).max())
    print(f"ulysses_attend_cached on 2 gloo ranks vs one rank: max abs err "
          f"{float(err.max()):.3e}, worst error / bar {ratio:.3f}")
    assert ratio <= 1.0


def test_autograd_collectives_on_cuda_operands_of_two_gloo_ranks(dev,
                                                                 tmp_path):
    """The autograd collectives (``own_chunk`` / ``all_gather``,
    ``copy_to`` / ``reduce_from``, ``all_to_all``) and ZeRO's
    ``reduce_scatter`` on CUDA operands between two gloo ranks sharing the
    card (gloo copies them through host memory), forward and gradient
    against the one-rank function at fp32 rounding (atol 1e-5)."""
    import torch_mesh_ranks as ranks
    from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
    for errs in spawn_ranks(ranks.collective_grads, ("cuda",), 2,
                            str(tmp_path), timeout=300):
        assert errs.pop("backward_bytes") > 0
        print(f"autograd collectives on CUDA operands: {errs}")
        assert max(errs.values()) <= 1e-5, errs


# ---- every dtype and head width of the forward kernels ---------------------

# the fp32 kernel against the plain version in fp32, per element: the
# tier-1 plain-versus-Pallas bar at fp32 (sums in other orders; no
# rounding to bf16)
FP32_ATOL = FP32_RTOL = 2e-5
# head widths whose padded widths are 32, 64, 64, 96, 128, 128: zero-filled
# head dims (16, 40, 104) and exact ones, at both dtypes
WIDTH_CASES = [(dtype, d) for dtype in (torch.bfloat16, torch.float32)
               for d in (16, 40, 64, 96, 104, 128)]


def _operand(dev, seed, dtype, *shape):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _width_err(got, plain, dtype):
    """The worst element's error over its bar: the bf16 bar (``_err``) for
    bf16 operands, the fp32 bar for fp32 ones; ``plain(vf)`` is the plain
    version with ``vf`` applied to V."""
    if dtype == torch.bfloat16:
        return _err(got, plain(lambda x: x), plain(torch.abs))
    got, want = (x.float().cpu() for x in (got, plain(lambda x: x)))
    bar = FP32_ATOL + FP32_RTOL * want.abs()
    return float(torch.nan_to_num((got - want).abs() / bar,
                                  nan=float("inf")).max())


def _launches(fn, dtype):
    return fn.launches if dtype == torch.bfloat16 else fn.fp32_launches


@pytest.mark.parametrize("dtype,d", WIDTH_CASES)
def test_k1_at_every_width(dev, dtype, d):
    """K1 (bf16: rank_attention.cu; fp32: fp32_attention.cu) at B 2, 129
    rows over 200 cached (a key tile that no query sees) + 77 new keys,
    into an output filled with NaN: a row left unstored, or a padded head
    dim stored over the next head's, fails the bar."""
    b, lq, lc, lt, h, hkv = 2, 129, 200, 77, 4, 2
    q = _operand(dev, 30, dtype, b, lq, h, d)
    kc, vc = _operand(dev, 31, dtype, b, hkv, lc, d), _operand(
        dev, 32, dtype, b, hkv, lc, d)
    kv = _operand(dev, 33, dtype, b, lt, 2, hkv, d)
    kt, vt = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    mask = _rank_mask(dev, 34, b, lq, lc + lt, never_tile=1)
    fill = q.new_full((b, lq, h, d), float("nan"))
    launch = fa._launch_rank
    fa.reset_launch_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "_launch_rank",
                   lambda *args: launch(*args, out=fill))
        got = fa.flash_mha_decode_split(q, kc, vc, kt, vt, mask)
    assert got is fill
    assert _launches(fa.flash_mha_decode_split, dtype) == 1
    assert fa.flash_mha_decode_split.launches \
        + fa.flash_mha_decode_split.fp32_launches == 1

    def plain(vf):
        return fa.rank_attention_reference(
            q.float(), (kc.float(), kt.float()), (vf(vc.float()),
                                                  vf(vt.float())),
            (mask.rank[:, :lc], mask.rank[:, lc:]), mask.q_off)

    assert _width_err(got, plain, dtype) <= 1.0


@pytest.mark.parametrize("dtype,d", WIDTH_CASES)
def test_k2_at_every_width(dev, dtype, d):
    """K2 over one tokens-major operand (B 2, 127 rows, 200 keys, the
    second key tile seen by no query); 600 rows on a causal mask at D
    128, where a bf16 block has two consumer warpgroups, not three."""
    for b, lq, lk, causal in ((2, 127, 200, False), (1, 600, 600, True)):
        q = _operand(dev, 35, dtype, b, lq, 4, d)
        k, v = _operand(dev, 36, dtype, b, lk, 2, d), _operand(
            dev, 37, dtype, b, lk, 2, d)
        if causal:
            mask = fa.DecodeMask(
                torch.arange(lk, dtype=torch.int32, device=dev)[None],
                torch.arange(lq, dtype=torch.int32, device=dev)[None])
        else:
            mask = _rank_mask(dev, 38, b, lq, lk, never_tile=1)
        fa.reset_launch_counts()
        got = fa.flash_mha_decode(q, k, v, mask)
        assert _launches(fa.flash_mha_decode, dtype) == 1

        def plain(vf):
            return fa.rank_attention_reference(
                q.float(), (k.float().transpose(1, 2),),
                (vf(v.float()).transpose(1, 2),), (mask.rank,), mask.q_off)

        assert _width_err(got, plain, dtype) <= 1.0, (b, lq, lk)


def _k3_width_error(dev, dtype, d, sliced=False):
    """K3 with the bf16 bias of a CFG layout (B 2), GQA, v a view of the
    fused projection (``sliced``: q, k, v the first d dims of 64-wide
    rows) against the plain version: the worst error / bar of the output
    and, at fp32, of its logsumexp against the plain softmax's."""
    h, hkv = 4, 2
    lay = layout.frame_block_inference_layout(3, 2, 30, use_cfg=True)
    meta = AttnMeta.from_layout(lay, dev)
    b, L = lay.batch, lay.length
    bias = fa.precompute_bias(meta, meta)
    qkv = _operand(dev, 39, dtype, b, L, h + 2 * hkv, 64 if sliced else d)
    q, k = qkv[:, :, :h], qkv[:, :, h:h + hkv]
    if sliced:
        q, k = q[..., :d], k[..., :d]
    else:
        q, k = q.contiguous(), k.contiguous()
    v = qkv[:, :, h + hkv:, :d]
    fa.reset_launch_counts()
    got, lse = fa._bias_forward(q, k, v, fa.bias_map(bias), with_lse=True)
    assert _launches(fa.flash_mha, dtype) == 1

    def plain(vf):
        return fa.bias_attention_reference(q.float(), k.float(),
                                           vf(v.float()), bias)

    ratio = _width_err(got, plain, dtype)
    if dtype == torch.float32:
        kf = k.float().repeat_interleave(h // hkv, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * d ** -0.5 \
            + bias.float()[:, None]
        want = torch.logsumexp(logits, -1)
        ratio = max(ratio, _width_err(lse, lambda vf: want, dtype))
    return ratio


@pytest.mark.parametrize("dtype,d", WIDTH_CASES)
def test_k3_at_every_width(dev, dtype, d):
    """K3 (bf16: bias_attention.cu; fp32: fp32_attention.cu) over the bias
    and its map, with its logsumexp at fp32; at head_dim 40 also on q, k
    and v that are the first 40 dims of 64-wide rows (strided views)."""
    assert _k3_width_error(dev, dtype, d) <= 1.0
    if d == 40:
        assert _k3_width_error(dev, dtype, d, sliced=True) <= 1.0


def _k6_width_error(dev, dtype, d):
    """K6 over a training layout with pad rows and GQA (the map built in
    the launch), and over the small batched prefill (``index`` with batch
    stride 0), against the plain version: the worst error / bar of the
    output and, at fp32, of its logsumexp."""
    ratio = 0.0
    blocks, n_img = (2, 1, 2), 30
    f = sum(blocks)
    lay = layout.build_layout([layout.RowSpec(blocks, "training")], n_img,
                              pad_to=2 * f * (n_img + 2))
    lay_b = layout.frame_block_inference_layout(6, 2, 30, use_cfg=False,
                                                rows=2)
    mp = AttnMeta.from_layout(lay_b, dev).cols(
        slice(0, lay_b.length - lay_b.noisy_tail_len()))
    for meta in (AttnMeta.from_layout(lay, dev), mp):
        b, L = meta.index.shape
        qkv = _operand(dev, 40, dtype, b, L, 8, d)
        q, k, v = qkv[:, :, :4].contiguous(), qkv[:, :, 4:6].contiguous(), \
            qkv[:, :, 6:]
        fa.reset_launch_counts()
        got, lse = fa._inline_forward(q, k, v, meta, meta, with_lse=True)
        assert _launches(fa.flash_mha_inline, dtype) == 1

        def plain(vf):
            return fa.inline_attention_reference(q.float(), k.float(),
                                                 vf(v.float()), meta,
                                                 meta)[0]

        ratio = max(ratio, _width_err(got, plain, dtype))
        if dtype == torch.float32:
            want = fa.inline_attention_reference(q, k, v, meta, meta)[1]
            ratio = max(ratio, _width_err(lse, lambda vf: want, dtype))
    return ratio


@pytest.mark.parametrize("dtype,d", WIDTH_CASES)
def test_k6_at_every_width(dev, dtype, d):
    """K6 (bf16: inline_attention.cu; fp32: fp32_attention.cu) with its
    logsumexp at fp32."""
    assert _k6_width_error(dev, dtype, d) <= 1.0


# ---- the backward kernels at every dtype and head width --------------------

# the fp32 backward against its plain version in fp32, per element:
# |got - want| <= FP32_ATOL + FP32_RTOL |want| + FP32_BWD_MASS * mass, with
# the bf16 bar's masses (|ds| |K|, |ds|^T |Q|, p^T |dO|). Nothing is
# rounded to bf16, but ds = p (dp - di) cancels where dp is near di: an
# element of dq, dk, dv then carries the fp32 summation error of its terms
# (their mass, not its value), and p carries that of the forward's lse
# (~1e-6 relative at these logits). 2^-18 is 64 fp32 ulps of the mass.
FP32_BWD_MASS = 2.0 ** -18


def _bwd_width_err(got, want, mass, dtype):
    """The worst element's error over its bar: the bf16 bar for bf16
    gradients, the fp32 backward's (``FP32_BWD_MASS``) for fp32 ones."""
    if dtype == torch.bfloat16:
        return _err(got, want, mass)
    got, want, mass = (x.float().cpu() for x in (got, want, mass))
    bar = FP32_ATOL + FP32_RTOL * want.abs() + FP32_BWD_MASS * mass
    return float(torch.nan_to_num((got - want).abs() / bar,
                                  nan=float("inf")).max())


def _bwd_errors(got, want, mass, dtype):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
    return {name: _bwd_width_err(g, w, m, dtype)
            for name, g, w, m in zip(("dq", "dk", "dv"), got, want, mass)}


def _k9_width_errors(dev, dtype, d, sliced=False):
    """K3 forward (keeping the lse) and K9 (bf16: bias_attention_bwd.cu;
    fp32: fp32_attention_bwd.cu) over a training layout's bias with one
    row that sees no key, GQA 4:2, v a view of the fused projection
    (``sliced``: q, k, v the first d dims of 64-wide rows), against the
    plain backward: {grad: worst error / bar}."""
    h, hkv = 4, 2
    lay = _training_layout((1, 2, 1), 30)
    meta = AttnMeta.from_layout(lay, dev)
    b, L = lay.batch, lay.length
    bias = fa.precompute_bias(meta, meta)
    bias[:, 70] = fa.BF16_NEG
    qkv = _operand(dev, 43, dtype, b, L, h + 2 * hkv, 64 if sliced else d)
    q, k = qkv[:, :, :h], qkv[:, :, h:h + hkv]
    if sliced:
        q, k = q[..., :d], k[..., :d]
    else:
        q, k = q.contiguous(), k.contiguous()
    v = qkv[:, :, h + hkv:, :d]
    fa.reset_launch_counts()
    bm = fa.bias_map(bias)
    out, lse = fa._bias_forward(q, k, v, bm, with_lse=True)
    do = _operand(dev, 44, dtype, *out.shape)
    got = fa.flash_mha_bwd(q, k, v, bm, out, do, lse)
    torch.cuda.synchronize()
    assert _launches(fa.flash_mha_bwd, dtype) == 1
    assert fa.flash_mha_bwd.launches + fa.flash_mha_bwd.fp32_launches == 1
    args = [x.float() for x in (q, k, v)] + [bias, out.float(), do.float()]
    want = fa.bias_attention_backward_reference(*args)
    mass = fa.bias_attention_backward_reference(*args, magnitude=True)
    return _bwd_errors(got, want, mass, dtype)


@pytest.mark.parametrize("dtype,d", WIDTH_CASES)
def test_k9_at_every_width(dev, dtype, d):
    """K9 at bf16 (padded widths 32 / 64 / 96 / 128: two warpgroups in its
    dK/dV kernel at 128) and fp32; at head_dim 40 also on 40-wide views
    of 64-wide rows."""
    errs = _k9_width_errors(dev, dtype, d)
    assert max(errs.values()) <= 1.0, errs
    if d == 40:
        errs = _k9_width_errors(dev, dtype, d, sliced=True)
        assert max(errs.values()) <= 1.0, errs


def _k7_width_errors(dev, dtype, d):
    """K6 forward (keeping the lse) and K7 (bf16: inline_attention_bwd.cu;
    fp32: fp32_attention_bwd.cu) over a training layout with pad rows and
    over the small batched prefill (``index`` with batch stride 0), GQA
    4:2, against the plain backward; then K7 on the two chunks of the
    first layout's keys, each from the global lse of the whole row (a
    ring's chunks): {grad: worst error / bar}."""
    errs = {}
    blocks, n_img = (2, 1, 2), 30
    f = sum(blocks)
    lay = layout.build_layout([layout.RowSpec(blocks, "training")], n_img,
                              pad_to=2 * f * (n_img + 2))
    lay_b = layout.frame_block_inference_layout(6, 2, 30, use_cfg=False,
                                                rows=2)
    mp = AttnMeta.from_layout(lay_b, dev).cols(
        slice(0, lay_b.length - lay_b.noisy_tail_len()))
    for case, meta in enumerate((AttnMeta.from_layout(lay, dev), mp)):
        b, L = meta.index.shape
        qkv = _operand(dev, 45 + case, dtype, b, L, 8, d)
        q, k, v = qkv[:, :, :4].contiguous(), qkv[:, :, 4:6].contiguous(), \
            qkv[:, :, 6:]
        fa.reset_launch_counts()
        out, lse = fa._inline_forward(q, k, v, meta, meta, with_lse=True)
        do = _operand(dev, 47 + case, dtype, *out.shape)
        chunks = [(slice(None), lse)]
        if case == 0:  # two key chunks from the row's global lse
            chunks += [(slice(0, L // 2), lse), (slice(L // 2, L), lse)]
        for cols, lse_c in chunks:
            km = meta.cols(cols)
            kc, vc = k[:, cols], v[:, cols]
            fa.reset_launch_counts()
            got = fa.flash_mha_inline_bwd(q, kc, vc, meta, km, out, do,
                                          lse_c)
            torch.cuda.synchronize()
            assert _launches(fa.flash_mha_inline_bwd, dtype) == 1
            args = [x.float() for x in (q, kc, vc)] + [meta, km, out.float(),
                                                       do.float()]
            want = fa.inline_attention_backward_reference(*args, lse=lse_c)
            mass = fa.inline_attention_backward_reference(
                *args, magnitude=True, lse=lse_c)
            for name, e in _bwd_errors(got, want, mass, dtype).items():
                errs[name] = max(errs.get(name, 0.0), e)
    return errs


@pytest.mark.parametrize("dtype,d", WIDTH_CASES)
def test_k7_at_every_width(dev, dtype, d):
    """K7 at bf16 (padded widths 32 / 64 / 96 / 128: two warpgroups in its
    dK/dV kernel at 128) and fp32, over its own lse and a ring chunk's
    global one."""
    errs = _k7_width_errors(dev, dtype, d)
    assert max(errs.values()) <= 1.0, errs


# ---- the sliding window (the AFMoE trunk's sliding layers) ------------------

def _window_operands(dev, h, hkv, blocks, n_img, window, d=128, seed=27):
    """q/k/v at head width ``d`` over a training layout, its metadata and a
    window of ``window`` positions over its ``pos_ids``."""
    lay = _training_layout(blocks, n_img)
    meta = AttnMeta.from_layout(lay, dev)
    pos = torch.as_tensor(lay.pos_ids, dtype=torch.int32, device=dev)
    qkv = _bf16(dev, seed, lay.batch, lay.length, h + 2 * hkv, d)
    q, k = qkv[:, :, :h].contiguous(), qkv[:, :, h:h + hkv].contiguous()
    return q, k, qkv[:, :, h + hkv:], meta, Window(window, pos, pos)


def _window_errors(dev, q, k, v, meta, win):
    """Windowed K6 (with its lse) and K7 against the plain versions under
    the same window: ({output: worst error / bar}, the two tile maps)."""
    fa.reset_launch_counts()
    out, lse = fa._inline_forward(q, k, v, meta, meta, with_lse=True,
                                  window=win)
    qf, kf, vf = (x.float() for x in (q, k, v))
    want, want_lse = fa.inline_attention_reference(qf, kf, vf, meta, meta,
                                                   win)
    mass, _ = fa.inline_attention_reference(qf, kf, vf.abs(), meta, meta,
                                            win)
    do = _bf16(dev, 28, *out.shape)
    got = fa.flash_mha_inline_bwd(q, k, v, meta, meta, out, do, lse,
                                  window=win)
    args = [qf, kf, vf, meta, meta, out.float(), do.float()]
    want_b = fa.inline_attention_backward_reference(*args, window=win)
    mass_b = fa.inline_attention_backward_reference(*args, magnitude=True,
                                                    window=win)
    torch.cuda.synchronize()
    assert fa.flash_mha_inline.window_launches == 1
    assert fa.flash_mha_inline_bwd.window_launches == 1
    lse_bar = 1e-2 + 1e-3 * want_lse.abs()
    errs = {"out": _err(out, want, mass),
            "lse": float(torch.nan_to_num((lse - want_lse).abs() / lse_bar,
                                          nan=float("inf")).max())}
    errs.update({name: _err(g, w, m) for name, g, w, m in zip(
        ("dq", "dk", "dv"), got, want_b, mass_b)})
    return errs, out


@pytest.mark.parametrize("h,hkv,blocks,n_img,window", [
    (8, 1, (1, 2, 1, 3), 30, 40), (4, 2, ((1, 2, 1), (2, 2)), 30, 40),
    (32, 4, (1, 3, 1, 1, 2), 30, 70)])
def test_windowed_k6_k7_match_plain(dev, h, hkv, blocks, n_img, window):
    errs, _ = _window_errors(dev, *_window_operands(dev, h, hkv, blocks,
                                                    n_img, window))
    assert max(errs.values()) <= 1.0, errs


def test_windowed_tile_map_is_conservative(dev):
    """The window's map: empty only where the plain classes are, full only
    where they are, and fewer tiles than without the window."""
    _, _, _, meta, win = _window_operands(dev, 8, 1, (1, 2, 1, 3, 2), 60, 60)
    want = fa.inline_tile_classes_reference(meta, meta, window=win)
    for backward in (False, True):
        got = fa.inline_tile_classes(meta, meta, backward, window=win)
        assert bool((want[got == fa.TILE_EMPTY] == fa.TILE_EMPTY).all())
        assert bool((want[got == fa.TILE_FULL] == fa.TILE_FULL).all())
        unwindowed = fa.inline_tile_classes(meta, meta, backward)
        assert int((got != fa.TILE_EMPTY).sum()) < int(
            (unwindowed != fa.TILE_EMPTY).sum())


def _stage4_layout():
    """The cells' stage-4 row: 80 frames of 220 patches, padded as the
    collate pads it (2 x 80 x 222 = 35,520)."""
    return layout.build_layout([layout.RowSpec(tuple(STAGE4_BLOCKS),
                                               "training")], 220,
                               pad_to=2 * 80 * 222)


# the frame blocks of the stage-4 cells (bench_port/workloads)
STAGE4_BLOCKS = (1, 3, 1, 1, 1, 3, 3, 1, 2, 1, 1, 2, 1, 1, 1, 3, 2, 1, 2, 2,
                 1, 1, 1, 1, 2, 1, 1, 3, 2, 1, 2, 1, 2, 2, 1, 1, 2, 1, 3, 1,
                 2, 1, 2, 2, 1, 1, 1, 1, 3, 1, 2)


def test_windowed_k6_k7_at_the_trinity_stage4_shape(dev):
    """B 1, L 35,520, 32 heads of 128 over 4 KV heads, a window of 2048
    positions: the sliding layers of ``videogpt-trinitymini.train_stage4``."""
    lay = _stage4_layout()
    assert lay.length == 35520
    meta = AttnMeta.from_layout(lay, dev)
    pos = torch.as_tensor(lay.pos_ids, dtype=torch.int32, device=dev)
    qkv = _bf16(dev, 29, 1, lay.length, 40, 128)
    q, k = qkv[:, :, :32].contiguous(), qkv[:, :, 32:36].contiguous()
    errs, _ = _window_errors(dev, q, k, qkv[:, :, 36:], meta,
                             Window(2048, pos, pos))
    print(f"windowed K6/K7 at stage 4: worst error / bar {errs}")
    assert max(errs.values()) <= 1.0, errs


def test_grouped_experts_match_the_loop_at_a_cell_layer(dev):
    """The routed part of one expert layer of the stage-4 cell (35,076
    tokens, top 8 of 128 experts of width 1024 over hidden 2048) in bf16
    on ``torch._grouped_mm`` against the plain loop over the experts in
    fp32: the output and every gradient within 2% of their norm."""
    from video_gpt_tpu_torch.models.afmoe import RoutedExperts
    t, k, e, hid, inter = 35076, 8, 128, 2048, 1024
    g = torch.Generator(dev).manual_seed(31)
    m = torch.randn(t, hid, generator=g, device=dev)
    w = torch.rand(t, k, generator=g, device=dev)
    idx = torch.argsort(torch.rand(t, e, generator=g, device=dev),
                        dim=-1)[:, :k]
    wg = torch.randn(e, 2 * inter, hid, generator=g, device=dev) * 0.02
    wd = torch.randn(e, hid, inter, generator=g, device=dev) * 0.02
    r = torch.randn(t, hid, generator=g, device=dev)
    outs = []
    for dt in (torch.bfloat16, torch.float32):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (m.to(dt), w, wg, wd)]
        counts = torch.zeros(e, dtype=torch.int64, device=dev)
        out = RoutedExperts.apply(leaves[0], leaves[1], idx, leaves[2],
                                  leaves[3], counts)
        grads = torch.autograd.grad((out.float() * r).sum(), leaves)
        outs.append([out.float()] + [x.float() for x in grads])
    assert int(counts.sum()) == t * k
    for name, got, want in zip(("out", "dm", "dw", "dwg", "dwd"), *outs):
        rel = float((got - want).norm().detach() / want.norm())
        print(f"grouped experts {name}: relative error {rel:.2e}")
        assert rel < 2e-2, name
