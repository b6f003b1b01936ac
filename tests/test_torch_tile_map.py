"""The tile maps of K6 and K9 (``csrc/tile_map.cuh``): their plain versions
``inline_tile_classes_reference`` and ``bias_tile_classes_reference``
against the JAX package's ``visibility`` reduced tile by tile in numpy.

A map gives each (query tile, key tile) pair a class: empty (no real pair
visible: the kernel never loads the key tile), full (inside [0, Lq) x
[0, Lk) and every pair visible: the kernel skips the mask) or partial. The
layouts: frame-block training rows as ``collate`` pads them (stage 1's
blocks of one frame, a stage-4 ``random_block_partition`` draw), the CFG
inference pair (its uncond row starts with pad rows, which see every key),
its noisy tail against the whole row, and a batched prefill whose
``index`` has batch stride 0; tiles from 8 to 64. Classes are integers:
the bar is equality.

The kernels do not reduce the dense visibility: K6 classifies from per-tile
summaries of the metadata, K9 from one pass over the bias.
``_summary_classes`` mirrors K6's rule (``classify_meta``) in numpy; it
must equal the exact reduction on the collate layouts, at the kernels'
64 x 64 tiles and the stage-1 width of 176x320 frames. The card holds the
kernels' own maps to the plain versions (``chip_smoke.py``,
``tests/test_torch_kernels_gpu.py``).
"""
import random

import numpy as np
import pytest
import torch

from video_gpt_tpu import layout as jlayout
from video_gpt_tpu.ops.attention import AttnMeta as JMeta
from video_gpt_tpu.ops.attention import visibility as jvisibility
from video_gpt_tpu_torch import layout as tlayout
from video_gpt_tpu_torch.data.video import random_block_partition
from video_gpt_tpu_torch.ops import flash_attention as fa
from video_gpt_tpu_torch.ops.attention import AttnMeta

N_IMG = tlayout.tokens_per_frame(64, 96)   # 24 image tokens per frame
LAYOUTS = ("stage1", "stage4", "inference", "inference_tail", "prefill_b2")
TILES = [(64, 64), (16, 32), (8, 8)]


def _training(lib, blocks, n_img):
    f = sum(blocks)
    return lib.build_layout([lib.RowSpec(tuple(blocks), "training")], n_img,
                            pad_to=2 * f * (n_img + 2))


def _layouts(name, n_img=N_IMG):
    """(JAX layout, port layout, query rows, key columns)."""
    if name in ("stage1", "stage4"):
        blocks = ((1,) * 6 if name == "stage1" else
                  random_block_partition(20, random.Random(0)))
        return (_training(jlayout, blocks, n_img),
                _training(tlayout, blocks, n_img), slice(None), slice(None))
    if name == "prefill_b2":
        args = (6, 2, n_img)
        jl = jlayout.frame_block_inference_layout(*args, use_cfg=False,
                                                  rows=2)
        tl = tlayout.frame_block_inference_layout(*args, use_cfg=False,
                                                  rows=2)
        prefix = slice(0, tl.length - tl.noisy_tail_len())
        return jl, tl, prefix, prefix
    args = (4, 3, n_img)
    jl = jlayout.frame_block_inference_layout(*args, use_cfg=True)
    tl = tlayout.frame_block_inference_layout(*args, use_cfg=True)
    rows = (slice(-tl.noisy_tail_len(), None) if name == "inference_tail"
            else slice(None))
    return jl, tl, rows, slice(None)


def _metas(name):
    """(port query meta, port key meta, JAX visibility [B, Lq, Lk] bool)."""
    jl, tl, rows, cols = _layouts(name)
    jm, tm = JMeta.from_layout(jl), AttnMeta.from_layout(tl, "cpu")
    vis = np.asarray(jvisibility(JMeta(*(x[:, rows] for x in jm)),
                                 JMeta(*(x[:, cols] for x in jm))))
    return tm.cols(rows), tm.cols(cols), vis


def _exact(vis, tq, tk, dead_rows=None):
    """Classes of the dense visibility [B, Lq, Lk], tile by tile; a query
    tile holding a row of ``dead_rows`` ([B, Lq] bool) is never empty."""
    b, lq, lk = vis.shape
    nq, nk = -(-lq // tq), -(-lk // tk)
    pad = np.zeros((b, nq * tq, nk * tk), bool)
    pad[:, :lq, :lk] = vis
    t = pad.reshape(b, nq, tq, nk, tk)
    some, every = t.any((2, 4)), t.all((2, 4))
    if dead_rows is not None:
        d = np.zeros((b, nq * tq), bool)
        d[:, :lq] = dead_rows
        some |= d.reshape(b, nq, tq).any(2)[:, :, None]
    return np.where(every, fa.TILE_FULL,
                    np.where(some, fa.TILE_PARTIAL, fa.TILE_EMPTY))


def _check_sound(classes, vis, tq, tk):
    """No empty tile holds a visible pair; no full tile holds a masked one
    (or lies past Lq or Lk)."""
    b, lq, lk = vis.shape
    for bi, i, j in zip(*np.nonzero(classes != fa.TILE_PARTIAL)):
        tile = vis[bi, i * tq:(i + 1) * tq, j * tk:(j + 1) * tk]
        if classes[bi, i, j] == fa.TILE_EMPTY:
            assert not tile.any(), (bi, i, j)
        else:
            assert tile.shape == (tq, tk) and tile.all(), (bi, i, j)


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("name", LAYOUTS)
def test_inline_classes_match_the_jax_visibility(name, tiles):
    qm, km, vis = _metas(name)
    got = fa.inline_tile_classes_reference(qm, km, *tiles).numpy()
    _check_sound(got, vis, *tiles)
    np.testing.assert_array_equal(got, _exact(vis, *tiles))
    # every class occurs somewhere, or the case proves little
    if tiles == (8, 8):
        assert set(np.unique(got)) == {0, 1, 2}, name


@pytest.mark.parametrize("tiles", TILES[:2])
@pytest.mark.parametrize("name", LAYOUTS)
def test_bias_classes_match_the_jax_visibility(name, tiles):
    qm, km, vis = _metas(name)
    got = fa.bias_tile_classes_reference(fa.precompute_bias(qm, km),
                                         *tiles).numpy()
    _check_sound(got, vis, *tiles)
    np.testing.assert_array_equal(got, _exact(vis, *tiles))


@pytest.mark.parametrize("which", [0, 1, -1])
def test_a_row_that_sees_no_key_keeps_its_query_tile(which):
    """Its softmax is uniform, not 0: no tile of its query tile is empty,
    and every other query tile keeps its classes. The row: the first, a
    middle or the last of the rows whose query tile has an empty tile."""
    qm, km, vis = _metas("stage4")
    bias = fa.precompute_bias(qm, km)
    tq, tk = 16, 32
    before = fa.bias_tile_classes_reference(bias, tq, tk).numpy()
    rows = np.nonzero((before[0] == fa.TILE_EMPTY).any(1).repeat(tq)
                      [:vis.shape[1]])[0]
    row = int(rows[which] if which != 1 else rows[len(rows) // 2])
    bias[0, row] = fa.BF16_NEG
    got = fa.bias_tile_classes_reference(bias, tq, tk).numpy()
    vis = vis.copy()
    vis[0, row] = False
    dead = np.zeros(vis.shape[:2], bool)
    dead[0, row] = True
    np.testing.assert_array_equal(got, _exact(vis, tq, tk, dead))
    qt = row // tq
    assert (before[0, qt] == fa.TILE_EMPTY).any()
    assert not (got[0, qt] == fa.TILE_EMPTY).any()
    others = np.arange(got.shape[1]) != qt
    np.testing.assert_array_equal(got[0, others], before[0, others])


def test_cpu_wrappers_take_the_plain_versions():
    qm, km, _ = _metas("inference")
    np.testing.assert_array_equal(
        fa.inline_tile_classes(qm, km).numpy(),
        fa.inline_tile_classes_reference(qm, km).numpy())
    bias = fa.precompute_bias(qm, km)
    np.testing.assert_array_equal(fa.bias_tile_classes(bias).numpy(),
                                  fa.bias_tile_classes_reference(bias).numpy())


# ---- K6's rule from per-tile summaries (csrc/tile_map.cuh classify_meta) --

BIG = 2 ** 31 - 1


def _summary_classes(meta: AttnMeta, tq: int, tk: int) -> np.ndarray:
    """K6's tile map as the kernels build it, in numpy: summaries of each
    query tile (over its real rows, the non-pad ones unless noted) and key
    tile, then classify_meta on each pair."""
    m = {k: v.numpy().astype(np.int64) for k, v in meta._asdict().items()}
    b, L = m["index"].shape
    nq, nk = -(-L // tq), -(-L // tk)
    out = np.empty((b, nq, nk), np.int8)

    def lo(x, ok, empty):
        return x[ok].min() if ok.any() else empty

    def hi(x, ok, empty):
        return x[ok].max() if ok.any() else empty

    for bi in range(b):
        qs, ks = [], []
        for i in range(nq):
            r = slice(i * tq, min((i + 1) * tq, L))
            idx, blk, off = (m[k][bi, r] for k in ("index", "q_block",
                                                  "q_offset"))
            real = m["is_pad"][bi, r] == 0
            noisy = real & (blk >= 0)
            qs.append(dict(
                idx_min=lo(idx, real, BIG), idx_max=idx.max(),
                blk_min=lo(blk, noisy, BIG), blk_max=hi(blk, noisy, -1),
                off_min=lo(off, noisy, BIG), off_max=hi(off, noisy, -BIG),
                pad_any=(~real).any(), all_noisy=noisy.sum() == real.sum(),
                inside=(i + 1) * tq <= L))
        for j in range(nk):
            c = slice(j * tk, min((j + 1) * tk, L))
            vis, blk, role = (m[k][bi, c] for k in ("vis_start",
                                                    "noisy_block",
                                                    "noisy_role"))
            noisy = blk >= 0
            ks.append(dict(
                vis_min=vis.min(), vmax_c=hi(vis, ~noisy, -BIG),
                vmax_n=hi(vis, noisy, -BIG), blk_min=lo(blk, noisy, BIG),
                blk_max=hi(blk, noisy, -1), role_min=lo(role, noisy, BIG),
                role_max=hi(role, noisy, -BIG), any_noisy=noisy.any(),
                inside=(j + 1) * tk <= L))
        for i, q in enumerate(qs):
            for j, k in enumerate(ks):
                never = (k["blk_max"] < q["blk_min"]
                         or q["blk_max"] < k["blk_min"]
                         or q["off_max"] < k["role_min"])
                if not q["pad_any"] and q["idx_max"] < k["vis_min"] \
                        and never:
                    out[bi, i, j] = fa.TILE_EMPTY
                    continue
                always = (q["all_noisy"] and q["blk_min"] == q["blk_max"]
                          == k["blk_min"] == k["blk_max"]
                          and q["off_min"] >= k["role_max"])
                full = (q["inside"] and k["inside"]
                        and q["idx_min"] >= k["vmax_c"]
                        and (not k["any_noisy"] or q["idx_min"] >= k["vmax_n"]
                             or always))
                out[bi, i, j] = fa.TILE_FULL if full else fa.TILE_PARTIAL
    return out


@pytest.mark.parametrize("case", ["stage1_176x320", "stage4_64x96",
                                  "prefill_b2"])
def test_summary_rule_equals_the_exact_reduction(case):
    if case == "prefill_b2":
        _, tl, rows, cols = _layouts(case)
        meta = AttnMeta.from_layout(tl, "cpu").cols(rows)
    else:
        n_img = tlayout.tokens_per_frame(176, 320) if case.startswith(
            "stage1") else N_IMG
        blocks = ((1,) * 16 if case.startswith("stage1") else
                  random_block_partition(80, random.Random(0)))
        meta = AttnMeta.from_layout(_training(tlayout, blocks, n_img), "cpu")
    want = fa.inline_tile_classes_reference(meta, meta).numpy()
    np.testing.assert_array_equal(
        _summary_classes(meta, fa.TILE_Q, fa.TILE_K), want)
    assert (want == fa.TILE_EMPTY).any() and (want == fa.TILE_FULL).any()


# ---- K1/K2's classes of the columnar decode mask (q_off >= rank) ----------

from video_gpt_tpu.models import video_gpt as jvg  # noqa: E402
from video_gpt_tpu_torch.models import video_gpt as tvg  # noqa: E402

N_IMG_FLAGSHIP = tlayout.tokens_per_frame(176, 320)
RANK_CASES = ("flagship_cond", "flagship_uncond", "extend",
              "long_rollout_cond", "cond_b2")


def _rank_case(name):
    """(port ranks per key operand, port q_off, the same from the JAX
    package in numpy) of K1/K2's calls at 176x320 frames: the cond row's
    tail against its cache and itself, the uncond row against itself, the
    cache extend (the last of 8 clean frames against the prefix), the long
    rollout's cond row (12,432 + 5,328 keys) and a cond row at B 2."""
    n = N_IMG_FLAGSHIP
    if name == "extend":
        jl = jlayout.frame_block_inference_layout(8, 16, n, use_cfg=False)
        tl = tlayout.frame_block_inference_layout(8, 16, n, use_cfg=False)
        jm, tm = JMeta.from_layout(jl), AttnMeta.from_layout(tl, "cpu")
        seg = n + 2
        old, new = 7 * seg, seg
        sl = slice(old, old + new)
        je = jvg.extend_mask(JMeta(*(x[:, sl] for x in jm)),
                             JMeta(*(x[:, :old + new] for x in jm)))
        te = tvg.extend_mask(tm.cols(sl), tm.cols(slice(0, old + new)))
        jrank, jqoff = np.asarray(je.rank), np.asarray(je.q_off)
        return ((te.rank[:, :old], te.rank[:, old:]), te.q_off,
                (jrank[:, :old], jrank[:, old:]), jqoff)
    n_clean, n_gen, rows = {"flagship_cond": (8, 16, 1),
                            "flagship_uncond": (0, 16, 1),
                            "long_rollout_cond": (56, 24, 1),
                            "cond_b2": (8, 16, 2)}[name]
    jl = jlayout.frame_block_inference_layout(n_clean, n_gen, n,
                                              use_cfg=False, rows=rows)
    tl = tlayout.frame_block_inference_layout(n_clean, n_gen, n,
                                              use_cfg=False, rows=rows)
    tail = tl.noisy_tail_len()
    jrank, jqoff = jlayout.decode_rank(jl, tail)
    tm = AttnMeta.from_layout(tl, "cpu")
    mask = tvg.decode_mask(tm.tail(tail), tm)
    if not n_clean:
        return (mask.rank,), mask.q_off, (jrank,), jqoff
    lc = tl.length - tail
    return ((mask.rank[:, :lc], mask.rank[:, lc:]), mask.q_off,
            (jrank[:, :lc], jrank[:, lc:]), jqoff)


def _range_classes(ranks, q_off, tq, tk):
    """K1/K2's classes as the producer computes them, in numpy: per query
    tile the least and largest q_off of its real rows, per key tile the
    least and largest rank (keys past the operand count as never visible),
    then csrc/tile_map.cuh rank_tile_class."""
    b, lq = q_off.shape
    nq = -(-lq // tq)
    out = []
    for rank in ranks:
        lk = rank.shape[1]
        nk = -(-lk // tk)
        r = np.full((b, nk * tk), fa.NEVER, np.int64)
        r[:, :lk] = rank
        r = r.reshape(b, nk, tk)
        q = np.full((b, nq * tq), 0, np.int64)
        q[:, :lq] = q_off
        real = (np.arange(nq * tq) < lq).reshape(nq, tq)
        q = q.reshape(b, nq, tq)
        lo = np.where(real, q, BIG).min(2)[:, :, None]
        hi = np.where(real, q, -BIG - 1).max(2)[:, :, None]
        whole = real.all(1)[None, :, None]
        rmin, rmax = r.min(2)[:, None, :], r.max(2)[:, None, :]
        out.append(np.where(hi < rmin, fa.TILE_EMPTY, np.where(
            whole & (lo >= rmax), fa.TILE_FULL, fa.TILE_PARTIAL)))
    return np.concatenate(out, axis=2)


@pytest.mark.parametrize("name", RANK_CASES)
def test_rank_classes_match_the_jax_decode_rank(name):
    """The plain classifier, and the producer's rule from two ranges,
    against the JAX package's rank and q_off (held bit-equal to the port's)
    made dense and reduced tile by tile; soundness tile by tile."""
    ranks, q_off, jranks, jqoff = _rank_case(name)
    np.testing.assert_array_equal(q_off.numpy(), jqoff)
    for r, jr in zip(ranks, jranks):
        np.testing.assert_array_equal(r.numpy(), jr)
    tq, tk = fa.TILE_Q, fa.TILE_K
    got = fa.rank_tile_classes_reference(ranks, q_off, tq, tk).numpy()
    want, k0 = [], 0
    for jr in jranks:
        vis = jqoff[:, :, None] >= jr[:, None, :]
        nk = -(-jr.shape[1] // tk)
        _check_sound(got[:, :, k0:k0 + nk], vis, tq, tk)
        want.append(_exact(vis, tq, tk))
        k0 += nk
    want = np.concatenate(want, axis=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_range_classes(jranks, jqoff, tq, tk),
                                  want)
    assert (want == fa.TILE_FULL).any() and (want == fa.TILE_PARTIAL).any()


@pytest.mark.parametrize("group", [1, 2, 3])
@pytest.mark.parametrize("name", ["stage4", "inference", "inference_tail",
                                  "prefill_b2"])
def test_inline_groups_cover_their_rows(name, group):
    """K6's blocks of ``group`` query tiles (``inline_groups_reference``):
    every key tile that a query tile does not call empty is in its group's
    list, no other is; a tile is shared when no query tile of the group
    calls it empty; the counts are the lists' lengths and the order takes
    the groups by count, most first, each once."""
    _, tl, rows, cols = _layouts(name)
    meta = AttnMeta.from_layout(tl, "cpu")
    tiles = fa.inline_tile_classes_reference(meta.cols(rows),
                                             meta.cols(cols))
    b, nq, nk = tiles.shape
    g = fa.inline_groups_reference(tiles, group)
    ng = -(-nq // group)
    assert g.tiles.shape == g.shared.shape == (b, ng, nk)
    seen = tiles != fa.TILE_EMPTY
    for qt in range(nq):
        assert not (seen[:, qt] & ~g.tiles[:, qt // group]).any()
    for gi in range(ng):
        part = seen[:, gi * group:(gi + 1) * group]
        assert torch.equal(g.tiles[:, gi], part.any(1))
        assert torch.equal(g.shared[:, gi], part.all(1))
    assert torch.equal(g.counts, g.tiles.sum(-1).flatten())
    assert sorted(g.order.tolist()) == list(range(b * ng))
    counts = g.counts[g.order]
    assert (counts[:-1] >= counts[1:]).all()
    if group == 1:
        assert torch.equal(g.counts, seen.sum(-1).flatten())
