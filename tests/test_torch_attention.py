"""Port attention (video_gpt_tpu_torch.ops) vs the JAX package on the CPU.

The port's kernel wrappers take their plain PyTorch versions for CPU
tensors; the JAX side runs the Pallas kernels in interpret mode. Inputs are
numpy draws from a seed handed to both sides. Bar: atol = rtol = 2e-5 at
fp32, the JAX package's own kernel-vs-reference bar
(tests/test_flash_attention.py); both sides sum in another order, nothing
else differs. The masks are integer metadata and must match bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_gpt_tpu import layout as jlayout
from video_gpt_tpu.models import video_gpt as jvg
from video_gpt_tpu.ops import flash_attention as jfa
from video_gpt_tpu.ops.attention import AttnMeta as JMeta
from video_gpt_tpu_torch import layout as tlayout
from video_gpt_tpu_torch.models import video_gpt as tvg
from video_gpt_tpu_torch.ops import flash_attention as tfa
from video_gpt_tpu_torch.ops.attention import AttnMeta as TMeta

ATOL = RTOL = 2e-5
N_IMG = 4          # 32x32 frames: seg 6 tokens, never a 128-key multiple
H, HKV, D = 4, 2, 16
# the head widths of the K1/K2/K3 cases: the tiny model's 16, and the CUDA
# kernels' padded widths 64 and 128 (every width the Pallas kernels take
# is at most 128)
WIDTHS = (D, 64, 128)


def _widths(*cases):
    """Each case at every width of WIDTHS: at D under its own id, at the
    others with ``-d<width>`` appended."""
    out = []
    for case in cases:
        case = case if isinstance(case, tuple) else (case,)
        base = "-".join(str(x) for x in case)
        out += [pytest.param(*case, d, id=base if d == D else f"{base}-d{d}")
                for d in WIDTHS]
    return out


def _metas(n_clean, n_gen, use_cfg=False):
    jl = jlayout.frame_block_inference_layout(n_clean, n_gen, N_IMG,
                                              use_cfg=use_cfg)
    tl = tlayout.frame_block_inference_layout(n_clean, n_gen, N_IMG,
                                              use_cfg=use_cfg)
    return jl, tl, JMeta.from_layout(jl), TMeta.from_layout(tl, "cpu")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(port, want):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("n_clean,n_gen,use_cfg", [
    (0, 2, False), (2, 2, False), (3, 1, False), (3, 2, True)])
def test_layout_copy_and_decode_rank_bit_equal(n_clean, n_gen, use_cfg):
    jl, tl, _, _ = _metas(n_clean, n_gen, use_cfg)
    for f in ("input_ids", "pos_ids", "kind", "vis_start", "noisy_block",
              "noisy_role", "q_block", "q_offset", "clean_src", "noisy_src",
              "time_src", "noisy_gather", "clean_gather"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f), f)
    np.testing.assert_array_equal(tlayout.render_dense_mask(tl),
                                  jlayout.render_dense_mask(jl))
    tail = jl.noisy_tail_len()
    jr, tr = jlayout.decode_rank(jl, tail), tlayout.decode_rank(tl, tail)
    assert (jr is None) == (tr is None)
    if jr is not None:
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_clean", [0, 2, 3])
def test_decode_and_extend_masks_bit_equal(n_clean):
    jl, tl, jm, tm = _metas(n_clean, 2)
    tail = jl.noisy_tail_len()
    jd = jvg.decode_mask(jm.tail(tail), jm)
    td = tvg.decode_mask(tm.tail(tail), tm)
    np.testing.assert_array_equal(td.rank.numpy(), np.asarray(jd.rank))
    np.testing.assert_array_equal(td.q_off.numpy(), np.asarray(jd.q_off))
    if n_clean:
        # the extend step: the last clean frame's tokens against the prefix
        seg = N_IMG + 2
        old, new = (n_clean - 1) * seg, seg
        sl = slice(old, old + new)
        je = jvg.extend_mask(JMeta(*(x[:, sl] for x in jm)),
                             JMeta(*(x[:, :old + new] for x in jm)))
        te = tvg.extend_mask(tm.cols(sl), tm.cols(slice(0, old + new)))
        np.testing.assert_array_equal(te.rank.numpy(), np.asarray(je.rank))
        np.testing.assert_array_equal(te.q_off.numpy(), np.asarray(je.q_off))


@pytest.mark.parametrize("n_clean,use_cfg", [(0, False), (2, False),
                                             (3, True)])
def test_precompute_bias_equal_on_unpadded_region(n_clean, use_cfg):
    _, _, jm, tm = _metas(n_clean, 2, use_cfg)
    jb = np.asarray(jfa.precompute_bias(jm, jm).astype(jnp.float32))
    tb = tfa.precompute_bias(tm, tm)
    assert tb.dtype == torch.bfloat16
    lq, lk = tb.shape[1:]
    np.testing.assert_array_equal(tb.float().numpy(), jb[:, :lq, :lk])


@pytest.mark.parametrize("n_clean,d", _widths(2, 3))
def test_k1_decode_split_matches_pallas(n_clean, d):
    jl, _, jm, tm = _metas(n_clean, 2)
    tail, L = jl.noisy_tail_len(), jl.length
    lc = L - tail
    q = _rand(1, 1, tail, H, d)
    k, v = _rand(2, 1, HKV, L, d), _rand(3, 1, HKV, L, d)
    jmask = jvg.decode_mask(jm.tail(tail), jm)
    want = jfa.flash_mha_decode_split(
        jnp.asarray(q), jnp.asarray(k[:, :, :lc]), jnp.asarray(v[:, :, :lc]),
        jnp.asarray(k[:, :, lc:]), jnp.asarray(v[:, :, lc:]), jmask,
        interpret=True)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    # the tail arrives as a heads-major VIEW of tokens-major K/V, as in the
    # model's attention layer
    kt = tk[:, :, lc:].transpose(1, 2).contiguous().transpose(1, 2)
    vt = tv[:, :, lc:].transpose(1, 2).contiguous().transpose(1, 2)
    got = tfa.flash_mha_decode_split(
        torch.from_numpy(q), tk[:, :, :lc], tv[:, :, :lc], kt, vt,
        tvg.decode_mask(tm.tail(tail), tm))
    _close(got, want)


@pytest.mark.parametrize("n_clean,d", _widths(0, 2, 3))
def test_k2_decode_matches_pallas(n_clean, d):
    jl, _, jm, tm = _metas(n_clean, 2)
    tail, L = jl.noisy_tail_len(), jl.length
    q = _rand(4, 1, tail, H, d)
    k, v = _rand(5, 1, L, HKV, d), _rand(6, 1, L, HKV, d)
    want = jfa.flash_mha_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jvg.decode_mask(jm.tail(tail), jm), interpret=True)
    got = tfa.flash_mha_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tvg.decode_mask(tm.tail(tail), tm))
    _close(got, want)


def test_k1_extend_mask_matches_pallas():
    """The cache-extend call of K1: clean queries, extend_mask."""
    n_clean = 3
    jl, _, jm, tm = _metas(n_clean, 1)
    seg = N_IMG + 2
    old, new = (n_clean - 1) * seg, seg
    sl = slice(old, old + new)
    q = _rand(7, 1, new, H, D)
    k, v = _rand(8, 1, HKV, old + new, D), _rand(9, 1, HKV, old + new, D)
    jmask = jvg.extend_mask(JMeta(*(x[:, sl] for x in jm)),
                            JMeta(*(x[:, :old + new] for x in jm)))
    want = jfa.flash_mha_decode_split(
        jnp.asarray(q), jnp.asarray(k[:, :, :old]), jnp.asarray(v[:, :, :old]),
        jnp.asarray(k[:, :, old:]), jnp.asarray(v[:, :, old:]), jmask,
        interpret=True)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    got = tfa.flash_mha_decode_split(
        torch.from_numpy(q), tk[:, :, :old], tv[:, :, :old], tk[:, :, old:],
        tv[:, :, old:],
        tvg.extend_mask(tm.cols(sl), tm.cols(slice(0, old + new))))
    _close(got, want)


@pytest.mark.parametrize("n_clean,use_cfg,d", _widths(
    (0, False), (2, False), (3, True)))
def test_k3_biased_matches_pallas(n_clean, use_cfg, d):
    jl, _, jm, tm = _metas(n_clean, 2, use_cfg)
    b, L = jl.batch, jl.length
    q = _rand(10, b, L, H, d)
    k, v = _rand(11, b, L, HKV, d), _rand(12, b, L, HKV, d)
    want = jfa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jm, jm, bias=jfa.precompute_bias(jm, jm),
                         interpret=True)
    got = tfa.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), tfa.precompute_bias(tm, tm))
    _close(got, want)


def test_k3_prefill_prefix_matches_pallas():
    """K3 as the prefill calls it: the clean prefix only, heads GQA."""
    jl, _, jm, tm = _metas(3, 2)
    lp = jl.length - jl.noisy_tail_len()
    jp = JMeta(*(x[:, :lp] for x in jm))
    tp = tm.cols(slice(0, lp))
    q = _rand(13, 1, lp, H, D)
    k, v = _rand(14, 1, lp, HKV, D), _rand(15, 1, lp, HKV, D)
    want = jfa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jp, jp, bias=jfa.precompute_bias(jp, jp),
                         interpret=True)
    got = tfa.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), tfa.precompute_bias(tp, tp))
    _close(got, want)


# ---- K1/K2 at the lengths that the layouts above never make ---------------

def _rank_mask(seed, b, lq, lk, never_tile=None):
    """A random columnar mask (numpy): q_off in {0, 1, 2}, ranks in {-1, 0,
    1, 2, NEVER}; with ``never_tile`` the keys of that 64-key tile are
    NEVER, a key tile that no query sees."""
    rng = np.random.default_rng(seed)
    rank = rng.choice(np.array([-1, 0, 1, 2, tfa.NEVER], np.int32), (b, lk))
    if never_tile is not None:
        rank[:, 64 * never_tile:64 * (never_tile + 1)] = tfa.NEVER
    return rank, rng.integers(0, 3, (b, lq)).astype(np.int32)


@pytest.mark.parametrize("b,lq,lc,lt", [
    (1, 1, 70, 1), (1, 63, 1, 129), (2, 64, 9, 57), (1, 127, 200, 64),
    (2, 129, 13, 3)])
def test_k1_at_odd_lengths_matches_pallas(b, lq, lc, lt):
    """Query rows and operand lengths off the kernels' 64-row tiles (1, 63,
    64, 127, 129 queries; operands of 1 key, of lengths that are no
    multiple of 8 or 64), at B 1 and 2; at Lc 200 the cache's second key
    tile is seen by no query."""
    q = _rand(20, b, lq, H, D)
    kc, vc = _rand(21, b, HKV, lc, D), _rand(22, b, HKV, lc, D)
    kt, vt = _rand(23, b, lt, HKV, D), _rand(24, b, lt, HKV, D)
    rank, q_off = _rank_mask(25, b, lq, lc + lt,
                             never_tile=1 if lc >= 128 else None)
    want = jfa.flash_mha_decode_split(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kt.transpose(0, 2, 1, 3)),
        jnp.asarray(vt.transpose(0, 2, 1, 3)),
        jfa.DecodeMask(jnp.asarray(rank), jnp.asarray(q_off)),
        interpret=True)
    got = tfa.flash_mha_decode_split(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(kt).transpose(1, 2),
        torch.from_numpy(vt).transpose(1, 2),
        tfa.DecodeMask(torch.from_numpy(rank), torch.from_numpy(q_off)))
    _close(got, want)


def test_k1_with_an_empty_cache_matches_pallas_k2():
    """Lc = 0: K1 over the tail alone is the TPU's K2 over those keys."""
    b, lq, lt = 1, 70, 77
    q = _rand(26, b, lq, H, D)
    kt, vt = _rand(27, b, HKV, lt, D), _rand(28, b, HKV, lt, D)
    rank, q_off = _rank_mask(29, b, lq, lt)
    want = jfa.flash_mha_decode(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt),
        jfa.DecodeMask(jnp.asarray(rank), jnp.asarray(q_off)),
        interpret=True, kv_heads_major=True)
    tk, tv = torch.from_numpy(kt), torch.from_numpy(vt)
    got = tfa.flash_mha_decode_split(
        torch.from_numpy(q), tk[:, :, :0], tv[:, :, :0], tk, tv,
        tfa.DecodeMask(torch.from_numpy(rank), torch.from_numpy(q_off)))
    _close(got, want)


@pytest.mark.parametrize("b,lq,lk", [
    (1, 1, 1), (1, 63, 65), (2, 127, 7), (1, 129, 129), (1, 64, 200)])
def test_k2_at_odd_lengths_matches_pallas(b, lq, lk):
    """As the K1 case, over one tokens-major operand; at Lk 200 the second
    key tile is seen by no query."""
    q = _rand(30, b, lq, H, D)
    k, v = _rand(31, b, lk, HKV, D), _rand(32, b, lk, HKV, D)
    rank, q_off = _rank_mask(33, b, lq, lk,
                             never_tile=1 if lk >= 128 else None)
    want = jfa.flash_mha_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jfa.DecodeMask(jnp.asarray(rank), jnp.asarray(q_off)),
        interpret=True)
    got = tfa.flash_mha_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tfa.DecodeMask(torch.from_numpy(rank), torch.from_numpy(q_off)))
    _close(got, want)


def test_plain_versions_do_not_count_launches():
    """On CPU tensors the wrappers run the plain versions: no launch is
    counted (the counters prove a CUDA run went through the kernels)."""
    tfa.reset_launch_counts()
    test_k2_decode_matches_pallas(0, D)
    test_k1_extend_mask_matches_pallas()
    assert [f.launches for f in tfa.KERNELS] == [0] * len(tfa.KERNELS)
    assert [f.fp32_launches for f in tfa.KERNELS] == [0] * len(
        tfa.KERNELS)
