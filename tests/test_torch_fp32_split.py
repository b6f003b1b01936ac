"""The fp32 kernels' split-precision products, emulated on the CPU.

``csrc/fp32_attention.cu`` and ``csrc/fp32_attention_bwd.cu`` compute every
fp32 matrix product on the bf16 tensor cores: each operand split into three
bf16 pieces (``fa.split_pieces``), six of the nine piece products kept
(``fa.split_matmul``, ``csrc/fp32_split.cuh``). Here the split is shown
exact (h + m + l == x bit for bit over fp32 values from 2^-100 to 2^100,
the range of the rank mask's unshifted p), and the attention kernels' plain
versions, with every fp32 product replaced by the split product, are held
to the card's fp32 bars against the Pallas kernels run in fp32 in interpret
mode on the same numpy inputs: forward |got - want| <= 2e-5 + 2e-5 |want|,
backward plus 2^-18 of the gradient's mass (its products over absolute
values). One piece (a plain bf16 product) or two (hh, hm, mh, mm) fail
those bars: they tell the kernels' design from a shortcut. The queries are
scaled so that the logits spread over tens of units (the rank mask's up to
its clamp at 2^+-100), where a product's error moves p.
"""
import functools

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax.numpy as jnp

from video_gpt_tpu import layout as jlayout
from video_gpt_tpu.models import video_gpt as jvg
from video_gpt_tpu.ops import flash_attention as jfa
from video_gpt_tpu.ops.attention import AttnMeta as JMeta
from video_gpt_tpu_torch import layout as tlayout
from video_gpt_tpu_torch.models import video_gpt as tvg
from video_gpt_tpu_torch.ops import flash_attention as fa
from video_gpt_tpu_torch.ops.attention import AttnMeta

# the card's fp32 bars (chip_smoke.py FP32_ATOL, FP32_RTOL, FP32_BWD_MASS)
FP32_ATOL = FP32_RTOL = 2e-5
FP32_BWD_MASS = 2.0 ** -18
N_IMG = 4          # 32x32 frames
H, HKV, D = 4, 2, 64
# query scales: the rank mask's logits reach its clamp, the softmax masks'
# spread over tens of units
RANK_Q_SCALE, SOFTMAX_Q_SCALE = 24.0, 8.0
PIECES = (3, 2, 1)


class SplitProducts(TorchFunctionMode):
    """Every fp32 matrix product as ``fa.split_matmul`` of ``pieces``."""

    def __init__(self, pieces: int):
        super().__init__()
        self.pieces = pieces

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in (torch.matmul, torch.Tensor.matmul,
                     torch.Tensor.__matmul__) and not kwargs
                and all(x.dtype == torch.float32 for x in args)):
            return fa.split_matmul(*args, pieces=self.pieces)
        return func(*args, **kwargs)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _ratio(got, want, mass=None):
    """The worst element's error over the fp32 bar (forward; with ``mass``
    the backward's)."""
    got, want = got.double(), torch.from_numpy(np.array(want)).double()
    assert got.shape == want.shape
    bar = FP32_ATOL + FP32_RTOL * want.abs()
    if mass is not None:
        bar = bar + FP32_BWD_MASS * mass.double()
    return float(((got - want).abs() / bar).max())


@pytest.mark.parametrize("lo,hi", [(-100, -60), (-60, -20), (-20, 20),
                                   (20, 60), (60, 100)])
def test_split_is_exact(lo, hi):
    rng = np.random.default_rng(lo + 1000)
    n = 1 << 16
    x = (rng.uniform(1.0, 2.0, n) * np.exp2(rng.integers(lo, hi + 1, n))
         * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    t = torch.from_numpy(x)
    h, m, l = fa.split_pieces(t)
    assert h.dtype == m.dtype == l.dtype == torch.bfloat16
    # the pieces are exact: summed in fp32 (each partial sum is exact) and
    # in fp64, bit for bit
    assert torch.equal((h.float() + m.float()) + l.float(), t)
    assert torch.equal(h.double() + m.double() + l.double(), t.double())
    # and ordered: each piece within half an ulp of bf16 of the rest
    assert bool((m.float().abs() <= h.float().abs() * 2.0 ** -8).all())
    assert bool((l.float().abs() <= m.float().abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("pieces", PIECES)
def test_split_matmul_is_an_fp32_product(pieces):
    """Three pieces: within fp32 summation error of the fp64 product (4
    ulps of the terms' mass: the dropped products are 2^-24 of it); one or
    two pieces are not."""
    a, b = _rand(1, 96, 128), _rand(2, 128, 80)
    got = fa.split_matmul(torch.from_numpy(a), torch.from_numpy(b), pieces)
    want = torch.from_numpy(a).double() @ torch.from_numpy(b).double()
    mass = torch.from_numpy(np.abs(a)).double() @ torch.from_numpy(
        np.abs(b)).double()
    ratio = float(((got.double() - want).abs() / (mass * 2.0 ** -22)).max())
    assert (ratio <= 1.0) == (pieces == 3), ratio


def _decode_case(n_clean=3):
    jl = jlayout.frame_block_inference_layout(n_clean, 2, N_IMG, False)
    tl = tlayout.frame_block_inference_layout(n_clean, 2, N_IMG, False)
    jm, tm = JMeta.from_layout(jl), AttnMeta.from_layout(tl, "cpu")
    return jl, jm, tm


@functools.lru_cache(maxsize=None)
def _k1_case():
    jl, jm, tm = _decode_case()
    tail, L = jl.noisy_tail_len(), jl.length
    lc = L - tail
    q = _rand(1, 1, tail, H, D, scale=RANK_Q_SCALE)
    k, v = _rand(2, 1, HKV, L, D), _rand(3, 1, HKV, L, D)
    want = jfa.flash_mha_decode_split(
        jnp.asarray(q), jnp.asarray(k[:, :, :lc]), jnp.asarray(v[:, :, :lc]),
        jnp.asarray(k[:, :, lc:]), jnp.asarray(v[:, :, lc:]),
        jvg.decode_mask(jm.tail(tail), jm), interpret=True)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)

    def port():
        return fa.flash_mha_decode_split(
            torch.from_numpy(q), tk[:, :, :lc], tv[:, :, :lc],
            tk[:, :, lc:], tv[:, :, lc:], tvg.decode_mask(tm.tail(tail), tm))

    return port, np.asarray(want)


@functools.lru_cache(maxsize=None)
def _k2_case():
    jl, jm, tm = _decode_case()
    tail, L = jl.noisy_tail_len(), jl.length
    q = _rand(4, 1, tail, H, D, scale=RANK_Q_SCALE)
    k, v = _rand(5, 1, L, HKV, D), _rand(6, 1, L, HKV, D)
    want = jfa.flash_mha_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jvg.decode_mask(jm.tail(tail), jm), interpret=True)

    def port():
        return fa.flash_mha_decode(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tvg.decode_mask(tm.tail(tail), tm))

    return port, np.asarray(want)


def _training_case(seed):
    jl = jlayout.build_layout([jlayout.RowSpec((1, 2, 1), "training")],
                              N_IMG)
    tl = tlayout.build_layout([tlayout.RowSpec((1, 2, 1), "training")],
                              N_IMG)
    jm, tm = JMeta.from_layout(jl), AttnMeta.from_layout(tl, "cpu")
    b, L = tl.batch, tl.length
    q = _rand(seed, b, L, H, D, scale=SOFTMAX_Q_SCALE)
    k, v = _rand(seed + 1, b, L, HKV, D), _rand(seed + 2, b, L, HKV, D)
    return jm, tm, q, k, v, _rand(seed + 3, b, L, H, D)


@functools.lru_cache(maxsize=None)
def _k3_case():
    jm, tm, q, k, v, _ = _training_case(10)
    want = jfa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jm, jm, bias=jfa.precompute_bias(jm, jm),
                         interpret=True)
    bias = fa.precompute_bias(tm, tm)

    def port():
        return fa.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), bias)

    return port, np.asarray(want)


@functools.lru_cache(maxsize=None)
def _k6_case():
    jm, tm, q, k, v, _ = _training_case(20)
    jfa.INTERPRET = True
    try:
        want, _ = jfa._stream_inline_fwd(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jm, jm,
                                         block_q=16, block_k=128)
    finally:
        jfa.INTERPRET = False

    def port():
        return fa.flash_mha_inline(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), tm, tm)

    return port, np.asarray(want)


FORWARD = {"K1": _k1_case, "K2": _k2_case, "K3": _k3_case, "K6": _k6_case}


@pytest.mark.parametrize("kernel", sorted(FORWARD))
@pytest.mark.parametrize("pieces", PIECES)
def test_split_forward_holds_the_fp32_bar(kernel, pieces):
    """The plain version with split products against the Pallas kernel in
    fp32: within the bar with three pieces, past it with one or two."""
    port, want = FORWARD[kernel]()
    with torch.no_grad(), SplitProducts(pieces):
        got = port()
    ratio = _ratio(got, want)
    assert (ratio <= 1.0) == (pieces == 3), (kernel, pieces, ratio)


@functools.lru_cache(maxsize=None)
def _k9_case():
    jm, tm, q, k, v, do = _training_case(30)
    bias = fa.precompute_bias(tm, tm)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = fa.bias_attention_reference(tq, tk, tv, bias)
    jfa.INTERPRET = True
    try:
        want = jfa._flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jfa.precompute_bias(jm, jm),
                              jnp.asarray(o.numpy()), jnp.asarray(do),
                              D ** -0.5)
    finally:
        jfa.INTERPRET = False
    mass = fa.bias_attention_backward_reference(tq, tk, tv, bias, o, tdo,
                                                magnitude=True)

    def port():
        return fa.bias_attention_backward_reference(tq, tk, tv, bias, o, tdo)

    return port, [np.asarray(w) for w in want], mass


@functools.lru_cache(maxsize=None)
def _k7_case():
    jm, tm, q, k, v, do = _training_case(40)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, _ = fa.inline_attention_reference(tq, tk, tv, tm, tm)
    jfa.INTERPRET = True
    try:
        _, jlse = jfa._stream_inline_fwd(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jm, jm,
                                         block_q=16, block_k=128)
        want = jfa._stream_inline_bwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(o.numpy()), jlse, jnp.asarray(do), jm, jm,
            block_q=16, block_k=128)
    finally:
        jfa.INTERPRET = False
    mass = fa.inline_attention_backward_reference(tq, tk, tv, tm, tm, o, tdo,
                                                  magnitude=True)

    def port():
        return fa.inline_attention_backward_reference(tq, tk, tv, tm, tm, o,
                                                      tdo)

    return port, [np.asarray(w) for w in want], mass


BACKWARD = {"K9": _k9_case, "K7": _k7_case}


@pytest.mark.parametrize("kernel", sorted(BACKWARD))
@pytest.mark.parametrize("pieces", PIECES)
def test_split_backward_holds_the_fp32_bar(kernel, pieces):
    """dq, dk, dv of the plain backward with split products against the
    Pallas backward in fp32: within the backward bar with three pieces,
    past it with one or two."""
    port, want, mass = BACKWARD[kernel]()
    with SplitProducts(pieces):
        got = port()
    ratio = max(_ratio(g, w, m) for g, w, m in zip(got, want, mass))
    assert (ratio <= 1.0) == (pieces == 3), (kernel, pieces, ratio)
