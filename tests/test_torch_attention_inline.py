"""The port's metadata-inline attention (K6's and K7's plain versions and
the autograd Function ``flash_mha_inline``) against the JAX package on the
CPU.

The JAX side runs its Pallas kernels in interpret mode (``INTERPRET`` set
inside try/finally, as tests/test_flash_attention.py does):
``_stream_inline_fwd`` (K6) and ``_stream_inline_bwd_impl`` (K7a/b) at
small blocks, so that their online softmax and their dq / dk-dv sums run
over several tiles; ``flash_mha(..., bias=None)`` (K8, the resident
kernel with the same function); ``jax.grad`` through
``flash_mha_streaming_inline`` (K6 forward, K7 backward) and through
``flash_mha_inline`` (K8 forward, K9 backward from a derived bias). Both
sides get the same fp32 numpy inputs at head_dim 96, MHA and GQA 2:1, on an
inference layout (the noisy tail against the whole CFG pair) and a
frame-block training layout; the K6 forward also at head_dim 64 and 128,
the CUDA kernels' other padded widths, and the K7 backward at head_dim 16,
64 and 128 with GQA 2:1. Bars: the forward at atol = rtol = 2e-5, the
JAX package's kernel-vs-reference bar; the backward at atol = rtol = 5e-5,
its flash-backward bar (fp32 sums in other orders).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_gpt_tpu import layout as jlayout
from video_gpt_tpu.ops import flash_attention as jfa
from video_gpt_tpu.ops.attention import AttnMeta as JMeta
from video_gpt_tpu_torch import layout as tlayout
from video_gpt_tpu_torch.ops import flash_attention as fa
from video_gpt_tpu_torch.ops.attention import (AttnMeta, Window, attend,
                                               attention_bias, mha_reference,
                                               visibility)

FWD_TOL, BWD_TOL = 2e-5, 5e-5
D = 96
N_IMG = tlayout.tokens_per_frame(32, 48)   # 24 image tokens per frame
# the Pallas kernels' tiles in these tests: several query and key tiles
BLOCK_Q, BLOCK_K = 16, 128


def _layouts(kind):
    """(JAX layout, port layout, query rows): 'inference' takes the noisy
    tail of a CFG pair against every key; 'training' a frame-block row."""
    if kind == "inference":
        args = (3, 2, N_IMG)
        jl = jlayout.frame_block_inference_layout(*args, use_cfg=True)
        tl = tlayout.frame_block_inference_layout(*args, use_cfg=True)
        return jl, tl, slice(-jl.noisy_tail_len(), None)
    jl = jlayout.build_layout([jlayout.RowSpec((1, 2, 1), "training")], N_IMG)
    tl = tlayout.build_layout([tlayout.RowSpec((1, 2, 1), "training")], N_IMG)
    return jl, tl, slice(None)


def _case(kind, h, hkv, seed=0, d=D):
    jl, tl, rows = _layouts(kind)
    jm, tm = JMeta.from_layout(jl), AttnMeta.from_layout(tl, "cpu")
    jq, tq = JMeta(*(x[:, rows] for x in jm)), tm.cols(rows)
    b, lk = tl.batch, tl.length
    lq = tq.index.shape[1]
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v = arr(b, lq, h, d), arr(b, lk, hkv, d), arr(b, lk, hkv, d)
    return (jq, jm), (tq, tm), (q, k, v), arr(b, lq, h, d)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=name)


CASES = [("inference", 4, 4), ("inference", 4, 2), ("training", 4, 4),
         ("training", 4, 2)]


@pytest.mark.parametrize("kind,h,hkv,d", [
    pytest.param(*case, d, id="-".join(map(str, case))
                 + ("" if d == D else f"-d{d}"))
    for case in CASES for d in (D, 64, 128)])
def test_plain_k6_matches_pallas_stream_inline(kind, h, hkv, d):
    (jq, jk), (tq, tk), qkv, _ = _case(kind, h, hkv, d=d)
    out, lse = fa.inline_attention_reference(*_t(*qkv), tq, tk)
    jfa.INTERPRET = True
    try:
        want, want_lse = jfa._stream_inline_fwd(*_j(*qkv), jq, jk,
                                                block_q=BLOCK_Q,
                                                block_k=BLOCK_K)
    finally:
        jfa.INTERPRET = False
    b, lq, h, _ = out.shape
    _close(out, want, FWD_TOL, "out")
    # the Pallas lse is [B*H, 1, Lqp]: the padded rows are dropped
    want_lse = np.asarray(want_lse)[:, 0, :lq].reshape(b, h, lq)
    _close(lse, want_lse, FWD_TOL, "lse")


@pytest.mark.parametrize("kind,h,hkv", CASES)
def test_plain_k6_matches_pallas_k8(kind, h, hkv):
    """K8, the resident inline kernel, computes the same function."""
    (jq, jk), (tq, tk), qkv, _ = _case(kind, h, hkv, seed=1)
    out, _ = fa.inline_attention_reference(*_t(*qkv), tq, tk)
    want = jfa.flash_mha(*_j(*qkv), jq, jk, bias=None, interpret=True)
    _close(out, want, FWD_TOL)


# a sliding window of half a frame of positions (the AFMoE
# trunk's sliding layers), which hides keys in both layouts
WINDOW = 12


def _window(kind):
    """The window over the port layout's positions: (queries, keys)."""
    _, tl, rows = _layouts(kind)
    pos = torch.as_tensor(tl.pos_ids, dtype=torch.int32)
    return Window(WINDOW, pos[:, rows], pos)


@pytest.mark.parametrize("kind,h,hkv,window", [
    pytest.param(*case, w, id="-".join(map(str, case)) + ("-window" if w
                                                          else ""))
    for case in CASES for w in (False, True)])
def test_plain_k6_matches_dense_reference(kind, h, hkv, window,
                                          monkeypatch):
    """The plain version row by row equals the port's dense masked
    attention, with small row steps so several of them run; with a window
    the plain K6 and K7 and the plain K3 and K9 over the windowed bias
    equal the dense attention under the rule and the window, and its
    gradients."""
    _, (tq, tk), qkv, dout = _case(kind, h, hkv, seed=2)
    q, k, v = _t(*qkv)
    monkeypatch.setattr(fa, "INLINE_ROWS", 7)
    win = _window(kind) if window else None
    out, _ = fa.inline_attention_reference(q, k, v, tq, tk, win)
    want = mha_reference(q, k, v, attention_bias(tq, tk, window=win))
    _close(out, want.numpy(), FWD_TOL)
    if not window:
        return
    assert not bool(visibility(tq, tk, win).eq(visibility(tq, tk)).all())
    bias = fa.precompute_bias(tq, tk, win)
    _close(fa.bias_attention_reference(q, k, v, bias), want.numpy(),
           FWD_TOL, "K3")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    dense = mha_reference(*leaves, attention_bias(tq, tk, window=win))
    grads = torch.autograd.grad(dense, leaves, torch.from_numpy(dout))
    k7 = fa.inline_attention_backward_reference(q, k, v, tq, tk, out,
                                                torch.from_numpy(dout),
                                                window=win)
    k9 = fa.bias_attention_backward_reference(q, k, v, bias, out,
                                              torch.from_numpy(dout))
    for name, g, a, b in zip(("dq", "dk", "dv"), grads, k7, k9):
        _close(a, g.numpy(), BWD_TOL, f"K7 {name}")
        _close(b, g.numpy(), BWD_TOL, f"K9 {name}")


# the backward's cases: CASES at head_dim 96, and GQA 2:1 at the other
# widths (ids of the 96 cases as before)
BWD_WIDTHS = (16, 64, 128)


@pytest.mark.parametrize("kind,h,hkv,d", [
    pytest.param(*case, D, id="-".join(map(str, case))) for case in CASES] + [
    pytest.param(kind, 4, 2, d, id=f"{kind}-4-2-d{d}")
    for kind in ("inference", "training") for d in BWD_WIDTHS])
def test_plain_k7_matches_pallas_stream_bwd(kind, h, hkv, d, monkeypatch):
    (jq, jk), (tq, tk), qkv, do = _case(kind, h, hkv, seed=3, d=d)
    q, k, v = _t(*qkv)
    o, _ = fa.inline_attention_reference(q, k, v, tq, tk)
    monkeypatch.setattr(fa, "INLINE_ROWS", 9)   # several row steps
    got = fa.inline_attention_backward_reference(q, k, v, tq, tk, o,
                                                 torch.from_numpy(do))
    jfa.INTERPRET = True
    try:
        _, jlse = jfa._stream_inline_fwd(*_j(*qkv), jq, jk, block_q=BLOCK_Q,
                                         block_k=BLOCK_K)
        want = jfa._stream_inline_bwd_impl(
            *_j(*qkv), jnp.asarray(o.numpy()), jlse, jnp.asarray(do), jq, jk,
            block_q=BLOCK_Q, block_k=BLOCK_K)
    finally:
        jfa.INTERPRET = False
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        _close(g, w, BWD_TOL, name)


@pytest.mark.parametrize("jax_fn", ["flash_mha_streaming_inline",
                                    "flash_mha_inline"])
@pytest.mark.parametrize("h,hkv,d", [
    pytest.param(h, hkv, D, id=f"{h}-{hkv}") for h, hkv in [(4, 4), (4, 2)]]
    + [pytest.param(4, 2, d, id=f"4-2-d{d}") for d in BWD_WIDTHS])
def test_flash_mha_inline_grads_match_jax_grad(jax_fn, h, hkv, d):
    """The port's autograd Function (on CPU tensors: plain K6 forward,
    plain K7 backward) against jax.grad through the JAX package's two
    differentiable inline attentions, on the training layout."""
    (jq, jk), (tq, tk), qkv, w = _case("training", h, hkv, seed=4, d=d)
    tq_, tk_, tv_ = (x.requires_grad_() for x in _t(*qkv))
    fa.reset_launch_counts()
    out = fa.flash_mha_inline(tq_, tk_, tv_, tq, tk)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    assert [f.launches for f in fa.KERNELS] == [0] * len(fa.KERNELS)
    fn = getattr(jfa, jax_fn)
    jfa.INTERPRET = True
    try:
        def loss(q, k, v):
            return (fn(q, k, v, jq, jk) * w).sum()
        want = jax.grad(loss, argnums=(0, 1, 2))(*_j(*qkv))
    finally:
        jfa.INTERPRET = False
    for x, wt, name in zip((tq_, tk_, tv_), want, "qkv"):
        _close(x.grad, wt, BWD_TOL, "d" + name)


def test_inline_magnitude_bounds_the_gradients():
    """The card's rounding bar reads each gradient against the plain
    version over absolute values: it bounds every element's magnitude."""
    _, (tq, tk), qkv, do = _case("training", 4, 2, seed=5)
    q, k, v = _t(*qkv)
    o, _ = fa.inline_attention_reference(q, k, v, tq, tk)
    args = (q, k, v, tq, tk, o, torch.from_numpy(do))
    grads = fa.inline_attention_backward_reference(*args)
    mass = fa.inline_attention_backward_reference(*args, magnitude=True)
    for g, m in zip(grads, mass):
        assert g.shape == m.shape
        assert bool((g.abs() <= m * (1 + 1e-5) + 1e-6).all())


def test_attend_without_bias_runs_the_inline_route():
    """``attend`` with no bias takes K6's wrapper, which on CPU tensors
    runs the plain version and counts no launch."""
    _, (tq, tk), qkv, _ = _case("inference", 4, 2, seed=6)
    q, k, v = _t(*qkv)
    fa.reset_launch_counts()
    got = attend(q, k, v, tq, tk)
    assert [f.launches for f in fa.KERNELS] == [0] * len(fa.KERNELS)
    _close(got, fa.inline_attention_reference(q, k, v, tq, tk)[0].numpy(),
           0.0)
