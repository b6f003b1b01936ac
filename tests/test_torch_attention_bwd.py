"""The attention backward of the port (K9's plain version and the autograd
Function of ``flash_mha``) against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode (``INTERPRET`` set
inside try/finally, as tests/test_flash_attention.py does): ``_flash_bwd``
(the TPU ``_bwd_kernel``) and ``jax.grad`` of ``flash_mha_biased`` (forward
``_bias_kernel``, backward ``_bwd_kernel``). Both sides get the same fp32
numpy inputs on a (1, 2, 1) training layout at head_dim 96, MHA and GQA 2:1,
and at head_dim 16, 64 and 128 with GQA 2:1 (the backward kernels' other
padded widths, 32, 64 and 128). Bar: atol = rtol = 5e-5, the JAX package's
own bar for its flash backward against dense gradients (fp32 sums in other
orders).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_gpt_tpu.layout import RowSpec as JRowSpec
from video_gpt_tpu.layout import build_layout as jbuild_layout
from video_gpt_tpu.ops import flash_attention as jfa
from video_gpt_tpu.ops.attention import AttnMeta as JMeta
from video_gpt_tpu_torch.layout import RowSpec, build_layout, tokens_per_frame
from video_gpt_tpu_torch.ops import flash_attention as fa
from video_gpt_tpu_torch.ops.attention import AttnMeta

TOL = 5e-5
D = 96
# (h, hkv, head_dim): the flagship's width in MHA and GQA (ids "4-4",
# "4-2"), and GQA at the other widths
WIDTH_CASES = [pytest.param(h, hkv, d, id=f"{h}-{hkv}" + (
    "" if d == D else f"-d{d}"))
    for h, hkv, d in [(4, 4, D), (4, 2, D), (4, 2, 16), (4, 2, 64),
                      (4, 2, 128)]]


def _case(h, hkv, seed=0, d=D):
    n = tokens_per_frame(32, 32)
    meta = AttnMeta.from_layout(
        build_layout([RowSpec((1, 2, 1), "training")], n), "cpu")
    jmeta = JMeta.from_layout(jbuild_layout([JRowSpec((1, 2, 1),
                                                      "training")], n))
    b, l = meta.index.shape
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v = arr(b, l, h, d), arr(b, l, hkv, d), arr(b, l, hkv, d)
    return meta, jmeta, q, k, v, arr(b, l, h, d)


def _close(got, want, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("h,hkv,d", WIDTH_CASES)
def test_plain_k9_matches_pallas_bwd(h, hkv, d):
    meta, jmeta, q, k, v, do = _case(h, hkv, d=d)
    bias = fa.precompute_bias(meta, meta)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = fa.bias_attention_reference(tq, tk, tv, bias)
    got = fa.bias_attention_backward_reference(tq, tk, tv, bias, o, tdo)
    jfa.INTERPRET = True
    try:
        want = jfa._flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jfa.precompute_bias(jmeta, jmeta),
                              jnp.asarray(o.numpy()), jnp.asarray(do),
                              d ** -0.5)
    finally:
        jfa.INTERPRET = False
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        _close(g, w, name)


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_flash_mha_grads_match_jax_grad(h, hkv):
    """The port's autograd Function (on CPU tensors: plain K3 forward,
    plain K9 backward) against jax.grad of the Pallas flash_mha_biased."""
    meta, jmeta, q, k, v, w = _case(h, hkv, seed=1)
    bias = fa.precompute_bias(meta, meta)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_mha(tq, tk, tv, bias)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    jbias = jfa.precompute_bias(jmeta, jmeta)
    jfa.INTERPRET = True
    try:
        def loss(q, k, v):
            return (jfa.flash_mha_biased(q, k, v, jbias) * w).sum()
        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    finally:
        jfa.INTERPRET = False
    for x, wt, name in zip((tq, tk, tv), want, "qkv"):
        _close(x.grad, wt, "d" + name)


def test_magnitude_bounds_the_gradients():
    """The card's rounding bar reads each gradient against the plain
    version over absolute values: it bounds every element's magnitude."""
    meta, _, q, k, v, do = _case(4, 2, seed=2)
    bias = fa.precompute_bias(meta, meta)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = fa.bias_attention_reference(tq, tk, tv, bias)
    grads = fa.bias_attention_backward_reference(tq, tk, tv, bias, o, tdo)
    mass = fa.bias_attention_backward_reference(tq, tk, tv, bias, o, tdo,
                                                magnitude=True)
    for g, m in zip(grads, mass):
        assert g.shape == m.shape
        assert bool((g.abs() <= m * (1 + 1e-5) + 1e-6).all())


@pytest.mark.parametrize("h,hkv,d", WIDTH_CASES)
def test_bias_carrier_grads_match_jax_grad(h, hkv, d):
    """The model's bias carrier (``maybe_bias``: the bias with its tile
    map, which on the CPU holds no map and counts no build) through a
    checkpointed ``flash_mha``, as a layer with per-layer recompute runs
    it: the forward, its recompute and the backward read the one carrier,
    and the gradients equal jax.grad of the Pallas flash_mha_biased."""
    from torch.utils.checkpoint import checkpoint

    from video_gpt_tpu_torch.config import ModelConfig
    from video_gpt_tpu_torch.models.video_gpt import maybe_bias
    meta, jmeta, q, k, v, w = _case(h, hkv, seed=3, d=d)
    fa.reset_launch_counts()
    bm = maybe_bias(ModelConfig.tiny(), meta, meta)
    assert isinstance(bm, fa.BiasMap)
    assert bm.tile_map is None and bm.rowdead is None and bm.order is None
    assert torch.equal(bm.bias, fa.precompute_bias(meta, meta))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = checkpoint(fa.flash_mha, tq, tk, tv, bm, use_reentrant=False)
    (out * torch.from_numpy(w)).sum().backward()
    assert fa.flash_mha.bias_map_builds == 0 and fa.flash_mha.launches == 0
    jbias = jfa.precompute_bias(jmeta, jmeta)
    jfa.INTERPRET = True
    try:
        def loss(q, k, v):
            return (jfa.flash_mha_biased(q, k, v, jbias) * w).sum()
        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    finally:
        jfa.INTERPRET = False
    for x, wt, name in zip((tq, tk, tv), want, "qkv"):
        _close(x.grad, wt, "d" + name)
