"""The ring over the mesh's seq axis, module by module, against the JAX
package on the CPU: the plain K7 on a given (global) logsumexp, the
neighbour hop ``ppermute``, and ``ring_attend``'s output and gradients.

The port's ranks run in spawned gloo processes (``spawn_ranks``, with a
timeout, so that a hop issued out of order fails instead of hanging),
which load only torch and the port (``torch_mesh_ranks.py``); the JAX side
runs in this process on ``conftest.py``'s 8 CPU devices under the same
grid. Inputs are fp32 numpy arrays from seeds.

Bars: the plain K7 against the Pallas ``_stream_inline_bwd_impl`` in
interpret mode at atol = rtol = 5e-5 (slice 3's K7 bar); ``ring_attend``
against the JAX ``ring_attend`` at 2e-5 forward and 1e-4 for the
gradients (``tests/test_ring.py``'s bars: the per-chunk partials are
merged, and their gradients summed, in another order), the JAX chunks
dense (``impl='reference'``) or the Pallas K6/K7 in interpret mode.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_ranks as ranks
from video_gpt_tpu import layout as jlayout
from video_gpt_tpu.config import MeshConfig as JMeshConfig
from video_gpt_tpu.ops import flash_attention as jfa
from video_gpt_tpu.ops.attention import AttnMeta as JMeta
from video_gpt_tpu.parallel.mesh import make_mesh as jmake_mesh
from video_gpt_tpu.parallel.ring import ring_attend as jring
from video_gpt_tpu_torch.config import MeshConfig
from video_gpt_tpu_torch.ops import flash_attention as fa
from video_gpt_tpu_torch.ops.attention import AttnMeta, attend
from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
from video_gpt_tpu_torch.parallel.ring import LSE_START, merge

K7_TOL = 5e-5
FWD_TOL, GRAD_TOL = 2e-5, 1e-4
H, HKV, D = 8, 4, 16
N_IMG = 6
NEVER = 2 ** 30


def _layout_meta(rows=2, multiple=4):
    """A frame-block training layout padded to the seq multiple: its
    metadata as numpy arrays per field (both packages read them)."""
    lay = jlayout.build_layout([jlayout.RowSpec((1, 2, 1), "training")]
                               * rows, N_IMG, pad_to_multiple=multiple)
    return {f: np.asarray(x, np.int32) for f, x in
            zip(AttnMeta._fields, JMeta.from_layout(lay))}


def _arrays(meta, seed, h=H, hkv=HKV, d=D):
    b, l = meta["index"].shape
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"q": arr(b, l, h, d), "k": arr(b, l, hkv, d),
            "v": arr(b, l, hkv, d), "dout": arr(b, l, h, d)}


def _tmeta(meta):
    return AttnMeta(*(torch.from_numpy(meta[f].copy())
                      for f in AttnMeta._fields))


def _jmeta(meta):
    return JMeta(*(jnp.asarray(meta[f]) for f in AttnMeta._fields))


# ---- step 0: the plain K7 takes the lse it is handed -----------------------

def _global_lse_case():
    """A training layout's queries over the second of two key chunks:
    q/k/v, dO, the port's (out, lse) over all the keys, and both
    packages' metadata of the queries and of the chunk."""
    meta = _layout_meta(rows=1, multiple=2)
    a = _arrays(meta, seed=11, h=4, hkv=2, d=96)
    tm, jm = _tmeta(meta), _jmeta(meta)
    q, k, v = (torch.from_numpy(a[x]) for x in "qkv")
    o, lse = fa.inline_attention_reference(q, k, v, tm, tm)
    half = slice(q.shape[1] // 2, None)
    return (a, q, k[:, half], v[:, half], o, lse, tm, tm.cols(half), jm,
            JMeta(*(x[:, half] for x in jm)))


def test_plain_k7_takes_the_global_lse():
    """The chunk's gradients from the global lse (not the chunk's own)
    equal the Pallas K7's on the same lse; the plain K7 that ignores the
    lse and renormalises over the chunk misses the bar by far, so the
    test sees the fault the ring would inherit."""
    a, q, kc, vc, o, lse, tm, tmc, jm, jmc = _global_lse_case()
    do = torch.from_numpy(a["dout"])
    got = fa.inline_attention_backward_reference(q, kc, vc, tm, tmc, o, do,
                                                 lse=lse)
    jfa.INTERPRET = True
    try:
        # the Pallas lse layout [B*H, 1, Lqp] at the kernels' query block
        _, jlse = jfa._stream_inline_fwd(
            jnp.asarray(a["q"]), jnp.asarray(a["k"]), jnp.asarray(a["v"]),
            jm, jm, block_q=16, block_k=128)
        b, lq, h, _ = q.shape
        lse_p = np.zeros(np.asarray(jlse).shape, np.float32)
        lse_p[:, 0, :lq] = lse.reshape(b * h, lq).numpy()
        want = jfa._stream_inline_bwd_impl(
            jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()),
            jnp.asarray(vc.numpy()), jnp.asarray(o.numpy()),
            jnp.asarray(lse_p), jnp.asarray(do.numpy()), jm, jmc,
            block_q=16, block_k=128)
    finally:
        jfa.INTERPRET = False
    own = fa.inline_attention_backward_reference(q, kc, vc, tm, tmc, o, do)
    worst_own = 0.0
    for g, g_own, w, name in zip(got, own, want, ("dq", "dk", "dv")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=K7_TOL, rtol=K7_TOL,
                                   err_msg=name)
        worst_own = max(worst_own, float(
            (np.abs(g_own.numpy() - w) / (K7_TOL + K7_TOL * np.abs(w))
             ).max()))
    assert worst_own > 100.0, worst_own


def test_flash_mha_inline_bwd_passes_the_lse_on_the_cpu():
    """The wrapper hands a given lse to the plain version on CPU tensors
    (before, it dropped it)."""
    a, q, kc, vc, o, lse, tm, tmc, _, _ = _global_lse_case()
    do = torch.from_numpy(a["dout"])
    got = fa.flash_mha_inline_bwd(q, kc, vc, tm, tmc, o, do, lse)
    want = fa.inline_attention_backward_reference(q, kc, vc, tm, tmc, o, do,
                                                  lse=lse)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_merge_starts_finite_and_skips_dead_rows():
    """A row that sees no key in a chunk (K6: out 0, lse -inf) merges with
    weight 0 from the finite start; from -inf it would be NaN."""
    o0 = torch.zeros(1, 2, 1, 3)
    start = torch.full((1, 1, 2), LSE_START)
    dead = torch.full((1, 1, 2), float("-inf"))
    o, lse = merge(o0, start, torch.zeros(1, 2, 1, 3), dead)
    assert torch.equal(o, o0) and torch.equal(lse, start)
    live = torch.tensor([[[0.5, -1.0]]])
    oj = torch.randn(1, 2, 1, 3)
    o, lse = merge(o, lse, oj, live)
    assert torch.allclose(o, oj) and torch.allclose(lse, live)
    nan, _ = merge(o0, dead, torch.zeros(1, 2, 1, 3), dead)
    assert torch.isnan(nan).all()


# ---- the hop ---------------------------------------------------------------

@pytest.fixture(scope="module")
def hops(tmp_path_factory):
    """The four ranks' hops, run once for the cases below."""
    return spawn_ranks(ranks.ppermute_case, (), 4,
                       str(tmp_path_factory.mktemp("hops")), threads=1,
                       timeout=300)


@pytest.mark.parametrize("group,shift", [("group4", 1), ("group4", -1),
                                         ("group2", 1), ("group2", -1)])
def test_ppermute_forward_and_backward(hops, group, shift):
    """Group rank i receives rank (i - shift)'s x; x's gradient is the
    cotangent of the rank it went to, (i + shift) (the reverse hop). The
    seq groups of (seq 4) are all four ranks, of (data 2, seq 2) the pairs
    {0, 1}, {2, 3} (rank order data-major)."""
    res = hops
    n = 4 if group == "group4" else 2
    for r, out in enumerate(res):
        rec = out[f"{group}_{shift}"]
        i = rec["seq_index"]
        base = r - i  # the group's first global rank
        src = base + (i - shift) % n
        dst = base + (i + shift) % n
        assert torch.equal(rec["y"], torch.full((3, 2), src + ((i - shift)
                                                               % n) / 10))
        assert torch.equal(rec["grad"], torch.full((3, 2), 1.0 + dst))
        assert rec["stats"] == (24, 24)  # 6 fp32 sent each way


# ---- ring_attend -----------------------------------------------------------

def _whole(res, name, seq, tensor):
    """The ranks' chunks of ``name`` put back into [B, L, H, D] (rank
    order: seq-major, tensor-minor)."""
    rows = [torch.cat([res[s * tensor + t][name] for t in range(tensor)],
                      dim=2) for s in range(seq)]
    return torch.cat(rows, dim=1).numpy()


def _jax_ring(meta, a, seq, tensor, impl="reference"):
    """(out, dq, dk, dv) of sum(ring_attend * dout) under the JAX mesh."""
    jm = _jmeta(meta)

    def loss(q, k, v):
        out = jring(q, k, v, jm, jm, impl=impl)
        return jnp.sum(out * a["dout"]), out

    mesh = jmake_mesh(JMeshConfig(seq=seq, tensor=tensor))
    with jax.sharding.set_mesh(mesh):
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(a[x]) for x in "qkv"))
    return (np.asarray(out),) + tuple(np.asarray(g) for g in grads)


def _check_ring(res, want, seq, tensor, rows=slice(None)):
    names = ("out", "q", "k", "v")
    for name, w in zip(names, want):
        tol = FWD_TOL if name == "out" else GRAD_TOL
        got = _whole(res, name, seq, tensor)
        np.testing.assert_allclose(got[rows] if name == "out" else got,
                                   w[rows] if name == "out" else w,
                                   atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("seq,tensor", [(2, 1), (4, 1), (2, 2)],
                         ids=["seq2", "seq4", "seq2_tensor2"])
def test_ring_attend_matches_jax(tmp_path, seq, tensor):
    """Each rank's output chunk and q/k/v chunk gradients, put together,
    against the JAX ring (dense chunks) under the same mesh; the hops
    moved bytes in both directions."""
    meta = _layout_meta()
    a = _arrays(meta, seed=seq + 10 * tensor)
    res = spawn_ranks(ranks.ring_grads, (MeshConfig(seq=seq, tensor=tensor),
                                         a, meta), seq * tensor,
                      str(tmp_path), threads=1, timeout=300)
    _check_ring(res, _jax_ring(meta, a, seq, tensor), seq, tensor)
    assert all(r["stats"][0] > 0 and r["stats"][1] > 0 for r in res)


def test_ring_attend_matches_the_jax_pallas_chunks(tmp_path):
    """(seq 2), GQA 8:4 at head_dim 96: the JAX ring's chunks run the
    Pallas K6/K7 in interpret mode (``impl='pallas'``, as
    ``tests/test_ring.py`` runs its GQA case)."""
    meta = _layout_meta(rows=1, multiple=2)
    a = _arrays(meta, seed=5, d=96)
    res = spawn_ranks(ranks.ring_grads, (MeshConfig(seq=2), a, meta), 2,
                      str(tmp_path), threads=1, timeout=300)
    jfa.INTERPRET = True
    try:
        want = _jax_ring(meta, a, 2, 1, impl="pallas")
    finally:
        jfa.INTERPRET = False
    _check_ring(res, want, 2, 1)


def _dead_row_meta():
    """One row of 16 tokens over (seq 2) with only causal keys: keys 0-7
    (chunk 0) visible to queries from 4 on, keys 8-11 to queries from 1
    on, keys 12-15 never (padded keys). Query 0 sees no key in either
    chunk; queries 1-3 see none in their own chunk 0 (rank 0's first
    merge step) and some in chunk 1."""
    vis = np.array([4] * 8 + [1] * 4 + [NEVER] * 4, np.int32)[None]
    zeros = np.zeros((1, 16), np.int32)
    return dict(index=np.arange(16, dtype=np.int32)[None], vis_start=vis,
                noisy_block=zeros - 1, noisy_role=zeros,
                q_block=zeros - 1, q_offset=zeros, is_pad=zeros)


def test_ring_attend_rows_that_see_no_key(tmp_path):
    """Trap 2 (the merge's start): rows dead in the first chunk they meet
    and alive later, and a row dead in every chunk. Against the one-rank
    plain K6/K7 (``attend``, differentiable) on every row: the dead row
    comes out 0 with a zero gradient, nothing is NaN. Against the JAX ring
    on the rows that see a key (JAX averages every key on a row that sees
    none; its cotangent is set to 0 so that it moves no gradient)."""
    meta = _dead_row_meta()
    a = _arrays(meta, seed=9)
    a["dout"][:, 0] = 0.0
    res = spawn_ranks(ranks.ring_grads, (MeshConfig(seq=2), a, meta), 2,
                      str(tmp_path), threads=1, timeout=300)
    tm = _tmeta(meta)
    q, k, v = (torch.from_numpy(a[x]).requires_grad_() for x in "qkv")
    out = attend(q, k, v, tm, tm)
    (out * torch.from_numpy(a["dout"])).sum().backward()
    one = (out.detach().numpy(), q.grad.numpy(), k.grad.numpy(),
           v.grad.numpy())
    assert not np.abs(one[0][:, 0]).any() and not np.abs(one[1][:, 0]).any()
    for name, w in zip(("out", "q", "k", "v"), one):
        got = _whole(res, name, 2, 1)
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, w, atol=FWD_TOL, rtol=FWD_TOL,
                                   err_msg=name)
    _check_ring(res, _jax_ring(meta, a, 2, 1), 2, 1,
                rows=(slice(None), slice(1, None)))


def test_ring_attend_refuses_what_jax_refuses():
    from video_gpt_tpu_torch.parallel.mesh import Mesh
    from video_gpt_tpu_torch.parallel.ring import ring_attend
    meta = _tmeta(_layout_meta(rows=1, multiple=1))
    l = meta.index.shape[1]
    assert l % 3, "the layout must not divide by the seq axis"
    mesh = Mesh(MeshConfig(seq=3), 0, {})
    x = torch.zeros(1, l // 3, H, D)
    with pytest.raises(ValueError, match="ring SP=3 needs sequence lengths "
                                         "divisible by the seq axis"):
        ring_attend(x, x, x, meta, meta, mesh)
