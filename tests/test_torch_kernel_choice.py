"""Which hand-written attention kernel a call selects, without a card.

``ops.flash_attention.forward_kernel`` is the pure function the forward
wrappers (K1/K2, K3, K6) call: bf16 operands run the tensor-core kernel of
their mask, fp32 operands ``csrc/fp32_attention.cu``, each at the least of
32, 64, 96, 128 that holds the head width. What the Pallas kernels'
``flash_attention_supported`` refuses (head_dim above 128, heads not a
multiple of the kv heads) is refused here too, and so are what the CUDA
kernels cannot load (a head_dim that is not a multiple of 8), another
dtype and mixed dtypes. ``backward_kernel``, its twin, is what the
backward wrappers (K9, K7) call: bf16 operands run the tensor-core K9 /
K7, fp32 operands ``csrc/fp32_attention_bwd.cu``, at the same widths, with
the same refusals. The C entry point a launch takes is read through a
stand-in for ``_launch``, on CPU tensors (the checks touch no CUDA).
"""
import pytest
import torch

from video_gpt_tpu_torch.ops import flash_attention as fa

BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("d,dp", [(8, 32), (16, 32), (32, 32), (40, 64),
                                  (64, 64), (72, 96), (96, 96), (104, 128),
                                  (128, 128)])
@pytest.mark.parametrize("dtype,kernel", [(BF16, "bf16"), (FP32, "fp32")])
def test_forward_kernel_by_dtype_and_width(dtype, kernel, d, dp):
    choice = fa.forward_kernel([dtype] * 3, d, 8, 2)
    assert choice == fa.KernelChoice(kernel, dp)
    assert dp in fa.KERNEL_HEAD_DIMS


@pytest.mark.parametrize("dtypes,d,h,hkv,err,match", [
    ((BF16, FP32, BF16), 96, 4, 2, TypeError, "one dtype"),
    ((FP32, FP32, BF16), 96, 4, 2, TypeError, "one dtype"),
    ((torch.float16,) * 3, 96, 4, 2, TypeError, "bf16 or fp32"),
    ((torch.float64,) * 3, 96, 4, 2, TypeError, "bf16 or fp32"),
    ((BF16,) * 3, 136, 4, 2, ValueError, "head_dim <= 128"),
    ((FP32,) * 3, 256, 4, 2, ValueError, "head_dim <= 128"),
    ((BF16,) * 3, 0, 4, 2, ValueError, "head_dim <= 128"),
    ((BF16,) * 3, 20, 4, 2, ValueError, "multiple of 8"),
    ((FP32,) * 3, 100, 4, 2, ValueError, "multiple of 8"),
    ((BF16,) * 3, 96, 6, 4, ValueError, "not a multiple of 4 kv heads"),
])
def test_forward_kernel_refuses(dtypes, d, h, hkv, err, match):
    with pytest.raises(err, match=match):
        fa.forward_kernel(list(dtypes), d, h, hkv)


def _rank_operands(dtype, d, b=1, lq=5, lc=7, lt=5, h=4, hkv=2):
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    q = t(b, lq, h, d)
    ops = [(t(b, hkv, n, d), t(b, hkv, n, d),
            torch.zeros(b, n, dtype=torch.int32)) for n in (lc, lt)]
    return q, ops, torch.zeros(b, lq, dtype=torch.int32)


@pytest.mark.parametrize("dtype,entry", [
    (BF16, ("rank_attention", "vgt_rank_attention")),
    (FP32, ("fp32_attention", "vgt_fp32_rank_attention"))])
@pytest.mark.parametrize("d", [16, 96, 128])
def test_k1_launch_takes_the_kernel_of_its_dtype(monkeypatch, dtype, entry,
                                                 d):
    """``_launch_rank`` (K1/K2) checks the operands and hands the C entry
    point of its dtype the true head_dim (the kernel pads it)."""
    seen = []
    monkeypatch.setattr(fa, "_launch", lambda lib, fn, args, device:
                        seen.append((lib, fn, args.head_dim)))
    q, ops, q_off = _rank_operands(dtype, d)
    out, choice = fa._launch_rank(q, ops, q_off)
    assert seen == [entry + (d,)]
    assert out.dtype == dtype and out.shape == q.shape
    assert choice == fa.forward_kernel([dtype], d, 4, 2)


def test_k1_launch_refuses_mixed_operands(monkeypatch):
    monkeypatch.setattr(fa, "_launch", lambda *a: pytest.fail("launched"))
    q, ops, q_off = _rank_operands(BF16, 96)
    k, v, r = ops[1]
    with pytest.raises(TypeError, match="one dtype"):
        fa._launch_rank(q, [ops[0], (k.float(), v.float(), r)], q_off)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa._launch_rank(*_rank_operands(FP32, 12))


@pytest.mark.parametrize("dtype,d", [(BF16, 16), (BF16, 128), (FP32, 96),
                                     (FP32, 64)])
def test_row_kernels_choose_by_dtype_and_the_backward_refuses(dtype, d):
    """K3 and K6 (``_kv_views``) take every dtype and width the dispatch
    takes, and so do the backward kernels K7 and K9 (``backward=True``);
    the backward refuses what the forward refuses: k and v in another
    dtype than q."""
    q = torch.zeros(1, 6, 4, d, dtype=dtype)
    k = v = torch.zeros(1, 6, 2, d, dtype=dtype)
    kh, vh, choice = fa._kv_views(q, k, v)
    assert choice == fa.forward_kernel([dtype], d, 4, 2)
    assert kh.shape == (1, 2, 6, d)
    assert fa._kv_views(q, k, v, backward=True)[2] == fa.backward_kernel(
        [dtype], d, 4, 2) == choice
    other = FP32 if dtype == BF16 else BF16
    with pytest.raises(TypeError, match="one dtype"):
        fa._kv_views(q, k.to(other), v.to(other), backward=True)


def test_the_backward_takes_bf16_at_96():
    q = torch.zeros(1, 6, 4, 96, dtype=BF16)
    k = v = torch.zeros(1, 6, 2, 96, dtype=BF16)
    assert fa._kv_views(q, k, v, backward=True)[2] == fa.KernelChoice(
        "bf16", 96)


@pytest.mark.parametrize("d,dp", [(16, 32), (40, 64), (64, 64), (96, 96),
                                  (104, 128), (128, 128)])
@pytest.mark.parametrize("dtype,kernel", [(BF16, "bf16"), (FP32, "fp32")])
def test_backward_kernel_by_dtype_and_width(dtype, kernel, d, dp):
    """bf16 runs the tensor-core K9 / K7 at the padded width, fp32
    ``fp32_attention_bwd.cu``: the forward's choice for the same operands,
    so a step whose forward ran has a backward."""
    choice = fa.backward_kernel([dtype] * 3, d, 8, 2)
    assert choice == fa.KernelChoice(kernel, dp)
    assert choice == fa.forward_kernel([dtype] * 3, d, 8, 2)


@pytest.mark.parametrize("dtypes,d,h,hkv,err,match", [
    ((BF16, FP32, FP32), 96, 4, 2, TypeError, "one dtype"),
    ((torch.float16,) * 3, 64, 4, 2, TypeError, "bf16 or fp32"),
    ((FP32,) * 3, 136, 4, 2, ValueError, "head_dim <= 128"),
    ((BF16,) * 3, 20, 4, 2, ValueError, "multiple of 8"),
    ((FP32,) * 3, 96, 6, 4, ValueError, "not a multiple of 4 kv heads"),
])
def test_backward_kernel_refuses(dtypes, d, h, hkv, err, match):
    with pytest.raises(err, match=match):
        fa.backward_kernel(list(dtypes), d, h, hkv)


def _bwd_operands(dtype, d, lq=70, lk=70, h=4, hkv=2):
    """q, k, v, o, dO and an lse for a backward launch on CPU tensors,
    with the metadata of a one-row training layout of ``lq`` tokens."""
    from video_gpt_tpu_torch import layout
    from video_gpt_tpu_torch.ops.attention import AttnMeta

    lay = layout.build_layout([layout.RowSpec((1, 1), "training")], 33)
    meta = AttnMeta.from_layout(lay, "cpu")
    lq = lk = meta.index.shape[1]
    g = torch.Generator().manual_seed(1)

    def t(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    q, o, do = t(1, lq, h, d), t(1, lq, h, d), t(1, lq, h, d)
    k, v = t(1, lk, hkv, d), t(1, lk, hkv, d)
    return q, k, v, o, do, torch.zeros(1, h, lq), meta


@pytest.mark.parametrize("dtype,kernel,bias_entry,inline_entry", [
    (BF16, "bf16", ("bias_attention_bwd", "vgt_bias_attention_bwd"),
     ("inline_attention_bwd", "vgt_inline_attention_bwd")),
    (FP32, "fp32", ("fp32_attention_bwd", "vgt_fp32_bias_attention_bwd"),
     ("fp32_attention_bwd", "vgt_fp32_inline_attention_bwd"))])
@pytest.mark.parametrize("d", [16, 96, 128])
def test_backward_launch_takes_the_kernel_of_its_dtype(
        monkeypatch, dtype, kernel, bias_entry, inline_entry, d):
    """``flash_mha_bwd`` (K9) and ``flash_mha_inline_bwd`` (K7) check the
    operands, hand the C entry point of their dtype the true head_dim
    and its scales (the kernel pads it), and count the launch in
    ``launches`` (bf16) or ``fp32_launches`` (fp32)."""
    seen = []
    monkeypatch.setattr(fa, "_launch", lambda lib, fn, args, device:
                        seen.append((lib, fn, args.head_dim, args.scale)))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda x: True))
    q, k, v, o, do, lse, meta = _bwd_operands(dtype, d)
    lq = q.shape[1]
    bias = fa.precompute_bias(meta, meta)
    bm = fa.BiasMap(bias, torch.zeros(1, 2, 2, dtype=torch.int8),
                    torch.zeros(1, lq), torch.zeros(2, dtype=torch.int32))
    fa.reset_launch_counts()
    for fn, call, entry in (
            (fa.flash_mha_bwd, lambda: fa.flash_mha_bwd(
                q, k, v, bm, o, do, lse), bias_entry),
            (fa.flash_mha_inline_bwd, lambda: fa.flash_mha_inline_bwd(
                q, k, v, meta, meta, o, do, lse), inline_entry)):
        seen.clear()
        dq, dk, dv = call()
        assert seen == [entry + (d, pytest.approx(d ** -0.5))]
        assert (dq.dtype, dk.dtype, dv.dtype) == (dtype,) * 3
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        assert (fn.launches, fn.fp32_launches) == (
            (1, 0) if kernel == "bf16" else (0, 1))


@pytest.mark.parametrize("kind", ["bf16", "fp32"])
def test_launches_count_apart_by_kernel(kind):
    """Each kernel keeps its own counter: a bf16 launch in ``launches``
    (and past 8192 keys in ``long_launches``), an fp32 launch in
    ``fp32_launches``; ``reset_launch_counts`` zeroes both."""
    fa.reset_launch_counts()
    choice = fa.KernelChoice(kind, 96)
    for fn in fa.KERNELS:
        fa._count(fn, choice, fa.TPU_KEY_CAP + 1)
        assert (fn.launches, fn.fp32_launches) == (
            (1, 0) if kind == "bf16" else (0, 1))
        if hasattr(fn, "long_launches"):
            assert fn.long_launches == (kind == "bf16")
    fa.reset_launch_counts()
    assert all(fn.launches == fn.fp32_launches == 0
               for fn in fa.KERNELS)
